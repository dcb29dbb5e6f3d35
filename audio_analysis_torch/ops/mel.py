"""Mel filterbanks (the JAX package's ops/mel.py).

The break-frequency HTK filterbank (the reference's "custommel",
src/custommel.py:6-56) and librosa's Slaney filterbank are built on the host
in float64 numpy and handed to the device as float32 matrices by the
kernels' wrappers (ops/melspec.py).
"""

from functools import lru_cache

import numpy as np


def hz_to_mel(frequencies, break_freq: float = 1750.0):
    """HTK-style mel with configurable break frequency
    (reference: src/custommel.py:6-8)."""
    return 2595.0 * np.log10(1.0 + np.asarray(frequencies, dtype=np.float64) / break_freq)


def mel_to_hz(mels, break_freq: float = 1750.0):
    return break_freq * (10.0 ** (np.asarray(mels, dtype=np.float64) / 2595.0) - 1.0)


def mel_frequencies(n_mels: int, fmin: float, fmax: float, break_freq: float) -> np.ndarray:
    """Uniformly spaced mel-band centre frequencies in Hz
    (reference: src/custommel.py:11-16)."""
    min_mel = hz_to_mel(fmin, break_freq)
    max_mel = hz_to_mel(fmax, break_freq)
    mels = np.linspace(min_mel, max_mel, n_mels)
    return mel_to_hz(mels, break_freq)


def fft_frequencies(sr: float, n_fft: int) -> np.ndarray:
    """Centre frequency of each rFFT bin (librosa.fft_frequencies)."""
    return np.linspace(0.0, float(sr) / 2.0, 1 + n_fft // 2)


@lru_cache(maxsize=32)
def _mel_filterbank_np(sr, n_mels, fmin, fmax, n_fft, break_freq) -> np.ndarray:
    """Triangular filterbank with Slaney normalisation
    (the math of reference src/custommel.py:19-56)."""
    n_mels = int(n_mels)
    weights = np.zeros((n_mels, 1 + n_fft // 2), dtype=np.float32)
    fftfreqs = fft_frequencies(sr, n_fft)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax, break_freq)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney: approximately constant energy per channel
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None].astype(np.float32)
    return weights


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, f / f_sp)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


@lru_cache(maxsize=32)
def _mel_filterbank_slaney_np(sr, n_mels, fmin, fmax, n_fft) -> np.ndarray:
    """librosa's default (htk=False) Slaney-scale filterbank with slaney
    norm (reference src/identify_tracks.py:229-238)."""
    weights = np.zeros((n_mels, 1 + n_fft // 2), dtype=np.float32)
    fftfreqs = fft_frequencies(sr, n_fft)
    mel_f = _mel_to_hz_slaney(
        np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    )
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None].astype(np.float32)
    return weights


def filterbank_np(sr, n_mels, fmin, fmax, n_fft, break_freq, htk) -> np.ndarray:
    """[n_mels, 1 + n_fft//2] float32: the break-frequency HTK bank when
    `htk`, else librosa's Slaney bank (break_freq unused)."""
    if htk:
        return _mel_filterbank_np(float(sr), int(n_mels), float(fmin), float(fmax), int(n_fft), float(break_freq))
    return _mel_filterbank_slaney_np(float(sr), int(n_mels), float(fmin), float(fmax), int(n_fft))


def mel_support_bins(sr, n_mels, fmin, fmax, n_fft, break_freq, htk) -> int:
    """Number of leading rFFT bins carrying any mel weight (the rest are
    zero, so dropping them is exact)."""
    fb = filterbank_np(sr, n_mels, fmin, fmax, n_fft, break_freq, htk)
    nz = np.nonzero(fb.any(axis=0))[0]
    return int(nz[-1]) + 1 if len(nz) else fb.shape[1]
