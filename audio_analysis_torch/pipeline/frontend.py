"""Batched spectrogram frontend: the reference's per-window ``get_spect``
(src/identify_tracks.py:212-288) over the whole window grid (the JAX
package's pipeline/frontend.py::spectrogram_grid).

Normalise -> framed DFT -> mel -> dB (-> the mfcc rows) -> mean-sub ->
channels. The DFT -> mel runs at one of two levels (``frontend_level``): ``exact``, the float64
``stft_mel`` kernel, or ``fast``, the bf16 tensor-core ``stft_mel_bf16``
kernel (the AAT_FAST throughput preset; its dif route for n_fft % 8 == 0).
"""

import logging
import math
import os

import torch

from audio_analysis_torch.models.layers import resize_with_pad
from audio_analysis_torch.ops.dct import dct2
from audio_analysis_torch.ops.mel import filterbank_np
from audio_analysis_torch.ops.melspec import stft_mel, stft_mel_bf16
from audio_analysis_torch.ops.scale import normalize_minmax, power_to_db
from audio_analysis_torch.ops.stft import stft_magnitude
from audio_analysis_torch.utils.runtime import fast_mode

EXACT, FAST = "exact", "fast"

_FAST_WORDS = ("1", "true", "on", "yes")
# the JAX package's exact levels (exact, exact1, exact2, 2, 3) and its XLA
# level (0 and the false words) all resolve to the float64 kernel here: it
# meets exact2's 1.5e-6 contract and keeps the XLA level's float parity
_EXACT_WORDS = ("0", "false", "off", "no", "exact", "exact1", "exact2", "2", "3")
_WARNED_BAD_LEVEL = False


def frontend_level() -> str:
    """The DFT -> mel level, the counterpart of the JAX package's
    ``_use_pallas_default``, read at each call so a warm process can flip it:

    - an explicit AAT_PALLAS beats AAT_FAST;
    - AAT_PALLAS=1/true/on/yes, or AAT_FAST=1 with no AAT_PALLAS: ``fast``;
    - unset, 0/false/off/no and exact/exact1/exact2/2/3: ``exact``;
    - any other AAT_PALLAS warns once and takes the default (``fast`` under
      AAT_FAST, else ``exact``).

    Unlike the JAX package, the fast level does not degrade on the CPU:
    there it runs the bf16 kernel's plain version. AAT_PALLAS_ALG=matmul
    sends the fast level to the direct DFT, as in the JAX package
    (``ops/melspec.py::bf16_route``, read at each call)."""
    global _WARNED_BAD_LEVEL
    raw = os.environ.get("AAT_PALLAS", "").strip().lower()
    if raw in _FAST_WORDS:
        return FAST
    if raw in _EXACT_WORDS:
        return EXACT
    if raw and not _WARNED_BAD_LEVEL:
        _WARNED_BAD_LEVEL = True
        logging.warning(
            "unrecognised AAT_PALLAS=%r (expected a boolean or one of %s); using the "
            "default level", raw, sorted(_EXACT_WORDS[4:]),
        )
    return FAST if fast_mode() else EXACT


def dft_mel(level):
    """The DFT -> mel wrapper of a level."""
    if level not in (EXACT, FAST):
        raise ValueError(f"unknown frontend level {level!r}")
    return stft_mel_bf16 if level == FAST else stft_mel


def spectrogram_grid(
    windows: torch.Tensor,
    *,
    sr: int,
    hop_length: int = 281,
    n_fft: int = 4096,
    n_mels: int = 160,
    mel_break: float = 1000.0,
    htk: bool = True,
    fmin: float = 50.0,
    fmax: float = 11000.0,
    power: float = 2.0,
    db_scale: bool = False,
    normalize: bool = True,
    mean_sub: bool = False,
    use_mfcc: bool = False,
    channels: int = 1,
    level: str = None,
) -> torch.Tensor:
    """[N, sample_size] PCM windows -> [N, n_mels, frames, channels].

    Faithful to get_spect, including the fmax-keyed-on-fmin quirk
    (src/identify_tracks.py:260-261) and per-window power_to_db(ref=max).
    ``level`` is ``exact`` or ``fast``; None resolves it now
    (``frontend_level``)."""
    mel_of = dft_mel(frontend_level() if level is None else level)
    if normalize:
        windows = normalize_minmax(windows)
    if htk:
        f_lo = 50.0 if fmin is None else fmin
        f_hi = 11000.0 if fmin is None else fmax  # quirk: keyed on fmin
        mel = mel_of(
            windows.contiguous(), sr=sr, n_fft=n_fft, hop_length=hop_length,
            n_mels=n_mels, fmin=f_lo, fmax=f_hi, break_freq=mel_break,
            power=power, htk=True,
        )
    else:
        # librosa.feature.melspectrogram defaults: Slaney scale/norm, power 2
        mel = mel_of(
            windows.contiguous(), sr=sr, n_fft=n_fft, hop_length=hop_length,
            n_mels=n_mels, fmin=50.0, fmax=11000.0, power=2.0, htk=False,
        )
    if db_scale:
        mel = power_to_db(mel, ref_axes=(-2, -1))
    mel = mel[..., None]  # channel dim
    if use_mfcc:
        # the reference concatenates a resized MFCC under the mel
        # (src/identify_tracks.py:269-280); its own call passes a 2-D array
        # to tf.image.resize_with_pad and would fail, so this is the JAX
        # package's reading of its intent: the MFCC resized to the mel's
        # [n_mels, T], then stacked on the mel axis
        mfcc = _mfcc(windows, sr, hop_length)
        mfcc = resize_with_pad(mfcc[..., None], mel.shape[-3], mel.shape[-2])
        mel = torch.cat((mel, mfcc), dim=-3)
    if mean_sub:
        mel = mel - mel.mean(dim=-2, keepdim=True)
    if channels > 1:
        mel = mel.repeat_interleave(channels, dim=-1)
    return mel


def _mfcc(windows, sr, hop_length, n_mfcc=20, n_mels=80):
    """librosa.feature.mfcc(htk=True, fmin=50, fmax=11000, n_mels=80) of the
    normalised windows: |STFT|^2 at n_fft 2048 in float32 (XLA's rfft in the
    JAX package) -> htk mel (break 700) -> power_to_db(ref=1) with an 80 dB
    floor per window -> ortho DCT-II over the mel axis, the first 20
    coefficients: [N, 20, frames]."""
    mag = stft_magnitude(windows, 2048, hop_length)
    fb = torch.from_numpy(filterbank_np(sr, n_mels, 50.0, 11000.0, 2048, 700.0, True))
    mel = torch.einsum("mf,nft->nmt", fb.to(windows.device), mag * mag)
    log_spec = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    peak = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, peak - 80.0)
    d = dct2(log_spec.transpose(-1, -2))  # [..., frames, n_mels]
    n = d.shape[-1]
    scale = torch.full((n,), math.sqrt(1.0 / (2.0 * n)), device=d.device)
    scale[0] /= math.sqrt(2.0)
    return (d * scale).transpose(-1, -2)[..., :n_mfcc, :]
