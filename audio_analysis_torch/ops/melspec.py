"""Framed DFT -> |X|^power -> mel, and the full |STFT| of long signals.

``stft_mel`` replaces the Pallas kernel ``ops/pallas/melspec.py::_kernel_dif``
and ``stft_mag`` replaces ``_kernel_dif_mag`` (CUDA source:
``csrc/stft.cu``). Each wrapper launches its kernel for a CUDA tensor and
uses the plain PyTorch version beside it for a CPU tensor; there is no
other route. Each counts its launches in ``.launches``.

The TPU kernels' z layout, DIF factoring, split-bf16 passes and 320-frame
cap exist for the MXU and VMEM; here the kernel takes plain float32 windows
[N, S], frames them by index with librosa's centre/constant padding, and
computes the DFT for any n_fft.

Both the kernels and the plain versions window in float32 and take the DFT
in float64, rounding to float32 at the end. The detection thresholds
consume raw bin magnitudes down to 1e-3 of the maximum, where a float32
FFT is off by 2-8e-5 relative, as far as a 2-way split-bf16 product (the
error at which the mask flips bits); in float64 the kernel and its plain
version agree to float32 rounding.
"""

from functools import lru_cache

import numpy as np
import torch

from audio_analysis_torch.ops import cuda
from audio_analysis_torch.ops.mel import filterbank_np, mel_support_bins
from audio_analysis_torch.ops.stft import stft_magnitude
from audio_analysis_torch.ops.windows import get_window_np


@lru_cache(maxsize=8)
def _twiddles_np(n_fft: int):
    """cos/sin(2 pi j / n_fft) for j < n_fft, float64."""
    ang = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    return np.cos(ang), np.sin(ang)


_DEVICE_CONSTS = {}


def _device_consts(key, build, device):
    """Host-built constants, uploaded once per device."""
    k = (key, str(device))
    got = _DEVICE_CONSTS.get(k)
    if got is None:
        got = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in build())
        _DEVICE_CONSTS[k] = got
    return got


def _dft_consts(n_fft, device):
    def build():
        cs, sn = _twiddles_np(n_fft)
        return get_window_np("hann", n_fft, periodic=True), cs, sn

    return _device_consts(("dft", n_fft), build, device)


def _mel_consts(sr, n_mels, fmin, fmax, n_fft, break_freq, htk, device):
    """fb [n_mels, bins_used] and each row's nonzero support [lo, hi)."""

    def build():
        bu = mel_support_bins(sr, n_mels, fmin, fmax, n_fft, break_freq, htk)
        fb = filterbank_np(sr, n_mels, fmin, fmax, n_fft, break_freq, htk)[:, :bu]
        nz = fb != 0
        any_nz = nz.any(axis=1)
        lo = np.where(any_nz, nz.argmax(axis=1), 0).astype(np.int32)
        hi = np.where(any_nz, bu - nz[:, ::-1].argmax(axis=1), 0).astype(np.int32)
        return fb, lo, hi

    return _device_consts(("mel", sr, n_mels, fmin, fmax, n_fft, break_freq, htk), build, device)


def _frame_count(n_samples, hop_length, frames):
    total = 1 + n_samples // hop_length
    if frames is None:
        return total
    if not 0 <= frames <= total:
        raise ValueError(f"{frames} frames asked for, the signal has {total}")
    return frames


def stft_mel_plain(windows, *, sr, n_fft, hop_length, n_mels, fmin, fmax,
                   break_freq=1750.0, power=2.0, htk=True, frames=None):
    """Plain PyTorch version of ``stft_mel``: constant-padded frames ->
    ``torch.fft.rfft`` in float64 -> |X|^power rounded to float32 ->
    filterbank matmul in float64, rounded to float32."""
    n_out = _frame_count(windows.shape[-1], hop_length, frames)
    bu = mel_support_bins(sr, n_mels, fmin, fmax, n_fft, break_freq, htk)
    p = stft_magnitude(windows, n_fft, hop_length, power=power,
                       dtype=torch.float64)[..., :bu, :n_out]
    fb = torch.from_numpy(filterbank_np(sr, n_mels, fmin, fmax, n_fft, break_freq, htk)[:, :bu])
    mel = torch.matmul(fb.to(windows.device, torch.float64), p.to(torch.float32).to(torch.float64))
    return mel.to(torch.float32)


def stft_mel(windows, *, sr, n_fft, hop_length, n_mels, fmin, fmax,
             break_freq=1750.0, power=2.0, htk=True, frames=None):
    """[N, S] float32 PCM windows -> [N, n_mels, frames] mel spectrograms
    (librosa centre/constant framing; every frame when ``frames`` is None,
    else the first ``frames``). ``htk`` picks the
    break-frequency filterbank, else librosa's Slaney one."""
    if windows.device.type == "cpu":
        return stft_mel_plain(
            windows, sr=sr, n_fft=n_fft, hop_length=hop_length, n_mels=n_mels,
            fmin=fmin, fmax=fmax, break_freq=break_freq, power=power, htk=htk,
            frames=frames,
        )
    cuda.require_cuda(windows, "stft_mel")
    if windows.dim() != 2:
        raise ValueError(f"stft_mel: expected [N, S] windows, got {tuple(windows.shape)}")
    n, s = windows.shape
    n_out = _frame_count(s, hop_length, frames)
    dev = windows.device
    win, cs, sn = _dft_consts(int(n_fft), dev)
    fb, lo, hi = _mel_consts(int(sr), int(n_mels), float(fmin), float(fmax), int(n_fft),
                             float(break_freq), bool(htk), dev)
    out = torch.empty((n, n_mels, n_out), dtype=torch.float32, device=dev)
    rc = cuda.library().aat_stft_mel(
        windows.data_ptr(), win.data_ptr(), cs.data_ptr(), sn.data_ptr(),
        fb.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(),
        n, s, int(n_fft), int(hop_length), n_out, fb.shape[1],
        int(n_mels), float(power), cuda.stream_of(windows),
    )
    cuda.check(rc, "stft_mel")
    stft_mel.launches += 1
    return out


stft_mel.launches = 0


def stft_mag_plain(y, *, n_fft, hop_length, power=1.0):
    """Plain PyTorch version of ``stft_mag``: the float64 DFT of the
    float32-windowed frames, rounded to float32."""
    return stft_magnitude(y, n_fft, hop_length, power=power,
                          dtype=torch.float64).to(torch.float32)


def stft_mag(y, *, n_fft, hop_length, power=1.0):
    """[B, T] float32 PCM -> [B, 1 + n_fft//2, 1 + T//hop] |STFT|^power,
    natural bin order (librosa centre/constant-pad conventions)."""
    if y.device.type == "cpu":
        return stft_mag_plain(y, n_fft=n_fft, hop_length=hop_length, power=power)
    cuda.require_cuda(y, "stft_mag")
    if y.dim() != 2:
        raise ValueError(f"stft_mag: expected [B, T] signals, got {tuple(y.shape)}")
    b, t = y.shape
    n_frames = 1 + t // hop_length
    win, cs, sn = _dft_consts(int(n_fft), y.device)
    out = torch.empty((b, n_fft // 2 + 1, n_frames), dtype=torch.float32, device=y.device)
    rc = cuda.library().aat_stft_mag(
        y.data_ptr(), win.data_ptr(), cs.data_ptr(), sn.data_ptr(), out.data_ptr(),
        b, t, int(n_fft), int(hop_length), n_frames, float(power), cuda.stream_of(y),
    )
    cuda.check(rc, "stft_mag")
    stft_mag.launches += 1
    return out


stft_mag.launches = 0
