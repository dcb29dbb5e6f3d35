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

``stft_mel_bf16`` is the fast frontend level's DFT -> mel (AAT_FAST=1 /
AAT_PALLAS=1): it replaces the direct-DFT Pallas kernel
``ops/pallas/melspec.py::_kernel`` and serves ``_kernel_dif``'s bf16
(exact=0) level too (CUDA source: ``csrc/stft_bf16.cu``). Its contract is
bf16 operands with float32 accumulation, about 1-2% relative; the
classify frontend and the end-scan take it at every n_fft and frame count.
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


def _device_consts(key, build, device, dtype=None):
    """Host-built constants, uploaded once per device (converted to `dtype`
    on the host first, when given)."""
    k = (key, str(device))
    got = _DEVICE_CONSTS.get(k)
    if got is None:
        got = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(device)
                    for a in build())
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


# ---------------------------------------------------------------------------
# The bf16 tensor-core DFT -> mel (the fast frontend level)
# ---------------------------------------------------------------------------

BF16_K_STEP = 64  # the kernel's K chunk: n_fft is zero-padded to a multiple
BF16_BIN_TILE = 64  # the kernel's bin tile: the support is zero-padded to a multiple
BF16_MEL_ROWS = (64, 128, 160, 256)  # mel capacities the kernel is built for
_PLAIN_STEP = 1 << 24  # framed samples per step of the plain version


def _bf16_consts(sr, n_mels, fmin, fmax, n_fft, break_freq, htk, device):
    """(wr, wi [bins_p, k_pad], melt [mel_rows, bins_p]) bf16 and the mel
    support ``bins_used``: the Hann-folded cos and -sin built in float64 as
    the JAX package's ``_dft_mats`` builds them, rounded to float32 and then
    to bf16; the filterbank as float32, then bf16 (``_mel_mat``); zero past
    n_fft, past the support and past n_mels."""
    sr, n_mels, n_fft, htk = int(sr), int(n_mels), int(n_fft), bool(htk)
    fmin, fmax, break_freq = float(fmin), float(fmax), float(break_freq)
    bu = mel_support_bins(sr, n_mels, fmin, fmax, n_fft, break_freq, htk)
    rows = next((r for r in BF16_MEL_ROWS if r >= n_mels), None)
    if rows is None:
        raise ValueError(f"stft_mel_bf16: {n_mels} mels, the kernel takes at most "
                         f"{BF16_MEL_ROWS[-1]}")

    def build():
        bins_p = -(-bu // BF16_BIN_TILE) * BF16_BIN_TILE
        k_pad = -(-n_fft // BF16_K_STEP) * BF16_K_STEP
        n = np.arange(n_fft)
        k = np.arange(bu)
        ang = 2.0 * np.pi * np.outer(k, n) / n_fft
        w = get_window_np("hann", n_fft, periodic=True).astype(np.float64)
        wr = np.zeros((bins_p, k_pad), np.float32)
        wi = np.zeros((bins_p, k_pad), np.float32)
        wr[:bu, :n_fft] = (np.cos(ang) * w).astype(np.float32)
        wi[:bu, :n_fft] = (-np.sin(ang) * w).astype(np.float32)
        melt = np.zeros((rows, bins_p), np.float32)
        fb = filterbank_np(sr, n_mels, fmin, fmax, n_fft, break_freq, htk)
        melt[:n_mels, :bu] = fb[:, :bu].astype(np.float32)
        return wr, wi, melt

    key = ("bf16", sr, n_mels, fmin, fmax, n_fft, break_freq, htk)
    wr, wi, melt = _device_consts(key, build, device, dtype=torch.bfloat16)
    return wr, wi, melt, bu


def stft_mel_bf16_plain(windows, *, sr, n_fft, hop_length, n_mels, fmin, fmax,
                        break_freq=1750.0, power=2.0, htk=True, frames=None):
    """Plain PyTorch version of ``stft_mel_bf16``, the same arithmetic in
    float32 (TF32 is off, ``device.py``): bf16-rounded frames and constants
    upcast to float32 (a product of two bf16 values is exact in float32, so
    only the order of summation differs from the kernel), the DFT matmul,
    |X|^power rounded to bf16 and back, the mel matmul. Loops over chunks of
    windows and frames to bound memory."""
    n, s = windows.shape
    n_out = _frame_count(s, hop_length, frames)
    wr, wi, melt, bu = _bf16_consts(sr, n_mels, fmin, fmax, n_fft, break_freq, htk,
                                    windows.device)
    wr_t = wr[:bu, :n_fft].to(torch.float32).T  # [n_fft, bins]
    wi_t = wi[:bu, :n_fft].to(torch.float32).T
    mel_t = melt[:n_mels, :bu].to(torch.float32).T  # [bins, n_mels]
    # frame t = x[t*hop - n_fft//2 : ... + n_fft], zero outside the window
    half = n_fft // 2
    padded = torch.nn.functional.pad(windows.to(torch.float32), (half, n_fft - half))
    view = padded.unfold(-1, n_fft, hop_length)[:, :n_out]  # [n, n_out, n_fft]
    out = torch.empty((n, n_mels, n_out), dtype=torch.float32, device=windows.device)
    fc = max(1, min(n_out, _PLAIN_STEP // n_fft))
    wc = max(1, _PLAIN_STEP // (fc * n_fft))
    for w0 in range(0, n, wc):
        for f0 in range(0, n_out, fc):
            fr = view[w0:w0 + wc, f0:f0 + fc].to(torch.bfloat16).to(torch.float32)
            re, im = fr @ wr_t, fr @ wi_t
            p = re * re + im * im
            if power == 1.0:
                p = torch.sqrt(p)
            elif power != 2.0:
                p = torch.pow(p, power / 2.0)
            p = p.to(torch.bfloat16).to(torch.float32)
            out[w0:w0 + wc, :, f0:f0 + fc] = (p @ mel_t).transpose(1, 2)
    return out


def stft_mel_bf16(windows, *, sr, n_fft, hop_length, n_mels, fmin, fmax,
                  break_freq=1750.0, power=2.0, htk=True, frames=None):
    """[N, S] float32 PCM windows -> [N, n_mels, frames] mel spectrograms
    through the bf16 tensor cores (the fast frontend level's contract: bf16
    operands, float32 accumulation, ~1% relative). Same framing and
    arguments as ``stft_mel``."""
    if windows.device.type == "cpu":
        return stft_mel_bf16_plain(
            windows, sr=sr, n_fft=n_fft, hop_length=hop_length, n_mels=n_mels,
            fmin=fmin, fmax=fmax, break_freq=break_freq, power=power, htk=htk,
            frames=frames,
        )
    cuda.require_cuda(windows, "stft_mel_bf16")
    if windows.dim() != 2:
        raise ValueError(f"stft_mel_bf16: expected [N, S] windows, got {tuple(windows.shape)}")
    if not power > 0:
        raise ValueError(f"stft_mel_bf16: power must be positive, got {power}")
    n, s = windows.shape
    n_out = _frame_count(s, hop_length, frames)
    wr, wi, melt, _ = _bf16_consts(sr, n_mels, fmin, fmax, n_fft, break_freq, htk,
                                   windows.device)
    out = torch.empty((n, n_mels, n_out), dtype=torch.float32, device=windows.device)
    rc = cuda.library().aat_stft_mel_bf16(
        windows.data_ptr(), wr.data_ptr(), wi.data_ptr(), melt.data_ptr(), out.data_ptr(),
        n, s, int(n_fft), wr.shape[1], int(hop_length), n_out, wr.shape[0], melt.shape[0],
        int(n_mels), float(power), cuda.stream_of(windows),
    )
    cuda.check(rc, "stft_mel_bf16")
    stft_mel_bf16.launches += 1
    return out


stft_mel_bf16.launches = 0
