"""Plain signal processing of the reference: librosa-style framing, the
|STFT|, mel spectra, dB, the masked medians, OpenCV-style morphology and
connected components, and detection (reference src/identify_tracks.py:
387-413, 650-706, as the port's detect/signal_noise.py documents them).

``Precision`` names the number formats: the default is what the
configurations state (float64 DFTs, float32 classifiers with TF32 off);
the controls lower one step (float32 DFTs; TF32 or fp8 classifiers and
frontend).
"""

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from benchref.mel import fft_frequencies, filterbank_np, mel_support_bins
from benchref.signal import SIGNAL_WIDTH, Signal

HOP = 281  # detection |STFT| (reference src/identify_tracks.py:654)
N_FFT = 4096
ENDSCAN_MELS = 120
FP8_MAX = 448.0  # largest float8_e4m3fn


@dataclass(frozen=True)
class Precision:
    """detect_dft, frontend_dft: the type of detection's and of the classify
    frontend's DFTs (torch.float64 or torch.float32); cnn: "float32" (TF32
    off), "tf32" or "fp8" (operands rounded to float8_e4m3fn with a
    per-tensor scale, float32 accumulation); fp8_frontend: the frontend's
    framed windows and power spectra rounded to fp8 too."""

    detect_dft: torch.dtype = torch.float64
    frontend_dft: torch.dtype = torch.float64
    cnn: str = "float32"
    fp8_frontend: bool = False


EXACT = Precision()


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8_e4m3fn over a per-tensor scale, back in x's type."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return ((x / scale).to(torch.float8_e4m3fn).to(x.dtype)) * scale


def hann(n: int, device) -> torch.Tensor:
    """Periodic Hann window, built in float64 on the host, as float32."""
    k = np.arange(n, dtype=np.float64)
    return torch.from_numpy((0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)).astype(np.float32)).to(device)


def stft_power(y: torch.Tensor, n_fft: int, hop: int, power: float, dft=torch.float64,
               fp8=False):
    """[..., T] float32 -> |STFT|**power [..., 1 + n_fft//2, frames] as float32:
    zero padding of n_fft//2 both sides, the float32-windowed frames (with
    ``fp8``, rounded to fp8), the DFT in ``dft``."""
    y = F.pad(y, (n_fft // 2, n_fft // 2))
    frames = y.unfold(-1, n_fft, hop) * hann(n_fft, y.device)
    if fp8:
        frames = fp8_round(frames)
    mag = torch.fft.rfft(frames.to(dft), dim=-1).abs()
    out = mag if power == 1.0 else (mag * mag if power == 2.0 else mag ** power)
    return out.to(torch.float32).transpose(-1, -2)


def n_frames(n_samples: int, n_fft: int, hop: int) -> int:
    return 1 + (n_samples - n_fft % 2) // hop


def mel_spec(y, *, sr, n_fft, hop, n_mels, fmin, fmax, break_freq, power, htk,
             frames=None, dft=torch.float64, fp8=False):
    """[N, S] -> [N, n_mels, frames] float32: the power spectrum over the
    bins the filterbank uses, the filterbank product in the DFT's type."""
    bu = mel_support_bins(sr, n_mels, fmin, fmax, n_fft, break_freq, htk)
    p = stft_power(y, n_fft, hop, power, dft, fp8)[..., :bu, :]
    if frames is not None:
        p = p[..., :frames]
    if fp8:
        p = fp8_round(p)
    fb = torch.from_numpy(filterbank_np(sr, n_mels, fmin, fmax, n_fft, break_freq, htk)[:, :bu])
    acc = dft
    return torch.matmul(fb.to(y.device, acc), p.to(acc)).to(torch.float32)


def power_to_db(s, amin=1e-10, top_db=80.0):
    """librosa power_to_db(ref=max) per window over the last two axes."""
    ref = s.amax(dim=(-2, -1), keepdim=True)
    log = 10.0 * torch.log10(torch.clamp(s, min=amin)) - 10.0 * torch.log10(
        torch.clamp(ref, min=amin))
    return torch.maximum(log, log.amax(dim=(-2, -1), keepdim=True) - top_db)


def normalize_minmax(x):
    """The reference's normalize_data (src/identify_tracks.py:202-209)."""
    x = x - x.amin(dim=-1, keepdim=True)
    x = x / x.amax(dim=-1, keepdim=True) + 0.000001
    return (x - 0.5) * 2.0


def features(windows, meta, prec: Precision = EXACT):
    """get_spect over [N, S] float32 windows -> [N, n_mels, frames, 1]
    (htk bank keyed as the reference keys it; dB per window when
    ``db_scale``)."""
    if meta.get("normalize", True):
        windows = normalize_minmax(windows)
    fmin = meta.get("fmin", 50)
    htk = meta.get("htk", False)
    mel = mel_spec(
        windows, sr=48000, n_fft=int(meta.get("n_fft", 4096)), hop=int(meta.get("hop_length", 640)),
        n_mels=int(meta.get("n_mels", 160)),
        fmin=(50.0 if fmin is None else float(fmin)) if htk else 50.0,
        fmax=(11000.0 if fmin is None else float(meta.get("fmax", 11000))) if htk else 11000.0,
        break_freq=float(meta.get("break_freq", 1750)), power=float(meta.get("power", 2)) if htk
        else 2.0, htk=bool(htk), dft=prec.frontend_dft, fp8=prec.fp8_frontend,
    )
    if meta.get("db_scale", True):
        mel = power_to_db(mel)
    return mel[..., None]


# -- detection -----------------------------------------------------------------


def median_rows(spec, nvf):
    """np.median of each row over its first nvf columns: [bins, T] -> [bins, 1]."""
    s = torch.sort(spec[:, :nvf], dim=-1).values
    return (s[:, (nvf - 1) // 2] + s[:, nvf // 2])[:, None] * 0.5


def median_cols(spec):
    """np.median of each column: [bins, T] -> [1, T]."""
    s = torch.sort(spec, dim=0).values
    n = spec.shape[0]
    return (s[(n - 1) // 2] + s[n // 2])[None, :] * 0.5


def _max1d(x, k, dim, fill):
    if k <= 1:
        return x
    lead, trail = k // 2, k - 1 - k // 2
    x4 = x[None, None]
    if dim == -1:
        return F.max_pool2d(F.pad(x4, (lead, trail), value=fill), (1, k), stride=1)[0, 0]
    return F.max_pool2d(F.pad(x4, (0, 0, lead, trail), value=fill), (k, 1), stride=1)[0, 0]


def dilate(x, kh, kw):
    """cv2.dilate with an all-ones (kh, kw) kernel, anchor (kh//2, kw//2)."""
    return _max1d(_max1d(x, kh, -2, 0.0), kw, -1, 0.0)


def erode(x, kh, kw):
    return 1.0 - dilate(1.0 - x, kh, kw)


def mask_height_width(sr, hop, n_fft):
    width = int(SIGNAL_WIDTH * sr / hop)
    height = 0
    for i, f in enumerate(fft_frequencies(sr, n_fft)):
        if f > 100:
            height = i + 1
            break
    return height, width


def components(mask: np.ndarray) -> np.ndarray:
    """cv2.connectedComponentsWithStats (8-connectivity), background left
    out: [n, 5] (left, top, width, height, area), labels in raster order."""
    labels, n = ndimage.label(mask, structure=np.ones((3, 3), bool))
    if n == 0:
        return np.zeros((0, 5), np.int64)
    boxes = ndimage.find_objects(labels)
    area = np.bincount(labels.ravel(), minlength=n + 1)[1:]
    return np.asarray([[b[1].start, b[0].start, b[1].stop - b[1].start, b[0].stop - b[0].start,
                        a] for b, a in zip(boxes, area)], np.int64)


def end_scan(y, n_valid, sr, dft=torch.float64):
    """(found, flat_sec, mask_valid): the first ~1 s chunk of the 120-mel
    power-1 spectrogram (n_fft sr//10, hop 281) whose max equals its min
    (reference src/identify_tracks.py:387-413)."""
    chunk = sr // HOP
    n_chunks = (1 + y.shape[-1] // HOP) // chunk
    if n_chunks == 0:
        return False, 0, n_valid
    mel = mel_spec(y[None], sr=sr, n_fft=sr // 10, hop=HOP, n_mels=ENDSCAN_MELS, fmin=50.0,
                   fmax=11000.0, break_freq=1750.0, power=1.0, htk=True,
                   frames=n_chunks * chunk, dft=dft)[0]
    usable = mel.reshape(ENDSCAN_MELS, n_chunks, chunk)
    flat = (usable.amax(dim=(0, 2)) == usable.amin(dim=(0, 2))).cpu().numpy()
    nfv = 1 + n_valid // HOP
    for k in range(n_chunks):
        if flat[k] and (k + 1) * chunk < nfv:
            flat_sec = (k * chunk * HOP) // sr
            return True, flat_sec, sr * flat_sec
    return False, 0, n_valid


def detect(y: torch.Tensor, sr: int, prec: Precision = EXACT):
    """(length_seconds, signals) of one recording: float32 PCM [T] on the
    reference's device, every sample valid."""
    n_valid = y.shape[-1]
    found, flat_sec, mask_valid = end_scan(y, n_valid, sr, prec.detect_dft)
    y = torch.where(torch.arange(n_valid, device=y.device) < mask_valid, y, 0.0)
    spec = stft_power(y, N_FFT, HOP, 1.0, prec.detect_dft)
    nvf = 1 + mask_valid // HOP
    spec = spec / spec[:, :nvf].amax()
    row_m, col_m = median_rows(spec, nvf), median_cols(spec)
    cols = torch.arange(spec.shape[-1], device=spec.device) < nvf
    mask = ((spec > 3 * col_m) & (spec > 3 * row_m) & cols[None, :]).to(torch.float32)
    cv = cols[None, :].to(torch.float32)
    h, w = mask_height_width(sr, HOP, N_FFT)
    u = erode(torch.maximum(mask, 1.0 - cv), 4, 4)
    u = dilate(u * cv, 4, 4)
    u = dilate(u * cv, h, w)
    u = erode(torch.maximum(u, 1.0 - cv), h // 10, w)
    stats = components(((u * cv) > 0.5).cpu().numpy())
    length = int(flat_sec) if found else float(n_valid) / sr
    return length, signals_from_stats(stats, sr)


def signals_from_stats(stats, sr):
    stats = sorted(stats.tolist(), key=lambda s: s[0])
    height, width = mask_height_width(sr, HOP, N_FFT)
    freqs = fft_frequencies(sr, N_FFT)
    stats = [s for s in stats if s[2] > 0.65 * width and s[3] > height - height // 10]
    out = []
    for s in stats:
        max_freq = min(len(freqs) - 1, s[1] + s[3])
        out.append(Signal(s[0] * HOP / sr, (s[0] + s[2]) * HOP / sr, freqs[s[1]], freqs[max_freq]))
    return out


def fft_flops(n_fft: int) -> float:
    """Operations of one real FFT of n_fft points (2.5 n log2 n)."""
    return 2.5 * n_fft * math.log2(n_fft)
