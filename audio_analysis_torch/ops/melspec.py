"""Framed DFT -> |X|^power -> mel, and the full |STFT| of long signals.

``stft_mel`` replaces the Pallas kernel ``ops/pallas/melspec.py::_kernel_dif``
and ``stft_mag`` replaces ``_kernel_dif_mag`` (CUDA source:
``csrc/stft.cu``). Each wrapper launches a kernel for a CUDA tensor and
uses the plain PyTorch version beside it for a CPU tensor; it never falls
back to the plain version on the card. Each counts its launches in
``.launches`` and each route's in ``.fft_launches``, ``.fft1_launches``,
``.bluestein_launches`` and ``.cluster_launches``.

The TPU kernels' z layout, DIF factoring, split-bf16 passes and 320-frame
cap exist for the MXU and VMEM; here the kernel takes plain float32 windows
[N, S] and frames them by index with librosa's centre/constant padding.
``stft_plan`` picks the route from the shape alone, the first that fits in
the card's shared memory: ``fft``, a mixed-radix float64 FFT in two
buffers, when n_fft's prime factors are 2, 3, 5 and 7 (the radices and
twiddle table are built here, ``fft_radices`` and ``_twiddles_np``);
``fft1``, the same passes in place in one buffer (staged in the order
``fft_positions`` gives), also the only route of the radix-11, radix-13 and
generic prime passes (prime factors up to ``FFT_MAX_PRIME``);
``bluestein``, for an n_fft with a larger prime factor, the chirp product over a padded length
``bluestein_size`` in one buffer (``bluestein_np``); else ``cluster``, the
FFT of n_fft (or Bluestein's chirp product over a padded length) split over
a thread-block cluster of c blocks that exchange their points once a
transform through distributed shared memory (``cluster_plan``); ``ValueError``
when none fits.

Both the kernels and the plain versions window in float32 and take the DFT
in float64, rounding to float32 at the end. The detection thresholds
consume raw bin magnitudes down to 1e-3 of the maximum, where a float32
FFT is off by 2-8e-5 relative, as far as a 2-way split-bf16 product (the
error at which the mask flips bits); in float64 the kernel and its plain
version agree to float32 rounding.

``stft_mel_bf16`` is the fast frontend level's DFT -> mel (AAT_FAST=1 /
AAT_PALLAS=1), bf16 operands with float32 sums, about 1-2% relative (CUDA
source: ``csrc/stft_bf16.cu``). ``bf16_route`` picks its route as the JAX
package's ``_use_dif`` does, at each call: ``dif``, the factored DFT of
``_kernel_dif`` at exact=0 (an L-level decimation-in-frequency split in
float32, then bf16 leaf DFTs on the tensor cores), for n_fft % 8 == 0 and
n_fft >= 64; ``direct``, the DFT-as-GEMM of ``_kernel``, for any other
n_fft or when AAT_PALLAS_ALG=matmul. The JAX package's 320-frame cap is
its VMEM limit and has no counterpart here. Each route has its plain
version (``stft_mel_dif_bf16_plain``, ``stft_mel_bf16_plain``), and the
wrapper counts the direct route's launches in ``.direct_launches``.
"""

import math
import os
from functools import lru_cache

import numpy as np
import torch

from audio_analysis_torch.device import device_consts
from audio_analysis_torch.ops import cuda
from audio_analysis_torch.ops.mel import filterbank_np, mel_support_bins
from audio_analysis_torch.ops.stft import stft_magnitude
from audio_analysis_torch.ops.windows import get_window_np

TWO_BUFFER_RADICES = (8, 4, 2, 3, 5, 7)  # the fft route's passes
FFT_RADICES = TWO_BUFFER_RADICES + (11, 13)  # butterflies of their own, in the order a plan takes them
FFT_MAX_PRIME = 61  # odd primes above 13 up to this one take the generic pass
WIDE_PRIMES = tuple(p for p in range(17, FFT_MAX_PRIME + 1, 2)
                    if all(p % d for d in range(3, int(p ** 0.5) + 1, 2)))
BLUESTEIN_PRIMES = (2, 3, 5, 7)  # Bluestein's padded length is a product of these
TWIDDLE_LO = 64  # the low level of the kernel's two-level twiddle table
FFT_THREADS = 512  # threads a block of the FFT routes
INPLACE_HELD = 26  # outputs a thread holds in the in-place generic pass
FFT_TILES = (8, 4, 2)  # frames a block of the fft routes, largest that fits first
ONE_MAG_TILES = (8,)  # the one-buffer stft_mag has no tile: 8 frames a block
CLUSTER_SIZES = (2, 3, 4, 5, 7, 8)  # blocks a cluster: radices of the exchange pass, at most 8
SMEM_OPTIN_H100 = 232448  # bytes of shared memory a block may opt in to on an H100


@lru_cache(maxsize=8)
def _twiddles_np(n_fft: int):
    """cos/sin(2 pi j / n_fft) for j < n_fft, float64."""
    ang = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    return np.cos(ang), np.sin(ang)


def fft_radices(n_fft: int):
    """The FFT routes' passes: radices from ``FFT_RADICES`` (8s first, then
    4, 2, 3, 5, 7, 11, 13), then the primes of ``WIDE_PRIMES``, whose
    product is n_fft; None when n_fft has a prime factor above
    ``FFT_MAX_PRIME``."""
    out, n = [], int(n_fft)
    for r in FFT_RADICES + WIDE_PRIMES:
        while n > 1 and n % r == 0:
            out.append(r)
            n //= r
    return tuple(out) if n == 1 else None


def fft_positions(radices):
    """Where the in-place passes of ``radices`` want sample s staged so that
    the spectrum comes out in natural order (the mixed-radix digit
    reversal): the last pass combines the subsequences s mod R_last, each
    laid out the same way one level down."""
    n = math.prod(radices)
    s = np.arange(n)
    pos = np.zeros(n, np.int64)
    span = n
    for r in reversed(radices):
        span //= r
        pos += (s % r) * span
        s //= r
    return pos


def _smooth(m: int) -> bool:
    """m is a product of ``BLUESTEIN_PRIMES``."""
    for p in BLUESTEIN_PRIMES:
        while m % p == 0:
            m //= p
    return m == 1


def bluestein_size(n_fft: int) -> int:
    """Bluestein's padded length: the smallest product of
    ``BLUESTEIN_PRIMES`` at least 2 n_fft - 1 (no wrap of the chirp
    product)."""
    m = 2 * int(n_fft) - 1
    while not _smooth(m):
        m += 1
    return m


def _bluestein_filter(n: int, m: int):
    """The chirp cos/sin(pi k^2 / n), k < n, with k^2 taken mod 2n (exact
    integers), and the FFT of the conjugate chirp laid out circularly over
    m >= 2n - 1 points, divided by m, in natural order."""
    k = np.arange(n, dtype=np.int64)
    ang = np.pi * ((k * k) % (2 * n)) / n
    chc, chs = np.cos(ang), np.sin(ang)
    conj_chirp = chc + 1j * chs
    b = np.zeros(m, np.complex128)
    b[:n] = conj_chirp
    b[m - n + 1:] = conj_chirp[1:][::-1]
    return chc, chs, np.fft.fft(b) / m


@lru_cache(maxsize=8)
def bluestein_np(n_fft: int):
    """(chc, chs [n_fft], bc, bs [M]) float64: the chirp and the FFT of the
    conjugate chirp over M = ``bluestein_size(n_fft)`` (``_bluestein_filter``),
    stored at ``fft_positions`` (the order the forward pass by decimation in
    frequency leaves its spectrum in)."""
    m = bluestein_size(n_fft)
    chc, chs, spec_nat = _bluestein_filter(int(n_fft), m)
    spec = np.empty(m, np.complex128)
    spec[fft_positions(fft_radices(m))] = spec_nat
    return chc, chs, spec.real.copy(), spec.imag.copy()


@lru_cache(maxsize=8)
def bluestein_cluster_np(n_fft: int, points: int, c: int):
    """(chc, chs [n_fft], bc, bs [points]) float64 for Bluestein over a
    cluster of c blocks of m = points / c: the forward transform (the
    exchange pass, then each block's passes by decimation in frequency)
    leaves bin c k1 + r in block r at ``fft_positions`` of the m-point plan
    at k1, so the filter's bin c k1 + r is stored at r m +
    fft_positions(m)[k1]."""
    m = points // c
    chc, chs, spec_nat = _bluestein_filter(int(n_fft), int(points))
    pos = fft_positions(fft_radices(m))
    spec = np.empty(points, np.complex128)
    for r in range(c):
        spec[r * m + pos] = spec_nat[r::c]
    return chc, chs, spec.real.copy(), spec.imag.copy()


def twiddle_rows(n_fft: int) -> int:
    """Entries of each half (cos, sin) of the fft route's two-level twiddle
    table: e^{-2 pi i 64 h / n} for h < ceil(n / 64), then e^{-2 pi i l / n}
    for l < 64."""
    return -(-n_fft // TWIDDLE_LO) + TWIDDLE_LO


def fft_points(route: str, n_fft: int) -> int:
    """The points of a route's FFT: Bluestein's padded length, else n_fft."""
    return bluestein_size(n_fft) if route == "bluestein" else int(n_fft)


def stft_smem(route: str, n_fft: int, bins: int, tf: int, mel: bool) -> int:
    """Shared memory of one block, in bytes, as ``csrc/stft.cu`` sizes it:
    the fft route holds two complex float64 buffers of n_fft points (one
    spare double after every 8), the twiddle table and a float32 tile of
    bins x tf frames (rows of tf + 1 for ``stft_mag``); fft1 and bluestein
    one buffer and the table of n_fft or M points and, for the mel kernel
    only, a tile of tf x bins. The cluster route: ``cluster_smem``."""
    if route == "fft":
        padded = n_fft + n_fft // 8
        return 8 * (4 * padded + 2 * twiddle_rows(n_fft)) + 4 * (tf if mel else tf + 1) * bins
    if route in ("fft1", "bluestein"):
        m = fft_points(route, n_fft)
        return 8 * (2 * (m + m // 8) + 2 * twiddle_rows(m)) + (4 * tf * bins if mel else 0)
    raise ValueError(f"no block size for route {route!r}")


def cluster_smem(points: int, c: int, bins: int, tf: int, mel: bool) -> int:
    """Shared memory of one block of the cluster route, in bytes, as
    ``csrc/stft.cu`` sizes it: one complex float64 buffer of m = points / c
    points (one spare double after every 8) and the twiddle table of m, 16
    bytes for the block's frame flags and, for the mel kernel, a float32
    tile of tf frames x ceil(bins / c) bins (the bins k = r + c i the block
    computes)."""
    m = points // c
    return (8 * (2 * (m + m // 8) + 2 * twiddle_rows(m)) + 16
            + (4 * tf * -(-bins // c) if mel else 0))


def _cluster_lengths(n_fft: int):
    """The transform lengths a cluster may split, in order: n_fft itself
    when ``fft_radices`` takes it, then Bluestein's padded lengths, every
    product of ``BLUESTEIN_PRIMES`` from ``bluestein_size`` up to what the
    largest cluster of the largest one-buffer blocks holds."""
    if fft_radices(n_fft) is not None:
        yield n_fft
    most = CLUSTER_SIZES[-1] * INPLACE_HELD * FFT_THREADS
    for m in range(bluestein_size(n_fft), most + 1):
        if _smooth(m):
            yield m


@lru_cache(maxsize=256)
def cluster_plan(n_fft: int, bins: int, *, mel: bool, cap: int = SMEM_OPTIN_H100):
    """(c, points, frames a cluster) of the cluster route, or None: the
    first transform length of ``_cluster_lengths`` (n_fft, else a
    Bluestein length: points != n_fft) and the smallest c of
    ``CLUSTER_SIZES`` dividing it whose block of points / c (at most
    ``INPLACE_HELD * FFT_THREADS``) fits `cap` bytes, with the most frames
    of ``FFT_TILES`` (``stft_mel``) or 8 (``stft_mag``)."""
    tiles = FFT_TILES if mel else ONE_MAG_TILES
    for points in _cluster_lengths(int(n_fft)):
        for c in CLUSTER_SIZES:
            if points % c or points // c > INPLACE_HELD * FFT_THREADS:
                continue
            for tf in tiles:
                if cluster_smem(points, c, bins, tf, mel) <= cap:
                    return c, points, tf
    return None


def stft_plan(n_fft: int, bins: int, *, mel: bool, cap: int = SMEM_OPTIN_H100):
    """(route, frames a block, or a cluster) for a DFT of n_fft points whose
    first ``bins`` bins are kept (the mel support, or all 1 + n_fft//2 for
    ``stft_mag``), the first route whose block fits in ``cap`` bytes of
    shared memory: ``"fft"`` and then ``"fft1"`` when n_fft's radices are
    all in ``TWO_BUFFER_RADICES``, ``"fft1"`` when ``fft_radices`` takes
    n_fft with another, else ``"bluestein"``; then ``"cluster"``
    (``cluster_plan``); ValueError when none fits."""
    one_tiles = FFT_TILES if mel else ONE_MAG_TILES
    radices = fft_radices(n_fft)
    if radices is None:
        routes = (("bluestein", one_tiles),)
    elif set(radices) <= set(TWO_BUFFER_RADICES):
        routes = (("fft", FFT_TILES), ("fft1", one_tiles))
    else:
        routes = (("fft1", one_tiles),)
    for route, tiles in routes:
        if fft_points(route, n_fft) > INPLACE_HELD * FFT_THREADS:
            continue
        for tf in tiles:
            if stft_smem(route, n_fft, bins, tf, mel) <= cap:
                return route, tf
    plan = cluster_plan(int(n_fft), int(bins), mel=mel, cap=int(cap))
    if plan is not None:
        return "cluster", plan[2]
    raise ValueError(f"n_fft {n_fft}: no DFT route fits in {cap} bytes of shared memory")


def cluster_twiddles_np(n_fft: int, c: int, points: int):
    """(xc, xs [(c - 1) m]) float64: the cluster route's exchange twiddles
    by buffer address q, cos/sin(2 pi k p(q) / points) at (k - 1) m + q for
    k = 1 .. c - 1, entries of ``_twiddles_np(points)``; p(q), the point a
    block holds at address q, is the inverse of ``fft_positions`` where the
    block stages there (points = n_fft), else q (Bluestein)."""
    m = points // c
    point = np.arange(m)
    if points == n_fft:
        point = np.empty(m, np.int64)
        point[fft_positions(fft_radices(m))] = np.arange(m)
    cs, sn = _twiddles_np(points)
    idx = (np.arange(1, c)[:, None] * point[None, :]).ravel()
    return cs[idx], sn[idx]


def _dft_consts(n_fft, route, device, split=None):
    """The Hann window, the twiddle table and the radices of the route's
    FFT, then fft1's staging positions, or Bluestein's chirp and filter
    (``bluestein_np``). The cluster route, `split` = (c, points): the table
    of points and the radices of the m = points / c points of a block, the
    staging positions (points = n_fft, else none), the table of m, the
    exchange's twiddles (``cluster_twiddles_np``), then, for Bluestein over
    the cluster, its chirp and filter (``bluestein_cluster_np``)."""
    def build():
        win = get_window_np("hann", n_fft, periodic=True)
        if route == "cluster":
            c, points = split
            cs, sn = _twiddles_np(points)
            radices = fft_radices(points // c)
            head = (win, cs, sn, np.asarray(radices, np.int32))
            perm = fft_positions(radices) if points == n_fft else np.zeros(0)
            tables = (perm.astype(np.int32), *_twiddles_np(points // c),
                      *cluster_twiddles_np(n_fft, c, points))
            if points == n_fft:
                return head + tables
            return head + tables + bluestein_cluster_np(n_fft, points, c)
        m = fft_points(route, n_fft)
        cs, sn = _twiddles_np(m)
        radices = fft_radices(m)
        head = (win, cs, sn, np.asarray(radices, np.int32))
        if route == "fft1":
            return head + (fft_positions(radices).astype(np.int32),)
        if route == "bluestein":
            return head + bluestein_np(n_fft)
        return head

    return device_consts(("dft", n_fft, route, split), build, device)


def _launch_dft(fn, kind, route, lib, head, consts, tail, split=None):
    """Launches ``aat_stft_<kind>_<route>`` with the pointers in `head`,
    the route's constants (and the cluster's (c, points) `split`) and
    `tail`, and counts the launch on `fn` (``.launches`` and
    ``.<route>_launches``)."""
    _, cs, _, radix, *extra = consts
    mid = (radix.data_ptr(), radix.numel())
    if route == "fft1":
        mid += (extra[0].data_ptr(),)
    elif route == "bluestein":
        mid += (cs.numel(), *(t.data_ptr() for t in extra))
    elif route == "cluster":  # perm, the block's and the exchange's tables, c, m, Bluestein's
        perm, *tables = extra[:5]
        blue = [t.data_ptr() for t in extra[5:]] or [None] * 4
        c = split[0]
        mid += (perm.data_ptr() if perm.numel() else None, *(t.data_ptr() for t in tables), c,
                cs.numel() // c, *blue)
    rc = getattr(lib, f"aat_stft_{kind}_{route}")(*head, *mid, *tail)
    cuda.check(rc, fn.__name__)
    fn.launches += 1
    setattr(fn, f"{route}_launches", getattr(fn, f"{route}_launches") + 1)


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

    return device_consts(("mel", sr, n_mels, fmin, fmax, n_fft, break_freq, htk), build, device)


def stft_frames(n_samples, n_fft, hop_length):
    """Frames of the float64 |STFT| of n_samples: the signal padded with
    n_fft//2 zeros on both sides (librosa's centre framing), so odd n_fft
    has one frame fewer when hop divides n_samples."""
    return 1 + (n_samples - n_fft % 2) // hop_length


def _frame_count(total, frames):
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
    n_out = _frame_count(stft_frames(windows.shape[-1], n_fft, hop_length), frames)
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
    n_fft = int(n_fft)
    n_out = _frame_count(stft_frames(s, n_fft, hop_length), frames)
    dev = windows.device
    fb, lo, hi = _mel_consts(int(sr), int(n_mels), float(fmin), float(fmax), n_fft,
                             float(break_freq), bool(htk), dev)
    lib = cuda.library()
    cap = cuda.smem_optin(dev)
    route, tf = stft_plan(n_fft, fb.shape[1], mel=True, cap=cap)
    split = cluster_plan(n_fft, fb.shape[1], mel=True, cap=cap)[:2] if route == "cluster" else None
    consts = _dft_consts(n_fft, route, dev, split)
    win, cs, sn = consts[:3]
    out = torch.empty((n, n_mels, n_out), dtype=torch.float32, device=dev)
    ptrs = (windows.data_ptr(), win.data_ptr(), cs.data_ptr(), sn.data_ptr())
    mel_args = (fb.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(), n, s, n_fft,
                int(hop_length), n_out, fb.shape[1], int(n_mels), float(power), tf,
                cuda.stream_of(windows))
    _launch_dft(stft_mel, "mel", route, lib, ptrs, consts, mel_args, split)
    return out


stft_mel.launches = 0
stft_mel.fft_launches = stft_mel.fft1_launches = 0
stft_mel.bluestein_launches = stft_mel.cluster_launches = 0


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
    n_fft = int(n_fft)
    n_frames = stft_frames(t, n_fft, hop_length)
    lib = cuda.library()
    cap = cuda.smem_optin(y.device)
    route, tf = stft_plan(n_fft, n_fft // 2 + 1, mel=False, cap=cap)
    split = (cluster_plan(n_fft, n_fft // 2 + 1, mel=False, cap=cap)[:2] if route == "cluster"
             else None)
    consts = _dft_consts(n_fft, route, y.device, split)
    win, cs, sn = consts[:3]
    out = torch.empty((b, n_fft // 2 + 1, n_frames), dtype=torch.float32, device=y.device)
    ptrs = (y.data_ptr(), win.data_ptr(), cs.data_ptr(), sn.data_ptr())
    mag_args = (out.data_ptr(), b, t, n_fft, int(hop_length), n_frames, float(power), tf,
                cuda.stream_of(y))
    _launch_dft(stft_mag, "mag", route, lib, ptrs, consts, mag_args, split)
    return out


stft_mag.launches = 0
stft_mag.fft_launches = stft_mag.fft1_launches = 0
stft_mag.bluestein_launches = stft_mag.cluster_launches = 0


# ---------------------------------------------------------------------------
# The bf16 tensor-core DFT -> mel (the fast frontend level)
# ---------------------------------------------------------------------------

BF16_K_STEP = 64  # the kernel's K chunk: n_fft is zero-padded to a multiple
BF16_BIN_TILE = 64  # the kernel's bin tile: the support is zero-padded to a multiple
BF16_MEL_ROWS = (64, 128, 160, 256)  # mel capacities the kernel is built for
_PLAIN_STEP = 1 << 24  # framed samples per step of the plain version
DIRECT_FRAMES = 128  # frames (rows) a work item of the direct kernel, 64 a consumer warpgroup
DIRECT_STAGES = 4  # the direct kernel's ring of K chunks


def direct_classes(hop: int) -> int:
    """P = 8 / gcd(hop, 8), the direct kernel's frame classes t % P: copy c
    of a window, shifted by c * gcd(hop, 8) samples, holds frame t (element
    t * hop of the padded window) 16-byte aligned for c = (t * hop % 8) /
    gcd(hop, 8), and the frames of one class lie P * hop samples apart, a
    multiple of 16 bytes: a tensor map's stride, so one TMA box fetches
    them."""
    return 8 // math.gcd(int(hop), 8)


def direct_tiles(n_out: int, n_fft: int, hop: int) -> tuple:
    """(n_tiles, lrow) of the direct kernel, whose work item takes 128
    frames of one of the P classes: n_tiles = ceil(ceil(n_out / P) / 128)
    tiles a class, and lrow, the row of a window's copy, holds every frame
    of every tile (a multiple of 8). The pre-pass's scratch is [n_windows,
    P, lrow] bf16: P bf16 copies of each window."""
    p = direct_classes(hop)
    tiles = -(-(-(-int(n_out) // p)) // DIRECT_FRAMES)
    return tiles, -(-((p * tiles * DIRECT_FRAMES - 1) * int(hop) + int(n_fft)) // 8) * 8


def direct_smem(mel_rows: int) -> int:
    """Shared memory of one direct block, in bytes, as ``csrc/stft_bf16.cu``
    sizes it: 1024 bytes to align the tiles, the ring (a stage holds the
    frames [128 x 64] and Wr, Wi [64 + 64 x 64], bf16), two mel tiles
    [mel_rows x 64] bf16 and the stages' and mel tiles' full and empty
    barriers."""
    stage = DIRECT_FRAMES * BF16_K_STEP * 2 + 2 * BF16_BIN_TILE * BF16_K_STEP * 2
    return (1024 + DIRECT_STAGES * stage + 2 * int(mel_rows) * BF16_BIN_TILE * 2
            + 8 * (2 * DIRECT_STAGES + 4))


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
    wr, wi, melt = device_consts(key, build, device, dtype=torch.bfloat16)
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
    n_out = _frame_count(1 + s // hop_length, frames)
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


# ---------------------------------------------------------------------------
# The dif route: _kernel_dif's factored DFT at exact=0
# ---------------------------------------------------------------------------

DIF_MAX_LEVELS = 8  # the kernel is built for 3 to 8 levels (n_fft up to 32768 needs 8)
DIF_FRAMES = 16  # frames a work item: N = 8 leaves x 16 frames = 128 columns
DIF_K_CHUNK = 64  # leaf positions a K chunk: a 128-byte row of bf16
DIF_GROUP = 8  # leaves a group
DIF_BIN_TILE = 128  # most bins of a leaf a pass: 64 a consumer warpgroup
DIF_MEL_MAX = 256  # most mel rows
# (ring stages, span buffers, band list), the first that fits; the last,
# without the band list, takes the deepest splits at n_fft 32768
DIF_PLANS = ((3, 2, 1), (2, 2, 1), (2, 1, 1), (1, 1, 1), (1, 1, 0))


def bf16_route(n_fft: int) -> str:
    """``dif`` or ``direct``: the JAX package's ``_use_dif``, read at each
    call (AAT_PALLAS_ALG=matmul forces the direct route)."""
    if os.environ.get("AAT_PALLAS_ALG", "").strip().lower() == "matmul":
        return "direct"
    return "dif" if n_fft % 8 == 0 and n_fft >= 64 else "direct"


def dif_levels(n_fft: int, bins_used: int) -> int:
    """The split's depth, as the JAX package's ``_dif_levels``: 3 levels,
    deepened while a leaf would carry more than 128 bins, n_fft divides
    and leaves keep at least 128 points."""
    levels = 3
    while (-(-bins_used // (1 << levels)) > 128 and n_fft % (1 << (levels + 1)) == 0
           and (n_fft >> (levels + 1)) >= 128):
        levels += 1
    return levels


def leaf_off(levels: int) -> tuple:
    """Leaf b holds bins 2^levels j + leaf_off(levels)[b]: the bit reversal
    of b (the JAX package's ``_leaf_off``)."""
    return tuple(int(format(b, f"0{levels}b")[::-1], 2) for b in range(1 << levels))


def dif_leaf_width(bins_per_leaf: int) -> int:
    """Columns of a leaf's DFT matrix: a multiple of the k16 step up to 128
    bins, else of the kernel's 128-bin tile (zero columns change nothing)."""
    tile = 16 if bins_per_leaf <= DIF_BIN_TILE else DIF_BIN_TILE
    return -(-bins_per_leaf // tile) * tile


def dif_pass_width(bl: int) -> int:
    """Bins of a leaf a pass of the dif kernel (the p tile's and the mel
    product's width); a leaf of more bins takes bl / 128 passes."""
    return min(bl, DIF_BIN_TILE)


def dif_span_alloc(hop: int, n_fft: int) -> int:
    """bf16 elements of a span buffer: (16 - 1) hop + n_fft samples and 3
    of alignment, rounded up to 8."""
    return -(-((DIF_FRAMES - 1) * hop + n_fft + 3) // 8) * 8


def dif_band_cap(levels: int, bl: int, mel_rows: int) -> int:
    """Mel weights the dif block's band list holds: every bin of the leaves
    in two triangular filters at most, and one more a row; a multiple of
    8. Bands beyond it are read from the mel matrix instead."""
    return -(-((2 << levels) * bl + mel_rows) // 8) * 8


def dif_smem(hop: int, n_fft: int, levels: int, bl: int, mel_rows: int, stages: int = 2,
             spans: int = 2, listed: int = 1) -> int:
    """Shared memory of one dif block, in bytes, as ``csrc/stft_bf16.cu``
    sizes it: 1024 of alignment, `stages` ring stages (the pass's C and S
    chunks [width x 64] and the group's real and imaginary leaves [128 x
    64], bf16), the p tile [8 leaves x width x 16 frames] bf16, `spans`
    span buffers, the mel bands and list offsets [2 x 260] int32, where
    `listed` the band list's weights (bf16; else the mel passes read the
    mel matrix) and 10 barriers."""
    width = dif_pass_width(bl)
    stage = 2 * width * DIF_K_CHUNK * 2 + 2 * DIF_GROUP * DIF_FRAMES * DIF_K_CHUNK * 2
    return (1024 + stages * stage + DIF_GROUP * width * DIF_FRAMES * 2
            + spans * dif_span_alloc(hop, n_fft) * 2 + (2 * DIF_MEL_MAX + 8) * 4
            + (dif_band_cap(levels, bl, mel_rows) * 2 if listed else 0) + 10 * 8)


def dif_plan(hop: int, n_fft: int, levels: int, bl: int, mel_rows: int, cap: int):
    """(ring stages, span buffers, band list): the first of ``DIF_PLANS``
    whose block fits `cap` bytes of shared memory, as the kernel's launcher
    picks it; None where none fits."""
    return next((p for p in DIF_PLANS
                 if dif_smem(hop, n_fft, levels, bl, mel_rows, *p) <= cap), None)


def _dif_consts(sr, n_mels, fmin, fmax, n_fft, break_freq, htk, device):
    """The dif route's constants and geometry: (win [n_fft] float32, twc,
    tws [n_fft - (n_fft >> L)] float32, ct, st [bl, m_pad] bf16, melt
    [mel_rows, 2^L bl] bf16, levels, nb, bl). The window and the twiddles
    are built in float64 and rounded to float32: level l's table
    cos/sin(2 pi p / (n_fft >> l)), p < n_fft >> (l + 1), starts at
    n_fft - (n_fft >> l) (``dif_twiddle_offset``), as the JAX package's
    per-level tables; the leaf DFT matrices cos/sin(2 pi n j
    / m_leaf), transposed, are rounded to float32 and then to bf16, zero
    past m_leaf and past nb bins a leaf; the leaf-permuted mel matrix
    (``_mel_mat_dif``) row b bl + j carries bin 2^L j + leaf_off[b],
    transposed, zero rows past n_mels."""
    sr, n_mels, n_fft, htk = int(sr), int(n_mels), int(n_fft), bool(htk)
    fmin, fmax, break_freq = float(fmin), float(fmax), float(break_freq)
    bu = mel_support_bins(sr, n_mels, fmin, fmax, n_fft, break_freq, htk)
    levels = dif_levels(n_fft, bu)
    rows = next((r for r in BF16_MEL_ROWS if r >= n_mels), None)
    if rows is None:
        raise ValueError(f"stft_mel_bf16: {n_mels} mels, the kernel takes at most "
                         f"{BF16_MEL_ROWS[-1]}")
    if levels > DIF_MAX_LEVELS:
        raise ValueError(f"stft_mel_bf16: n_fft {n_fft} needs {levels} levels, the dif "
                         f"kernel takes at most {DIF_MAX_LEVELS}")
    n_leaves = 1 << levels
    m_leaf = n_fft // n_leaves
    nb = -(-bu // n_leaves)
    bl = dif_leaf_width(nb)
    m_pad = -(-m_leaf // 16) * 16

    def build_f32():
        ang = np.concatenate([2 * np.pi * np.arange(n_fft >> (lvl + 1)) / (n_fft >> lvl)
                              for lvl in range(levels)])
        return (get_window_np("hann", n_fft, periodic=True).astype(np.float32),
                np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))

    def build_bf16():
        leaf = 2.0 * np.pi * np.outer(np.arange(nb), np.arange(m_leaf)) / m_leaf
        ct = np.zeros((bl, m_pad), np.float32)
        st = np.zeros((bl, m_pad), np.float32)
        ct[:nb, :m_leaf] = np.cos(leaf)
        st[:nb, :m_leaf] = np.sin(leaf)
        fb = filterbank_np(sr, n_mels, fmin, fmax, n_fft, break_freq, htk).astype(np.float32)
        melt = np.zeros((rows, n_leaves * bl), np.float32)
        for b, off in enumerate(leaf_off(levels)):
            k = off + n_leaves * np.arange(bl)
            valid = k < fb.shape[1]
            melt[:n_mels, b * bl : b * bl + int(valid.sum())] = fb[:, k[valid]]
        return ct, st, melt

    key = ("dif", sr, n_mels, fmin, fmax, n_fft, break_freq, htk)
    win, twc, tws = device_consts(key + ("f32",), build_f32, device)
    ct, st, melt = device_consts(key + ("bf16",), build_bf16, device, dtype=torch.bfloat16)
    return win, twc, tws, ct, st, melt, levels, nb, bl


def dif_twiddle_offset(n_fft: int, level: int) -> int:
    """Where level `level`'s twiddle table starts in the dif route's
    twiddles: after the tables of n_fft/2, n_fft/4, ... entries."""
    return n_fft - (n_fft >> level)


def dif_tree(x, twc, tws, levels):
    """The JAX package's ``_dif_tree`` on [..., n_fft] float32 frames: the
    2^levels leaves [(real, imag or None), ...] in tree-emit order (the sum
    branch first at every level)."""
    branches = [(x, None)]
    n_fft = x.shape[-1]
    q = n_fft // 2
    for lvl in range(levels):
        off = dif_twiddle_offset(n_fft, lvl)
        c, s = twc[off:off + q], tws[off:off + q]
        nxt = []
        for r, i in branches:
            a, b = r[..., :q], r[..., q:]
            if i is None:
                nxt += [(a + b, None), ((a - b) * c, (b - a) * s)]
            else:
                ia, ib = i[..., :q], i[..., q:]
                dr, di = a - b, ia - ib
                nxt += [(a + b, ia + ib), (dr * c + di * s, di * c - dr * s)]
        branches = nxt
        q //= 2
    return branches


def _bf16_round(t):
    return t.to(torch.bfloat16).to(torch.float32)


def stft_mel_dif_bf16_plain(windows, *, sr, n_fft, hop_length, n_mels, fmin, fmax,
                            break_freq=1750.0, power=2.0, htk=True, frames=None):
    """Plain PyTorch version of the dif route, step for step as
    ``_kernel_dif`` at exact=0: bf16-rounded frames times the float32
    window, the float32 split (``dif_tree``), each leaf rounded to bf16 and
    multiplied by the bf16 leaf matrices in float32 (a product of two bf16
    values is exact in float32, so only the order of summation differs from
    the kernel), |X|^power rounded to bf16, the leaf's mel rows. Loops over
    chunks of windows and frames to bound memory."""
    n, s = windows.shape
    n_fft = int(n_fft)
    n_out = _frame_count(1 + s // hop_length, frames)
    win, twc, tws, ct, st, melt, levels, _, bl = _dif_consts(
        sr, n_mels, fmin, fmax, n_fft, break_freq, htk, windows.device)
    m_leaf = n_fft >> levels
    cm = ct[:, :m_leaf].to(torch.float32).T  # [m_leaf, bl]
    sm = st[:, :m_leaf].to(torch.float32).T
    mel = melt[:n_mels].to(torch.float32).T  # [2^L bl, n_mels]
    half = n_fft // 2
    padded = torch.nn.functional.pad(windows.to(torch.float32), (half, n_fft - half))
    view = padded.unfold(-1, n_fft, hop_length)[:, :n_out]  # [n, n_out, n_fft]
    out = torch.empty((n, n_mels, n_out), dtype=torch.float32, device=windows.device)
    fc = max(1, min(n_out, _PLAIN_STEP // n_fft))
    wc = max(1, _PLAIN_STEP // (fc * n_fft))
    for w0 in range(0, n, wc):
        for f0 in range(0, n_out, fc):
            x = _bf16_round(view[w0:w0 + wc, f0:f0 + fc]) * win
            acc = None
            for b, (r, i) in enumerate(dif_tree(x, twc, tws, levels)):
                rb = _bf16_round(r)
                if i is None:
                    xr, xi = rb @ cm, -(rb @ sm)
                else:
                    ib = _bf16_round(i)
                    xr = rb @ cm + ib @ sm
                    xi = ib @ cm - rb @ sm
                p = xr * xr + xi * xi
                if power == 1.0:
                    p = torch.sqrt(p)
                elif power != 2.0:
                    p = torch.pow(p, power / 2.0)
                t = _bf16_round(p) @ mel[b * bl:(b + 1) * bl]
                acc = t if acc is None else acc + t
            out[w0:w0 + wc, :, f0:f0 + fc] = acc.transpose(1, 2)
    return out


def stft_mel_bf16(windows, *, sr, n_fft, hop_length, n_mels, fmin, fmax,
                  break_freq=1750.0, power=2.0, htk=True, frames=None):
    """[N, S] float32 PCM windows -> [N, n_mels, frames] mel spectrograms
    through the bf16 tensor cores (the fast frontend level's contract: bf16
    operands, float32 accumulation, ~1% relative), on the route
    ``bf16_route`` picks. Same framing and arguments as ``stft_mel``."""
    kw = dict(sr=sr, n_fft=n_fft, hop_length=hop_length, n_mels=n_mels, fmin=fmin,
              fmax=fmax, break_freq=break_freq, power=power, htk=htk, frames=frames)
    route = bf16_route(int(n_fft))
    if windows.device.type == "cpu":
        plain = stft_mel_dif_bf16_plain if route == "dif" else stft_mel_bf16_plain
        return plain(windows, **kw)
    cuda.require_cuda(windows, "stft_mel_bf16")
    if windows.dim() != 2:
        raise ValueError(f"stft_mel_bf16: expected [N, S] windows, got {tuple(windows.shape)}")
    if not power > 0:
        raise ValueError(f"stft_mel_bf16: power must be positive, got {power}")
    n, s = windows.shape
    n_out = _frame_count(1 + s // hop_length, frames)
    out = torch.empty((n, n_mels, n_out), dtype=torch.float32, device=windows.device)
    lib = cuda.library()
    if route == "dif":
        win, twc, tws, ct, st, melt, levels, nb, bl = _dif_consts(
            sr, n_mels, fmin, fmax, n_fft, break_freq, htk, windows.device)
        if dif_plan(int(hop_length), int(n_fft), levels, bl, melt.shape[0],
                    cuda.smem_optin(windows.device)) is None:
            raise ValueError(f"stft_mel_bf16: hop {hop_length} and n_fft {n_fft}: a block's "
                             "PCM span does not fit in shared memory")
        rc = lib.aat_stft_mel_dif_bf16(
            windows.data_ptr(), win.data_ptr(), twc.data_ptr(), tws.data_ptr(), ct.data_ptr(),
            st.data_ptr(), melt.data_ptr(), out.data_ptr(), n, s, int(n_fft), levels,
            ct.shape[1], int(hop_length), n_out, nb, bl, melt.shape[0], int(n_mels),
            float(power), cuda.stream_of(windows),
        )
        stft_mel_bf16.dif_launches += 1
    else:
        wr, wi, melt, _ = _bf16_consts(sr, n_mels, fmin, fmax, n_fft, break_freq, htk,
                                       windows.device)
        hop = int(hop_length)
        _, lrow = direct_tiles(n_out, n_fft, hop)
        xb = torch.empty((n, direct_classes(hop), lrow), dtype=torch.bfloat16,
                         device=windows.device)
        rc = lib.aat_stft_mel_bf16(
            windows.data_ptr(), wr.data_ptr(), wi.data_ptr(), melt.data_ptr(), xb.data_ptr(),
            out.data_ptr(), n, s, int(n_fft), wr.shape[1], hop, n_out, wr.shape[0],
            melt.shape[0], int(n_mels), float(power), lrow, cuda.sm_count(windows.device),
            cuda.stream_of(windows),
        )
        stft_mel_bf16.direct_launches += 1
    cuda.check(rc, "stft_mel_bf16")
    stft_mel_bf16.launches += 1
    return out


stft_mel_bf16.launches = 0
stft_mel_bf16.dif_launches = stft_mel_bf16.direct_launches = 0
