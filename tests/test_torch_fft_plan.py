"""The host-side plan of the port's float64 FFT kernels (``csrc/stft.cu``,
fft route), checked on the CPU: the radix sequences, the route choice, and
a numpy executor of the same plan (same pass order, same twiddle-table
indexing, frames paired as z = a + i b and split) against ``np.fft.rfft``
and the plain version. The kernel itself runs only on a GPU
(``tests/test_torch_kernels.py``); this puts its indexing under a test that
needs no card:

    python -m pytest tests/test_torch_fft_plan.py -q
"""

import math

import numpy as np
import pytest
import torch

from audio_analysis_torch.ops import melspec as ms
from audio_analysis_torch.ops.mel import mel_support_bins
from audio_analysis_torch.ops.stft import stft_magnitude
from audio_analysis_torch.ops.windows import get_window_np

SIZES = (4096, 4800, 4410, 480, 512, 441, 2, 3, 6, 49, 1024, 2048, 4000)


# ---------------------------------------------------------------------------
# a numpy transcription of the kernel (stage_pair, fft_pass, split_pair)
# ---------------------------------------------------------------------------


def _butterfly(vr, vi, r, wc, ws):
    """butterfly<R>: exact radix 2 and 4, radix 8 as two radix-4 DFTs and
    the w8 rotations, direct DFT with table constants for odd radices."""
    if r == 8:
        er, ei = _butterfly(vr[0::2], vi[0::2], 4, None, None)
        orr, oi = _butterfly(vr[1::2], vi[1::2], 4, None, None)
        h = np.sqrt(0.5)
        tr = [orr[0], (orr[1] + oi[1]) * h, oi[2], (oi[3] - orr[3]) * h]
        ti = [oi[0], (oi[1] - orr[1]) * h, -orr[2], -(orr[3] + oi[3]) * h]
        return ([er[k] + tr[k] for k in range(4)] + [er[k] - tr[k] for k in range(4)],
                [ei[k] + ti[k] for k in range(4)] + [ei[k] - ti[k] for k in range(4)])
    if r == 2:
        return [vr[0] + vr[1], vr[0] - vr[1]], [vi[0] + vi[1], vi[0] - vi[1]]
    if r == 4:
        ar, ai = vr[0] + vr[2], vi[0] + vi[2]
        br, bi = vr[0] - vr[2], vi[0] - vi[2]
        cr, ci = vr[1] + vr[3], vi[1] + vi[3]
        dr, di = vr[1] - vr[3], vi[1] - vi[3]
        return [ar + cr, br + di, ar - cr, br - di], [ai + ci, bi - dr, ai - ci, bi + dr]
    yr, yi = [], []
    for k in range(r):
        sr, si = vr[0].copy(), vi[0].copy()
        for q_r in range(1, r):
            q = (q_r * k) % r
            sr = sr + vr[q_r] * wc[q] + vi[q_r] * ws[q]
            si = si + vi[q_r] * wc[q] - vr[q_r] * ws[q]
        yr.append(sr)
        yi.append(si)
    return yr, yi


def twiddle_np(t, cs, sn):
    """The kernel's ``twiddle_of``: e^{-2 pi i t / n} as (cos, sin) from the
    two-level table, the product of entries 64 (t // 64) and t % 64 of the
    float64 table."""
    h, lo = (t // ms.TWIDDLE_LO) * ms.TWIDDLE_LO, t % ms.TWIDDLE_LO
    c1, s1, c0, s0 = cs[h], sn[h], cs[lo], sn[lo]
    return c1 * c0 - s1 * s0, s1 * c0 + c1 * s0


def fft_plan_np(zr, zi, radices, cs, sn):
    """The kernel's ``fft``: Stockham passes in plan order over one complex
    buffer of n points (vectorised over the butterflies j; the kernel's
    spare doubles in shared memory are layout only)."""
    n = len(zr)
    ns = 1
    for r in radices:
        m = n // r
        step = m // ns
        wc, ws = cs[np.arange(r) * m], sn[np.arange(r) * m]
        j = np.arange(m)
        jm = j % ns
        vr = [zr[j + q * m] for q in range(r)]
        vi = [zi[j + q * m] for q in range(r)]
        for q in range(1, r):
            c, s = twiddle_np(q * jm * step, cs, sn)
            vr[q], vi[q] = vr[q] * c + vi[q] * s, vi[q] * c - vr[q] * s
        vr, vi = _butterfly(vr, vi, r, wc, ws)
        d = (j - jm) * r + jm
        zr, zi = np.empty(n), np.empty(n)
        for q in range(r):
            zr[d + q * ns] = vr[q]
            zi[d + q * ns] = vi[q]
        ns *= r
    return zr, zi


def stage_pair_np(x, win, hop, ta, has_b):
    """The kernel's ``stage_pair``: frames ta and ta + 1 windowed in float32,
    widened to float64, and each frame's non-zero flag."""
    n = len(win)
    s = ta * hop - n // 2 + np.arange(n)
    frames = []
    for off, present in ((0, True), (hop, has_b)):
        v = np.zeros(n, np.float32)
        ok = (s + off >= 0) & (s + off < len(x)) & present
        v[ok] = x[(s + off)[ok]] * win[ok]
        frames.append(v)
    return (frames[0].astype(np.float64), frames[1].astype(np.float64),
            bool(frames[0].any()), bool(frames[1].any()))


def split_pair_np(zr, zi, bins, flags=(True, True)):
    """The kernel's ``split_pair``, as complex spectra X_a, X_b of the first
    ``bins`` bins; a frame flagged all-zero gets exact zeros."""
    n = len(zr)
    k = np.arange(bins)
    k2 = np.where(k > 0, n - k, 0)
    xa = 0.5 * (zr[k] + zr[k2]) + 0.5j * (zi[k] - zi[k2])
    xb = 0.5 * (zi[k] + zi[k2]) + 0.5j * (zr[k2] - zr[k])
    return (xa if flags[0] else 0 * xa), (xb if flags[1] else 0 * xb)


def stft_np(x, n_fft, hop, bins=None):
    """The fft route's complex spectra [bins, frames] of a float32 signal,
    frames taken two at a time as the kernel takes them."""
    radices = ms.fft_radices(n_fft)
    cs, sn = ms._twiddles_np(n_fft)
    win = get_window_np("hann", n_fft, periodic=True)
    bins = n_fft // 2 + 1 if bins is None else bins
    n_frames = ms.stft_frames(len(x), n_fft, hop)
    out = np.zeros((bins, n_frames), np.complex128)
    for t in range(0, n_frames, 2):
        has_b = t + 1 < n_frames
        ar, ai, fa, fb = stage_pair_np(x, win, hop, t, has_b)
        zr, zi = fft_plan_np(ar, ai, radices, cs, sn)
        xa, xb = split_pair_np(zr, zi, bins, (fa, fb))
        out[:, t] = xa
        if has_b:
            out[:, t + 1] = xb
    return out


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_fft", SIZES)
def test_radices_multiply_to_n_fft(n_fft):
    radices = ms.fft_radices(n_fft)
    assert radices is not None
    assert math.prod(radices) == n_fft
    assert set(radices) <= set(ms.FFT_RADICES)
    order = [ms.FFT_RADICES.index(r) for r in radices]
    assert order == sorted(order)  # 8s first, then 4, 2, 3, 5, 7
    assert radices.count(4) + radices.count(2) <= 1  # 2s are taken as 8s where they can


@pytest.mark.parametrize("n_fft", [4400, 11, 4096 * 11, 13 * 64, 1021])
def test_other_prime_factors_have_no_plan(n_fft):
    assert ms.fft_radices(n_fft) is None


@pytest.mark.parametrize("n_fft,bins,mel,route,tf", [
    (4096, 2049, False, "fft", 8),  # detection |STFT|
    (4800, 2401, False, "fft", 4),  # 8 frames of 2401 bins (rows of 9) take 242,260 bytes
    (4096, mel_support_bins(48000, 160, 50.0, 11000.0, 4096, 1750.0, True), True, "fft", 8),
    (4800, mel_support_bins(48000, 120, 50.0, 11000.0, 4800, 1750.0, True), True, "fft", 8),
    (4410, 2206, False, "fft", 4),
    (441, 221, False, "fft", 8),
    (5120, 2561, False, "fft", 2),  # the smallest tile
    (5600, 2801, False, "direct", 4),  # not even 2 frames of the fft route fit
    (4400, 2201, False, "direct", 4),  # prime factor 11
    (4400, 2201, True, "direct", 4),
    (8192, 4097, False, "direct", 2),  # the fft route's buffers alone take 256 KiB
])
def test_route_choice(n_fft, bins, mel, route, tf):
    assert ms.stft_plan(n_fft, bins, mel=mel) == (route, tf)
    assert ms.stft_smem(route, n_fft, bins, tf, mel) <= ms.SMEM_OPTIN_H100


@pytest.mark.parametrize("n_fft", [32768, 29063])
def test_no_route_fits_raises(n_fft):
    with pytest.raises(ValueError, match="shared memory"):
        ms.stft_plan(n_fft, n_fft // 2 + 1, mel=False)


def test_direct_only_route_when_fft_does_not_fit():
    """A smaller card: n_fft 4096 takes the direct route when even two
    frames of the fft route do not fit."""
    cap = ms.stft_smem("fft", 4096, 2049, 2, False) - 1
    assert ms.stft_plan(4096, 2049, mel=False, cap=cap) == ("direct", 4)


def test_cpu_wrappers_take_the_plain_version():
    """On a CPU tensor the wrappers compute the plain version and launch
    nothing, whatever the route of n_fft."""
    y = torch.from_numpy(np.random.RandomState(0).randn(1, 6000).astype(np.float32))
    before = (ms.stft_mag.launches, ms.stft_mag.direct_launches)
    for n_fft in (480, 4400 // 4):  # fft route, direct route (1100 = 4 * 5^2 * 11)
        got = ms.stft_mag(y, n_fft=n_fft, hop_length=120)
        assert torch.equal(got, ms.stft_mag_plain(y, n_fft=n_fft, hop_length=120))
    assert (ms.stft_mag.launches, ms.stft_mag.direct_launches) == before


# ---------------------------------------------------------------------------
# the executor against numpy and the plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_fft", SIZES)
def test_plan_executor_matches_rfft(n_fft):
    """One pair through the plan reproduces np.fft.rfft of both frames to
    1e-12 of the spectrum's maximum."""
    rng = np.random.RandomState(n_fft)
    win = get_window_np("hann", n_fft, periodic=True)
    a = (rng.randn(n_fft).astype(np.float32) * win).astype(np.float64)
    b = (rng.randn(n_fft).astype(np.float32) * win).astype(np.float64)
    cs, sn = ms._twiddles_np(n_fft)
    zr, zi = fft_plan_np(a, b, ms.fft_radices(n_fft), cs, sn)
    xa, xb = split_pair_np(zr, zi, n_fft // 2 + 1)
    for got, frame in ((xa, a), (xb, b)):
        ref = np.fft.rfft(frame)
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("n_fft,hop,samples", [
    (4096, 281, 20000),  # 72 frames
    (4800, 281, 19954),  # 72 frames
    (4410, 256, 12000),  # 47 frames: an odd count, the last pair has one frame
    (441, 100, 2000),  # odd n_fft: no Nyquist bin
    (480, 120, 4800),
])
def test_plan_executor_matches_plain_stft(n_fft, hop, samples):
    """The whole signal, framed by index and paired as the kernel does,
    against the plain version's float64 |STFT| (before its float32 cast), to
    1e-12 of the maximum; frames past a silent tail are exact zeros."""
    rng = np.random.RandomState(samples)
    x = (0.1 * rng.randn(samples)).astype(np.float32)
    tail = samples * 2 // 3
    x[tail:] = 0.0
    got = np.abs(stft_np(x, n_fft, hop))
    ref = stft_magnitude(torch.from_numpy(x), n_fft, hop, dtype=torch.float64).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-12 * ref.max()
    silent = 1 + (tail + n_fft // 2) // hop
    assert silent < got.shape[1]
    assert not got[:, silent:].any() and not ref[:, silent:].any()


def test_zero_frame_needs_its_flag():
    """An all-zero frame paired with a non-zero one: the split leaves
    rounding residue of the partner (which survives a float32 cast), so the
    kernel writes flagged frames as exact zeros."""
    n_fft = 4800
    rng = np.random.RandomState(1)
    a = (rng.randn(n_fft).astype(np.float32)
         * get_window_np("hann", n_fft, periodic=True)).astype(np.float64)
    cs, sn = ms._twiddles_np(n_fft)
    zr, zi = fft_plan_np(a, np.zeros(n_fft), ms.fft_radices(n_fft), cs, sn)
    _, residue = split_pair_np(zr, zi, n_fft // 2 + 1)
    assert np.abs(residue).astype(np.float32).any()
    _, flagged = split_pair_np(zr, zi, n_fft // 2 + 1, (True, False))
    assert not flagged.any()


def test_mel_bins_prefix():
    """The mel kernel keeps only the filterbank's support: the executor's
    first ``bins`` bins are the full spectrum's."""
    x = (0.1 * np.random.RandomState(3).randn(9000)).astype(np.float32)
    bu = mel_support_bins(48000, 120, 50.0, 11000.0, 4800, 1750.0, True)
    full = stft_np(x, 4800, 281)
    part = stft_np(x, 4800, 281, bins=bu)
    assert np.array_equal(part, full[:bu])
