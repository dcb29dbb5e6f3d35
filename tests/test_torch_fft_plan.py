"""The host-side plan of the port's float64 FFT kernels (``csrc/stft.cu``:
the fft, fft1, bluestein and cluster routes; the cluster's own numpy
transcription is ``tests/test_torch_cluster_fft.py``), checked on the CPU: the radix
sequences, the route choice, and a numpy executor of the same plans (same
pass order, same twiddle-table indexing, the in-place passes' positions,
Bluestein's chirp product, frames paired as z = a + i b and split) against
``np.fft.rfft`` and the plain version. The kernel itself runs only on a GPU
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
# n_fft the one-buffer plans take: radix 11 (4400), too large for two
# buffers (8192, 9600, 11025), radix 13 (832 = 13 * 64); Bluestein (the
# primes 1021 and 4099)
WIDE_SIZES = (4400, 8192, 9600, 11025, 832, 1021, 4099)
SMALLEST_CLUSTER_MAG = 6301  # prime; Bluestein's 12800 points do not fit one block's 232,448 B


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
    if r >= 11:  # butterfly_pairs: sums and differences of the points r, R - r
        h = (r - 1) // 2
        sr = [vr[q] + vr[r - q] for q in range(1, h + 1)]
        si = [vi[q] + vi[r - q] for q in range(1, h + 1)]
        dr = [vr[q] - vr[r - q] for q in range(1, h + 1)]
        di = [vi[q] - vi[r - q] for q in range(1, h + 1)]
        yr, yi = [vr[0] + sum(sr)] + [None] * (r - 1), [vi[0] + sum(si)] + [None] * (r - 1)
        for k in range(1, h + 1):
            ar, ai, br, bi = vr[0], vi[0], 0.0, 0.0
            for q_r in range(1, h + 1):
                q = (q_r * k) % r
                c = wc[q] if q <= h else wc[r - q]
                s = ws[q] if q <= h else -ws[r - q]
                ar, ai = ar + sr[q_r - 1] * c, ai + si[q_r - 1] * c
                br, bi = br + dr[q_r - 1] * s, bi + di[q_r - 1] * s
            yr[k], yi[k] = ar + bi, ai - br
            yr[r - k], yi[r - k] = ar - bi, ai + br
        return yr, yi
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


def prime_outputs_np(zr, zi, first, stride, r, t1, cs, sn):
    """The kernel's ``prime_output`` (radix above 13): the r-term sum of the
    points first + q stride, term q times the table's twiddle of q t1 mod n."""
    n = len(zr)
    ar, ai = zr[first].copy(), zi[first].copy()
    for q in range(1, r):
        c, s = twiddle_np((q * t1) % n, cs, sn)
        vr, vi = zr[first + q * stride], zi[first + q * stride]
        ar, ai = ar + (vr * c + vi * s), ai + (vi * c - vr * s)
    return ar, ai


def fft_plan_np(zr, zi, radices, cs, sn):
    """The kernel's ``fft``: Stockham passes in plan order over one complex
    buffer of n points (vectorised over the butterflies j; the kernel's
    spare doubles in shared memory are layout only). The kernel's fft route
    takes radices 8, 4, 2, 3, 5 and 7; radix 11, 13 and a prime above 13
    (``prime_output``'s sum, one output (q, j) at a time) are the Stockham
    arithmetic that the in-place passes are held to."""
    n = len(zr)
    ns = 1
    for r in radices:
        m = n // r
        step = m // ns
        wc, ws = cs[np.arange(r) * m], sn[np.arange(r) * m]
        j = np.arange(m)
        jm = j % ns
        d = (j - jm) * r + jm
        nr, ni = np.empty(n), np.empty(n)
        if r > 13:
            for q in range(r):
                nr[d + q * ns], ni[d + q * ns] = prime_outputs_np(
                    zr, zi, j, m, r, jm * step + q * m, cs, sn)
        else:
            vr = [zr[j + q * m] for q in range(r)]
            vi = [zi[j + q * m] for q in range(r)]
            for q in range(1, r):
                c, s = twiddle_np(q * jm * step, cs, sn)
                vr[q], vi[q] = vr[q] * c + vi[q] * s, vi[q] * c - vr[q] * s
            vr, vi = _butterfly(vr, vi, r, wc, ws)
            for q in range(r):
                nr[d + q * ns] = vr[q]
                ni[d + q * ns] = vi[q]
        zr, zi = nr, ni
        ns *= r
    return zr, zi


def fft_inplace_np(zr, zi, radices, cs, sn, dif=False):
    """The kernel's ``fft_inplace`` (dif False: input at ``fft_positions``,
    output in natural order) and ``fft_inplace_dif`` (dif True: the
    transpose, last pass first, twiddles after the butterfly): butterfly b
    of the pass with stride ns owns the points g r ns + jm + q ns,
    g = b // ns, jm = b % ns, and writes them back in place."""
    n = len(zr)
    zr, zi = zr.copy(), zi.copy()
    strides = [math.prod(radices[:p]) for p in range(len(radices))]
    order = range(len(radices) - 1, -1, -1) if dif else range(len(radices))
    for p in order:
        r, ns = radices[p], strides[p]
        m = n // r
        step = m // ns
        wc, ws = cs[np.arange(r) * m], sn[np.arange(r) * m]
        b = np.arange(m)
        jm = b % ns
        base = (b // ns) * r * ns + jm
        if r > 13:  # fft_pass_prime_inplace: every output read before any is written
            assert not dif
            out = [prime_outputs_np(zr, zi, base, ns, r, jm * step + q * m, cs, sn)
                   for q in range(r)]
            for q, (vr, vi) in enumerate(out):
                zr[base + q * ns], zi[base + q * ns] = vr, vi
            continue
        vr = [zr[base + q * ns] for q in range(r)]
        vi = [zi[base + q * ns] for q in range(r)]
        if dif:
            vr, vi = _butterfly(vr, vi, r, wc, ws)
        for q in range(1, r):
            c, s = twiddle_np(q * jm * step, cs, sn)
            vr[q], vi[q] = vr[q] * c + vi[q] * s, vi[q] * c - vr[q] * s
        if not dif:
            vr, vi = _butterfly(vr, vi, r, wc, ws)
        for q in range(r):
            zr[base + q * ns], zi[base + q * ns] = vr[q], vi[q]
    return zr, zi


def bluestein_plan_np(zr, zi):
    """The kernel's ``stage_one`` and ``bluestein``: the n points times the
    chirp, zero-padded to M; the forward pass by decimation in frequency;
    times the host's filter spectrum (in that pass's order) and conjugated;
    the in-place passes; conjugated and times the chirp."""
    n = len(zr)
    m = ms.bluestein_size(n)
    radices = ms.fft_radices(m)
    cs, sn = ms._twiddles_np(m)
    chc, chs, bc, bs = ms.bluestein_np(n)
    ar, ai = np.zeros(m), np.zeros(m)
    ar[:n], ai[:n] = zr * chc + zi * chs, zi * chc - zr * chs
    ar, ai = fft_inplace_np(ar, ai, radices, cs, sn, dif=True)
    ar, ai = ar * bc - ai * bs, -(ar * bs + ai * bc)
    ar, ai = fft_inplace_np(ar, ai, radices, cs, sn)
    ar, ai = ar[:n], -ai[:n]
    return ar * chc + ai * chs, ai * chc - ar * chs


def route_fft_np(zr, zi, route):
    """The spectrum of one staged pair z = zr + i zi, natural order, by the
    executor of `route` (fft, fft1 staged at ``fft_positions``, bluestein)."""
    n = len(zr)
    if route == "bluestein":
        return bluestein_plan_np(zr, zi)
    radices = ms.fft_radices(n)
    cs, sn = ms._twiddles_np(n)
    if route == "fft":
        return fft_plan_np(zr, zi, radices, cs, sn)
    pos = ms.fft_positions(radices)
    br, bi = np.empty(n), np.empty(n)
    br[pos], bi[pos] = zr, zi
    return fft_inplace_np(br, bi, radices, cs, sn)


def mag_route(n_fft):
    return ms.stft_plan(n_fft, n_fft // 2 + 1, mel=False)[0]


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


def stft_np(x, n_fft, hop, bins=None, route="fft"):
    """A route's complex spectra [bins, frames] of a float32 signal, frames
    taken two at a time as the kernel takes them."""
    win = get_window_np("hann", n_fft, periodic=True)
    bins = n_fft // 2 + 1 if bins is None else bins
    n_frames = ms.stft_frames(len(x), n_fft, hop)
    out = np.zeros((bins, n_frames), np.complex128)
    for t in range(0, n_frames, 2):
        has_b = t + 1 < n_frames
        ar, ai, fa, fb = stage_pair_np(x, win, hop, t, has_b)
        zr, zi = route_fft_np(ar, ai, route)
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


@pytest.mark.parametrize("n_fft", [4400, 11, 4096 * 11, 13 * 64, 1021, 4099, 67 * 64, 17 * 512,
                                   61 * 200, 29063])
def test_other_prime_factors_have_no_plan(n_fft):
    """Prime factors other than 2, 3, 5 and 7: 11 and 13 take butterflies of
    their own, odd primes up to FFT_MAX_PRIME (61) the generic pass, in
    that order after the small radices; a larger prime factor leaves no
    plan (the bluestein or cluster route)."""
    largest = max(p for p in range(2, n_fft + 1) if n_fft % p == 0
                  and all(p % d for d in range(2, int(p ** 0.5) + 1)))
    radices = ms.fft_radices(n_fft)
    if largest > ms.FFT_MAX_PRIME:
        assert radices is None
        return
    assert math.prod(radices) == n_fft and largest in radices
    order = [(ms.FFT_RADICES + ms.WIDE_PRIMES).index(r) for r in radices]
    assert order == sorted(order)


@pytest.mark.parametrize("n_fft,bins,mel,route,tf", [
    (4096, 2049, False, "fft", 8),  # detection |STFT|
    (4800, 2401, False, "fft", 4),  # 8 frames of 2401 bins (rows of 9) take 242,260 bytes
    (4096, mel_support_bins(48000, 160, 50.0, 11000.0, 4096, 1750.0, True), True, "fft", 8),
    (4800, mel_support_bins(48000, 120, 50.0, 11000.0, 4800, 1750.0, True), True, "fft", 8),
    (4410, 2206, False, "fft", 4),
    (441, 221, False, "fft", 8),
    (5120, 2561, False, "fft", 2),  # the smallest tile
    (5600, 2801, False, "fft1", 8),  # not even 2 frames of the fft route fit: one buffer
    (4400, 2201, False, "fft1", 8),  # prime factor 11: the radix-11 pass runs in place
    (4400, mel_support_bins(48000, 160, 50.0, 11000.0, 4400, 1750.0, True), True, "fft1", 8),
    (832, 417, False, "fft1", 8),  # 8^2 * 13: two buffers would fit, radix 13 runs in place
    (1088, 545, False, "fft1", 8),  # 8^2 * 17: the generic prime pass, in place
    (1088, mel_support_bins(16000, 40, 50.0, 7000.0, 1088, 1750.0, True), True, "fft1", 8),
    (8192, 4097, False, "fft1", 8),  # the fft route's buffers alone take 256 KiB
    (8192, mel_support_bins(48000, 160, 50.0, 11000.0, 8192, 1750.0, True), True, "fft1", 8),
    (11025, 5513, False, "fft1", 8),  # 3^2 5^2 7^2: the one-buffer |STFT| has no tile
    (11025, mel_support_bins(44100, 120, 50.0, 11000.0, 11025, 1750.0, True), True, "fft1", 2),
    (4099, 2050, False, "bluestein", 8),  # prime: the chirp product over M = 8232
    (SMALLEST_CLUSTER_MAG, 3151, False, "cluster", 8),  # Bluestein over two blocks
    (12800, 6401, False, "cluster", 8),  # one buffer of 12800 points does not fit
    (16384, mel_support_bins(48000, 160, 50.0, 11000.0, 16384, 1750.0, True), True, "cluster",
     8),
])
def test_route_choice(n_fft, bins, mel, route, tf):
    assert ms.stft_plan(n_fft, bins, mel=mel) == (route, tf)
    if route == "cluster":
        c, points, _ = ms.cluster_plan(n_fft, bins, mel=mel)
        assert ms.cluster_smem(points, c, bins, tf, mel) <= ms.SMEM_OPTIN_H100
    else:
        assert ms.stft_smem(route, n_fft, bins, tf, mel) <= ms.SMEM_OPTIN_H100


@pytest.mark.parametrize("n_fft", [131072, 65537])
def test_no_route_fits_raises(n_fft):
    """Above the cluster's capacity (eight blocks of at most ~12,700
    points): 2^17, and the prime 65537, whose Bluestein length is above
    2^17."""
    with pytest.raises(ValueError, match="shared memory"):
        ms.stft_plan(n_fft, n_fft // 2 + 1, mel=False)


def test_direct_only_route_when_fft_does_not_fit():
    """A smaller card: n_fft 4096 takes one buffer (fft1) when even two
    frames of the fft route do not fit, the cluster route (two blocks of
    2048 points) when one buffer does not fit either, more blocks as the
    card shrinks, and no route below eight blocks of 512."""
    cap = ms.stft_smem("fft", 4096, 2049, 2, False) - 1
    assert ms.stft_plan(4096, 2049, mel=False, cap=cap) == ("fft1", 8)
    cap = ms.stft_smem("fft1", 4096, 2049, 8, False) - 1
    assert ms.stft_plan(4096, 2049, mel=False, cap=cap) == ("cluster", 8)
    assert ms.cluster_plan(4096, 2049, mel=False, cap=cap) == (2, 4096, 8)
    cap = ms.cluster_smem(4096, 2, 2049, 8, False) - 1
    assert ms.cluster_plan(4096, 2049, mel=False, cap=cap) == (4, 4096, 8)
    cap = ms.cluster_smem(4096, 8, 2049, 8, False) - 1
    with pytest.raises(ValueError, match="shared memory"):
        ms.stft_plan(4096, 2049, mel=False, cap=cap)


def test_cpu_wrappers_take_the_plain_version():
    """On a CPU tensor the wrappers compute the plain version and launch
    nothing, whatever the route of n_fft."""
    y = torch.from_numpy(np.random.RandomState(0).randn(1, 6000).astype(np.float32))
    counts = lambda: (ms.stft_mag.launches, ms.stft_mag.fft1_launches,
                      ms.stft_mag.bluestein_launches, ms.stft_mag.cluster_launches)
    before = counts()
    # fft route (480), fft1 (1100 = 4 * 5^2 * 11: a radix-11 pass; 8192), bluestein, cluster
    for n_fft, route in ((480, "fft"), (4400 // 4, "fft1"), (8192, "fft1"), (1021, "bluestein"),
                         (SMALLEST_CLUSTER_MAG, "cluster")):
        assert mag_route(n_fft) == route
        got = ms.stft_mag(y, n_fft=n_fft, hop_length=120)
        assert torch.equal(got, ms.stft_mag_plain(y, n_fft=n_fft, hop_length=120))
    assert counts() == before


def test_smallest_direct_n_fft():
    """Every n_fft below 6301 takes a one-block route for stft_mag on the
    H100's 232,448 bytes; 6301 (prime, Bluestein's M = 12800 does not fit
    one block) is the first that takes the cluster (the direct DFT is
    gone)."""
    routes = {n: mag_route(n) for n in range(2, SMALLEST_CLUSTER_MAG + 1)}
    assert routes[SMALLEST_CLUSTER_MAG] == "cluster"
    assert "cluster" not in {routes[n] for n in range(2, SMALLEST_CLUSTER_MAG)}
    assert set(routes.values()) == {"fft", "fft1", "bluestein", "cluster"}
    assert ms.bluestein_size(SMALLEST_CLUSTER_MAG) == 12800


def test_wider_radices_take_the_one_buffer_route():
    """The fft route's kernels hold only the passes of 8, 4, 2, 3, 5 and 7:
    every n_fft whose plan has a radix-11, radix-13 or generic prime pass
    takes fft1, for stft_mag and stft_mel alike, however small."""
    wide = [n for n in range(2, SMALLEST_CLUSTER_MAG)
            if ms.fft_radices(n) and not set(ms.fft_radices(n)) <= set(ms.TWO_BUFFER_RADICES)]
    assert 4400 in wide and 1088 in wide and 11 in wide
    for n in wide:
        assert mag_route(n) == "fft1"
        assert ms.stft_plan(n, n // 4 + 1, mel=True)[0] == "fft1"


def test_one_buffer_plans_fit_the_held_outputs():
    """The in-place generic pass holds INPLACE_HELD outputs a thread: every
    one-buffer plan that fits the H100's shared memory has at most
    INPLACE_HELD * FFT_THREADS points (the largest fft1 n_fft is 12,800)."""
    biggest = max(n for n in range(12000, 13400)
                  if ms.fft_radices(n) and ms.stft_smem("fft1", n, 0, 8, False)
                  <= ms.SMEM_OPTIN_H100)
    assert biggest <= ms.INPLACE_HELD * ms.FFT_THREADS
    assert mag_route(biggest) == "fft1"


# ---------------------------------------------------------------------------
# the executor against numpy and the plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_fft", SIZES + WIDE_SIZES)
def test_plan_executor_matches_rfft(n_fft):
    """One pair through the plan of stft_mag's route reproduces np.fft.rfft
    of both frames to 1e-12 of the spectrum's maximum."""
    rng = np.random.RandomState(n_fft)
    win = get_window_np("hann", n_fft, periodic=True)
    a = (rng.randn(n_fft).astype(np.float32) * win).astype(np.float64)
    b = (rng.randn(n_fft).astype(np.float32) * win).astype(np.float64)
    zr, zi = route_fft_np(a, b, mag_route(n_fft))
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
    (4400, 281, 20000),  # fft1, a radix-11 pass
    (8192, 281, 20001),  # fft1
    (4099, 256, 12000),  # bluestein, an odd n_fft
])
def test_plan_executor_matches_plain_stft(n_fft, hop, samples):
    """The whole signal, framed by index and paired as the kernel does on
    stft_mag's route, against the plain version's float64 |STFT| (before its
    float32 cast), to 1e-12 of the maximum; frames past a silent tail are
    exact zeros."""
    rng = np.random.RandomState(samples)
    x = (0.1 * rng.randn(samples)).astype(np.float32)
    tail = samples * 2 // 3
    x[tail:] = 0.0
    got = np.abs(stft_np(x, n_fft, hop, route=mag_route(n_fft)))
    ref = stft_magnitude(torch.from_numpy(x), n_fft, hop, dtype=torch.float64).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-12 * ref.max()
    silent = 1 + (tail + n_fft // 2) // hop
    assert silent < got.shape[1]
    assert not got[:, silent:].any() and not ref[:, silent:].any()


@pytest.mark.parametrize("n_fft", SIZES + (4400, 8192, 832, 11025, 17 * 512, 61 * 200))
def test_inplace_passes_are_the_stockham_arithmetic(n_fft):
    """The one-buffer passes on input staged at ``fft_positions`` compute
    every output from the same inputs, twiddles and butterflies as the
    Stockham passes: bit for bit the same spectrum."""
    rng = np.random.RandomState(n_fft)
    zr, zi = rng.randn(n_fft), rng.randn(n_fft)
    radices = ms.fft_radices(n_fft)
    cs, sn = ms._twiddles_np(n_fft)
    want = fft_plan_np(zr, zi, radices, cs, sn)
    got = route_fft_np(zr, zi, "fft1")
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("n_fft", [97, 1021, 4099, 4288])
def test_bluestein_dif_order_and_tables(n_fft):
    """The decimation-in-frequency passes leave the spectrum at
    ``fft_positions`` (so the filter is stored there), the chirp angle is
    pi (k^2 mod 2n) / n, and the padded length is the smallest product of
    2, 3, 5 and 7 at least 2 n - 1."""
    m = ms.bluestein_size(n_fft)
    assert m >= 2 * n_fft - 1 and all(ms.fft_radices(k) is None or
                                      set(ms.fft_radices(k)) - {8, 4, 2, 3, 5, 7}
                                      for k in range(2 * n_fft - 1, m))
    rng = np.random.RandomState(n_fft)
    z = rng.randn(m) + 1j * rng.randn(m)
    cs, sn = ms._twiddles_np(m)
    radices = ms.fft_radices(m)
    zr, zi = fft_inplace_np(z.real, z.imag, radices, cs, sn, dif=True)
    ref = np.fft.fft(z)
    pos = ms.fft_positions(radices)
    assert np.abs(zr[pos] + 1j * zi[pos] - ref).max() <= 1e-12 * np.abs(ref).max()
    chc, chs, _, _ = ms.bluestein_np(n_fft)
    k = np.arange(n_fft)
    assert np.allclose(chc - 1j * chs, np.exp(-1j * np.pi * k.astype(np.float64) ** 2 / n_fft),
                       atol=1e-9)


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
