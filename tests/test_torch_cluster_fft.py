"""The float64 cluster route (``csrc/stft.cu``: ``stft_mag_cluster_kernel``,
``stft_mel_cluster_kernel``) transcribed to numpy rank by rank, on the CPU:
each block's staging, the exchange pass across the cluster (by decimation
in frequency and in time), each block's in-place passes, the pair split
that reads its partner bin from another block, Bluestein's chirp product
over a cluster with the host's filter in the cluster's order
(``bluestein_cluster_np``), and the mel sums over the blocks' tiles;
against ``np.fft.fft`` and the plain version. Also the route's plan: every
n_fft from 2 to 32768 takes an FFT route (fft, fft1, bluestein or
cluster) for stft_mag and for the classify stft_mel. The kernel runs only
on a GPU (``tests/test_torch_kernels.py``):

    python -m pytest tests/test_torch_cluster_fft.py -q
"""

import numpy as np
import pytest
import torch

from audio_analysis_torch.ops import melspec as ms
from audio_analysis_torch.ops.mel import filterbank_np, mel_support_bins
from audio_analysis_torch.ops.stft import stft_magnitude
from audio_analysis_torch.ops.windows import get_window_np

import test_torch_fft_plan as plan  # noqa: E402  (the in-block passes' transcription)


def classify_bins(n_fft):
    return mel_support_bins(48000, 160, 50.0, 11000.0, n_fft, 1750.0, True)


# ---------------------------------------------------------------------------
# the transcription: buffers[r] is block r's complex buffer of m points
# ---------------------------------------------------------------------------


def exchange_np(bufs, n_fft, points, dit):
    """The kernel's ``exchange``: at each buffer address q, the radix-c
    butterfly over the blocks' values at q; decimation in frequency: output
    k2 times the host's twiddle of address q (``cluster_twiddles_np``:
    W_N^{p k2}, p the point at q) into block k2; in time: block r's value
    times its twiddle first. Vectorised over q (every address is one
    thread's, so their order does not matter)."""
    c = len(bufs)
    m = points // c
    cs, sn = ms._twiddles_np(points)
    wc, ws = cs[np.arange(c) * m], sn[np.arange(c) * m]
    xc, xs = ms.cluster_twiddles_np(n_fft, c, points)
    vr = [bufs[r][0].copy() for r in range(c)]
    vi = [bufs[r][1].copy() for r in range(c)]
    if dit:
        for r in range(1, c):
            co, si = xc[(r - 1) * m:r * m], xs[(r - 1) * m:r * m]
            vr[r], vi[r] = vr[r] * co + vi[r] * si, vi[r] * co - vr[r] * si
    vr, vi = plan._butterfly(vr, vi, c, wc, ws)
    if not dit:
        for k in range(1, c):
            co, si = xc[(k - 1) * m:k * m], xs[(k - 1) * m:k * m]
            vr[k], vi[k] = vr[k] * co + vi[k] * si, vi[k] * co - vr[k] * si
    for r in range(c):
        bufs[r][0][:], bufs[r][1][:] = vr[r], vi[r]


def cluster_transform_np(zr, zi, c, points):
    """The kernel's ``stage_cluster`` and ``cluster_transform`` on the
    staged pair z (n_fft points): the c blocks' buffers afterwards, and a
    function locating bin k < n_fft (its block, its local point)."""
    n = len(zr)
    m = points // c
    radices = ms.fft_radices(m)
    csm, snm = ms._twiddles_np(m)
    bluestein = points != n
    bufs = []
    if not bluestein:  # fft order: local point i (sample r m + i) at fft_positions[i]
        perm = ms.fft_positions(radices)
        for r in range(c):
            br, bi = np.empty(m), np.empty(m)
            br[perm], bi[perm] = zr[r * m:(r + 1) * m], zi[r * m:(r + 1) * m]
            bufs.append([br, bi])
        exchange_np(bufs, n, points, dit=False)
        bufs = [list(plan.fft_inplace_np(br, bi, radices, csm, snm)) for br, bi in bufs]
        return bufs, lambda k: (k % c, k // c)
    chc, chs, bc, bs = ms.bluestein_cluster_np(n, points, c)
    ar, ai = np.zeros(points), np.zeros(points)
    ar[:n], ai[:n] = zr * chc + zi * chs, zi * chc - zr * chs
    bufs = [[ar[r * m:(r + 1) * m].copy(), ai[r * m:(r + 1) * m].copy()] for r in range(c)]
    exchange_np(bufs, n, points, dit=False)
    for r in range(c):
        xr, xi = plan.fft_inplace_np(*bufs[r], radices, csm, snm, dif=True)
        fr, fi = bc[r * m:(r + 1) * m], bs[r * m:(r + 1) * m]
        bufs[r] = list(plan.fft_inplace_np(xr * fr - xi * fi, -(xr * fi + xi * fr),
                                           radices, csm, snm))
    exchange_np(bufs, n, points, dit=True)
    return bufs, lambda k: (k // m, k % m)


def cluster_z_np(bufs, where, k, chirp=None):
    """The kernel's ``cluster_z``: bin k of Z read from its block; with
    Bluestein's chirp (chc, chs), conjugated and times the chirp."""
    owner, i = where(k)
    zr = np.stack([b[0] for b in bufs])[owner, i]
    zi = np.stack([b[1] for b in bufs])[owner, i]
    if chirp is not None:
        chc, chs = chirp
        zi = -zi
        zr, zi = zr * chc[k] + zi * chs[k], zi * chc[k] - zr * chs[k]
    return zr, zi


def cluster_spectrum_np(zr, zi, c, points):
    """Z[k] for every k < n_fft, gathered from the blocks."""
    n = len(zr)
    bufs, where = cluster_transform_np(zr, zi, c, points)
    chirp = ms.bluestein_cluster_np(n, points, c)[:2] if points != n else None
    k = np.arange(n)
    gr, gi = cluster_z_np(bufs, where, k, chirp)
    return gr + 1j * gi


def split_cluster_np(zr, zi, c, points, bins, flags=(True, True)):
    """The kernel's ``split_cluster``: block r computes the bins r + c i,
    reading Z[k] and Z[n - k] from their blocks. Returns X_a, X_b [bins]
    assembled from the blocks, and each block's own bins (its tile)."""
    n = len(zr)
    bufs, where = cluster_transform_np(zr, zi, c, points)
    chirp = ms.bluestein_cluster_np(n, points, c)[:2] if points != n else None
    xa, xb = np.zeros(bins, np.complex128), np.zeros(bins, np.complex128)
    tiles = []
    for r in range(c):
        k = np.arange(r, bins, c)
        pr, pi = cluster_z_np(bufs, where, k, chirp)
        qr, qi = cluster_z_np(bufs, where, np.where(k > 0, n - k, 0), chirp)
        a = 0.5 * (pr + qr) + 0.5j * (pi - qi)
        b = 0.5 * (pi + qi) + 0.5j * (qr - pr)
        xa[k], xb[k] = (a if flags[0] else 0 * a), (b if flags[1] else 0 * b)
        tiles.append((xa[k], xb[k]))
    return xa, xb, tiles


def test_exchange_twiddles_follow_the_staging():
    """The exchange's table by address: at address q of a block staged at
    fft_positions, the point fft_positions^-1(q), so W_N^{k p} there; in
    natural order (Bluestein) W_N^{k q}; every entry is the table of N's."""
    for n_fft, c, points in ((16384, 2, 16384), (24000, 3, 24000), (6301, 2, 12800)):
        m = points // c
        xc, xs = ms.cluster_twiddles_np(n_fft, c, points)
        assert xc.shape == xs.shape == ((c - 1) * m,)
        pos = ms.fft_positions(ms.fft_radices(m)) if points == n_fft else np.arange(m)
        cs, sn = ms._twiddles_np(points)
        for k in range(1, c):
            row = slice((k - 1) * m, k * m)
            assert np.array_equal(xc[row][pos], cs[k * np.arange(m)])
            assert np.array_equal(xs[row][pos], sn[k * np.arange(m)])


# (n_fft, c, points): the H100's plans at the shapes the card runs, and
# splits that exercise the radix-5, -7 and -8 exchanges
TRANSFORMS = [
    (16384, 2, 16384),  # the n_fft-16384 classify: two blocks of 8192 (fft1's plan)
    (32768, 4, 32768),  # four blocks of 8192
    (12000, 2, 12000),  # the first classify stft_mel on the cluster
    (13230, 2, 13230),  # 2 3^3 5 7^2: blocks of 6615, radices 3, 5, 7
    (12800, 2, 12800),  # the first stft_mag on the cluster
    (24000, 3, 24000),  # the classify stft_mel at 24000: a radix-3 exchange
    (6301, 2, 12800),  # prime: Bluestein over two blocks of 6400
    (32749, 8, 65536),  # the largest prime below 32768: Bluestein over eight blocks
    (1021, 5, 2250),  # Bluestein at a length of its own: a radix-5 exchange, blocks of 450
    (4410, 7, 4410),  # a radix-7 exchange, blocks of 630
    (2048, 8, 2048),  # a radix-8 exchange
]


@pytest.mark.parametrize("n_fft,c,points", TRANSFORMS)
def test_cluster_fft_matches_numpy(n_fft, c, points):
    """The pair z through the cluster's stages equals np.fft.fft(z) to 1e-12
    of its maximum, in the order the blocks hold it."""
    rng = np.random.RandomState(n_fft + c)
    z = rng.randn(n_fft) + 1j * rng.randn(n_fft)
    got = cluster_spectrum_np(z.real, z.imag, c, points)
    ref = np.fft.fft(z)
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("n_fft,c,points", TRANSFORMS)
def test_cluster_pair_split_matches_rfft(n_fft, c, points):
    """Two windowed real frames as one complex transform, split with the
    partner bin read from its block: np.fft.rfft of each frame to 1e-12."""
    rng = np.random.RandomState(n_fft)
    win = get_window_np("hann", n_fft, periodic=True)
    a = (rng.randn(n_fft).astype(np.float32) * win).astype(np.float64)
    b = (rng.randn(n_fft).astype(np.float32) * win).astype(np.float64)
    xa, xb, tiles = split_cluster_np(a, b, c, points, n_fft // 2 + 1)
    for got, frame in ((xa, a), (xb, b)):
        ref = np.fft.rfft(frame)
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    assert sum(len(t[0]) for t in tiles) == n_fft // 2 + 1
    assert max(len(t[0]) for t in tiles) == -(-(n_fft // 2 + 1) // c)  # the tile's row


def test_bluestein_filter_order_is_the_clusters():
    """The forward transform over the cluster leaves bin c k1 + r in block r
    at fft_positions(m)[k1], the order the host stores the filter in; a
    filter stored in the one-block order (``bluestein_np``'s) would be
    wrong."""
    n, points, c = 6301, 12800, 2
    m = points // c
    rng = np.random.RandomState(1)
    z = rng.randn(points) + 1j * rng.randn(points)
    bufs = [[z.real[r * m:(r + 1) * m].copy(), z.imag[r * m:(r + 1) * m].copy()]
            for r in range(c)]
    exchange_np(bufs, n, points, dit=False)
    radices = ms.fft_radices(m)
    csm, snm = ms._twiddles_np(m)
    pos = ms.fft_positions(radices)
    ref = np.fft.fft(z)
    for r in range(c):
        xr, xi = plan.fft_inplace_np(*bufs[r], radices, csm, snm, dif=True)
        got = xr[pos] + 1j * xi[pos]
        assert np.abs(got - ref[r::c]).max() <= 1e-12 * np.abs(ref).max()
    _, _, bc, bs = ms.bluestein_cluster_np(n, points, c)
    spec = np.fft.fft(np.r_[np.exp(1j * np.pi * (np.arange(n) ** 2 % (2 * n)) / n),
                            np.zeros(points - 2 * n + 1),
                            np.exp(1j * np.pi * (np.arange(1, n)[::-1] ** 2 % (2 * n)) / n)])
    for r in range(c):
        held = bc[r * m:(r + 1) * m][pos] + 1j * bs[r * m:(r + 1) * m][pos]
        assert np.abs(held - spec[r::c] / points).max() <= 1e-12
    assert ms.bluestein_np(n)[2].shape == bc.shape and not np.allclose(ms.bluestein_np(n)[2], bc)


def stft_cluster_np(x, n_fft, hop, c, points, bins):
    """The kernel's whole signal on the cluster route: frames paired as it
    pairs them (``plan.stage_pair_np``), each pair through the cluster."""
    win = get_window_np("hann", n_fft, periodic=True)
    n_frames = ms.stft_frames(len(x), n_fft, hop)
    out = np.zeros((bins, n_frames), np.complex128)
    for t in range(0, n_frames, 2):
        has_b = t + 1 < n_frames
        ar, ai, fa, fb = plan.stage_pair_np(x, win, hop, t, has_b)
        xa, xb, _ = split_cluster_np(ar, ai, c, points, bins, (fa, fb))
        out[:, t] = xa
        if has_b:
            out[:, t + 1] = xb
    return out


@pytest.mark.parametrize("n_fft,hop,samples", [
    (16384, 2048, 40000),  # an odd frame count: the last pair has one frame
    (6301, 1600, 30000),  # Bluestein over two blocks
])
def test_cluster_stft_matches_plain(n_fft, hop, samples):
    """stft_mag's plan for n_fft through the transcription against the plain
    version's float64 |STFT|, to 1e-12 of the maximum; frames past a
    silent tail are exact zeros (the flags or-ed over the blocks)."""
    assert ms.stft_plan(n_fft, n_fft // 2 + 1, mel=False)[0] == "cluster"
    c, points, _ = ms.cluster_plan(n_fft, n_fft // 2 + 1, mel=False)
    rng = np.random.RandomState(samples)
    x = (0.1 * rng.randn(samples)).astype(np.float32)
    tail = samples * 2 // 3
    x[tail:] = 0.0
    got = np.abs(stft_cluster_np(x, n_fft, hop, c, points, n_fft // 2 + 1))
    ref = stft_magnitude(torch.from_numpy(x), n_fft, hop, dtype=torch.float64).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-12 * ref.max()
    silent = 1 + (tail + n_fft // 2) // hop
    assert silent < got.shape[1]
    assert not got[:, silent:].any()


def test_cluster_mel_sums_over_the_blocks_tiles():
    """The kernel's ``mel_cluster`` at the n_fft-16384 classify: each output
    sums fb[m][k] times bin k's power from block k mod c's tile at k / c, in
    bin order, over the row's support; against the dense product."""
    n_fft, hop = 16384, 640
    bins = classify_bins(n_fft)
    c, points, tf = ms.cluster_plan(n_fft, bins, mel=True)
    x = (0.1 * np.random.RandomState(7).randn(2 * hop + 100)).astype(np.float32)
    spec = stft_cluster_np(x, n_fft, hop, c, points, bins)
    power = (np.abs(spec) ** 2).astype(np.float32)  # [bins, frames]
    tiles = [power[r::c] for r in range(c)]  # block r's [bins / c, frames]
    fb = filterbank_np(48000, 160, 50.0, 11000.0, n_fft, 1750.0, True)[:, :bins]
    got = np.zeros((160, power.shape[1]))
    for m in range(160):
        nz = np.flatnonzero(fb[m])
        for f in range(power.shape[1]):
            acc = 0.0
            for k in range(nz[0], nz[-1] + 1) if len(nz) else ():
                acc += float(fb[m, k]) * float(tiles[k % c][k // c, f])
            got[m, f] = acc
    ref = fb.astype(np.float64) @ power.astype(np.float64)
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    want = ms.stft_mel_plain(torch.from_numpy(x[None]), sr=48000, n_fft=n_fft,
                             hop_length=hop, n_mels=160, fmin=50.0, fmax=11000.0)[0].numpy()
    den = np.maximum(np.abs(want), 1e-3 * np.abs(want).max())
    assert (np.abs(got.astype(np.float32) - want) / den).max() <= 1e-6


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_fft,mel,c,points,tf", [
    (6301, False, 2, 12800, 8),  # prime: Bluestein's 12800 points over two blocks
    (6301, True, 2, 12800, 8),
    (12000, True, 2, 12000, 8),  # the smallest classify stft_mel on the cluster
    (12800, False, 2, 12800, 8),  # the smallest stft_mag on the cluster but the primes'
    (16384, False, 2, 16384, 8),
    (16384, True, 2, 16384, 8),  # the n_fft-16384 TuiNet's classify
    (24000, True, 3, 24000, 8),  # two blocks of 12000 and their tile do not fit: three
    (32768, False, 4, 32768, 8),
    (32768, True, 4, 32768, 8),
    (29063, True, 5, 58320, 2),  # prime: Bluestein over five blocks, two frames
    (19601, False, 5, 39375, 8),  # bluestein_size's 39366 = 2 3^9 splits into no block that fits
])
def test_cluster_plan(n_fft, mel, c, points, tf):
    bins = classify_bins(n_fft) if mel else n_fft // 2 + 1
    assert ms.stft_plan(n_fft, bins, mel=mel) == ("cluster", tf)
    assert ms.cluster_plan(n_fft, bins, mel=mel) == (c, points, tf)
    smem = ms.cluster_smem(points, c, bins, tf, mel)
    assert smem <= ms.SMEM_OPTIN_H100
    assert points // c <= ms.INPLACE_HELD * ms.FFT_THREADS
    if points != n_fft:
        assert points >= 2 * n_fft - 1 and set(ms.fft_radices(points // c)) <= {8, 4, 2, 3, 5, 7}
    for smaller in [q for q in ms.CLUSTER_SIZES if q < c and points % q == 0]:
        assert ms.cluster_smem(points, smaller, bins, ms.FFT_TILES[-1], mel) > ms.SMEM_OPTIN_H100


def classify_bins_bound(n_fft):
    """At least ``classify_bins``: the support ends below the 11 kHz edge's
    bin."""
    return min(n_fft // 2 + 1, 11000 * n_fft // 48000 + 2)


def test_every_n_fft_to_32768_takes_an_fft_route():
    """No n_fft from 2 to 32768 is left without an FFT: stft_mag (every bin)
    and stft_mel on the classify grid (48 kHz, 160 mels, 11 kHz) each take
    fft, fft1, bluestein or cluster on the H100's 232,448 bytes. A block's
    size grows with the bins it keeps, so a route that fits the classify
    support's bound (``classify_bins_bound``, checked against the support
    every 331st n_fft) fits the support itself."""
    for n in range(2, 32769, 331):
        assert classify_bins(n) <= classify_bins_bound(n)
    first = {}
    for n in range(2, 32769):
        for mel, bins in ((False, n // 2 + 1), (True, classify_bins_bound(n))):
            route, _ = ms.stft_plan(n, bins, mel=mel)
            first.setdefault((route, mel), n)
    assert {r for r, _ in first} == {"fft", "fft1", "bluestein", "cluster"}
    # the smallest n_fft on the cluster: 6301 (prime, Bluestein's 12800
    # points) for stft_mag; 6004 = 4 19 79 for stft_mel (Bluestein's 12096
    # points and the tile)
    assert first[("cluster", False)] == 6301
    assert ms.stft_plan(6004, classify_bins(6004), mel=True)[0] == "cluster"
    assert first[("cluster", True)] == 6004


def test_cluster_plan_fills_the_generic_pass():
    """Every block of a cluster plan to 32768 respects the in-place generic
    pass's held outputs and takes only the radices the block's passes have
    (Bluestein's: 8, 4, 2, 3, 5, 7)."""
    for n in list(range(12000, 12100)) + list(range(32700, 32769)):
        c, points, _ = ms.cluster_plan(n, n // 2 + 1, mel=False)
        m = points // c
        assert m <= ms.INPLACE_HELD * ms.FFT_THREADS and ms.fft_radices(m) is not None
        if points != n:
            assert set(ms.fft_radices(m)) <= set(ms.TWO_BUFFER_RADICES)
