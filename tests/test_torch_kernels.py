"""Each CUDA kernel of the port against its plain PyTorch version, on a GPU.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips without a card. This file imports neither jax nor the JAX package
and uses no conftest fixture, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from audio_analysis_torch.ops import medians as md
from audio_analysis_torch.ops import melspec as ms


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.RandomState(42)


def _max_rel(got, gt):
    """tests/test_pallas_exact.py's measure."""
    got, gt = got.double().cpu().numpy(), gt.double().cpu().numpy()
    den = np.maximum(np.abs(gt), 1e-3 * np.abs(gt).max())
    return (np.abs(got - gt) / den).max()


# (sr, n_fft, hop, n_mels, fmin, fmax, break, samples, route): the fft route
# at n_fft 512, 480, 4096 (classify), 4800 (end-scan), 4410 (the end-scan at
# 44.1 kHz, radix 7) and the odd 441; fft1 (one buffer) at 4400 (radix 11),
# 832 (radix 13), 1088 (radix 17, the generic prime pass), 8192 and 11025;
# bluestein at the prime 4099; the cluster route (the transform split over
# a thread-block cluster) at 6301 (prime: Bluestein's 12800 points over two
# blocks), 12000, 16384 (two blocks), 24000 (three), 32768 (four) on the
# classify grid, and the prime 29063 (Bluestein's 58320 points over five
# blocks, two frames a cluster), short
MEL_GEOMS = {
    "nfft512": (16000, 512, 160, 40, 50.0, 7000.0, 1750.0, 4000, "fft"),
    "nfft480": (4800, 480, 120, 24, 50.0, 2000.0, 1750.0, 4800, "fft"),
    "classify": (48000, 4096, 640, 160, 50.0, 11000.0, 1750.0, 144000, "fft"),
    "endscan": (48000, 4800, 281, 120, 50.0, 11000.0, 1750.0, 96000, "fft"),
    "nfft4410": (44100, 4410, 281, 120, 50.0, 11000.0, 1750.0, 88200, "fft"),
    "nfft441": (4410, 441, 110, 24, 50.0, 2000.0, 1750.0, 4410, "fft"),
    "nfft4400": (44000, 4400, 281, 120, 50.0, 11000.0, 1750.0, 44000, "fft1"),
    "nfft832": (16000, 832, 160, 40, 50.0, 7000.0, 1750.0, 8000, "fft1"),
    "nfft1088": (16000, 1088, 160, 40, 50.0, 7000.0, 1750.0, 8000, "fft1"),
    "nfft8192": (48000, 8192, 640, 160, 50.0, 11000.0, 1750.0, 144000, "fft1"),
    "nfft11025": (44100, 11025, 441, 120, 50.0, 11000.0, 1750.0, 88200, "fft1"),
    "bluestein4099": (48000, 4099, 281, 120, 50.0, 11000.0, 1750.0, 48000, "bluestein"),
    "cluster6301": (48000, 6301, 640, 120, 50.0, 11000.0, 1750.0, 20000, "cluster"),
    "cluster12000": (48000, 12000, 640, 160, 50.0, 11000.0, 1750.0, 20000, "cluster"),
    "cluster16384": (48000, 16384, 640, 160, 50.0, 11000.0, 1750.0, 20000, "cluster"),
    "cluster24000": (48000, 24000, 640, 160, 50.0, 11000.0, 1750.0, 20000, "cluster"),
    "cluster32768": (48000, 32768, 640, 160, 50.0, 11000.0, 1750.0, 20000, "cluster"),
    "cluster29063": (48000, 29063, 640, 160, 50.0, 11000.0, 1750.0, 20000, "cluster"),
}
ROUTE_COUNTS = ("fft_launches", "fft1_launches", "bluestein_launches", "cluster_launches")


def _route_counts(fn):
    return tuple(getattr(fn, k) for k in ROUTE_COUNTS)


def _counted(before, route):
    """`before` with one more launch of `route`."""
    return tuple(c + (k == f"{route}_launches") for c, k in zip(before, ROUTE_COUNTS))


@pytest.mark.cuda
@pytest.mark.parametrize("geom", list(MEL_GEOMS))
@pytest.mark.parametrize("power", [1.0, 2.0])
def test_stft_mel_kernel_matches_plain(cuda_device, rng, geom, power):
    """Limit 1e-6 max rel: kernel and plain version take the DFT in float64
    (~1e-15 apart) and round alike to float32, so they differ by at most a
    float32 rounding flip. No atomics, so two launches agree bit for bit."""
    sr, n_fft, hop, n_mels, fmin, fmax, brk, s, route = MEL_GEOMS[geom]
    wins = torch.from_numpy(rng.randn(3, s).astype(np.float32)).to(cuda_device)
    kw = dict(sr=sr, n_fft=n_fft, hop_length=hop, n_mels=n_mels, fmin=fmin, fmax=fmax,
              break_freq=brk, power=power)
    before = (ms.stft_mel.launches, _route_counts(ms.stft_mel))
    got = ms.stft_mel(wins, **kw)
    assert (ms.stft_mel.launches, _route_counts(ms.stft_mel)) == (
        before[0] + 1, _counted(before[1], route))
    ref = ms.stft_mel_plain(wins, **kw)
    assert got.shape == ref.shape == (3, n_mels, ms.stft_frames(s, n_fft, hop))
    assert _max_rel(got, ref) <= 1e-6
    assert torch.equal(got, ms.stft_mel(wins, **kw))
    part = ms.stft_mel(wins, frames=7, **kw)
    assert _max_rel(part, ref[..., :7]) <= 1e-6
    slaney = ms.stft_mel(wins, htk=False, **kw)
    assert _max_rel(slaney, ms.stft_mel_plain(wins, htk=False, **kw)) <= 1e-6


# (n_fft, hop, route): 48000 samples give an odd frame count at hop 281
# (171); fft1 at 4400 (radix 11), 1088 and 8704 (radix 17, the generic pass
# held across a barrier), 8192 and 11025; bluestein at the primes 1021 and
# 4099; the cluster at 6301 (Bluestein over two blocks), 12800, 16384 and
# 24000 (two blocks), 32768 (four), the prime 32749 (Bluestein over eight
# blocks of 8192) and 19601 (Bluestein over five blocks of 7875)
MAG_GEOMS = [(4096, 281, "fft"), (480, 120, "fft"), (4800, 281, "fft"), (4410, 256, "fft"),
             (512, 128, "fft"), (441, 100, "fft"), (4400, 281, "fft1"), (1088, 160, "fft1"),
             (8192, 281, "fft1"), (8704, 281, "fft1"), (11025, 441, "fft1"),
             (1021, 256, "bluestein"),
             (4099, 281, "bluestein"), (6301, 640, "cluster"), (12800, 281, "cluster"),
             (16384, 281, "cluster"), (24000, 441, "cluster"), (32768, 281, "cluster"),
             (32749, 640, "cluster"), (19601, 640, "cluster")]


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop,route", MAG_GEOMS)
def test_stft_mag_kernel_matches_plain(cuda_device, rng, n_fft, hop, route):
    y = torch.from_numpy((0.1 * rng.randn(2, 48000)).astype(np.float32)).to(cuda_device)
    y[1, 30000:] = 0.0  # a silent tail: exact zeros on both sides
    before = (ms.stft_mag.launches, _route_counts(ms.stft_mag))
    got = ms.stft_mag(y, n_fft=n_fft, hop_length=hop)
    assert (ms.stft_mag.launches, _route_counts(ms.stft_mag)) == (
        before[0] + 1, _counted(before[1], route))
    ref = ms.stft_mag_plain(y, n_fft=n_fft, hop_length=hop)
    assert got.shape == ref.shape == (2, n_fft // 2 + 1, ms.stft_frames(48000, n_fft, hop))
    assert _max_rel(got, ref) <= 1e-6
    assert torch.equal(got, ms.stft_mag(y, n_fft=n_fft, hop_length=hop))
    tail = slice(1 + (30000 + n_fft // 2) // hop, None)
    assert not bool(got[1, :, tail].any())


@pytest.mark.cuda
def test_stft_mag_batch_of_silent_tails(cuda_device, rng):
    """Eight signals in one launch, each silent from its own point (one not
    at all, one from the start): exact zeros past each tail, an odd frame
    count (1 + 96200 // 281 = 343 frames: 43 tiles of 8, the last of 7, so
    its last pair has one frame), and the plain version's values."""
    y = (0.1 * rng.randn(8, 96200)).astype(np.float32)
    tails = [96200, 90000, 61234, 48000, 30001, 12345, 2000, 0]
    for row, at in zip(y, tails):
        row[at:] = 0.0
    y = torch.from_numpy(y).to(cuda_device)
    got = ms.stft_mag(y, n_fft=4096, hop_length=281)
    ref = ms.stft_mag_plain(y, n_fft=4096, hop_length=281)
    assert got.shape == ref.shape == (8, 2049, 343)
    assert _max_rel(got, ref) <= 1e-6
    for b, at in enumerate(tails):
        silent = 1 + (at + 2048) // 281
        assert not bool(got[b, :, silent:].any())
        assert not bool(ref[b, :, silent:].any())


@pytest.mark.cuda
def test_no_route_fits_raises(cuda_device):
    """n_fft 131072 fits no route, the cluster's eight blocks included:
    ValueError, never the plain version (which computes it on the CPU)."""
    x = torch.zeros(1, 40000, device=cuda_device)
    before = (ms.stft_mag.launches, ms.stft_mel.launches)
    with pytest.raises(ValueError, match="shared memory"):
        ms.stft_mag(x, n_fft=131072, hop_length=4096)
    with pytest.raises(ValueError, match="shared memory"):
        ms.stft_mel(x, sr=48000, n_fft=131072, hop_length=4096, n_mels=40, fmin=50.0,
                    fmax=11000.0)
    assert (ms.stft_mag.launches, ms.stft_mel.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop", [(16384, 640), (6301, 640), (32768, 281)])
def test_cluster_mel_silent_frames(cuda_device, rng, n_fft, hop):
    """The cluster route on windows silent from their own points: the frame
    flags are or-ed over the cluster's blocks, so frames wholly past each
    tail are exact zeros; the rest within 1e-6 of the plain version, two
    launches bit for bit."""
    s = 30 * hop + n_fft
    tails = (s, s // 2, 3 * hop, 0)
    x = (0.1 * rng.randn(len(tails), s)).astype(np.float32)
    for row, at in zip(x, tails):
        row[at:] = 0.0
    x = torch.from_numpy(x).to(cuda_device)
    kw = dict(sr=48000, n_fft=n_fft, hop_length=hop, n_mels=160, fmin=50.0, fmax=11000.0,
              power=2.0)
    before = ms.stft_mel.cluster_launches
    got = ms.stft_mel(x, **kw)
    assert ms.stft_mel.cluster_launches == before + 1
    assert _max_rel(got, ms.stft_mel_plain(x, **kw)) <= 1e-6
    assert torch.equal(got, ms.stft_mel(x, **kw))
    for b, at in enumerate(tails):
        silent = -(-(at + n_fft // 2) // hop)  # first frame wholly past the tail
        assert not bool(got[b, :, silent:].any())


@pytest.mark.cuda
def test_cluster_smem_matches_the_kernel(cuda_device):
    """The host's size of a cluster block's shared memory is the library's,
    fits the card, and the card holds at least one such cluster, for every
    cluster plan of the geometries above."""
    from audio_analysis_torch.ops import cuda as kcuda

    lib = kcuda.library()
    cap = kcuda.smem_optin(cuda_device)
    plans = [(n_fft, n_fft // 2 + 1, False) for n_fft, _, route in MAG_GEOMS if route == "cluster"]
    plans += [(g[1], ms.mel_support_bins(g[0], g[3], g[4], g[5], g[1], g[6], True), True)
              for g in MEL_GEOMS.values() if g[-1] == "cluster"]
    for n_fft, bins, mel in plans:
        c, points, tf = ms.cluster_plan(n_fft, bins, mel=mel, cap=cap)
        smem = ms.cluster_smem(points, c, bins, tf, mel)
        assert lib.aat_stft_cluster_smem(tf, c, points // c, bins, int(mel)) == smem <= cap
        assert lib.aat_stft_cluster_occupancy(tf, c, points // c, bins, int(mel),
                                              int(points != n_fft)) > 0


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    with pytest.raises(ValueError):
        ms.stft_mag(torch.zeros(2, 1000, device=cuda_device, dtype=torch.float64),
                    n_fft=256, hop_length=64)
    with pytest.raises(ValueError):
        ms.stft_mag(torch.zeros(4, 1000, device=cuda_device)[:, ::2], n_fft=256, hop_length=64)
    with pytest.raises(ValueError):
        md.col_medians(torch.zeros(1, 5, 5, device=cuda_device, dtype=torch.float64))


# (sr, n_fft, hop, n_mels, samples, frames): the classify frontend, the
# end-scan's frame prefix, a 4.5 s window of 338 frames, n_fft 2056 over the
# whole band (129 bins a leaf: two bin tiles, leaves padded 257 -> 272), all
# on the dif route, and n_fft % 8 != 0 (direct route, frames by TMA from P
# = 8 / gcd(hop, 8) shifted bf16 copies, one box a class): 500 at hop 125
# (P = 8, 40 mels), the classify grid at n_fft 4410 (hop 640, P = 1), with
# 256 mels, the prime 4099 at hop 281 (P = 8, 120 mels) and a frame prefix
# of 4410
BF16_GEOMS = {
    "classify": (48000, 4096, 640, 160, 144000, None),
    "endscan": (48000, 4800, 281, 120, 96000, 340),
    "long": (48000, 4096, 640, 160, 216000, None),
    "nfft2056": (16000, 2056, 512, 40, 16000, None),
    "nfft500": (16000, 500, 125, 40, 16000, None),
    "nfft4410": (48000, 4410, 640, 160, 144000, None),
    "nfft4410-mel256": (48000, 4410, 640, 256, 48000, None),
    "nfft4099": (48000, 4099, 281, 120, 48000, None),
    "nfft4410-prefix": (48000, 4410, 640, 120, 96000, 131),
}


def _bf16_plain(wins, **kw):
    """The plain version of the route the wrapper takes for kw's n_fft."""
    dif = ms.bf16_route(kw["n_fft"]) == "dif"
    return (ms.stft_mel_dif_bf16_plain if dif else ms.stft_mel_bf16_plain)(wins, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("geom", list(BF16_GEOMS))
@pytest.mark.parametrize("power", [1.0, 1.5, 2.0])
def test_stft_mel_bf16_kernel_matches_plain(cuda_device, rng, geom, power):
    """Limit 1e-2 max rel against the plain version of the same route: one
    bf16 rounding flip of a power term moves a mel value by at most 2^-7 of
    itself; the order of the float32 sums adds ~1e-6. No atomics, so two
    launches agree bit for bit."""
    sr, n_fft, hop, n_mels, s, frames = BF16_GEOMS[geom]
    wins = torch.from_numpy(rng.randn(3, s).astype(np.float32)).to(cuda_device)
    kw = dict(sr=sr, n_fft=n_fft, hop_length=hop, n_mels=n_mels, fmin=50.0,
              fmax=min(11000.0, sr / 2), power=power, frames=frames)
    direct = ms.bf16_route(n_fft) == "direct"
    assert direct == (n_fft % 8 != 0)
    before = (ms.stft_mel_bf16.launches, ms.stft_mel_bf16.direct_launches)
    got = ms.stft_mel_bf16(wins, **kw)
    assert (ms.stft_mel_bf16.launches, ms.stft_mel_bf16.direct_launches) == (
        before[0] + 1, before[1] + direct)
    ref = _bf16_plain(wins, **kw)
    assert got.shape == ref.shape == (3, n_mels, frames or 1 + s // hop)
    assert _max_rel(got, ref) <= 1e-2
    assert torch.equal(got, ms.stft_mel_bf16(wins, **kw))
    slaney = ms.stft_mel_bf16(wins, htk=False, **kw)
    assert _max_rel(slaney, _bf16_plain(wins, htk=False, **kw)) <= 1e-2


# (sr, n_fft, hop, n_mels, fmax, samples, frames): the dif kernel's tiling
# at the classify geometry with frame counts that leave a partial tile of
# 16 (17, 65, 129); 5 levels (n_fft 8192 over the whole band at 48 kHz:
# 4096 support bins, 128 a leaf, 256 mels; one span buffer; at hop 1186
# also one ring stage); 32 bins a leaf (the second consumer warpgroup holds
# none); n_fft 64 (leaves of 8 points padded to 16: TMA boxes larger than
# the tables); the end-scan's geometry at hop 2700 (one span buffer); a
# frame prefix that ends inside a tile
DIF_GEOMS = {
    "frames17": (48000, 4096, 640, 160, 11000.0, 16 * 640, None),
    "frames65": (48000, 4096, 640, 160, 11000.0, 64 * 640 + 100, None),
    "frames129": (48000, 4096, 640, 160, 11000.0, 128 * 640, None),
    "levels5": (48000, 8192, 640, 256, 24000.0, 48000, None),
    "levels5-hop1186": (48000, 8192, 1186, 256, 24000.0, 100000, None),
    "bl32": (16000, 512, 160, 40, 7000.0, 16000, None),
    "nfft64": (16000, 64, 16, 8, 7000.0, 4000, None),
    "hop2700": (48000, 4800, 2700, 120, 11000.0, 300000, None),
    "prefix": (48000, 4800, 281, 120, 11000.0, 96000, 333),
}


@pytest.mark.cuda
@pytest.mark.parametrize("geom", list(DIF_GEOMS))
@pytest.mark.parametrize("power", [1.0, 2.0])
def test_stft_mel_dif_bf16_tiling(cuda_device, rng, geom, power):
    """The dif kernel against its plain version where its tiling has edges:
    max rel 1e-2, the shape, two launches bit for bit, one launch counted
    on the dif route."""
    sr, n_fft, hop, n_mels, fmax, s, frames = DIF_GEOMS[geom]
    wins = torch.from_numpy(rng.randn(2, s).astype(np.float32)).to(cuda_device)
    kw = dict(sr=sr, n_fft=n_fft, hop_length=hop, n_mels=n_mels, fmin=50.0, fmax=fmax,
              power=power, frames=frames)
    assert ms.bf16_route(n_fft) == "dif"
    before = (ms.stft_mel_bf16.launches, ms.stft_mel_bf16.dif_launches)
    got = ms.stft_mel_bf16(wins, **kw)
    assert (ms.stft_mel_bf16.launches, ms.stft_mel_bf16.dif_launches) == (
        before[0] + 1, before[1] + 1)
    ref = ms.stft_mel_dif_bf16_plain(wins, **kw)
    assert got.shape == ref.shape == (2, n_mels, frames or 1 + s // hop)
    assert _max_rel(got, ref) <= 1e-2
    assert torch.equal(got, ms.stft_mel_bf16(wins, **kw))


# (sr, n_fft, hop, n_mels, fmax, htk, samples): the dif split at 6 levels
# (n_fft 24000 and 32768 on the classify geometry), 7 (32768 over the whole
# band at 256 mels: no plan with the band list fits, the mel passes read
# melt) and 8 (the same with Slaney's bank, whose support takes the Nyquist
# bin)
DEEP_DIF_GEOMS = {
    "levels6-nfft24000": (48000, 24000, 640, 160, 11000.0, True, 60000),
    "levels6-nfft32768": (48000, 32768, 640, 160, 11000.0, True, 60000),
    "levels7-nfft32768": (48000, 32768, 640, 256, 24000.0, True, 60000),
    "levels8-nfft32768": (48000, 32768, 640, 256, 24000.0, False, 60000),
}


@pytest.mark.cuda
@pytest.mark.parametrize("geom", list(DEEP_DIF_GEOMS))
def test_stft_mel_dif_bf16_deep_splits(cuda_device, rng, geom):
    """The dif kernel at 6 to 8 levels against its plain version: max rel
    1e-2, two launches bit for bit, one launch counted on the dif route."""
    sr, n_fft, hop, n_mels, fmax, htk, s = DEEP_DIF_GEOMS[geom]
    levels = int(geom[6])
    wins = torch.from_numpy(rng.randn(2, s).astype(np.float32)).to(cuda_device)
    kw = dict(sr=sr, n_fft=n_fft, hop_length=hop, n_mels=n_mels, fmin=50.0, fmax=fmax,
              htk=htk, power=1.0)
    assert ms._dif_consts(sr, n_mels, 50.0, fmax, n_fft, 1750.0, htk, "cpu")[6] == levels
    before = ms.stft_mel_bf16.dif_launches
    got = ms.stft_mel_bf16(wins, **kw)
    assert ms.stft_mel_bf16.dif_launches == before + 1
    ref = ms.stft_mel_dif_bf16_plain(wins, **kw)
    assert got.shape == ref.shape == (2, n_mels, 1 + s // hop)
    assert _max_rel(got, ref) <= 1e-2
    assert torch.equal(got, ms.stft_mel_bf16(wins, **kw))


@pytest.mark.cuda
def test_stft_mel_bf16_above_8_levels_raises(cuda_device):
    """n_fft 65536 over the whole band needs a 9-level split, past the
    kernel's 8: ValueError on the card (the JAX package's ``_kernel_dif``
    computes it: an open divergence)."""
    x = torch.zeros(1, 70000, device=cuda_device)
    with pytest.raises(ValueError, match="9 levels"):
        ms.stft_mel_bf16(x, sr=48000, n_fft=65536, hop_length=640, n_mels=256, fmin=50.0,
                         fmax=24000.0, htk=False)


@pytest.mark.cuda
def test_dif_smem_matches_the_kernel(cuda_device):
    """The host's size of a dif block's shared memory is the library's for
    every plan, and some plan fits the card at every geometry above."""
    from audio_analysis_torch.ops import cuda as kcuda

    lib = kcuda.library()
    cap = kcuda.smem_optin(cuda_device)
    geoms = [(sr, n_fft, hop, n_mels, fmax, True) for sr, n_fft, hop, n_mels, fmax, _, _
             in DIF_GEOMS.values()]
    geoms += [g[:6] for g in DEEP_DIF_GEOMS.values()]
    for sr, n_fft, hop, n_mels, fmax, htk in geoms:
        *_, melt, levels, _, bl = ms._dif_consts(sr, n_mels, 50.0, fmax, n_fft, 1750.0, htk,
                                                 "cpu")
        rows = melt.shape[0]
        for plan in ms.DIF_PLANS:
            assert lib.aat_stft_mel_dif_bf16_smem(hop, n_fft, levels, bl, rows,
                                                  *plan) == ms.dif_smem(hop, n_fft, levels, bl,
                                                                        rows, *plan)
        assert ms.dif_plan(hop, n_fft, levels, bl, rows, cap) is not None


@pytest.mark.cuda
@pytest.mark.parametrize("samples,tails", [
    (96001, (96001, 50000, 20001, 0)),  # 342 frames at hop 281: 21 tiles of 16, then 6
    (48281, (48281, 40000, 30000, 1)),  # 172 frames
    # the first frame checked silent is 80 (a tile's first), 81, 79 and 96
    (96001, (79 * 281 - 2400, 80 * 281 - 2400, 78 * 281 - 2400, 95 * 281 - 2400)),
])
def test_stft_mel_dif_bf16_silent_frames_and_odd_counts(cuda_device, rng, samples, tails):
    """The end-scan's geometry (n_fft 4800, 120 mels, power 1) on windows
    silent from their own points: frames past each tail come out as exact
    zeros, the rest within 1e-2 of the plain version, two launches bit for
    bit."""
    x = (0.1 * rng.randn(len(tails), samples)).astype(np.float32)
    for row, at in zip(x, tails):
        row[at:] = 0.0
    x = torch.from_numpy(x).to(cuda_device)
    kw = dict(sr=48000, n_fft=4800, hop_length=281, n_mels=120, fmin=50.0, fmax=11000.0,
              power=1.0)
    got = ms.stft_mel_bf16(x, **kw)
    ref = ms.stft_mel_dif_bf16_plain(x, **kw)
    assert got.shape == ref.shape == (len(tails), 120, 1 + samples // 281)
    assert _max_rel(got, ref) <= 1e-2
    assert torch.equal(got, ms.stft_mel_bf16(x, **kw))
    for b, at in enumerate(tails):
        silent = 1 + (at + 2400) // 281  # first frame wholly past the tail
        assert not bool(got[b, :, silent:].any())


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop", [(4410, 640), (4099, 281), (500, 125)])
def test_stft_mel_bf16_direct_silent_frames_and_nan_rows(cuda_device, rng, n_fft, hop):
    """The direct route on windows silent from their own points, one window
    not finite (all-zero audio normalises to NaN) and one all zero: frames
    wholly past each tail come out as exact zeros, the NaN window stays in
    its own rows, the finite rows are within 1e-2 of the plain version, two
    launches bit for bit; at hop 640 (one copy, P = 1) and at hops 281
    and 125 (P = 8 shifted copies, one TMA box a class)."""
    s = 40 * hop + n_fft
    tails = (s, s // 2, 3 * hop, 0)
    x = (0.1 * rng.randn(len(tails) + 1, s)).astype(np.float32)
    for row, at in zip(x, tails):
        row[at:] = 0.0
    x[-1] = np.nan
    x = torch.from_numpy(x).to(cuda_device)
    kw = dict(sr=48000, n_fft=n_fft, hop_length=hop, n_mels=64, fmin=50.0, fmax=11000.0,
              power=1.0)
    before = ms.stft_mel_bf16.direct_launches
    got = ms.stft_mel_bf16(x, **kw)
    assert ms.stft_mel_bf16.direct_launches == before + 1
    ref = ms.stft_mel_bf16_plain(x, **kw)
    fin = slice(0, len(tails))
    assert bool(torch.isfinite(got[fin]).all())
    assert bool(torch.isnan(got[-1]).all()) and bool(torch.isnan(ref[-1]).all())
    assert _max_rel(got[fin], ref[fin]) <= 1e-2
    again = ms.stft_mel_bf16(x, **kw)
    assert torch.equal(got[fin], again[fin])
    for b, at in enumerate(tails):
        silent = -(-(at + n_fft // 2) // hop)  # first frame wholly past the tail
        assert not bool(got[b, :, silent:].any())


@pytest.mark.cuda
def test_direct_smem_matches_the_kernel(cuda_device):
    """The host's size of a direct block's shared memory is the library's,
    for every mel capacity, and fits the card."""
    from audio_analysis_torch.ops import cuda as kcuda

    lib = kcuda.library()
    for rows in ms.BF16_MEL_ROWS:
        assert lib.aat_stft_mel_bf16_smem(rows) == ms.direct_smem(rows) <= lib.aat_smem_optin()


@pytest.mark.cuda
def test_stft_mel_bf16_matmul_forces_the_direct_route(cuda_device, rng, monkeypatch):
    """AAT_PALLAS_ALG=matmul sends the classify shape to the direct kernel,
    read at each call, as the JAX package's ``_use_dif``."""
    wins = torch.from_numpy(rng.randn(2, 48000).astype(np.float32)).to(cuda_device)
    kw = dict(sr=48000, n_fft=4096, hop_length=640, n_mels=160, fmin=50.0, fmax=11000.0)
    monkeypatch.setenv("AAT_PALLAS_ALG", "matmul")
    before = ms.stft_mel_bf16.direct_launches
    got = ms.stft_mel_bf16(wins, **kw)
    assert ms.stft_mel_bf16.direct_launches == before + 1
    assert _max_rel(got, ms.stft_mel_bf16_plain(wins, **kw)) <= 1e-2
    monkeypatch.delenv("AAT_PALLAS_ALG")
    ms.stft_mel_bf16(wins, **kw)
    assert ms.stft_mel_bf16.direct_launches == before + 1


@pytest.mark.cuda
def test_bf16_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    kw = dict(sr=16000, n_fft=512, hop_length=160, fmin=50.0, fmax=7000.0)
    x = torch.zeros(2, 4000, device=cuda_device)
    with pytest.raises(ValueError):
        ms.stft_mel_bf16(x, n_mels=257, **kw)
    with pytest.raises(ValueError):
        ms.stft_mel_bf16(x.double(), n_mels=40, **kw)
    with pytest.raises(ValueError):
        ms.stft_mel_bf16(x, n_mels=40, power=0.0, **kw)


def _spec(rng, kind, bins, t):
    if kind == "equal":
        return np.full((bins, t), 0.375, np.float32)
    if kind == "ties":
        return (rng.randint(0, 4, size=(bins, t)) * 0.25).astype(np.float32)
    if kind == "zeros":
        x = np.abs(rng.randn(bins, t)).astype(np.float32)
        x[rng.rand(bins, t) < 0.7] = 0.0
        return x
    return (np.abs(rng.randn(bins, t)) ** 3).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,bins,t,nvf", [
    ("random", 37, 50, 50), ("random", 38, 51, 33), ("ties", 41, 64, 64),
    ("ties", 40, 60, 21), ("zeros", 33, 45, 44), ("zeros", 34, 45, 1),
    ("random", 2049, 2000, 1500), ("equal", 16, 40, 40), ("equal", 16, 41, 7),
    ("ties", 24, 30, 2), ("zeros", 9, 12, 3), ("ties", 2049, 10250, 8883),
    ("random", 2049, 10250, 8884),
])
def test_median_kernels_equal_plain(cuda_device, rng, kind, bins, t, nvf):
    spec = torch.from_numpy(_spec(rng, kind, bins, t))[None].to(cuda_device)
    nv = torch.tensor([nvf], device=cuda_device)
    before = (md.row_medians.launches, md.col_medians.launches)
    row, col = md.masked_medians_rowcol(spec, nv)
    assert (md.row_medians.launches, md.col_medians.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(row, md.row_medians_plain(spec, nv))
    assert torch.equal(col, md.col_medians_plain(spec))
    np_row = np.median(spec[0, :, :nvf].cpu().numpy(), axis=1).astype(np.float32)
    assert np.array_equal(row[0, :, 0].cpu().numpy(), np_row)


@pytest.mark.cuda
def test_median_kernels_batch(cuda_device, rng):
    spec = torch.from_numpy(np.stack([_spec(rng, "random", 50, 70) for _ in range(3)]))
    spec = spec.to(cuda_device)
    nv = torch.tensor([70, 13, 2], device=cuda_device)
    assert torch.equal(md.row_medians(spec, nv), md.row_medians_plain(spec, nv))
    assert torch.equal(md.col_medians(spec), md.col_medians_plain(spec))


def _scaled(rng, bins, t):
    """A spectrogram-like [bins, t] block scaled into [0, 1], as detection
    normalises by a_max."""
    x = (np.abs(rng.randn(bins, t)) ** 3).astype(np.float32)
    return x / x.max()


@pytest.mark.cuda
@pytest.mark.parametrize("bins,t,tail", [
    (2049, 10250, 1367),  # 60 s at hop 281, silent from 52 s: the last 1,367 columns zero
    (2049, 1003, 0),      # T not a multiple of the 8-column tile
    (2049, 5, 0),         # T smaller than one tile
    (2048, 21, 6),        # an even row count: the successor pass
    (2080, 37, 9),        # the tallest column held in registers
    (2081, 19, 3),        # the shortest column read from device memory
    (1, 9, 0), (2, 17, 4), (64, 3, 1),
])
def test_col_medians_tiles_and_silent_tails(cuda_device, rng, bins, t, tail):
    """Bit for bit against the plain version and np.median over every
    column, the all-zero tail included."""
    x = _scaled(rng, bins, t)
    x[:, t - tail:] = 0.0
    spec = torch.from_numpy(x)[None].to(cuda_device)
    before = md.col_medians.launches
    got = md.col_medians(spec)
    assert md.col_medians.launches == before + 1
    assert got.shape == (1, 1, t)
    assert torch.equal(got, md.col_medians_plain(spec))
    want = np.median(x, axis=0).astype(np.float32)
    np.testing.assert_array_equal(got[0, 0].cpu().numpy().view(np.int32), want.view(np.int32))
    assert not bool(got[0, 0, t - tail:].any())


@pytest.mark.cuda
def test_col_medians_batch_of_silent_tails(cuda_device, rng):
    """Eight recordings in one launch, each with its own all-zero tail (one
    without, one all zero), as the fast batch gives them: bit for bit
    against the plain version."""
    tails = [0, 1367, 2000, 5, 1999, 800, 8, 123]
    x = np.stack([_scaled(rng, 2049, 2000) for _ in tails])
    for rec, tail in zip(x, tails):
        rec[:, 2000 - tail:] = 0.0
    spec = torch.from_numpy(x).to(cuda_device)
    got = md.col_medians(spec)
    assert got.shape == (8, 1, 2000)
    assert torch.equal(got, md.col_medians_plain(spec))
    for b, tail in enumerate(tails):
        assert not bool(got[b, 0, 2000 - tail:].any())
        if tail < 2000:
            assert bool(got[b, 0, : 2000 - tail].all())


@pytest.mark.cuda
def test_median_kernels_read_device_memory_beyond_shared_memory(cuda_device, rng):
    """Lines longer than shared memory holds are searched in place: still
    exact."""
    spec = torch.from_numpy(_spec(rng, "ties", 3, 70000))[None].to(cuda_device)
    nv = torch.tensor([65001], device=cuda_device)
    assert torch.equal(md.row_medians(spec, nv), md.row_medians_plain(spec, nv))
    tall = torch.from_numpy(_spec(rng, "random", 70001, 3))[None].to(cuda_device)
    assert torch.equal(md.col_medians(tall), md.col_medians_plain(tall))
