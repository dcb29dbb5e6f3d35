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


# (sr, n_fft, hop, n_mels, fmin, fmax, break, samples)
MEL_GEOMS = {
    "nfft512": (16000, 512, 160, 40, 50.0, 7000.0, 1750.0, 4000),
    "nfft480": (4800, 480, 120, 24, 50.0, 2000.0, 1750.0, 4800),
    "classify": (48000, 4096, 640, 160, 50.0, 11000.0, 1750.0, 144000),
    "endscan": (48000, 4800, 281, 120, 50.0, 11000.0, 1750.0, 96000),
}


@pytest.mark.cuda
@pytest.mark.parametrize("geom", list(MEL_GEOMS))
@pytest.mark.parametrize("power", [1.0, 2.0])
def test_stft_mel_kernel_matches_plain(cuda_device, rng, geom, power):
    sr, n_fft, hop, n_mels, fmin, fmax, brk, s = MEL_GEOMS[geom]
    wins = torch.from_numpy(rng.randn(3, s).astype(np.float32)).to(cuda_device)
    kw = dict(sr=sr, n_fft=n_fft, hop_length=hop, n_mels=n_mels, fmin=fmin, fmax=fmax,
              break_freq=brk, power=power)
    before = ms.stft_mel.launches
    got = ms.stft_mel(wins, **kw)
    assert ms.stft_mel.launches == before + 1
    ref = ms.stft_mel_plain(wins, **kw)
    assert got.shape == ref.shape == (3, n_mels, 1 + s // hop)
    assert _max_rel(got, ref) < 1e-5
    part = ms.stft_mel(wins, frames=7, **kw)
    assert _max_rel(part, ref[..., :7]) < 1e-5
    slaney = ms.stft_mel(wins, htk=False, **kw)
    assert _max_rel(slaney, ms.stft_mel_plain(wins, htk=False, **kw)) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop", [(4096, 281), (480, 120)])
def test_stft_mag_kernel_matches_plain(cuda_device, rng, n_fft, hop):
    y = torch.from_numpy((0.1 * rng.randn(2, 48000)).astype(np.float32)).to(cuda_device)
    y[1, 30000:] = 0.0  # a silent tail: exact zeros on both sides
    before = ms.stft_mag.launches
    got = ms.stft_mag(y, n_fft=n_fft, hop_length=hop)
    assert ms.stft_mag.launches == before + 1
    ref = ms.stft_mag_plain(y, n_fft=n_fft, hop_length=hop)
    assert got.shape == ref.shape == (2, n_fft // 2 + 1, 1 + 48000 // hop)
    assert _max_rel(got, ref) < 1e-5
    tail = slice(1 + (30000 + n_fft // 2) // hop, None)
    assert not bool(got[1, :, tail].any())


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
# end-scan's frame prefix, a 4.5 s window of 338 frames, n_fft % 8 != 0
BF16_GEOMS = {
    "classify": (48000, 4096, 640, 160, 144000, None),
    "endscan": (48000, 4800, 281, 120, 96000, 340),
    "long": (48000, 4096, 640, 160, 216000, None),
    "nfft500": (16000, 500, 125, 40, 16000, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("geom", list(BF16_GEOMS))
@pytest.mark.parametrize("power", [1.0, 2.0])
def test_stft_mel_bf16_kernel_matches_plain(cuda_device, rng, geom, power):
    """Limit 1e-2 max rel: one bf16 rounding flip of a power term moves a
    mel value by at most 2^-7 of itself; the order of the float32 sums adds
    ~1e-6. No atomics, so two launches agree bit for bit."""
    sr, n_fft, hop, n_mels, s, frames = BF16_GEOMS[geom]
    wins = torch.from_numpy(rng.randn(3, s).astype(np.float32)).to(cuda_device)
    kw = dict(sr=sr, n_fft=n_fft, hop_length=hop, n_mels=n_mels, fmin=50.0,
              fmax=min(11000.0, sr / 2), power=power, frames=frames)
    before = ms.stft_mel_bf16.launches
    got = ms.stft_mel_bf16(wins, **kw)
    assert ms.stft_mel_bf16.launches == before + 1
    ref = ms.stft_mel_bf16_plain(wins, **kw)
    assert got.shape == ref.shape == (3, n_mels, frames or 1 + s // hop)
    assert _max_rel(got, ref) <= 1e-2
    assert torch.equal(got, ms.stft_mel_bf16(wins, **kw))
    slaney = ms.stft_mel_bf16(wins, htk=False, **kw)
    assert _max_rel(slaney, ms.stft_mel_bf16_plain(wins, htk=False, **kw)) <= 1e-2


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
    ("random", 2049, 2000, 1500),
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


@pytest.mark.cuda
def test_median_kernels_read_device_memory_beyond_shared_memory(cuda_device, rng):
    """Lines longer than shared memory holds are searched in place: still
    exact."""
    spec = torch.from_numpy(_spec(rng, "ties", 3, 70000))[None].to(cuda_device)
    nv = torch.tensor([65001], device=cuda_device)
    assert torch.equal(md.row_medians(spec, nv), md.row_medians_plain(spec, nv))
    tall = torch.from_numpy(_spec(rng, "random", 70001, 3))[None].to(cuda_device)
    assert torch.equal(md.col_medians(tall), md.col_medians_plain(tall))
