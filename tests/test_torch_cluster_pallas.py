"""The float64 DFTs at n_fft the cluster route serves on the card (16384,
two blocks; 32768, four; the prime 6301, Bluestein over two blocks),
against the JAX package on the CPU: ``stft_mel`` (its plain version on a
CPU tensor) against the Pallas kernel in interpret mode, as
``tests/test_torch_nfft_routes.py`` holds 4400 and 8192, and, at 6301,
which the Pallas functions do not take (n_fft % 8 != 0), ``stft_mag``
against the JAX package's ``stft_magnitude`` (``stft_mag`` against the
Pallas kernel at 16384 and 32768: ``tests/test_torch_cluster_pallas_mag.py``). The cluster
kernels are held against these plain versions on a GPU
(``tests/test_torch_kernels.py``) and transcribed in
``tests/test_torch_cluster_fft.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_analysis_tpu.ops.pallas.melspec import pallas_mel_spectrogram
from audio_analysis_tpu.ops.stft import stft_magnitude as j_stft_magnitude

from audio_analysis_torch.ops import melspec as ms
from audio_analysis_torch.ops.windows import get_window_np


def _max_rel(got, gt):
    """tests/test_pallas_exact.py's measure."""
    den = np.maximum(np.abs(gt), 1e-3 * np.abs(gt).max())
    return (np.abs(got - gt) / den).max()


def _oracle(y, n_fft, hop, n_frames):
    """|rfft| in float64 of the float32-windowed centre-padded frames."""
    half = n_fft // 2
    x = np.pad(y, (half, half))
    frames = np.stack([x[i * hop: i * hop + n_fft] for i in range(n_frames)])
    frames = (frames * get_window_np("hann", n_fft, periodic=True)).astype(np.float64)
    return np.abs(np.fft.rfft(frames, axis=-1)).T


@pytest.mark.parametrize("n_fft,power", [(16384, 2.0), (32768, 1.0)])
def test_stft_mel_matches_pallas(n_fft, power):
    """Two windows of three frames at the classify geometry: limit 1e-5 max
    rel, as the 8192 case (the Pallas kernel's exact=2 split products carry
    ~1e-6); the card takes the cluster route for this shape."""
    rng = np.random.RandomState(n_fft)
    wins = rng.randn(2, 2 * 640).astype(np.float32)
    kw = dict(sr=48000, n_fft=n_fft, hop_length=640, n_mels=160, fmin=50.0, fmax=11000.0,
              power=power)
    bins = ms.mel_support_bins(48000, 160, 50.0, 11000.0, n_fft, 1750.0, True)
    assert ms.stft_plan(n_fft, bins, mel=True)[0] == "cluster"
    got = ms.stft_mel(torch.from_numpy(wins), **kw).numpy()
    ref = np.asarray(pallas_mel_spectrogram(jnp.asarray(wins), interpret=True, exact=2, **kw))
    assert got.shape == ref.shape == (2, 160, 3)
    assert _max_rel(got, ref) < 1e-5


def test_stft_mag_matches_jax_stft_at_6301():
    """The prime 6301 (Bluestein over a cluster on the card): against the JAX
    package's ``stft_magnitude`` (a float32 FFT, atol 1e-5 of the largest
    magnitude; odd n_fft frames alike) and 1e-6 against the float64 DFT."""
    n_fft, hop = 6301, 640
    rng = np.random.RandomState(6301)
    y = (0.1 * rng.randn(1, 12000)).astype(np.float32)
    y[:, -3000:] = 0.0
    assert ms.stft_plan(n_fft, n_fft // 2 + 1, mel=False)[0] == "cluster"
    got = ms.stft_mag(torch.from_numpy(y), n_fft=n_fft, hop_length=hop).numpy()
    ref = np.asarray(j_stft_magnitude(jnp.asarray(y), n_fft, hop))
    n = min(got.shape[2], ref.shape[2])
    assert got.shape[:2] == ref.shape[:2] == (1, 3151) and n == got.shape[2]
    np.testing.assert_allclose(got, ref[..., :n], rtol=0, atol=1e-5 * np.abs(ref).max())
    assert _max_rel(got[0], _oracle(y[0], n_fft, hop, n)) < 1e-6
