"""``stft_mag`` at n_fft the cluster route serves on the card (16384, two
blocks; 32768, four) against the JAX package's Pallas kernel in interpret
mode on the CPU (its plain version on a CPU tensor), as
``tests/test_torch_nfft_routes.py`` holds 4400 and 8192; a file of its
own, as the two interpret runs take most of a minute each."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_analysis_tpu.ops.pallas.melspec import pallas_stft_magnitude

from audio_analysis_torch.ops import melspec as ms

from test_torch_cluster_pallas import _max_rel, _oracle  # noqa: E402


@pytest.mark.parametrize("n_fft", [16384, 32768])
def test_stft_mag_matches_pallas(n_fft):
    """A signal of ten frames (hop n_fft / 8) ending in silence: 5e-5
    against the Pallas exact=2 magnitude (itself ~2e-5 from float64), 1e-6
    against the float64 DFT of the float32-windowed frames."""
    hop = n_fft // 8
    rng = np.random.RandomState(n_fft + 1)
    y = (0.1 * rng.randn(1, n_fft // 2 + 5 * hop)).astype(np.float32)
    y[:, -2 * hop:] = 0.0
    assert ms.stft_plan(n_fft, n_fft // 2 + 1, mel=False)[0] == "cluster"
    got = ms.stft_mag(torch.from_numpy(y), n_fft=n_fft, hop_length=hop).numpy()
    ref = np.asarray(pallas_stft_magnitude(jnp.asarray(y), n_fft=n_fft, hop_length=hop,
                                           interpret=True))
    assert got.shape == ref.shape == (1, n_fft // 2 + 1, 1 + y.shape[1] // hop)
    assert _max_rel(got, ref) < 5e-5
    assert _max_rel(got[0], _oracle(y[0], n_fft, hop, got.shape[2])) < 1e-6
