"""The port's DSP ops (audio_analysis_torch.ops: windows, stft, mel, scale)
against the JAX package's on the same seeded inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_analysis_tpu.ops import mel as jmel
from audio_analysis_tpu.ops import scale as jscale
from audio_analysis_tpu.ops.stft import stft_magnitude as j_stft_magnitude
from audio_analysis_tpu.ops import windows as jwin
from audio_analysis_tpu.ops.pallas.melspec import mel_support_bins as j_support

from audio_analysis_torch.ops import mel as tmel
from audio_analysis_torch.ops import scale as tscale
from audio_analysis_torch.ops import stft as tstft
from audio_analysis_torch.ops import windows as twin


@pytest.mark.parametrize("name", ["hann", "hamming", "blackman", "bartlett", "kaiser", "tukey", "rect"])
@pytest.mark.parametrize("periodic", [True, False])
def test_windows_identical(name, periodic):
    np.testing.assert_array_equal(
        twin.get_window(name, 400, periodic).numpy(),
        np.asarray(jwin.get_window(name, 400, periodic)),
    )


@pytest.mark.parametrize("n_fft,hop", [(512, 160), (480, 120)])
@pytest.mark.parametrize("power", [1.0, 2.0])
def test_stft_magnitude_matches_jax(rng, n_fft, hop, power):
    """librosa centre framing with CONSTANT padding (torch.stft's default
    reflect padding would differ at both ends); atol 1e-5 on magnitudes of
    order 1 is float32 FFT rounding."""
    y = (0.1 * rng.randn(3, 4001)).astype(np.float32)
    got = tstft.stft_magnitude(torch.from_numpy(y), n_fft, hop, power=power).numpy()
    ref = np.asarray(j_stft_magnitude(jnp.asarray(y), n_fft, hop, power=power))
    assert got.shape == ref.shape == (3, n_fft // 2 + 1, 1 + 4001 // hop)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # the float64 DFT of the same float32-windowed frames agrees as well
    got64 = tstft.stft_magnitude(torch.from_numpy(y), n_fft, hop, power=power,
                                 dtype=torch.float64).numpy()
    np.testing.assert_allclose(got64, ref, rtol=0, atol=1e-5)


def test_stft_edges_are_zero_padded(rng):
    """The first frame sees n_fft//2 zeros, not a reflection."""
    y = rng.randn(1, 2000).astype(np.float32)
    mag = tstft.stft_magnitude(torch.from_numpy(y), 256, 64).numpy()
    fr = np.pad(y[0], (128, 128))[:256] * twin.get_window_np("hann", 256)
    np.testing.assert_allclose(mag[0, :, 0], np.abs(np.fft.rfft(fr)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("sr,n_mels,fmin,fmax,n_fft,brk", [
    (48000, 160, 50.0, 11000.0, 4096, 1750.0),
    (48000, 120, 50.0, 11000.0, 4800, 1750.0),
    (16000, 40, 50.0, 7000.0, 512, 1000.0),
])
def test_filterbanks_identical(sr, n_mels, fmin, fmax, n_fft, brk):
    np.testing.assert_array_equal(
        tmel.filterbank_np(sr, n_mels, fmin, fmax, n_fft, brk, True),
        np.asarray(jmel.mel_filterbank(sr, n_mels, fmin, fmax, n_fft, brk)),
    )
    np.testing.assert_array_equal(
        tmel.filterbank_np(sr, n_mels, fmin, fmax, n_fft, brk, False),
        jmel._mel_filterbank_slaney_np(float(sr), n_mels, fmin, fmax, n_fft),
    )
    for htk in (True, False):
        assert tmel.mel_support_bins(sr, n_mels, fmin, fmax, n_fft, brk, htk) == j_support(
            sr, n_mels, fmin, fmax, n_fft, brk, htk
        )


@pytest.mark.parametrize("ref_axes", [None, (-2, -1)])
def test_power_to_db_matches_jax(rng, ref_axes):
    s = (np.abs(rng.randn(3, 20, 30)) ** 4).astype(np.float32)
    s[0, :5] = 0.0  # below amin, and below the 80 dB floor
    got = tscale.power_to_db(torch.from_numpy(s), ref_axes=ref_axes).numpy()
    ref = np.asarray(jscale.power_to_db(jnp.asarray(s), ref_axes=ref_axes))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_normalize_minmax_matches_jax(rng):
    """Including the quirk: epsilon after the division, so an all-zero
    window is NaN on both sides."""
    x = rng.randn(4, 1000).astype(np.float32)
    x[2] = 0.0
    got = tscale.normalize_minmax(torch.from_numpy(x)).numpy()
    ref = np.asarray(jscale.normalize_minmax(jnp.asarray(x)))
    assert np.isnan(got[2]).all() and np.isnan(ref[2]).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
