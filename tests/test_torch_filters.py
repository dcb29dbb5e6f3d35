"""The port's band-pass filter (``audio_analysis_torch/ops/filters.py``):
the host Butterworth design equal to the JAX package's, and ``sosfilt``
held to float64 ``scipy.signal.sosfilt`` within 1e-3 of the output's
scale, and to the JAX package's float32 ``sosfilt`` within 1e-2 (the JAX
scan itself is off scipy by up to ~6e-3 of scale at 50-11000 and 100-300
Hz)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from audio_analysis_torch.ops import filters as tf

jf = importlib.import_module("audio_analysis_tpu.ops.filters")

SR = 48000
BANDS = [(1000, 8000), (50, 11000), (0, 5000), (600, 1200), (100, 300)]


def _scipy(sos, x):
    """float64 scipy.signal.sosfilt of (b0, b1, b2, a1, a2) sections."""
    s6 = np.array([[b0, b1, b2, 1.0, a1, a2] for b0, b1, b2, a1, a2 in sos])
    return scipy.signal.sosfilt(s6, np.asarray(x, np.float64))


@pytest.fixture(scope="module")
def noise():
    return (0.3 * np.random.RandomState(7).randn(4, 3 * SR)).astype(np.float32)


@pytest.mark.parametrize("fs", [48000.0, 32000.0, 16000.0])
@pytest.mark.parametrize("low,high", BANDS + [(2900, 3100), (0, 700)])
def test_butter_design_equals_jax(low, high, fs):
    if high >= fs / 2:
        high = 0.45 * fs  # a band edge below Nyquist
    got = tf.butter_bandpass_sos(float(low), float(high), fs)
    assert got == jf.butter_bandpass_sos(float(low), float(high), fs)
    assert len(got) == (1 if low <= 0 else 2)


@pytest.mark.parametrize("low,high", BANDS)
def test_sosfilt_against_scipy_and_jax(noise, low, high):
    sos = tf.butter_bandpass_sos(float(low), float(high), float(SR))
    got = tf.sosfilt(sos, torch.from_numpy(noise))
    assert got.dtype == torch.float32 and got.shape == noise.shape
    got = got.numpy().astype(np.float64)
    ref = _scipy(sos, noise)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-3 * scale
    jax_out = np.asarray(jf.sosfilt(sos, jnp.asarray(noise)))
    assert np.abs(got - jax_out).max() <= 1e-2 * scale


def test_sosfilt_array_per_row_filters_with_identity_padding(noise):
    """One filter a row, a 1-section low-pass padded with an identity
    section beside 2-section band-passes (the track stack's layout), equal
    to each row's own sosfilt and near scipy."""
    bands = [(0, 5000), (1000, 8000), (600, 1200), (0, 700)]
    sos = [tf.butter_bandpass_sos(float(lo), float(hi), float(SR)) for lo, hi in bands]
    arr = np.zeros((4, 2, 5))
    arr[:, :, 0] = 1.0
    for i, s in enumerate(sos):
        arr[i, : len(s)] = s
    got = tf.sosfilt_array(arr, torch.from_numpy(noise)).numpy()
    for i, s in enumerate(sos):
        row = tf.sosfilt(s, torch.from_numpy(noise[i])).numpy()
        np.testing.assert_array_equal(got[i], row)
        ref = _scipy(s, noise[i])
        assert np.abs(got[i] - ref).max() <= 1e-3 * np.abs(ref).max()


@pytest.mark.parametrize("shape", [(1,), (5,), (2, 3, 1000)])
def test_sosfilt_shapes_and_impulse(shape):
    """Any leading shape, lengths below the scan's first step, and the
    impulse response of a narrow band against scipy's."""
    sos = tf.butter_bandpass_sos(100.0, 300.0, float(SR))
    x = np.zeros(shape, np.float32)
    x[..., 0] = 1.0
    got = tf.sosfilt(sos, torch.from_numpy(x)).numpy()
    ref = _scipy(sos, x)
    assert got.shape == x.shape
    assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()

