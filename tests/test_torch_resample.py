"""The port's resampler (``audio_analysis_torch/ops/resample.py``): equal to
the JAX package's ``resample_poly`` on 1 s of audio at every rate pair the
pipeline meets (max abs 5e-6, the same length), the soxr-HQ spec of
tests/test_resample_quality.py on the port itself, and ``load_recording``
of WAVs at other rates equal to the JAX package's."""

import importlib
import math
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from audio_analysis_torch.io.audio import load_recording
from audio_analysis_torch.ops.resample import design_resample_filter, resample, resample_poly

jr = importlib.import_module("audio_analysis_tpu.ops.resample")

PAIRS = [(32000, 48000), (48000, 16000), (16000, 48000), (96000, 48000), (44100, 48000),
         (22050, 48000)]
# the track pipeline's (-> 48 kHz) and the old index's (-> 16 kHz) pairs
SPEC_PAIRS = [(44100, 48000), (32000, 48000), (22050, 48000), (48000, 16000), (44100, 16000)]


def _resample_np(x, sr_in, sr_out):
    return resample(torch.from_numpy(np.asarray(x, np.float32)), sr_in, sr_out).double().numpy()


@pytest.mark.parametrize("sr_in,sr_out", PAIRS)
def test_equals_jax_resample_poly(sr_in, sr_out):
    x = (0.5 * np.random.RandomState(sr_in % 97).randn(sr_in)).astype(np.float32)
    got = resample(torch.from_numpy(x), sr_in, sr_out)
    ref = np.asarray(jr.resample_poly(jnp.asarray(x), sr_out, sr_in))
    assert got.dtype == torch.float32
    assert got.shape == ref.shape == (-(-sr_in * sr_out // sr_in),)
    assert np.abs(got.numpy() - ref).max() <= 5e-6


@pytest.mark.parametrize("up,down", [(160, 147), (3, 2), (1, 3), (320, 147)])
def test_filter_design_and_bank_equal_jax(up, down):
    from audio_analysis_torch.ops.resample import _polyphase_bank

    np.testing.assert_array_equal(design_resample_filter(up, down),
                                  jr.design_resample_filter(up, down, "hq"))
    bank, r_min = _polyphase_bank(up, down)
    ref, ref_min = jr._polyphase_bank(up, down, "hq")
    assert r_min == ref_min
    np.testing.assert_array_equal(bank, ref)


def _tones(sr, seconds, freqs):
    t = np.arange(int(seconds * sr)) / sr
    return sum(np.sin(2 * np.pi * f * t) for f in freqs)


@pytest.mark.parametrize("sr_in,sr_out", SPEC_PAIRS)
def test_quality_spec(sr_in, sr_out):
    """tests/test_resample_quality.py's spec on the port: band-limited SNR
    > 100 dB, passband ripple < 0.01 dB, alias rejection > 110 dB when
    downsampling, and an impulse landing at k * up / down."""
    nyq = min(sr_in, sr_out) / 2
    edge = sr_out // 10
    freqs = [0.05 * nyq, 0.31 * nyq, 0.72 * nyq]
    y = _resample_np(_tones(sr_in, 2.0, freqs), sr_in, sr_out)
    assert y.shape == (-(-2 * sr_in * sr_out // sr_in),)
    ideal = _tones(sr_out, 2.0, freqs)
    err = y[edge:-edge] - ideal[edge:-edge]
    snr = 10 * np.log10(np.sum(ideal[edge:-edge] ** 2) / np.sum(err**2))
    assert snr > 100.0, snr

    for frac in (0.1, 0.5, 0.8, 0.9):
        seg = _resample_np(_tones(sr_in, 1.0, [frac * 0.913 * nyq]), sr_in, sr_out)[edge:-edge]
        ripple = abs(20 * np.log10(np.sqrt(2.0) * np.sqrt(np.mean(seg**2))))
        assert ripple < 0.01, (frac, ripple)

    if sr_out < sr_in:
        f0 = 0.75 * sr_in / 2
        seg = _resample_np(_tones(sr_in, 1.0, [f0]), sr_in, sr_out)[edge:-edge]
        assert 10 * np.log10(np.mean(seg**2) / 0.5 + 1e-300) < -110.0

    n = sr_in // 4
    x = np.zeros(n)
    x[n // 2] = 1.0
    peak = int(np.argmax(np.abs(_resample_np(x, sr_in, sr_out))))
    assert abs(peak - round(n // 2 * sr_out / sr_in)) <= 1


@pytest.mark.parametrize("sr_in,sr_out", SPEC_PAIRS)
def test_conv_equals_upfirdn_with_the_same_filter(sr_in, sr_out):
    """The convolution against scipy's polyphase upfirdn driving the same
    float64 filter, centred on its group delay."""
    g = math.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    h = design_resample_filter(up, down)
    x = np.random.RandomState(1).randn(sr_in // 8)
    n_out = -(-len(x) * up // down)
    half = (len(h) - 1) // 2
    full = scipy.signal.upfirdn(h, np.pad(x, (0, half)), up, 1)
    ref = full[half : half + len(x) * up : down][:n_out]
    got = resample_poly(torch.from_numpy(x.astype(np.float32)), up, down).double().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_batched_rows_and_identity():
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 3, 4410).astype(np.float32))
    y = resample(x, 44100, 48000)
    assert y.shape == (2, 3, 4800)
    torch.testing.assert_close(y[1, 2], resample(x[1, 2], 44100, 48000), rtol=0, atol=0)
    assert resample(x, 48000, 48000) is x


def _write_wav16(path, y, sr):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.clip(y * 32768.0, -32768, 32767).astype("<i2").tobytes())


@pytest.mark.parametrize("sr", [44100, 32000, 96000])
def test_load_recording_resamples_like_jax(tmp_path, sr):
    """A 16-bit WAV at another rate comes back at 48 kHz as float32, equal
    to the JAX package's load_recording; the int16 fast path stays for
    48 kHz files only."""
    from audio_analysis_tpu.io.audio import load_recording as jax_load_recording

    r = np.random.RandomState(sr % 101)
    y = 0.3 * r.randn(sr).astype(np.float32) + 0.2 * np.sin(2 * np.pi * 2000 * np.arange(sr) / sr)
    path = tmp_path / f"rec{sr}.wav"
    _write_wav16(path, y, sr)
    got, got_sr = load_recording(path, prefer_int16=True, device="cpu")
    ref, ref_sr = jax_load_recording(path, prefer_int16=True)
    assert got_sr == ref_sr == 48000
    assert got.dtype == np.float32 and got.shape == ref.shape == (48000,)
    assert np.abs(got - np.asarray(ref)).max() <= 5e-6
    p48 = tmp_path / "rec48.wav"
    _write_wav16(p48, y[:4800], 48000)
    assert load_recording(p48, prefer_int16=True, device="cpu")[0].dtype == np.int16


def test_load_recording_resamples_on_the_card_unless_cpu_is_asked_for(tmp_path):
    """The resampling device defaults to the card: with no GPU, a file at
    another rate raises instead of quietly resampling on the CPU, while a
    48 kHz file needs no device."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid here")
    y = np.zeros(4410, np.float32)
    _write_wav16(tmp_path / "a.wav", y, 44100)
    _write_wav16(tmp_path / "b.wav", y, 48000)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_recording(tmp_path / "a.wav")
    assert load_recording(tmp_path / "b.wav")[1] == 48000
