"""The port's PCM wire codec (``audio_analysis_torch/io/pcmcodec.py`` and
``native/pcmcodec.cpp``) against the JAX package's on the CPU: every
encode equal field by field (native encoder and numpy version) over
tests/test_pcmcodec.py's cases, the torch decode bit for bit equal to the
JAX decode (CPU backend) and to ``decode_pcm_np``, a hand-built encoding
with a width-32 tier, exceptions in a width-0 block and wrapping
integrations, the raw-upload rule, and ``AAT_WIRE_CODEC``'s words."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import audio_analysis_tpu.io.pcmcodec as jpc
import audio_analysis_tpu.native as jnat

import audio_analysis_torch.io.pcmcodec as pc
import audio_analysis_torch.native as nat

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the hand-built encoding)

import test_pcmcodec  # noqa: E402  (the JAX package's codec cases)


def _cases():
    """tests/test_pcmcodec.py's cases, plus its pFOR outliers, a spike in
    digital silence, white noise, band-limited audio and odd lengths."""
    rng = np.random.RandomState(0)
    cases = test_pcmcodec._cases(rng)
    x = np.clip(rng.randn(2, 48000) * 40, -32768, 32767).astype(np.int16)
    spikes = rng.choice(x.shape[1], size=60, replace=False)
    x[0, spikes] = 32000
    x[1, spikes[:30]] = -32000
    cases["pfor_outliers"] = x
    x = np.zeros((1, 4 * pc.BLOCK), np.int16)
    x[0, pc.BLOCK + 7] = 12345
    cases["spike_in_silence"] = x
    cases["white_noise"] = np.clip(rng.randn(2, 96000) * 328, -32768, 32767).astype(np.int16)
    t = np.arange(4 * 48000) / 48000
    y = sum(a * np.sin(2 * np.pi * f * t) for f, a in ((400, 0.05), (900, 0.03), (2500, 0.01)))
    cases["band_limited"] = (y * 32767).astype(np.int16)[None]
    cases["odd_lengths"] = np.clip(rng.randn(3, 3 * pc.BLOCK + 77) * 3000, -32768,
                                   32767).astype(np.int16)
    return cases


CASES = _cases()


def _same_encoding(got, ref):
    assert got.shape == ref.shape and got.n_valid == ref.n_valid and got.order == ref.order
    assert sorted(got.tiers) == sorted(ref.tiers)
    for w in got.tiers:
        for a, b in zip(got.tiers[w], ref.tiers[w]):
            assert a.dtype == b.dtype and np.array_equal(a, b), w
    assert (got.exceptions is None) == (ref.exceptions is None)
    if got.exceptions is not None:
        for a, b in zip(got.exceptions, ref.exceptions):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.fixture(params=["native", "numpy"])
def encoder(request, monkeypatch):
    """Both packages' encoders on the native library, or both on numpy."""
    if request.param == "native":
        if nat.load_pcmcodec_library() is None or jnat.load_pcmcodec_library() is None:
            pytest.fail("the native encoder did not build (g++ is part of this image)")
    else:
        monkeypatch.setitem(nat._LIBS, "pcmcodec", None)
        monkeypatch.setitem(jnat._LIBS, "pcmcodec", None)
    return request.param


@pytest.mark.parametrize("order", [None, 0, 1, 2, 3])
@pytest.mark.parametrize("name", sorted(CASES))
def test_encode_equals_jax_and_decode_is_exact(encoder, name, order):
    """The port's encode equals the JAX package's field by field; the torch
    decode on the CPU equals the JAX decode and decode_pcm_np bit for bit,
    and gives back the samples."""
    x = CASES[name]
    enc = pc.encode_pcm(x, order=order)
    _same_encoding(enc, jpc.encode_pcm(x, order=order))
    got = pc.decode_pcm(enc, "cpu")
    assert got.dtype == torch.int16 and tuple(got.shape) == enc.shape
    got = got.numpy()
    assert np.array_equal(got, pc.decode_pcm_np(enc))
    assert np.array_equal(got, np.asarray(jpc.decode_pcm(jpc.EncodedPCM(*enc))))
    assert np.array_equal(got[:, : enc.n_valid], x if x.ndim == 2 else x[None])


def test_encoder_cases_reach_what_they_name():
    """The cases hit order 0 (white noise), exceptions (outliers, the spike
    in silence, which leaves no tier), and a wire win on band-limited
    audio, as tests/test_pcmcodec.py requires of the JAX encoder."""
    assert pc.encode_pcm(CASES["white_noise"]).order == 0
    enc = pc.encode_pcm(CASES["pfor_outliers"], order=0)
    assert enc.exceptions is not None and max(enc.tiers) < 15
    enc = pc.encode_pcm(CASES["spike_in_silence"], order=0)
    assert enc.exceptions is not None and not enc.tiers
    x = CASES["band_limited"]
    assert x.nbytes / pc.wire_bytes(pc.encode_pcm(x)) > 1.8


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_decode_of_hand_built_encoding(order):
    """chip_smoke.codec_edge_case: a width-32 tier (32-bit words, no shift),
    width-0 blocks with exceptions in one, pad rows and a pad exception on
    the dummy row, int32 wraparound in the integrations: the three decoders
    agree bit for bit. An explicit width-0 tier (the JAX formula shifts its
    word right by 32) decodes to zeros as in the JAX package."""
    enc = chip_smoke.codec_edge_case(order, seed=order)
    assert 32 in enc.tiers and enc.exceptions is not None
    got = pc.decode_pcm(enc, "cpu").numpy()
    assert np.array_equal(got, pc.decode_pcm_np(enc))
    assert np.array_equal(got, np.asarray(jpc.decode_pcm(jpc.EncodedPCM(*enc))))
    tiers = {**enc.tiers, 0: (np.asarray([2, 8], np.int32), np.zeros((2, 0), np.int32))}
    enc0 = enc._replace(tiers=tiers)
    assert np.array_equal(pc.decode_pcm(enc0, "cpu").numpy(),
                          np.asarray(jpc.decode_pcm(jpc.EncodedPCM(*enc0))))
    assert np.array_equal(pc.decode_pcm(enc0, "cpu").numpy(), got)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_raw_upload_rule(monkeypatch, as_tensor):
    """tests/test_pcmcodec.py:222: incompressible samples go raw (BLOCK-padded,
    no decode), compressible ones through the decode; both exact. The rule
    takes the stack as numpy or as a host tensor (batch serving's pinned
    stack)."""
    rng = np.random.RandomState(1)
    loud = np.clip(rng.randn(2, 48000 + 5) * 9000, -32768, 32767).astype(np.int16)
    tonal = (np.sin(np.arange(2 * 48000).reshape(2, -1) / 9.0) * 8000).astype(np.int16)
    decoded = []
    real_decode = pc.decode_pcm
    monkeypatch.setattr(pc, "decode_pcm", lambda *a: decoded.append(1) or real_decode(*a))
    for x, raw in ((loud, True), (tonal, False)):
        enc = pc.encode_pcm(x)
        assert (pc.wire_bytes(enc) >= x.nbytes) == raw
        n = len(decoded)
        arg = torch.from_numpy(x) if as_tensor else x
        up = pc.upload_pcm_encoded(arg, enc, "cpu")
        assert len(decoded) == n + (not raw)
        assert up.shape[1] % pc.BLOCK == 0 and np.array_equal(up.numpy()[:, : x.shape[1]], x)
        assert not up.numpy()[:, x.shape[1]:].any()
        assert np.array_equal(np.asarray(jpc.upload_pcm(x)), up.numpy())
    assert np.array_equal(pc.upload_pcm(tonal[0], "cpu").numpy(),
                          np.asarray(jpc.upload_pcm(tonal[0])))


@pytest.mark.parametrize("value", [None, "", "0", "off", "OFF", "false", "False", "1", "on",
                                   "true", "yes", "2"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "no-native"])
def test_wire_codec_words_match_jax(monkeypatch, value, native):
    """AAT_WIRE_CODEC: 0/off/false (any case) off, any other value on, as
    the JAX function says. Unset, the port's codec is off whether or not the
    native encoder loads (the kept divergence: the JAX package turns it on
    when the encoder loads)."""
    if value is None:
        monkeypatch.delenv("AAT_WIRE_CODEC", raising=False)
    else:
        monkeypatch.setenv("AAT_WIRE_CODEC", value)
    if not native:
        monkeypatch.setitem(nat._LIBS, "pcmcodec", None)
        monkeypatch.setitem(jnat._LIBS, "pcmcodec", None)
    if value is None:
        assert not pc.wire_codec_enabled()
        assert jpc.wire_codec_enabled() == (jnat.load_pcmcodec_library() is not None)
    else:
        assert pc.wire_codec_enabled() == jpc.wire_codec_enabled()
        assert pc.wire_codec_enabled() == (value.lower() not in ("0", "off", "false"))
