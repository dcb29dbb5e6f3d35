"""The port's detection (audio_analysis_torch.detect.signal_noise) against
the JAX package's detect() on the same recordings, and its morphology
against the JAX package's OpenCV-exact morphology."""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_analysis_tpu.ops import morphology as jmorph

from audio_analysis_torch.detect import signal_noise as tsn
from audio_analysis_torch.ops import morphology as tmorph

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the golden recording)

# the package re-exports a function named signal_noise, so import the module
jsn = importlib.import_module("audio_analysis_tpu.detect.signal_noise")
SR = 48000
_golden_recording = chip_smoke.golden_recording


def _silent_tail_recording():
    """Chirps, then digital silence from 9 s: the end-scan cuts the data
    there and the detection runs over the valid part only."""
    y = _golden_recording()[: 14 * SR].copy()
    y[9 * SR :] = 0.0
    return y


def _as_int16(y):
    return np.clip(y * 32768.0, -32768, 32767).astype(np.int16)


def _signals(sig):
    return [s.to_array(decimals=6) for s in sig]


@pytest.mark.parametrize("make,pcm16", [
    (_golden_recording, False),
    (_silent_tail_recording, False),
    (_silent_tail_recording, True),
], ids=["golden", "silent-tail", "silent-tail-int16"])
def test_detect_matches_jax(make, pcm16):
    y = make()
    if pcm16:
        y = _as_int16(y)
    j_len, j_sig = jsn.detect(jnp.asarray(y), SR)
    t_len, t_sig = tsn.detect(torch.from_numpy(y), SR)
    assert t_len == j_len
    assert _signals(t_sig) == _signals(j_sig)
    assert len(t_sig) > 0
    if make is _silent_tail_recording:
        assert t_len == 9


@pytest.mark.parametrize("kh,kw", [(4, 4), (10, 42), (1, 42), (3, 5), (2, 1)])
def test_morphology_matches_jax(rng, kh, kw):
    """cv2 anchors (k//2, asymmetric for even k) and identity borders."""
    x = (rng.rand(2, 40, 120) < 0.3).astype(np.float32)
    np.testing.assert_array_equal(
        tmorph.dilate(torch.from_numpy(x), kh, kw).numpy(),
        np.asarray(jmorph.dilate(jnp.asarray(x), kh, kw)),
    )
    np.testing.assert_array_equal(
        tmorph.erode(torch.from_numpy(x), kh, kw).numpy(),
        np.asarray(jmorph.erode(jnp.asarray(x), kh, kw)),
    )


def test_threshold_morph_matches_jax_packed_mask(rng):
    """The whole mask tail (thresholds, the four morphology stages with the
    invalid region set to each stage's identity) equals the JAX package's
    bit-packed version, bit for bit."""
    bins, t, nvf = 2049, 300, 251
    spec = (np.abs(rng.randn(bins, t)) ** 2).astype(np.float32)
    spec[40:60, 100:160] *= 40.0  # a box above both thresholds
    col_valid = np.arange(t) < nvf
    spec = spec / spec[:, :nvf].max()
    row_m, col_m = jsn._masked_medians_rowcol(jnp.asarray(spec), jnp.asarray(col_valid), nvf, bins)
    kw = dict(sr=SR, hop_length=281, n_fft=4096)
    packed = np.asarray(jsn._mask_threshold_morph(
        jnp.asarray(spec), row_m, col_m, jnp.asarray(col_valid), **kw))
    ref = np.unpackbits(packed.astype(">i4").view(np.uint8), axis=1)[:, :t].astype(bool)
    got = tsn._mask_threshold_morph(
        torch.from_numpy(spec)[None], torch.from_numpy(np.array(row_m))[None],
        torch.from_numpy(np.array(col_m))[None], torch.from_numpy(col_valid)[None], **kw,
    )[0].numpy()
    assert ref[40:60, 100:160].any()
    np.testing.assert_array_equal(got, ref)


def test_endscan_decision_matches_jax(rng):
    mx = rng.rand(2, 6).astype(np.float32)
    mn = mx.copy()
    mn[0, :] -= 0.1
    mn[0, 3] = mx[0, 3]  # chunk 3 flat in recording 0; recording 1 all flat
    n_valid = np.array([6 * SR, 2 * SR])
    got = tsn._endscan_decision(torch.from_numpy(n_valid), torch.from_numpy(mx),
                                torch.from_numpy(mn), sr=SR, hop_length=281)
    for b in range(2):
        ref = jsn._endscan_decision(jnp.int32(n_valid[b]), jnp.asarray(mx[b]),
                                    jnp.asarray(mn[b]), sr=SR, hop_length=281)
        assert [bool(got[0][b]), int(got[1][b]), int(got[2][b])] == [
            bool(ref[0]), int(ref[1]), int(ref[2])]


def test_pack_bits_is_np_packbits(rng):
    m = rng.rand(7, 43) < 0.4
    np.testing.assert_array_equal(tsn.pack_bits(torch.from_numpy(m)).numpy(),
                                  np.packbits(m, axis=1))
