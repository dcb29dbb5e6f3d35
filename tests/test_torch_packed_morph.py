"""The port's packed-word morphology (``ops/morphology.py::packed_dilate``
/ ``packed_erode`` on int32 words, most significant bit first) bit for bit
against its float 0/1 plain version and the JAX package's packed ops on
uint32 words, and the detection mask tail (``_mask_threshold_morph``)
against the JAX package's and the float pipeline's."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_analysis_torch.detect import signal_noise as tsn  # the module, not the function
from audio_analysis_torch.ops import morphology as tmorph

jmorph = importlib.import_module("audio_analysis_tpu.ops.morphology")
jsn = importlib.import_module("audio_analysis_tpu.detect.signal_noise")

SR = 48000
KERNELS = [(4, 4), (10, 42), (1, 42), (3, 5), (2, 33), (1, 1)]


def _unpack(words, width):
    """[..., W] int32 MSB-first words -> [..., width] bool."""
    w = np.asarray(words).astype(">i4")
    bits = np.unpackbits(w.view(np.uint8).reshape(w.shape[:-1] + (-1,)), axis=-1)
    return bits[..., :width].astype(bool)


def _mask(seed, shape):
    """A random 0/1 mask with dense and empty patches, and bit 31 of many
    words set (p = 0.5 away from the patches)."""
    r = np.random.RandomState(seed)
    m = r.rand(*shape) < 0.5
    m[..., 3:9, 10:40] = True
    m[..., 12:20, 40:70] = False
    return m


@pytest.mark.parametrize("width", [70, 96, 129])
@pytest.mark.parametrize("kh,kw", KERNELS)
def test_packed_ops_equal_float_and_jax(kh, kw, width):
    m = _mask(kh * 100 + kw + width, (2, 23, width))
    words = tsn.pack_words(torch.from_numpy(m))
    assert words.dtype == torch.int32 and words.shape[-1] == -(-width // 32)
    assert bool((words < 0).any())  # bit 31 (a word's first column) is set somewhere
    n_words = words.shape[-1]
    pad = 32 * n_words - width
    ones_pad = torch.full_like(words[..., -1:], (1 << pad) - 1 if pad else 0)
    erode_in = words.clone()
    erode_in[..., -1:] |= ones_pad  # pad bits 1 for erode (the caller's duty)
    fm = torch.from_numpy(m.astype(np.float32))
    ju = jnp.asarray(words.numpy().view(np.uint32))
    je = jnp.asarray(erode_in.numpy().view(np.uint32))
    for packed, plain, jax_op, x, jx in [
        (tmorph.packed_dilate, tmorph.dilate, jmorph.packed_dilate, words, ju),
        (tmorph.packed_erode, tmorph.erode, jmorph.packed_erode, erode_in, je),
    ]:
        got = packed(x, kh, kw)
        assert got.dtype == torch.int32 and got.shape == words.shape
        ref = plain(fm, kh, kw).numpy() > 0.5
        np.testing.assert_array_equal(_unpack(got.numpy(), width), ref)
        ref_j = np.asarray(jax_op(jx, kh, kw)).view(np.int32)
        np.testing.assert_array_equal(_unpack(got.numpy(), width), _unpack(ref_j, width))
        if packed is tmorph.packed_dilate:  # zero pad bits stay zero
            np.testing.assert_array_equal(got.numpy(), ref_j)


@pytest.mark.parametrize("d", [-70, -33, -32, -31, -5, -1, 0, 1, 7, 31, 32, 33, 64, 95])
@pytest.mark.parametrize("fill_ones", [False, True])
def test_shift_cols_equals_jax(d, fill_ones):
    """Shifts of words with bit 31 set: torch's int32 ``>>`` copies the sign
    bit, so each right shift is masked."""
    r = np.random.RandomState(abs(d))
    u = r.randint(-(2**31), 2**31, size=(3, 4), dtype=np.int64).astype(np.int32)
    u[:, 0] |= np.int32(-(2**31))
    got = tmorph._shift_cols(torch.from_numpy(u), d, fill_ones).numpy()
    ref = np.asarray(jmorph._shift_cols(jnp.asarray(u.view(np.uint32)), d, fill_ones))
    np.testing.assert_array_equal(got.view(np.uint32), ref)


def test_pack_words_and_bytes_match_jax_and_packbits():
    m = _mask(3, (5, 77))
    words = tsn.pack_words(torch.from_numpy(m))
    np.testing.assert_array_equal(words.numpy(),
                                  np.asarray(jsn._pack_bits(jnp.asarray(m))))
    batched = tsn.pack_words(torch.from_numpy(m.reshape(1, 5, 77)))
    np.testing.assert_array_equal(batched[0].numpy(), words.numpy())


def _spec_case(seed, bins, t, nvf):
    r = np.random.RandomState(seed)
    spec = (np.abs(r.randn(bins, t)) ** 2).astype(np.float32)
    spec[40:60, 100:160] *= 40.0  # boxes above both thresholds
    spec[300:320, 20:90] *= 30.0
    col_valid = np.arange(t) < nvf
    return spec / spec[:, :nvf].max(), col_valid


def test_mask_threshold_morph_equals_jax_and_plain():
    """A batch of two recordings with different valid lengths: the packed
    words equal the JAX package's per recording, and unpacked they equal
    the float pipeline's mask (``mask_threshold_morph_plain``)."""
    bins, t = 2049, 300
    kw = dict(sr=SR, hop_length=281, n_fft=4096)
    cases = [_spec_case(0, bins, t, 251), _spec_case(1, bins, t, 300)]
    spec = np.stack([c[0] for c in cases])
    col_valid = np.stack([c[1] for c in cases])
    row_m, col_m, ref_words = [], [], []
    for (s, cv), nvf in zip(cases, (251, 300)):
        r, c = jsn._masked_medians_rowcol(jnp.asarray(s), jnp.asarray(cv), nvf, bins)
        row_m.append(np.asarray(r))
        col_m.append(np.asarray(c))
        ref_words.append(np.asarray(jsn._mask_threshold_morph(
            jnp.asarray(s), r, c, jnp.asarray(cv), **kw)))
    args = [torch.from_numpy(a) for a in (spec, np.stack(row_m), np.stack(col_m), col_valid)]
    words = tsn._mask_threshold_morph(*args, **kw)
    plain = tsn.mask_threshold_morph_plain(*args, **kw).numpy()
    assert words.shape == (2, bins, -(-t // 32))
    for b in range(2):
        np.testing.assert_array_equal(words[b].numpy(), ref_words[b])
        np.testing.assert_array_equal(_unpack(words[b].numpy(), t), plain[b])
        assert plain[b][40:60, 100:160].any()
    assert not plain[0][:, 251:].any()  # nothing past the valid frames
