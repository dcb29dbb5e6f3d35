"""The port's native host libraries (``audio_analysis_torch/native``): each
ctypes wrapper is built once per library, and calls from many threads at
once (batch serving runs the CCL of a batch's recordings in host threads)
give the single-thread results, which equal the JAX package's; the CCL of
the packed mask words, native and numpy, equals the numpy labelling of the
unpacked mask."""

import sys
import threading

import numpy as np
import pytest

import audio_analysis_tpu.io.pcmcodec as jpc
from audio_analysis_tpu.ops.components import (
    connected_components_with_stats_packed as jax_ccl_packed,
)

import audio_analysis_torch.native as nat
from audio_analysis_torch.io.pcmcodec import encode_pcm
from audio_analysis_torch.ops import components
from audio_analysis_torch.ops.components import (
    _connected_components_numpy,
    connected_components_with_stats_packed,
)

LOADERS = {"ccl": nat.load_ccl_library, "pcmcodec": nat.load_pcmcodec_library}


def _words(mask):
    """[h, width] bool -> [h, ceil(width/32)] int32 words, bit 31 of word j
    the column 32 j, the pad bits zero (the device's layout)."""
    packed = np.packbits(mask, axis=1)
    return np.pad(packed, ((0, 0), (0, -packed.shape[1] % 4))).view(">i4").astype(np.int32)


def _ccl_case():
    words = _words(np.random.RandomState(0).rand(64, 256) > 0.7)
    return (lambda: connected_components_with_stats_packed(words, 256),
            jax_ccl_packed(words, 256))


def _pcmcodec_case():
    rng = np.random.RandomState(1)
    x = np.clip(np.cumsum(rng.randn(2, 4096) * 300, axis=1), -32768, 32767).astype(np.int16)
    return lambda: encode_pcm(x), jpc.encode_pcm(x)


def _same(a, b):
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return (a.shape == b.shape and a.n_valid == b.n_valid and a.order == b.order
            and sorted(a.tiers) == sorted(b.tiers)
            and all(np.array_equal(x, y) for w in a.tiers for x, y in zip(a.tiers[w], b.tiers[w]))
            and (a.exceptions is None) == (b.exceptions is None)
            and (a.exceptions is None
                 or all(np.array_equal(x, y) for x, y in zip(a.exceptions, b.exceptions))))


@pytest.mark.parametrize("stem", sorted(LOADERS))
def test_wrapper_is_built_once(stem):
    """Every load returns the same wrapper of the same library."""
    first = LOADERS[stem]()
    assert first is not None, f"the native {stem} library did not build"
    assert all(LOADERS[stem]() is first for _ in range(3))


@pytest.mark.parametrize("stem", sorted(LOADERS))
def test_calls_from_many_threads_give_one_threads_result(stem):
    """16 threads (more than this machine's cores), each loading the
    library and calling it 200 times at a shortened switch interval, all
    get the single-thread result, which equals the JAX package's. Setting
    a wrapper's argtypes on every load broke concurrent calls."""
    assert LOADERS[stem]() is not None, f"the native {stem} library did not build"
    call, jax_result = _ccl_case() if stem == "ccl" else _pcmcodec_case()
    ref = call()
    assert _same(ref, jax_result)
    errors = []

    def work():
        try:
            for _ in range(200):
                if not _same(call(), ref):
                    errors.append("differs")
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


def _mask_case(case, width):
    """(mask [h, width] bool, its words) for a labelling case: a random
    mask, an empty one, or rows of ones whose words have every pad bit set
    too (a producer that does not zero them)."""
    r = np.random.RandomState(width)
    h = 6 if width > 1000 else 19
    if case == "random":
        mask = r.rand(h, width) < 0.35
        mask[2:5, : width // 2 + 1] = True  # one wide blob across words
        return mask, _words(mask)
    mask = np.zeros((h, width), bool)
    words = _words(mask)
    if case == "ones_into_pad":
        mask[1::3] = True
        words[1::3] = -1
    return mask, words


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("case", ["random", "empty", "ones_into_pad"])
@pytest.mark.parametrize("width", [1, 31, 32, 33, 77, 10250])
def test_words_ccl_equals_numpy_on_the_unpacked_mask(width, case, native, monkeypatch):
    if native:
        assert nat.load_ccl_library() is not None, "the native ccl library did not build"
    else:
        monkeypatch.setattr(components, "load_ccl_library", lambda: None)
    mask, words = _mask_case(case, width)
    assert words.shape == (mask.shape[0], -(-width // 32))
    got = connected_components_with_stats_packed(words, width)
    ref = _connected_components_numpy(mask)
    assert got.shape[1] == 5
    assert sorted(got.tolist()) == sorted(ref.tolist())
    if case == "empty":
        assert got.shape == (0, 5)
    else:
        assert len(got) > 0


def test_words_ccl_refuses_bytes():
    """Bytes (np.packbits' layout) are not words: viewing them as uint32
    would label another mask."""
    with pytest.raises(TypeError, match="32-bit"):
        connected_components_with_stats_packed(np.packbits(np.ones((3, 64), bool), axis=1), 64)
