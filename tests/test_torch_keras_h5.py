"""The port's HDF5 reader (``io/h5read.py``) and ``.keras`` import against
h5py and the JAX package's importer: the same keys, shapes, dtypes and bytes
on every archive the Keras tests build, the features it refuses, and the
EfficientNetB0 fixture that ``chip_smoke.efficientnet_fixture`` writes into
the committed archive's bytes."""

import io
import sys
import zipfile
from pathlib import Path

import h5py
import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from audio_analysis_tpu.io.keras_import import read_keras_archive as jax_read  # noqa: E402

from audio_analysis_torch.io.h5read import Dataset, read_h5  # noqa: E402
from audio_analysis_torch.io.keras_import import read_keras_archive  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the EfficientNetB0 fixture)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _h5py_datasets(buf):
    out = {}
    with h5py.File(io.BytesIO(buf), "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, (obj[()], obj.id.get_offset()))
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def _assert_same_as_h5py(buf, compact=()):
    """The port's tree against h5py's; h5py gives no offset for the
    `compact` datasets (their data sits in the object header)."""
    ours = dict(_flat(read_h5(buf)))
    ref = _h5py_datasets(buf)
    assert sorted(ours) == sorted(ref)
    for k, (arr, offset) in ref.items():
        d = ours[k]
        assert isinstance(d, Dataset)
        assert d.array.dtype == arr.dtype and d.array.shape == arr.shape, k
        assert d.array.tobytes() == np.asarray(arr).tobytes(), k
        if k in compact:
            raw = np.asarray(arr).tobytes()
            assert buf[d.offset : d.offset + len(raw)] == raw
        else:
            assert d.offset == offset, k
    return ours


def _weights_h5(path):
    with zipfile.ZipFile(path) as z:
        return z.read("model.weights.h5")


def _archives(tmp_path):
    """{name: .keras path}: the committed fixture, a tf-built
    EfficientNetB0, tests/test_keras_import.py's and test_keras_zoo_ext.py's
    architectures, and a Keras-2 (tf_keras) archive."""
    import tf_keras as tk
    from test_torch_keras_graph import ARCHS

    rng = np.random.RandomState(0)
    out = {"committed_fixture": chip_smoke.EFFNET_ZERO}
    tf.keras.utils.set_random_seed(7)
    b0 = tf.keras.applications.EfficientNetB0(weights=None, input_shape=(32, 32, 3), classes=8)
    out["efficientnet_b0"] = tmp_path / "b0.keras"
    b0.save(str(out["efficientnet_b0"]))
    for name in ("cacophony_cnn", "efficientnet_block", "separable_concat", "sequential",
                 "names_and_nesting", "magtransform_v1", "conv1d_family", "embedding"):
        model, _, keras2 = ARCHS[name](rng)
        out[name] = tmp_path / f"{name}.keras"
        model.save(str(out[name]))
    inp = tk.Input((8, 3))
    k2 = tk.Model(inp, tk.layers.Dense(3)(tk.layers.Conv1D(4, 3)(inp)))
    out["keras2"] = tmp_path / "k2.keras"
    k2.save(str(out["keras2"]), save_format="keras")
    return out


def test_reader_matches_h5py_on_every_archive(tmp_path):
    """Keys, shapes, dtypes, bytes and raw-data offsets as h5py reads them,
    and read_keras_archive's weights equal the JAX importer's (which reads
    them through h5py)."""
    for name, path in _archives(tmp_path).items():
        _assert_same_as_h5py(_weights_h5(path))
        config, weights, meta = read_keras_archive(path)
        jconfig, jweights, jmeta = jax_read(path)
        assert (config, meta) == (jconfig, jmeta), name
        assert sorted(weights) == sorted(jweights), name
        for k in jweights:
            assert len(weights[k]) == len(jweights[k])
            for a, b in zip(weights[k], jweights[k]):
                assert a.dtype == b.dtype and np.array_equal(a, b), (name, k)


def test_efficientnet_groups_span_a_multi_level_btree():
    """EfficientNetB0's `layers` group (240 links) needs SNODs under a
    B-tree of more than one level; the reader walks it."""
    buf = _weights_h5(chip_smoke.EFFNET_ZERO)
    levels = [buf[i + 5] for i in range(len(buf) - 6)
              if buf[i : i + 4] == b"TREE" and buf[i + 4] == 0]
    assert max(levels) >= 1
    assert len(read_h5(buf)["layers"]) == 240


def _h5(tmp_path, build, **kw):
    p = tmp_path / "f.h5"
    with h5py.File(p, "w", **kw) as f:
        build(f)
    return p.read_bytes()


def test_reader_covers_what_keras_may_write(tmp_path):
    """Integers of every width, float16/64, scalars, empty datasets,
    compact storage, deep groups and a group of 600 links."""

    def build(f):
        g = f.create_group("a/b/c")
        for dt in ("<i1", "<u2", "<i4", "<u8", "<i8", "<f2", "<f4", "<f8"):
            g.create_dataset(dt.strip("<"), data=(np.arange(12) * 3 - 7).astype(dt).reshape(3, 4))
        g.create_dataset("scalar", data=np.float32(2.5))
        g.create_dataset("empty", shape=(0, 5), dtype="<f4")
        big = f.create_group("many")
        for i in range(600):
            big.create_dataset(str(i), data=np.float32([i]))
        space = h5py.h5s.create_simple((2, 3))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        h5py.h5d.create(f.id, b"compact", h5py.h5t.IEEE_F32LE, space, dcpl=dcpl).write(
            h5py.h5s.ALL, h5py.h5s.ALL, np.arange(6, dtype="<f4").reshape(2, 3))

    buf = _h5(tmp_path, build, libver="earliest")
    tree = _assert_same_as_h5py(buf, compact=("compact",))
    assert tree["a/b/c/empty"].array.shape == (0, 5)
    assert read_h5(buf)["many"]["599"].array.tolist() == [599.0]


@pytest.mark.parametrize("case,match", [
    ("latest", "superblock version"),
    ("chunked", "chunked|filter"),
    ("big_endian", "big-endian"),
    ("string", "string|variable-length"),
    ("link_groups", "link-message|version-2"),
    ("not_hdf5", "not an HDF5 file"),
    ("truncated", "truncated|malformed|past the end"),
])
def test_reader_refuses_what_it_does_not_read(tmp_path, case, match):
    """Each feature outside the subset raises ValueError naming it; there is
    no fallback to h5py."""
    data = np.arange(64, dtype=np.float32).reshape(8, 8)
    builds = {
        "latest": (lambda f: f.create_dataset("x", data=data), {"libver": "latest"}),
        "chunked": (lambda f: f.create_dataset("x", data=data, chunks=(4, 4),
                                               compression="gzip"), {}),
        "big_endian": (lambda f: f.create_dataset("x", data=data.astype(">f4")), {}),
        "string": (lambda f: f.create_dataset("x", data=np.array(["ab", "c"], dtype=object),
                                              dtype=h5py.string_dtype()), {}),
        # creation-order tracking makes a link-message group even in an
        # earliest-format file
        "link_groups": (lambda f: f.create_group("g", track_order=True).create_dataset(
            "x", data=data), {}),
    }
    if case == "not_hdf5":
        buf = b"PK\x03\x04" + bytes(100)
    elif case == "truncated":
        full = _h5(tmp_path, lambda f: f.create_dataset("x", data=data), libver="earliest")
        buf = full[: len(full) - 64]
    else:
        build, kw = builds[case]
        buf = _h5(tmp_path, build, **({"libver": "earliest"} | kw))
    with pytest.raises(ValueError, match=match):
        read_h5(buf)


def test_filled_fixture_reads_back_under_h5py(tmp_path):
    """The EfficientNetB0 fixture: every dataset h5py reads in the written
    archive equals what the port's reader reads (so the filler wrote each
    array at its dataset's offset, in its dtype and shape), the weights are
    the seeded ones (He-normal kernels, calibrated BatchNorm statistics,
    Normalization mean 0 and variance 1), and the JAX importer reads the
    same weights."""
    d = chip_smoke.efficientnet_fixture(tmp_path / "m", seed=0, threshold=0.5)
    path = d / "audioModel.keras"
    tree = _assert_same_as_h5py(_weights_h5(path))
    _, weights, _ = read_keras_archive(path)
    _, jweights, _ = jax_read(path)
    assert sorted(weights) == sorted(jweights)
    for k in weights:
        assert all(np.array_equal(a, b) for a, b in zip(weights[k], jweights[k]))
    stem = weights["conv2d"][0]
    assert stem.shape == (3, 3, 3, 32)
    assert abs(float(stem.std()) - np.sqrt(2.0 / 27)) < 0.05
    mean, var, count = weights["normalization"]
    assert (mean == 0).all() and (var == 1).all() and count.dtype == np.int64
    gamma, beta, moving_mean, moving_var = weights["batch_normalization"]
    assert (moving_var > 0).all() and np.abs(moving_mean).max() > 0
    assert 0.5 < float(gamma.mean()) < 1.5
    assert all(v.any() for k, vs in weights.items() for v in vs[:1]
               if not k.startswith("normalization"))
    meta = (d / "metadata.txt").read_text()
    assert '"threshold": 0.5' in meta and "efficientnet" in meta
    assert tree["layers/dense/vars/1"].array.tolist() == [0.0] * 8  # biases 0
    again = chip_smoke.efficientnet_fixture(tmp_path / "again", seed=0)
    assert _weights_h5(again / "audioModel.keras") == _weights_h5(path)  # seeded
