"""The port's SavedModel conversion (``audio_analysis_torch/io/convert.py``)
against the JAX package's (tests/test_convert.py's cases): logit parity of
a converted SavedModel through the port's Keras executor, the cache and its
stamp shared with the JAX package's ``auto_convert_saved_model``, the
rejection of a non-Keras export and ``HostSavedModel``'s outputs, and the
morepork CLI on an ensemble of raw SavedModel members. Every case copies
one module-scoped set of SavedModels, so each is written once."""

import contextlib
import io
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")
tf_keras = pytest.importorskip("tf_keras")

from audio_analysis_tpu.io import convert as jconvert  # noqa: E402

from audio_analysis_torch.io import convert  # noqa: E402
from audio_analysis_torch.models.keras_graph import KerasModel  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the recording)

from test_convert import _saved_model  # noqa: E402  (a legacy Keras SavedModel member)

MEMBERS = 3


class _Doubler(tf.Module):
    @tf.function(input_signature=[tf.TensorSpec([None, 3], tf.float32)])
    def __call__(self, x):
        return {"out": 2.0 * x + 1.0}


class _Embedder(tf.Module):
    """The (logits, embedding) contract as a plain export: two dict keys."""

    @tf.function(input_signature=[tf.TensorSpec([None, 4], tf.float32)])
    def __call__(self, x):
        return {"logits": tf.reduce_sum(x, axis=1, keepdims=True), "embedding": 3.0 * x}


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Keras SavedModel members (seeds 10, 11, 12; an output bias that puts
    their sum near the morepork threshold), and two plain exports."""
    d = tmp_path_factory.mktemp("savedmodels")
    for i in range(MEMBERS):
        m = _saved_model(d / "keras" / f"member{i}", seed=10 + i)
        kernel, _ = m.layers[-1].get_weights()
        m.layers[-1].set_weights([kernel, np.asarray([np.log(0.4 / 0.6)], np.float32)])
        m.save(str(d / "keras" / f"member{i}"), save_format="tf")
    tf.saved_model.save(_Doubler(), str(d / "doubler"))
    tf.saved_model.save(_Embedder(), str(d / "embedder"))
    return d


def _copy(src, dst):
    shutil.copytree(src, dst)
    return dst


def test_convert_logit_parity_through_the_port_executor(saved, tmp_path):
    """tests/test_convert.py::test_convert_saved_model_logit_parity: the
    port's conversion, loaded by the port's KerasModel, gives TF's logits;
    it writes the JAX package's archive and metadata."""
    src = _copy(saved / "keras" / "member0", tmp_path / "sm")
    out = convert.convert_saved_model(src, tmp_path / "native")
    ref = jconvert.convert_saved_model(_copy(src, tmp_path / "sm-jax"), tmp_path / "native-jax")
    assert sorted(p.name for p in out.iterdir()) == sorted(p.name for p in ref.iterdir())
    assert json.loads((out / "metadata.txt").read_text())["labels"] == ["morepork"]
    model = tf_keras.models.load_model(str(src), compile=False)
    x = np.random.default_rng(1).standard_normal((4, 60, 60, 1)).astype(np.float32)
    with torch.inference_mode():
        got = KerasModel.load(out / convert.ARCHIVE)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(model(x)), atol=1e-5)


def test_auto_convert_cache_and_stamp_equal_jax(saved, tmp_path, monkeypatch):
    """Both packages cache in <src>/.aat_native with saved_model.pb's
    st_mtime_ns as the stamp; a second call reuses the conversion, each
    package reuses the other's, and a current cache needs no tensorflow."""
    a = _copy(saved / "keras" / "member1", tmp_path / "a")
    b = _copy(saved / "keras" / "member1", tmp_path / "b")
    out_a = convert.auto_convert_saved_model(a)
    out_b = jconvert.auto_convert_saved_model(b)
    assert (out_a, out_b) == (a / ".aat_native", b / ".aat_native")
    for src, out in ((a, out_a), (b, out_b)):
        assert (out / ".stamp").read_text() == str((src / "saved_model.pb").stat().st_mtime_ns)
    mtimes = {out: (out / convert.ARCHIVE).stat().st_mtime_ns for out in (out_a, out_b)}

    def no_conversion(*a, **k):
        raise AssertionError("a current cache was converted again")

    monkeypatch.setattr(convert, "convert_saved_model", no_conversion)
    monkeypatch.setattr(jconvert, "convert_saved_model", no_conversion)
    for name in ("tensorflow", "tf_keras"):
        monkeypatch.setitem(sys.modules, name, None)
    for src in (a, b):
        assert convert.auto_convert_saved_model(src) == jconvert.auto_convert_saved_model(src)
    assert mtimes == {out: (out / convert.ARCHIVE).stat().st_mtime_ns for out in mtimes}
    with pytest.raises(convert.ConversionError, match="no saved_model.pb"):
        convert.auto_convert_saved_model(tmp_path)


def test_non_keras_export_is_rejected_and_runs_on_host_tf(saved, tmp_path):
    """tests/test_convert.py::test_convert_rejects_non_keras_export: a plain
    export raises ConversionError in both packages and runs through
    HostSavedModel, whose outputs (one tensor; the (logits, embedding) pair
    of a two-key dict) equal the JAX one's, as torch tensors."""
    for name in ("doubler", "embedder"):
        with pytest.raises(convert.ConversionError):
            convert.convert_saved_model(saved / name, tmp_path / f"{name}-native")
        with pytest.raises(jconvert.ConversionError):
            jconvert.convert_saved_model(saved / name, tmp_path / f"{name}-native-jax")
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    got = convert.HostSavedModel(saved / "doubler")(torch.from_numpy(x))
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), jconvert.HostSavedModel(saved / "doubler")(x))
    np.testing.assert_array_equal(got.numpy(), 2.0 * x + 1.0)
    x = np.arange(8, dtype=np.float32).reshape(2, 4)
    got = convert.HostSavedModel(saved / "embedder")(torch.from_numpy(x))
    ref = jconvert.HostSavedModel(saved / "embedder")(x)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)


def _cli_json(run, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run(argv)
    res = json.loads(buf.getvalue())
    res.pop("processing_time_seconds")
    return res


def test_morepork_cli_on_raw_saved_models_equals_jax(saved, tmp_path):
    """``analyse FILE --morepork-model DIR`` over raw SavedModel members
    (tests/test_convert.py::test_morepork_ingests_saved_model_dirs): each
    package converts its own copy and caches it in the members' dirs; the
    JSON is equal apart from the time."""
    from audio_analysis_torch.cli.analyse import run
    from audio_analysis_torch.io.audio import write_wav
    from audio_analysis_tpu.cli.analyse import run as jax_run

    wav = tmp_path / "rec.wav"
    write_wav(wav, chip_smoke.make_recording(seconds=20, silent_from=18.0, seed=6), 48000)
    ens = {side: _copy(saved / "keras", tmp_path / side) for side in ("port", "jax")}
    want = _cli_json(jax_run, ["-o", str(wav), "--morepork-model", str(ens["jax"])])
    got = _cli_json(run, ["-o", str(wav), "--morepork-model", str(ens["port"]), "--device", "cpu"])
    assert got == want
    for i in range(MEMBERS):
        assert (ens["port"] / f"member{i}" / ".aat_native" / convert.ARCHIVE).exists()
    assert got["morepork"], "the ensemble must put a span over the threshold"
