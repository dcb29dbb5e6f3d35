"""The port's ``.keras`` export without h5py (io/keras_export.py): a
same-shape archive (overwritten in place) and a replaced-head archive (the
head's data appended, its dataspace and layout rewritten) read back equal
through the port's loader, the JAX package's h5py loader and tf.keras; the
other members stay byte for byte; the writer never imports h5py; what it
cannot write in place raises, naming the dataset."""

import json
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import jax.numpy as jnp  # noqa: E402

from audio_analysis_tpu.models import KerasModel as JaxKerasModel  # noqa: E402

from audio_analysis_torch.io.keras_export import write_keras_archive  # noqa: E402
from audio_analysis_torch.models import KerasModel  # noqa: E402
from audio_analysis_torch.parallel.finetune import build_finetune, replace_head  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FEAT = (12, 10, 1)


@pytest.fixture(scope="module")
def saved_model(tmp_path_factory):
    """tests/test_finetune.py's toy, plus a SeparableConv2D and a nested
    Sequential block (weight keys under layers/<model>/layers/...)."""
    tf.keras.utils.set_random_seed(11)
    inner = tf.keras.Sequential([tf.keras.Input((12, 10, 8)),
                                 tf.keras.layers.SeparableConv2D(8, 3, padding="same")])
    inp = tf.keras.Input(FEAT)
    x = tf.keras.layers.Conv2D(8, 3, padding="same")(inp)
    x = tf.keras.layers.BatchNormalization()(x)
    x = tf.keras.layers.ReLU()(x)
    x = inner(x)
    x = tf.keras.layers.Dropout(0.1)(x)
    x = tf.keras.layers.GlobalAveragePooling2D()(x)
    out = tf.keras.layers.Dense(4, activation="softmax")(x)
    p = tmp_path_factory.mktemp("export") / "audioModel.keras"
    tf.keras.Model(inp, out).save(str(p))
    return p


def _tuned(path, head=None, steps=3):
    """(model, params, config) after a few fine-tune steps (with a head
    replaced for `head` labels)."""
    km = KerasModel.load(path)
    if head:
        replace_head(km, head, seed=2)
    params, opt, step = build_finetune(km, "cpu", lr=1e-2)
    rng = np.random.RandomState(0)
    for i in range(steps):
        y = rng.randint(0, head or 4, 32)
        x = (rng.randn(32, *FEAT) * 0.1 + y[:, None, None, None]).astype(np.float32)
        step(params, opt, torch.from_numpy(x), torch.from_numpy(y),
             torch.Generator().manual_seed(i))
    return km, params


def _tf_weights(path, keys):
    """tf.keras's variables of the reloaded archive, by the port's weight
    keys (the two walk the layers in the same order)."""
    model = tf.keras.models.load_model(str(path))

    def walk(layers):
        for layer in layers:
            if hasattr(layer, "layers") and layer.layers:  # a nested model
                yield from walk(layer.layers)
            elif not isinstance(layer, tf.keras.layers.InputLayer):
                yield layer

    real = [l for l in walk(model.layers)]
    return model, {k: [v.numpy() for v in l.weights] for k, l in zip(keys, real)}


@pytest.mark.parametrize("head", [None, 3], ids=["same-shape", "replaced-head"])
def test_export_reads_back_through_three_loaders(saved_model, tmp_path, head):
    """Every variable the port wrote reads back within 1e-6 (bit for bit,
    as float32 is written) through the port's loader, JAX KerasModel.load
    (h5py) and tf.keras.models.load_model; the three forwards agree."""
    km, params = _tuned(saved_model, head)
    out = write_keras_archive(saved_model, params, tmp_path / "out.keras",
                              config=km.config if head else None)
    want = {k: [t.detach().numpy() for t in vs] for k, vs in params.items()}
    port, jaxm = KerasModel.load(out), JaxKerasModel.load(out)
    keys = [k for k, _, _ in port.walk_layers()]
    tfm, tfw = _tf_weights(out, keys)
    for key, arrays in want.items():
        for i, a in enumerate(arrays):
            for name, got in (("port", port.params[key][i]), ("jax", jaxm.params[key][i]),
                              ("tf", tfw[key][i])):
                np.testing.assert_allclose(np.asarray(got), a, rtol=0, atol=1e-6,
                                           err_msg=f"{name} {key}/{i}")
    x = np.random.RandomState(1).randn(6, *FEAT).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (6, head or 4)
    np.testing.assert_allclose(got, np.asarray(jaxm(jnp.asarray(x))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, tfm.predict(x, verbose=0), rtol=1e-4, atol=1e-5)


def test_other_members_and_sizes(saved_model, tmp_path):
    """Members other than the weights (and config.json, unless one is
    given) keep their bytes; a same-shape export keeps the HDF5 file's size
    (every write in place); a replaced head appends exactly its data."""
    km, params = _tuned(saved_model, steps=1)
    same = write_keras_archive(saved_model, params, tmp_path / "same.keras")
    km3, params3 = _tuned(saved_model, head=3, steps=1)
    head = write_keras_archive(saved_model, params3, tmp_path / "head.keras", config=km3.config)
    read = lambda p: {n: zipfile.ZipFile(p).read(n) for n in zipfile.ZipFile(p).namelist()}
    src, a, b = read(saved_model), read(same), read(head)
    assert list(a) == list(src) == list(b)
    for n in src:
        if n != "model.weights.h5":
            assert a[n] == src[n], n
        if n not in ("model.weights.h5", "config.json"):
            assert b[n] == src[n], n
    assert len(a["model.weights.h5"]) == len(src["model.weights.h5"])
    dense = next(k for k, cls, _ in km3.walk_layers() if cls == "Dense")
    fan_in = params3[dense][0].shape[0]
    assert len(b["model.weights.h5"]) == len(src["model.weights.h5"]) + 4 * (fan_in * 3 + 3)
    assert json.loads(b["config.json"]) == km3.config


def test_export_imports_no_h5py(saved_model, tmp_path):
    """Both exports in a fresh interpreter where importing h5py fails."""
    km, params = _tuned(saved_model, head=3, steps=1)
    np.savez(tmp_path / "p.npz", **{f"{k}|{i}": t.detach().numpy()
                                    for k, vs in params.items() for i, t in enumerate(vs)})
    (tmp_path / "config.json").write_text(json.dumps(km.config))
    code = (
        "import json, sys\n"
        "sys.modules['h5py'] = None\n"
        "import numpy as np\n"
        "from audio_analysis_torch.io.keras_export import write_keras_archive\n"
        f"z = np.load({str(tmp_path / 'p.npz')!r})\n"
        "params = {}\n"
        "for name in z.files:\n"
        "    key, i = name.split('|')\n"
        "    params.setdefault(key, {})[int(i)] = z[name]\n"
        "params = {k: [v[i] for i in sorted(v)] for k, v in params.items()}\n"
        f"cfg = json.loads(open({str(tmp_path / 'config.json')!r}).read())\n"
        f"write_keras_archive({str(saved_model)!r}, params, {str(tmp_path / 'h.keras')!r}, cfg)\n"
        f"write_keras_archive({str(saved_model)!r}, {{}}, {str(tmp_path / 's.keras')!r})\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    x = np.random.RandomState(2).randn(3, *FEAT).astype(np.float32)
    got = KerasModel.load(tmp_path / "h.keras")(torch.from_numpy(x)).detach().numpy()
    ref = np.asarray(JaxKerasModel.load(tmp_path / "h.keras")(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert zipfile.ZipFile(tmp_path / "s.keras").read("model.weights.h5") == \
        zipfile.ZipFile(saved_model).read("model.weights.h5")


def test_what_cannot_be_written_raises(saved_model, tmp_path):
    """A rank change raises ValueError naming the dataset; an unknown
    weight key or variable raises KeyError."""
    km = KerasModel.load(saved_model)
    dense = next(k for k, cls, _ in km.walk_layers() if cls == "Dense")
    w, b = km.params[dense]
    with pytest.raises(ValueError, match=f"{dense}/vars/1: rank 1 -> 2"):
        write_keras_archive(saved_model, {dense: [w, b[None, :]]}, tmp_path / "x.keras")
    with pytest.raises(KeyError, match="not present"):
        write_keras_archive(saved_model, {"no_such_layer": [w]}, tmp_path / "x.keras")
    with pytest.raises(KeyError, match="vars/2"):
        write_keras_archive(saved_model, {dense: [w, b, b]}, tmp_path / "x.keras")


def test_keras2_export_config_pinned_across_both_fine_tune_clis(tmp_path, monkeypatch):
    """A Keras-2 archive with a nested model called twice and a nested
    Sequential (tests/test_torch_keras_graph.py's ``_keras2_nested_offset``,
    built with tf_keras) fine-tuned for one step by the port's
    ``cli/finetune.py`` and by the JAX package's ``tools/finetune_keras.py``
    on the same seeded recordings: both executors mark the config
    ``__aat_k2_shifted__`` and shift its nested node refs in place, and
    both CLIs write that config back, so the two exported config.json are
    equal, marked and shifted; each executor, reloading the other's export,
    gives the logits the other gives (within 1e-6). The features stand in
    for the frontend's: the model takes [8, 3], so both CLIs get the same
    reduction of each PCM window."""
    import importlib
    import importlib.util

    from audio_analysis_torch.cli import finetune as tcli
    from audio_analysis_torch.io.audio import write_wav

    spec = importlib.util.spec_from_file_location(
        "keras_graph_archs", REPO / "tests" / "test_torch_keras_graph.py")
    archs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(archs)
    model, x, keras2 = archs._keras2_nested_offset(np.random.RandomState(0))
    assert keras2
    mdir = tmp_path / "model"
    mdir.mkdir()
    model.save(str(mdir / "audioModel.keras"))
    labels = ["a", "b", "c"]
    (mdir / "metadata.txt").write_text(json.dumps({
        "name": "k2", "labels": labels, "segment_length": 1, "segment_stride": 1,
        "hop_length": 640, "n_mels": 8, "n_fft": 4096, "threshold": 0.5}))
    data = tmp_path / "data"
    rng = np.random.RandomState(1)
    for label in labels:
        (data / label).mkdir(parents=True)
        write_wav(data / label / "r.wav", (0.3 * rng.randn(48000)).astype(np.float32), 48000)

    def feats(pcm, sr, cfg):
        """[N, 48000] PCM -> [N, 8, 3]: means of 24 runs of 100 samples."""
        return pcm[:, :2400].reshape(-1, 8, 3, 100).mean(-1) * 10.0

    for pkg in ("audio_analysis_torch", "audio_analysis_tpu"):
        monkeypatch.setattr(importlib.import_module(f"{pkg}.pipeline.classify"),
                            "features_for_config", feats)
    args = ["--epochs", "1", "--batch", "3", "--lr", "1e-2", "--seed", "0"]
    assert tcli.run([str(mdir), str(data), str(tmp_path / "port"), *args,
                     "--device", "cpu"]) == 0
    monkeypatch.syspath_prepend(str(REPO / "tools"))
    spec = importlib.util.spec_from_file_location("finetune_keras",
                                                  REPO / "tools" / "finetune_keras.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(sys, "argv", ["finetune_keras.py", str(mdir), str(data),
                                      str(tmp_path / "jax"), *args])
    tool.main()

    def config(d):
        with zipfile.ZipFile(d / "audioModel.keras") as z:
            return json.loads(z.read("config.json"))

    with zipfile.ZipFile(mdir / "audioModel.keras") as z:
        original = json.loads(z.read("config.json"))
    port, jax_cfg = config(tmp_path / "port"), config(tmp_path / "jax")
    assert port == jax_cfg
    marked, orig = port["config"], original["config"]
    assert marked.get("__aat_k2_shifted__") is True and "__aat_k2_shifted__" not in orig
    assert {k: v for k, v in marked.items() if k != "__aat_k2_shifted__"} != orig
    assert {k: v for k, v in port.items() if k != "config"} == {
        k: v for k, v in original.items() if k != "config"}

    xt = torch.from_numpy(x)
    for d in ("port", "jax"):
        path = tmp_path / d / "audioModel.keras"
        with torch.no_grad():
            got = KerasModel.load(path)(xt).numpy()
        ref = np.asarray(JaxKerasModel.load(path)(jnp.asarray(x)))
        assert got.shape == (2, 3)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
