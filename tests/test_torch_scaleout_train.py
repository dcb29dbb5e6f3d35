"""The port's sharded training (parallel/train.py ``build_train(mesh=)``,
``shard_params``, the TP head; parallel/finetune.py
``build_finetune(mesh=)``; ``cli/train.py --model-parallel`` and
``cli/finetune.py --mesh``) on the CPU over gloo ranks: a data=2 and a
model=2 TuiNet step take the single-process step (loss within 1e-5, every
leaf after the step, BatchNorm's running statistics included, within 1e-5
in relative L2), the model=2 step's loss is the JAX package's
``build_sharded_train`` step's on conftest.py's virtual 8-device mesh
(model_parallel 2) within 1e-4, a data=2 fine-tune step with live dropout
takes the single-process step, the train CLI under torchrun (model=2)
writes, on rank 0 alone, a checkpoint that serves with the single-process
run's labels, and the fine-tune CLI under torchrun (``--mesh data=2``)
writes the single-process run's archive.

The TuiNet steps train on linear mel power
(``chip_smoke.linear_power_features``): the
trainer's dB features are all <= 0 and TuiNet's clamp zeroes them (ROADMAP
Queue 3), which would leave the convolutions without a gradient. One pair
of ranks runs every step (``ranks``, module scope)."""

import contextlib
import io
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (linear_power_features, fixture writers, the result contract)

from audio_analysis_torch.models import KerasModel  # noqa: E402
from audio_analysis_torch.models.birdnet import TuiNet, TuiNetConfig  # noqa: E402
from audio_analysis_torch.parallel import distributed as tdist  # noqa: E402
from audio_analysis_torch.parallel import finetune as tft  # noqa: E402
from audio_analysis_torch.parallel import train as ttrain  # noqa: E402
from audio_analysis_torch.parallel.mesh import data_index, make_mesh  # noqa: E402

SR, HOP = 1600, 64
CFG = dict(num_classes=4, n_mels=32, channels=(8, 16), dense_units=64, dtype="float32")
FREQS = [100, 250, 420, 700]
BATCH = 16
FEAT = (12, 10, 1)  # the fine-tune toy's input


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, as the ranks take (six test workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tone_batch(rng, n):
    """Four separable classes: tones at FREQS with a little noise, 3 s."""
    labels = rng.randint(0, 4, size=n)
    t = np.arange(3 * SR) / SR
    pcm = np.stack([np.sin(2 * np.pi * FREQS[l] * t) + 0.05 * rng.randn(len(t))
                    for l in labels]).astype(np.float32)
    return pcm, labels.astype(np.int32)


def _toy_batch(rng, n=BATCH):
    """tests/test_torch_finetune.py's amplitude-coded classes."""
    y = rng.randint(0, 4, n).astype(np.int32)
    x = rng.randn(n, *FEAT).astype(np.float32) * 0.1
    x += (y * 1.5).astype(np.float32)[:, None, None, None]
    return x, y


def _finetune_step(km, x, y, mesh=None):
    """One fine-tune step (lr 1e-3, dropout from a generator seeded 0) on
    this rank's rows of (x, y), or all of them without a mesh; (loss, acc,
    leaves after the step)."""
    rows = slice(None)
    if mesh is not None:
        per = len(x) // mesh.size(0)
        rows = slice(data_index(mesh) * per, (data_index(mesh) + 1) * per)
    params, opt, step = tft.build_finetune(km, "cpu" if mesh is None else None, lr=1e-3,
                                           mesh=mesh)
    loss, acc = step(params, opt, torch.from_numpy(x[rows]), torch.from_numpy(y[rows]),
                     torch.Generator().manual_seed(0))
    return float(loss), float(acc), {k: [t.detach().numpy().copy() for t in v]
                                     for k, v in params.items()}


def _steps_rank(p, pcm, labels, archive, x, y):
    """Every sharded step in one rank of a gloo pair: the TuiNet step on a
    data=2 and on a model=2 mesh from the parameters `p`, and a data=2
    fine-tune step of the Keras toy at `archive`."""
    out = {}
    for name, mp in (("data=2", 1), ("model=2", 2)):
        mesh = make_mesh(model_parallel=mp, device_type="cpu")
        net = ttrain.shard_params(TuiNet.from_jax_params(p, TuiNetConfig(**CFG)), mesh).train()
        opt = ttrain.make_optimizer(net, lr=1e-3)
        step = ttrain.make_train_step(sr=SR, hop_length=HOP, mesh=mesh)
        per = BATCH // mesh.size(0)
        rows = slice(data_index(mesh) * per, (data_index(mesh) + 1) * per)
        with chip_smoke.linear_power_features(ttrain):
            loss, acc = step(net, opt, torch.from_numpy(pcm[rows]),
                             torch.from_numpy(labels[rows]))
        out[name] = (float(loss), float(acc), ttrain.full_jax_params(net, mesh))
    out["finetune"] = _finetune_step(KerasModel.load(archive), x, y,
                                     make_mesh(device_type="cpu"))
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """JAX-initialised TuiNet parameters (``build_sharded_train``'s own
    draw at seed 0), a tone batch, and the fine-tune toy (Conv2D without
    bias, BatchNorm, ReLU, Dropout(0.1), pooling, Dense softmax) with its
    batch."""
    import jax

    from audio_analysis_tpu.models import birdnet as jbird

    tf = pytest.importorskip("tensorflow")
    p = jax.tree_util.tree_map(np.asarray, jbird.init_params(jax.random.PRNGKey(0),
                                                             jbird.TuiNetConfig(**CFG)))
    pcm, labels = _tone_batch(np.random.RandomState(3), BATCH)
    tf.keras.utils.set_random_seed(11)
    inp = tf.keras.Input(FEAT)
    # no conv bias: BatchNorm cancels it, so its gradient is float noise
    # around 0, and Adam's first step moves it by +-lr on that noise's sign
    h = tf.keras.layers.Conv2D(8, 3, padding="same", use_bias=False)(inp)
    h = tf.keras.layers.BatchNormalization()(h)
    h = tf.keras.layers.ReLU()(h)
    h = tf.keras.layers.Dropout(0.1)(h)
    h = tf.keras.layers.GlobalAveragePooling2D()(h)
    out = tf.keras.layers.Dense(4, activation="softmax")(h)
    archive = tmp_path_factory.mktemp("toy") / "audioModel.keras"
    tf.keras.Model(inp, out).save(str(archive))
    x, y = _toy_batch(np.random.RandomState(4))
    return p, pcm, labels, str(archive), x, y


@pytest.fixture(scope="module")
def ranks(data):
    """The pair of ranks' outputs, run in a thread while the tests compute
    the single-process steps."""
    box = {}

    def run():
        try:
            box["out"] = tdist.spawn(_steps_rank, 2, args=data, device="cpu", deadline=300)
        except Exception as e:  # noqa: BLE001  (re-raised below, in the test)
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    yield box, t
    t.join(400)


def _outputs(ranks):
    box, t = ranks
    t.join(400)
    assert not t.is_alive(), "the ranks outlived their deadline"
    if "error" in box:
        raise box["error"]
    return box["out"]


@pytest.fixture(scope="module")
def single(data):
    """The single-process step (parallel/train.py ``make_train_step``) on
    the whole batch, from the same parameters."""
    p, pcm, labels = data[:3]
    net = TuiNet.from_jax_params(p, TuiNetConfig(**CFG)).train()
    opt = ttrain.make_optimizer(net, lr=1e-3)
    with chip_smoke.linear_power_features(ttrain):
        loss, acc = ttrain.make_train_step(sr=SR, hop_length=HOP)(
            net, opt, torch.from_numpy(pcm), torch.from_numpy(labels))
    return float(loss), float(acc), net.to_jax_params()


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, np.asarray(tree)


def _assert_leaves_close(got, ref, rel=1e-5):
    ref = dict(_leaves(ref))
    got = dict(_leaves(got))
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        err = np.linalg.norm(got[k] - r) / max(np.linalg.norm(r), 1e-30)
        assert got[k].shape == r.shape and err <= rel, (k, got[k].shape, r.shape, err)


@pytest.mark.parametrize("mesh", ["data=2", "model=2"])
def test_sharded_step_takes_the_single_process_step(single, ranks, mesh):
    """The global batch's loss and accuracy on both ranks, and every leaf
    after the step (the head gathered whole; the running statistics'
    EMA, which is the global batch's statistics) within 1e-5."""
    loss, acc, params = single
    moved = dict(_leaves(params))["/blocks/0/bn1/mean"]
    assert np.abs(moved).max() > 1e-4  # the EMA moved the running mean
    for got in _outputs(ranks):
        g_loss, g_acc, g_params = got[mesh]
        np.testing.assert_allclose(g_loss, loss, rtol=1e-5)
        assert g_acc == acc
        _assert_leaves_close(g_params, params)


def test_model_parallel_step_tracks_jax_sharded_step(data, ranks, monkeypatch):
    """The model=2 step's loss against the JAX package's
    ``build_sharded_train`` (seed 0, the parameters the ranks started from)
    on the virtual 8-device mesh with model_parallel 2, both fed the port's
    features (the JAX frontend replaced by the identity, as the
    jax_frontend_is_ports fixture of tests/test_torch_train.py replaces it):
    within 1e-4."""
    import jax.numpy as jnp

    from audio_analysis_tpu.models import birdnet as jbird
    from audio_analysis_tpu.parallel import train as jtrain
    from audio_analysis_tpu.parallel.mesh import make_mesh as jax_mesh

    _, pcm, labels = data[:3]
    with chip_smoke.linear_power_features(ttrain):
        feats = ttrain.features(torch.from_numpy(pcm), CFG["n_mels"], SR, HOP).numpy()
    monkeypatch.setattr(jtrain, "spectrogram_grid", lambda x, **kw: x)
    mesh = jax_mesh(n_devices=8, model_parallel=2)
    with mesh:
        params, opt_state, jit_step = jtrain.build_sharded_train(
            mesh, jbird.TuiNetConfig(**CFG), sr=SR, hop_length=HOP, lr=1e-3, seed=0)
        _, _, loss, _ = jit_step(params, opt_state, jnp.asarray(feats), jnp.asarray(labels))
    for got in _outputs(ranks):
        np.testing.assert_allclose(got["model=2"][0], float(loss), rtol=1e-4)


def test_data_parallel_finetune_takes_the_single_process_step(data, ranks):
    """A data=2 fine-tune step of the toy with live dropout: each rank's
    masks are its rows of the global batch's, so the loss (1e-5) and every
    leaf after the step (1e-5 in relative L2) are one process's."""
    x, y = data[4:]
    loss, acc, leaves = _finetune_step(KerasModel.load(data[3]), x, y)
    for got in _outputs(ranks):
        np.testing.assert_allclose(got["finetune"][0], loss, rtol=1e-5)
        assert got["finetune"][1] == acc
        _assert_leaves_close(got["finetune"][2], leaves)


def test_model_parallel_needs_a_world_of_that_many_ranks():
    """``--model-parallel 2`` in one process: the JAX make_mesh's ValueError,
    and the process group left again."""
    import torch.distributed as dist

    from audio_analysis_torch.cli.train import run

    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        run(["data", "out", "--model-parallel", "2", "--device", "cpu"])
    assert not dist.is_initialized()
    from audio_analysis_torch.cli.finetune import mesh_size

    assert mesh_size("data=4") == 4
    with pytest.raises(ValueError, match="data=N"):
        mesh_size("model=2")


def _analyse(wav, model_dir):
    from audio_analysis_torch.cli.analyse import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run(["-o", str(wav), "--bird-model", str(model_dir), "--seed", "0", "--device", "cpu"])
    return json.loads(buf.getvalue())


def _one_and_torchrun(module, args, extra):
    """``python -m module`` with `args` in one process (OUT -> one) and
    under torchrun on two gloo CPU ranks with `extra` too (OUT -> many),
    both at once; their stdouts, after both exited 0."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    runs = (([sys.executable, "-m", module], "one", []),
            ([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
              "2", "-m", module], "many", extra))
    procs = [subprocess.Popen(cmd + [a.replace("OUT", out) for a in args] + more, cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd, out, more in runs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [out for out, _ in outs]


def test_train_cli_under_torchrun_serves_like_one_process(tmp_path):
    """tests/test_torch_train.py's data through ``cli/train.py`` in one
    process and under torchrun with ``--model-parallel 2`` (two gloo CPU
    ranks): rank 0 alone writes, and both checkpoints give the same
    analyse result (labels, boxes; confidences within 1)."""
    from audio_analysis_torch.io.audio import write_wav

    sr = 48000
    rng = np.random.RandomState(0)
    data_dir = tmp_path / "data"
    for label, make in [("bird", lambda t: 0.5 * np.sin(2 * np.pi * 3000 * t)),
                        ("noise", lambda t: 0.2 * rng.randn(len(t)))]:
        (data_dir / label).mkdir(parents=True)
        for i in range(2):
            t = np.arange(9 * sr) / sr
            write_wav(data_dir / label / f"{i}.wav", make(t).astype(np.float32), sr)
    _, many = _one_and_torchrun(
        "audio_analysis_torch.cli.train",
        [str(data_dir), str(tmp_path / "OUT"), "--epochs", "2", "--batch", "8", "--n-mels", "32",
         "--device", "cpu"], ["--model-parallel", "2"])
    assert many.count("saved servable checkpoint") == 1  # rank 0 alone
    assert many.count("epoch 1:") == 1
    meta = json.loads((tmp_path / "many" / "metadata.txt").read_text())
    assert meta["labels"] == ["bird", "noise"] and meta["net_channels"] == [64, 128, 256]

    t = np.arange(10 * sr) / sr
    rec = (0.01 * rng.randn(len(t))).astype(np.float32)
    m = (t > 2) & (t < 3.2)
    rec[m] += (0.6 * np.sin(2 * np.pi * (2800 * t[m] + 250 * (t[m] - 2) ** 2))).astype(
        np.float32)
    wav = tmp_path / "rec.wav"
    write_wav(wav, rec, sr)
    ref, got = _analyse(wav, tmp_path / "one"), _analyse(wav, tmp_path / "many")
    assert ref["species_identify"], "the recording must give a track"
    chip_smoke.compare_results(got, ref, confidence_tol=1)


def test_finetune_cli_mesh_under_torchrun_writes_the_one_process_archive(tmp_path):
    """tests/test_torch_finetune.py's CLI fixture (a net over [16, 226, 1]
    mel windows, a new two-label head) through ``cli/finetune.py`` in one
    process and under torchrun with ``--mesh data=2``: rank 0 alone writes,
    and every leaf of the two archives agrees within 1e-5 in relative L2."""
    tf = pytest.importorskip("tensorflow")
    from audio_analysis_torch.io.audio import write_wav

    sr = 48000
    tf.keras.utils.set_random_seed(3)
    inp = tf.keras.Input((16, 226, 1))
    h = tf.keras.layers.Conv2D(4, 3, strides=4, padding="same", activation="relu")(inp)
    h = tf.keras.layers.GlobalAveragePooling2D()(h)
    out = tf.keras.layers.Dense(3, activation="softmax")(h)
    mdir = tmp_path / "model"
    mdir.mkdir()
    tf.keras.Model(inp, out).save(str(mdir / "audioModel.keras"))
    (mdir / "metadata.txt").write_text(json.dumps({
        "name": "t", "labels": ["a", "b", "c"], "segment_length": 3, "segment_stride": 1.5,
        "hop_length": 640, "n_mels": 16, "break_freq": 1750, "htk": True, "fmin": 50,
        "fmax": 11000, "power": 2, "db_scale": True, "threshold": 0.5, "n_fft": 4096,
        "normalize": True,
    }))
    data = tmp_path / "data"
    rng = np.random.RandomState(0)
    for li, label in enumerate(("kiwi", "noise")):
        (data / label).mkdir(parents=True)
        for i in range(2):
            t = np.arange(4 * sr) / sr
            y = 0.05 * rng.randn(len(t)) + (0.3 if li else 0.02) * np.sin(2 * np.pi * 2000 * t)
            write_wav(data / label / f"r{i}.wav", y.astype(np.float32), sr)
    _, many = _one_and_torchrun(
        "audio_analysis_torch.cli.finetune",
        [str(mdir), str(data), str(tmp_path / "OUT"), "--epochs", "2", "--batch", "4",
         "--lr", "1e-3", "--device", "cpu"], ["--mesh", "data=2"])
    assert many.count("wrote ") == 1  # rank 0 alone
    one = KerasModel.load(tmp_path / "one" / "audioModel.keras").params
    two = KerasModel.load(tmp_path / "many" / "audioModel.keras").params
    _assert_leaves_close(two, one)
