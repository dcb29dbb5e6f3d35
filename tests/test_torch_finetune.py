"""The port's Keras fine-tuning (audio_analysis_torch.parallel.finetune, the
training forward of models/keras_graph.py, cli/finetune.py) against the JAX
package's, on the CPU: the masks, replace_head bit for bit, one fine-tune
step's loss, gradients and updated leaves on tests/test_finetune.py's toy
with its dropout zeroed (the masks cannot match jax.random's), frozen and
integer leaves, dropout on its own terms, learning, the CLI, and one
full-width EfficientNetB0 step."""

import json
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from audio_analysis_tpu.models import KerasModel as JaxKerasModel  # noqa: E402
from audio_analysis_tpu.parallel import finetune as jft  # noqa: E402

from audio_analysis_torch.io.keras_export import write_keras_archive  # noqa: E402
from audio_analysis_torch.models import KerasModel  # noqa: E402
from audio_analysis_torch.parallel import finetune as tft  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the EfficientNetB0 fixture)

N_CLASSES = 4
FEAT = (12, 10, 1)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run many small ops in loops, and
    with several test workers sharing the cores a parallel region's threads
    are descheduled and its barrier stalls (a step loop ran ~200x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
_DROPOUTS = ("Dropout", "SpatialDropout2D", "GaussianDropout", "GaussianNoise", "AlphaDropout")


def zero_dropout(src, dst):
    """A copy of the archive whose config.json sets every dropout-like
    layer's rate (and stddev) to 0: the JAX training forward then skips
    them (rate > 0 is its condition), and so does the port's."""

    def walk(obj):
        if isinstance(obj, dict):
            if obj.get("class_name") in _DROPOUTS and isinstance(obj.get("config"), dict):
                for k in ("rate", "stddev"):
                    if k in obj["config"]:
                        obj["config"][k] = 0.0
            for v in obj.values():
                walk(v)
        elif isinstance(obj, list):
            for v in obj:
                walk(v)

    with zipfile.ZipFile(src) as z:
        members = {n: z.read(n) for n in z.namelist()}
    config = json.loads(members["config.json"])
    walk(config)
    members["config.json"] = json.dumps(config).encode()
    with zipfile.ZipFile(dst, "w") as z:
        for n, data in members.items():
            z.writestr(n, data)
    return dst


@pytest.fixture(scope="module")
def saved_model(tmp_path_factory):
    """tests/test_finetune.py's toy: Conv2D, BatchNorm, ReLU, Dropout(0.1),
    GAP, Dense softmax."""
    tf.keras.utils.set_random_seed(11)
    inp = tf.keras.Input(FEAT)
    x = tf.keras.layers.Conv2D(8, 3, padding="same")(inp)
    x = tf.keras.layers.BatchNormalization()(x)
    x = tf.keras.layers.ReLU()(x)
    x = tf.keras.layers.Dropout(0.1)(x)
    x = tf.keras.layers.GlobalAveragePooling2D()(x)
    out = tf.keras.layers.Dense(N_CLASSES, activation="softmax")(x)
    p = tmp_path_factory.mktemp("ft") / "audioModel.keras"
    tf.keras.Model(inp, out).save(str(p))
    return p


@pytest.fixture(scope="module")
def no_dropout(saved_model, tmp_path_factory):
    return zero_dropout(saved_model, tmp_path_factory.mktemp("ft0") / "audioModel.keras")


@pytest.fixture(scope="module")
def logits_model(tmp_path_factory):
    """The toy without dropout and with a linear head: fine-tuned with
    outputs="logits" (log-softmax)."""
    tf.keras.utils.set_random_seed(12)
    inp = tf.keras.Input(FEAT)
    x = tf.keras.layers.Conv2D(8, 3, padding="same")(inp)
    x = tf.keras.layers.BatchNormalization()(x)
    x = tf.keras.layers.ReLU()(x)
    x = tf.keras.layers.GlobalAveragePooling2D()(x)
    out = tf.keras.layers.Dense(N_CLASSES)(x)
    p = tmp_path_factory.mktemp("logits") / "audioModel.keras"
    tf.keras.Model(inp, out).save(str(p))
    return p


@pytest.fixture(scope="module")
def norm_model(tmp_path_factory):
    """An adapted Normalization (float mean/variance, an integer count)
    and a BatchNorm ahead of a Dense head: the frozen and integer leaves."""
    tf.keras.utils.set_random_seed(5)
    norm = tf.keras.layers.Normalization()
    norm.adapt(np.random.RandomState(5).randn(64, *FEAT).astype(np.float32) * 2 + 0.5)
    inp = tf.keras.Input(FEAT)
    x = norm(inp)
    x = tf.keras.layers.Conv2D(6, 3, padding="same", activation="relu")(x)
    x = tf.keras.layers.BatchNormalization()(x)
    x = tf.keras.layers.GlobalAveragePooling2D()(x)
    out = tf.keras.layers.Dense(3, activation="softmax")(x)
    p = tmp_path_factory.mktemp("norm") / "audioModel.keras"
    tf.keras.Model(inp, out).save(str(p))
    return p


def _toy_batch(rng, n=64):
    """Amplitude-coded classes (they survive global pooling)."""
    y = rng.randint(0, N_CLASSES, n).astype(np.int32)
    x = rng.randn(n, *FEAT).astype(np.float32) * 0.1
    x += (y * 1.5).astype(np.float32)[:, None, None, None]
    return x, y


@pytest.mark.parametrize("which", ["toy", "normalization"])
def test_masks_match_jax(saved_model, norm_model, which):
    path = saved_model if which == "toy" else norm_model
    km, jkm = KerasModel.load(path), JaxKerasModel.load(path)
    assert tft.non_trainable_mask(km) == jft.non_trainable_mask(jkm)
    assert tft.decay_mask(km) == jax.tree_util.tree_map(bool, jft.decay_mask(jkm))
    frozen = tft.non_trainable_mask(km)
    bn = next(k for k, cls, _ in km.walk_layers() if cls == "BatchNormalization")
    assert frozen[bn] == [False, False, True, True]
    if which == "normalization":
        norm = next(k for k, cls, _ in km.walk_layers() if cls == "Normalization")
        assert frozen[norm] == [True, True, True]


def test_replace_head_bit_equal_to_jax(saved_model, rng):
    """Same numpy draw, same key, same config; the port's head callable is
    rebuilt, so its in-memory forward gives the new label space (within
    1e-6 of the JAX forward)."""
    km, jkm = KerasModel.load(saved_model), JaxKerasModel.load(saved_model)
    key = tft.replace_head(km, 3, seed=1)
    assert key == jft.replace_head(jkm, 3, seed=1)
    for a, b in zip(km.params[key], jkm.params[key]):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert km.config == jkm.config
    x = rng.randn(5, *FEAT).astype(np.float32)
    with torch.no_grad():
        got = km(torch.from_numpy(x)).numpy()
    assert got.shape == (5, 3)
    np.testing.assert_allclose(got, np.asarray(jkm(jnp.asarray(x))), rtol=0, atol=1e-6)


def _jax_grads(jkm, params, x, y, key, outputs):
    """jax.value_and_grad of the JAX fine-tune loss."""

    def loss(p):
        out, _ = jkm.apply_train(p, x, key)
        if outputs == "probs":
            logp = jnp.log(jnp.clip(out, 1e-9, 1.0))
        else:
            logp = jax.nn.log_softmax(out)
        return -jnp.take_along_axis(logp, y[:, None], axis=1).mean()

    return jax.value_and_grad(loss)(params)


@pytest.mark.parametrize("which", ["toy", "normalization", "logits"])
def test_finetune_step_matches_jax(no_dropout, norm_model, logits_model, which):
    """One fine-tune step from the same leaves on the same batch, dropout
    zeroed: the loss within 1e-5 relative; each trainable leaf's gradient
    within 1e-4 relative and 1e-4 of its layer's largest gradient of
    jax.value_and_grad's (a conv bias ahead of a training-mode BatchNorm
    has a zero gradient, float noise on both sides); the BN moving
    statistics after the EMA within 1e-5; frozen and integer leaves
    untouched (the integer count: int64 as stored, int32 in JAX without
    x64); the updated trainable leaves within 1e-4 x lr where the gradient
    is above 1e-3 of that scale, within 2 lr elsewhere (Adam's first step
    is ~sign(g) * lr, and a gradient at float noise can take either
    sign)."""
    path = {"toy": no_dropout, "normalization": norm_model, "logits": logits_model}[which]
    outputs = "logits" if which == "logits" else "probs"
    lr = 1e-2
    km, jkm = KerasModel.load(path), JaxKerasModel.load(path)
    rng = np.random.RandomState(3)
    x, y = _toy_batch(rng, 16)
    if which == "normalization":
        y = y % 3
    frozen = tft.non_trainable_mask(km)
    before = {k: [np.array(a) for a in vs] for k, vs in km.params.items()}

    jparams, jstate, jstep = jft.build_finetune(jkm, lr=lr, outputs=outputs)
    floats = {k: [a for a in vs if jnp.issubdtype(a.dtype, jnp.floating)]
              for k, vs in jparams.items()}
    loss_j, grads_j = _jax_grads(jkm, floats, jnp.asarray(x), jnp.asarray(y),
                                 jax.random.PRNGKey(0), outputs)
    jparams, jstate, jloss, _ = jstep(jparams, jstate, jnp.asarray(x), jnp.asarray(y),
                                      jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(jloss), float(loss_j), rtol=1e-6)

    params, opt, step = tft.build_finetune(km, "cpu", lr=lr, outputs=outputs)
    loss, _ = step(params, opt, torch.from_numpy(x), torch.from_numpy(y), torch.Generator())
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    for key, leaves in params.items():
        for i, t in enumerate(leaves):
            got, ref = t.detach().numpy(), np.asarray(jparams[key][i])
            name = f"{key}/{i}"
            assert got.dtype == ref.dtype or not t.is_floating_point(), name
            if frozen[key][i] or not t.is_floating_point():
                if "batch_normalization" in key:  # the moving statistics: the EMA
                    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6, err_msg=name)
                else:
                    np.testing.assert_array_equal(got, before[key][i], err_msg=name)
                    np.testing.assert_array_equal(ref, before[key][i], err_msg=name)
                assert t.grad is None, name
                continue
            g, gj = t.grad.numpy(), np.asarray(grads_j[key][i])
            scale = max(np.abs(np.asarray(a)).max() for a in grads_j[key])
            np.testing.assert_allclose(g, gj, rtol=1e-4, atol=1e-4 * scale, err_msg=name)
            clear = np.abs(gj) > 1e-3 * scale
            np.testing.assert_allclose(got[clear], ref[clear], rtol=0, atol=1e-4 * lr,
                                       err_msg=name)
            np.testing.assert_allclose(got, ref, rtol=0, atol=2 * lr, err_msg=name)


def test_dropout_semantics(tmp_path, rng):
    """The training forward's noise layers on their own terms: Dropout keeps
    1 - rate of the entries (within 0.02 over 12,288) and scales them by
    1/(1 - rate) exactly; SpatialDropout2D draws one mask per (batch,
    channel); Dropout's noise_shape (None, 1, 1, 1) one per example;
    GaussianDropout multiplies by 1 + N(0, rate/(1 - rate)); the same
    generator seed gives the same masks and another seed others; the
    inference forward is the identity."""
    inp = tf.keras.Input((8, 6, 4))
    outs = [tf.keras.layers.Dropout(0.3)(inp),
            tf.keras.layers.SpatialDropout2D(0.5)(inp),
            tf.keras.layers.Dropout(0.5, noise_shape=(None, 1, 1, 1))(inp),
            tf.keras.layers.GaussianDropout(0.2)(inp)]
    path = tmp_path / "noise.keras"
    tf.keras.Model(inp, outs).save(str(path))
    km = KerasModel.load(path)
    x = torch.from_numpy(rng.rand(64, 8, 6, 4).astype(np.float32) + 0.5)
    params = {k: [torch.from_numpy(a) for a in vs] for k, vs in km.params.items()}
    (d, sd, ns, gd), stats = km.apply_train(params, x, torch.Generator().manual_seed(0))
    assert stats == {}
    kept = d != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.02
    torch.testing.assert_close(d[kept], x[kept] / (1.0 - 0.3), rtol=0, atol=0)
    per_bc = (sd != 0).float().mean(dim=(1, 2))  # [64, 4]: each 0 or 1
    assert set(per_bc.unique().tolist()) == {0.0, 1.0}
    assert torch.equal(sd[sd != 0], x[sd != 0] * 2.0)
    per_b = (ns != 0).float().mean(dim=(1, 2, 3))
    assert set(per_b.unique().tolist()) == {0.0, 1.0}
    ratio = gd / x
    assert abs(ratio.mean().item() - 1.0) < 0.02
    assert abs(ratio.std().item() - np.sqrt(0.2 / 0.8)) < 0.02
    again, _ = km.apply_train(params, x, torch.Generator().manual_seed(0))
    other, _ = km.apply_train(params, x, torch.Generator().manual_seed(1))
    for a, b, c in zip((d, sd, ns, gd), again, other):
        assert torch.equal(a, b) and not torch.equal(a, c)
    with torch.no_grad():
        for o in km(x):
            assert torch.equal(o, x)


def test_batchnorm_training_forward_matches_jax(no_dropout, rng):
    """The batch statistics a training forward records for the toy's
    BatchNorm (mean, centered biased variance, on inputs of a large mean)
    and its output against JAX apply_train, dropout zeroed: within 1e-5."""
    km, jkm = KerasModel.load(no_dropout), JaxKerasModel.load(no_dropout)
    x = rng.randn(16, *FEAT).astype(np.float32) * 3 + 20  # a large mean
    params = {k: [torch.from_numpy(a) for a in vs] for k, vs in km.params.items()}
    out, stats = km.apply_train(params, torch.from_numpy(x), torch.Generator())
    jout, jstats = jkm.apply_train(jkm.params, jnp.asarray(x), jax.random.PRNGKey(0))
    assert set(stats) == set(jstats)
    for key, (bm, bv) in stats.items():
        np.testing.assert_allclose(bm.numpy(), np.asarray(jstats[key][0]), rtol=1e-5)
        np.testing.assert_allclose(bv.numpy(), np.asarray(jstats[key][1]), rtol=1e-5)
        assert not bm.requires_grad and not bv.requires_grad
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)


def test_finetune_learns_and_moves_bn(saved_model, rng, tmp_path):
    """tests/test_finetune.py's check through the port: 150 steps at lr
    3e-2 with live dropout reach accuracy > 0.9, the BN moving mean moves
    (the EMA), and the exported archive, reloaded, classifies held-out data
    at > 0.9."""
    km = KerasModel.load(saved_model)
    bn_key = next(k for k, cls, _ in km.walk_layers() if cls == "BatchNormalization")
    mean0 = np.array(km.params[bn_key][-2])
    params, opt, step = tft.build_finetune(km, "cpu", lr=3e-2)
    gen = torch.Generator().manual_seed(0)
    for _ in range(150):
        x, y = _toy_batch(rng)
        loss, acc = step(params, opt, torch.from_numpy(x), torch.from_numpy(y), gen)
    assert float(acc) > 0.9, float(acc)
    assert not np.allclose(params[bn_key][-2].numpy(), mean0)
    out = write_keras_archive(saved_model, params, tmp_path / "tuned.keras")
    x, y = _toy_batch(rng, 128)
    with torch.no_grad():
        probs = KerasModel.load(out)(torch.from_numpy(x)).numpy()
    assert (probs.argmax(1) == y).mean() > 0.9


def test_build_finetune_needs_cuda_unless_cpu_is_asked_for(saved_model):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tft.build_finetune(KerasModel.load(saved_model))


def test_finetune_cli_end_to_end(tmp_path):
    """``python -m audio_analysis_torch.cli.finetune MODEL DATA OUT --device
    cpu`` on tests/test_finetune.py's tool fixture (a net over [16, 226, 1]
    mel windows, two new labels): the head is replaced, metadata.txt
    carries the labels and drops ebird_ids, the model dir's *.json files
    are copied, and the archive loads in both packages with equal
    probabilities (within 1e-6)."""
    from audio_analysis_torch.io.audio import write_wav

    sr = 48000
    tf.keras.utils.set_random_seed(3)
    inp = tf.keras.Input((16, 226, 1))
    x = tf.keras.layers.Conv2D(4, 3, strides=4, padding="same", activation="relu")(inp)
    x = tf.keras.layers.GlobalAveragePooling2D()(x)
    out = tf.keras.layers.Dense(3, activation="softmax")(x)
    mdir = tmp_path / "model"
    mdir.mkdir()
    tf.keras.Model(inp, out).save(str(mdir / "audioModel.keras"))
    (mdir / "metadata.txt").write_text(json.dumps({
        "name": "t", "labels": ["a", "b", "c"], "ebird_ids": ["x", "y", "z"],
        "segment_length": 3, "segment_stride": 1.5, "hop_length": 640, "n_mels": 16,
        "break_freq": 1750, "htk": True, "fmin": 50, "fmax": 11000, "power": 2,
        "db_scale": True, "threshold": 0.5, "n_fft": 4096, "normalize": True,
    }))
    (mdir / "extra.json").write_text('{"k": 1}')
    data = tmp_path / "data"
    rng = np.random.RandomState(0)
    for li, label in enumerate(("kiwi", "noise")):
        (data / label).mkdir(parents=True)
        for i in range(2):
            t = np.arange(4 * sr) / sr
            y = 0.05 * rng.randn(len(t)) + (0.3 if li else 0.02) * np.sin(2 * np.pi * 2000 * t)
            write_wav(data / label / f"r{i}.wav", y.astype(np.float32), sr)
    outdir = tmp_path / "tuned"
    r = subprocess.run(
        [sys.executable, "-m", "audio_analysis_torch.cli.finetune", str(mdir), str(data),
         str(outdir), "--epochs", "1", "--batch", "4", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "replacing head" in r.stdout
    meta = json.loads((outdir / "metadata.txt").read_text())
    assert meta["labels"] == ["kiwi", "noise"] and "ebird_ids" not in meta
    assert (outdir / "extra.json").read_text() == '{"k": 1}'
    x = np.random.RandomState(1).rand(2, 16, 226, 1).astype(np.float32)
    with torch.no_grad():
        got = KerasModel.load(outdir / "audioModel.keras")(torch.from_numpy(x)).numpy()
    ref = np.asarray(JaxKerasModel.load(outdir / "audioModel.keras")(jnp.asarray(x)))
    assert got.shape == (2, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_efficientnet_b0_step_matches_jax(tmp_path):
    """One fine-tune step of the full-width EfficientNetB0 (the committed
    archive seeded by chip_smoke.efficientnet_fixture, dropout and
    stochastic depth zeroed) at batch 2 on [2, 160, 226, 3]: the loss
    within 1e-4 relative of the JAX step's, and the updated leaves of the
    stem conv, the first BatchNorm's moving mean and the head within
    2 x lr of JAX's (its gradients pass 81 BatchNorms)."""
    src = chip_smoke.efficientnet_fixture(tmp_path / "effnet", seed=0) / "audioModel.keras"
    path = zero_dropout(src, tmp_path / "b0.keras")
    km, jkm = KerasModel.load(path), JaxKerasModel.load(path)
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 160, 226, 3) * 10 - 40).astype(np.float32)
    y = np.array([1, 5], np.int32)
    lr = 1e-4
    jparams, jstate, jstep = jft.build_finetune(jkm, lr=lr)
    jparams, _, jloss, _ = jstep(jparams, jstate, jnp.asarray(x), jnp.asarray(y),
                                 jax.random.PRNGKey(0))
    params, opt, step = tft.build_finetune(km, "cpu", lr=lr)
    loss, _ = step(params, opt, torch.from_numpy(x), torch.from_numpy(y), torch.Generator())
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    keys = [k for k, cls, _ in km.walk_layers() if cls in ("Conv2D", "BatchNormalization",
                                                           "Dense")]
    for key in (keys[0], keys[1], keys[-1]):
        for i, t in enumerate(params[key]):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(jparams[key][i]),
                                       rtol=1e-5, atol=2 * lr, err_msg=f"{key}/{i}")
