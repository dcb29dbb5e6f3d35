"""The port's TuiNet trainer (audio_analysis_torch.parallel.train, the
training mode of models/birdnet.py, the checkpoint save and cli/train.py)
against the JAX package's, on the CPU at a small size: one step's loss and
gradients (through loss_fn, and on positive features so that every conv,
BatchNorm and mag_a gradient is nonzero), the batch statistics, AdamW on
identical gradients against optax, the BatchNorm EMA and the MagTransform
constraint bit for bit, a few whole steps, the EMA's convergence at lr 0,
and train -> serve through both packages' analyse CLIs."""

import contextlib
import copy
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from audio_analysis_tpu.io import checkpoint as jckpt
from audio_analysis_tpu.models import birdnet as jbird
from audio_analysis_tpu.parallel import train as jtrain

from audio_analysis_torch.io import checkpoint as tckpt
from audio_analysis_torch.models.birdnet import TuiNet, TuiNetConfig
from audio_analysis_torch.models.magtransform import mag_transform_apply_constraint
from audio_analysis_torch.parallel import train as ttrain

REPO = Path(__file__).resolve().parent.parent

SR, HOP = 1600, 64
CFG = dict(num_classes=4, n_mels=32, channels=(8, 16), dense_units=64, dtype="float32")
FREQS = [100, 250, 420, 700]


@pytest.fixture(autouse=True)
def _exact_level(monkeypatch):
    for knob in ("AAT_FAST", "AAT_PALLAS", "AAT_PALLAS_ALG"):
        monkeypatch.delenv(knob, raising=False)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run many small ops in loops, and
    with several test workers sharing the cores a parallel region's threads
    are descheduled and its barrier stalls (a step loop ran ~200x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(seed=0, cfg_kw=CFG):
    """JAX-initialised parameters with non-trivial BN statistics, numpy."""
    p = jax.tree_util.tree_map(
        np.asarray, jbird.init_params(jax.random.PRNGKey(seed), jbird.TuiNetConfig(**cfg_kw)))
    rng = np.random.RandomState(seed)
    for blk in p["blocks"]:
        for bn in ("bn1", "bn2"):
            c = blk[bn]["mean"].shape[0]
            blk[bn]["mean"] = (0.1 * rng.randn(c)).astype(np.float32)
            blk[bn]["var"] = (1 + 0.1 * rng.rand(c)).astype(np.float32)
            blk[bn]["gamma"] = (1 + 0.1 * rng.randn(c)).astype(np.float32)
            blk[bn]["beta"] = (0.1 * rng.randn(c)).astype(np.float32)
    return p


def _tone_batch(rng, n):
    """Four separable classes: tones at FREQS with a little noise, 3 s."""
    labels = rng.randint(0, 4, size=n)
    t = np.arange(3 * SR) / SR
    pcm = np.stack([np.sin(2 * np.pi * FREQS[l] * t) + 0.05 * rng.randn(len(t))
                    for l in labels]).astype(np.float32)
    return pcm, labels.astype(np.int32)


def _grads_tree(net):
    """The port's gradients in the JAX tree layout (conv kernels HWIO); the
    running statistics are not parameters and are left out."""
    g = copy.deepcopy(net)
    for p, src in zip(g.parameters(), net.parameters()):
        p.data = src.grad.clone()
    tree = g.to_jax_params()
    for blk in tree["blocks"]:
        for bn in ("bn1", "bn2"):
            del blk[bn]["mean"], blk[bn]["var"]
    return tree


def _assert_trees_close(got, ref, rel, what):
    """Each leaf of `got` within rel x (its max abs) of `ref`'s leaf."""
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    for path, g in jax.tree_util.tree_flatten_with_path(got)[0]:
        r = np.asarray(flat_ref[path])
        np.testing.assert_allclose(np.asarray(g), r, rtol=rel, atol=rel * np.abs(r).max() + 1e-12,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _to_port(tree, net):
    """A JAX-layout tree as {port parameter name: tensor} (HWIO -> OIHW)."""
    out = {}
    for name, _ in net.named_parameters():
        node = tree
        for part in ttrain._jax_path(name).split("/"):
            node = node[int(part)] if isinstance(node, list) else node[part]
        t = torch.from_numpy(np.array(node, np.float32))
        out[name] = t.permute(3, 2, 0, 1).contiguous() if t.ndim == 4 else t.reshape(
            dict(net.named_parameters())[name].shape)
    return out


def test_checkpoint_round_trip_with_jax(tmp_path):
    """The port's save_checkpoint is read by the JAX loader (and the JAX
    save by the port's), leaf for leaf; tensors are moved to the host; a
    '/' in a name is refused."""
    p = _jax_params(1)
    net = TuiNet.from_jax_params(p, TuiNetConfig(**CFG))
    meta = {"labels": ["a", "b", "c", "d"], "net_channels": [8, 16]}
    tckpt.save_checkpoint(tmp_path / "port", net.to_jax_params(), meta)
    jckpt.save_checkpoint(tmp_path / "jax", p, meta)
    assert (tmp_path / "port" / "metadata.txt").read_text() == \
        (tmp_path / "jax" / "metadata.txt").read_text()
    for a, b in ((jckpt.load_checkpoint_params(tmp_path / "port"), p),
                 (tckpt.load_checkpoint_params(tmp_path / "jax"), p)):
        jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)
    tckpt.save_checkpoint(tmp_path / "t", {"x": [torch.ones(2), np.zeros(3)]}, {})
    back = jckpt.load_checkpoint_params(tmp_path / "t")
    np.testing.assert_array_equal(back["x"][0], np.ones(2, np.float32))
    with pytest.raises(ValueError, match="'/'"):
        tckpt.save_checkpoint(tmp_path / "bad", {"a/b": np.zeros(1)}, {})


def test_to_jax_params_inverts_from_jax_params():
    p = _jax_params(2)
    back = TuiNet.from_jax_params(p, TuiNetConfig(**CFG)).to_jax_params()
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, p)


def test_init_matches_jax_shapes_and_scales():
    """``TuiNet.init`` draws the JAX init's tree (shapes, zeros, ones, and
    the He scales within 15%), reproducibly from a generator seed."""
    cfg = dict(CFG, channels=(32, 64), stem_channels=32, dense_units=128)
    ref = jax.tree_util.tree_map(np.asarray, jbird.init_params(jax.random.PRNGKey(0),
                                                               jbird.TuiNetConfig(**cfg)))
    a = TuiNet.init(TuiNetConfig(**cfg), torch.Generator().manual_seed(3)).to_jax_params()
    b = TuiNet.init(TuiNetConfig(**cfg), torch.Generator().manual_seed(3)).to_jax_params()
    jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)
    for (path, x), (_, r) in zip(jax.tree_util.tree_flatten_with_path(a)[0],
                                 jax.tree_util.tree_flatten_with_path(ref)[0]):
        assert x.shape == r.shape and x.dtype == r.dtype, path
        if r.std() == 0:
            np.testing.assert_array_equal(x, r)
        else:
            assert abs(x.std() / r.std() - 1) < 0.15, (jax.tree_util.keystr(path), x.std(), r.std())


@pytest.fixture
def jax_frontend_is_ports(monkeypatch):
    """The JAX loss_fn's frontend replaced by the port's (on concrete PCM).

    TuiNet clamps its dB input at 0 and raises it to sigmoid(mag_a) ~ 0.27,
    which is infinitely steep at 0: the JAX frontend on the CPU (XLA,
    float32) leaves values up to ~2e-6 above 0 in each window's loudest
    bin, which become ~0.03, where the port's float64 DFT gives exactly 0
    (ROADMAP Queue 3). The frontends are held to each other by their own
    tests and below within 1e-5; the trainer's parity is held on equal
    features."""

    def port_features(pcm, **kw):
        x = torch.from_numpy(np.array(pcm))
        return jnp.asarray(ttrain.features(x, kw["n_mels"], kw["sr"], kw["hop_length"]).numpy())

    monkeypatch.setattr(jtrain, "spectrogram_grid", port_features)


def test_training_frontend_matches_jax():
    """The port's training features against the JAX frontend's, within 1e-5
    (dB, so absolute); the port's are <= 0, as dB below the window's peak
    are."""
    from audio_analysis_tpu.pipeline.frontend import spectrogram_grid

    pcm, _ = _tone_batch(np.random.RandomState(0), 16)
    ref = np.asarray(spectrogram_grid(
        jnp.asarray(pcm), sr=SR, hop_length=HOP, n_fft=4096, n_mels=CFG["n_mels"],
        mel_break=1750.0, htk=True, power=2.0, db_scale=True, normalize=True))
    got = ttrain.features(torch.from_numpy(pcm), CFG["n_mels"], SR, HOP).numpy()
    assert got.shape == ref.shape == (16, CFG["n_mels"], 1 + 3 * SR // HOP, 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert got.max() <= 0.0


def test_loss_and_grads_match_jax_through_loss_fn(jax_frontend_is_ports):
    """One training step's loss, accuracy and gradients through loss_fn
    (the frontend, the training forward, the NLL) against
    jax.value_and_grad of the JAX loss_fn, on carried weights, one seeded
    batch and equal features: the loss within 1e-5 relative, each gradient
    leaf within 5e-4 of its max abs. (dB features are <= 0, so TuiNet's
    clamp zeroes them: the conv gradients are zero on both sides, and the
    BatchNorms see activations that vary only at the SAME padding's
    border, whose tiny variances make the gradients sensitive to the order
    of the float32 sums; the next test holds every leaf at 1e-4 on
    features the net sees.)"""
    p = _jax_params(0)
    pcm, labels = _tone_batch(np.random.RandomState(0), 16)
    (loss_j, (acc_j, _)), grads_j = jax.value_and_grad(jtrain.loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(pcm), jnp.asarray(labels),
        jbird.TuiNetConfig(**CFG), SR, HOP)
    net = TuiNet.from_jax_params(p, TuiNetConfig(**CFG)).train()
    loss, (acc, _) = ttrain.loss_fn(net, torch.from_numpy(pcm), torch.from_numpy(labels), SR, HOP)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    assert float(acc) == float(acc_j)
    grads_j = jax.tree_util.tree_map(np.asarray, grads_j)
    for blk in grads_j["blocks"]:
        for bn in ("bn1", "bn2"):
            assert not blk[bn]["mean"].any() and not blk[bn]["var"].any()
            del blk[bn]["mean"], blk[bn]["var"]
    _assert_trees_close(_grads_tree(net), grads_j, 5e-4, "gradient")


def _positive_features(seed=0, n=12):
    return (np.abs(np.random.RandomState(seed).randn(n, 32, 41, 1)) * 3.0).astype(np.float32)


def _jax_feature_loss(params, x, labels, cfg):
    logits, stats = jbird.apply(params, x, cfg, training=True, with_stats=True)
    logp = jax.nn.log_softmax(logits)
    return -jnp.take_along_axis(logp, labels[:, None], axis=1).mean(), stats


def test_grads_on_positive_features_match_jax():
    """The training forward on a seeded grid of positive features (so the
    clamp passes them): every conv, BatchNorm gamma/beta and mag_a gradient
    is nonzero, and each leaf is within 1e-4 of its max abs of the JAX
    gradient; the loss within 1e-5 relative."""
    p = _jax_params(4)
    x = _positive_features()
    labels = np.arange(len(x), dtype=np.int32) % 4
    (loss_j, _), grads_j = jax.value_and_grad(_jax_feature_loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(labels),
        jbird.TuiNetConfig(**CFG))
    net = TuiNet.from_jax_params(p, TuiNetConfig(**CFG)).train()
    logits = net(torch.from_numpy(x))
    loss = -torch.log_softmax(logits, 1).gather(1, torch.from_numpy(labels).long()[:, None]).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    for name, prm in net.named_parameters():
        assert prm.grad.abs().max() > 0, f"{name}: zero gradient"
    grads_j = jax.tree_util.tree_map(np.asarray, grads_j)
    for blk in grads_j["blocks"]:
        for bn in ("bn1", "bn2"):
            del blk[bn]["mean"], blk[bn]["var"]
    _assert_trees_close(_grads_tree(net), grads_j, 1e-4, "gradient")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_stats_match_jax(dtype):
    """Per-layer batch statistics of the training forward against JAX
    ``apply(training=True, with_stats=True)``: float32 within 1e-5 of each
    statistic's max abs; bfloat16 (both sides round the convolutions'
    inputs to bf16 at different places) within 2e-2."""
    cfg = dict(CFG, dtype=dtype)
    p = _jax_params(5)
    x = _positive_features(1)
    _, ref = jbird.apply(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
                         jbird.TuiNetConfig(**cfg), training=True, with_stats=True)
    net = TuiNet.from_jax_params(p, TuiNetConfig(**cfg)).train()
    with torch.no_grad():
        _, got = net(torch.from_numpy(x), with_stats=True)
    assert len(got) == len(ref) == len(cfg["channels"])
    rel = 1e-5 if dtype == "float32" else 2e-2
    for g, r in zip(got, ref):
        for bn in ("bn1", "bn2"):
            for k in ("mean", "var"):
                rk = np.asarray(r[bn][k])
                np.testing.assert_allclose(g[bn][k].numpy(), rk, rtol=rel,
                                           atol=rel * np.abs(rk).max(), err_msg=f"{bn} {k}")
    net.eval()
    with torch.no_grad():
        _, none = net(torch.from_numpy(x), with_stats=True)
    assert none == [{"bn1": None, "bn2": None}] * len(cfg["channels"])


def test_decay_mask_matches_jax():
    p = _jax_params(0)
    ref = jtrain._decay_mask(p)
    net = TuiNet.from_jax_params(p, TuiNetConfig(**CFG))
    mask = ttrain._decay_mask(net)
    flat = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
    for name, decayed in mask.items():
        parts = ttrain._jax_path(name).split("/")
        key = "".join(f"[{int(q)}]" if q.isdigit() else f"['{q}']" for q in parts)
        assert flat[key] is decayed, name
    assert sum(mask.values()) == 3 + 2 * len(CFG["channels"])  # stem, head, block kernels
    # the running statistics: decay-masked in JAX, outside the optimizer here
    assert not any("mean" in n or "var" in n for n in mask)


def test_adamw_update_matches_optax():
    """Three AdamW steps on identical gradients (seeded, with entries below
    eps and exact zeros, the statistics' gradients zero as the training
    forward makes them): the port's optimizer groups against
    ``optax.adamw(mask=_decay_mask)``, every leaf within 1e-6 relative and
    1e-4 x lr absolute (optax takes Adam's bias corrections 1 - beta^t in
    float32, ~3e-5 relative off at beta2 = 0.999 and t = 1; torch in
    float64)."""
    p = _jax_params(6)
    lr, wd = 3e-3, 1e-4
    opt = jtrain.make_optimizer(lr, weight_decay=wd, params=p)
    state = opt.init(p)
    pj = p
    net = TuiNet.from_jax_params(p, TuiNetConfig(**CFG)).train()
    topt = ttrain.make_optimizer(net, lr=lr, weight_decay=wd)
    rng = np.random.RandomState(7)
    for _ in range(3):
        def draw(path, a):
            name = jax.tree_util.keystr(path)
            if "'mean'" in name or "'var'" in name:
                return np.zeros_like(a)
            g = rng.randn(*a.shape).astype(np.float32)
            g[rng.rand(*a.shape) < 0.2] *= 1e-10  # well below eps
            g[rng.rand(*a.shape) < 0.1] = 0.0
            return g

        grads = jax.tree_util.tree_map_with_path(draw, p)
        updates, state = opt.update(grads, state, pj)
        pj = jax.tree_util.tree_map(np.asarray, optax.apply_updates(pj, updates))
        for name, g in _to_port(grads, net).items():
            dict(net.named_parameters())[name].grad = g
        topt.step()
    got = net.to_jax_params()
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-4 * lr), got, pj)


def test_bn_ema_and_constraint_are_exact():
    """The BatchNorm EMA and the MagTransform constraint, bit for bit."""
    p = _jax_params(8)
    rng = np.random.RandomState(8)
    stats = [{bn: {"mean": rng.randn(c).astype(np.float32),
                   "var": rng.rand(c).astype(np.float32)} for bn in ("bn1", "bn2")}
             for c in CFG["channels"]]
    for momentum in (0.99, 0.8):
        ref = jtrain._ema_bn_stats(jax.tree_util.tree_map(jnp.asarray, p), stats, momentum)
        net = TuiNet.from_jax_params(p, TuiNetConfig(**CFG))
        ttrain._ema_bn_stats(net, [{bn: {k: torch.from_numpy(v) for k, v in s[bn].items()}
                                    for bn in s} for s in stats], momentum)
        jax.tree_util.tree_map(np.testing.assert_array_equal, net.to_jax_params(),
                               jax.tree_util.tree_map(np.asarray, ref))
    from audio_analysis_tpu.models.magtransform import (
        mag_transform_apply_constraint as jconstraint)

    a = np.array([[-3.0], [-2.0], [-1.5], [-1.0], [-0.3], [0.0], [0.7], [1.0], [1.2], [2.5]],
                 np.float32)
    got = mag_transform_apply_constraint(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jconstraint(jnp.asarray(a))))
    net = TuiNet.from_jax_params(p, TuiNetConfig(**CFG))
    with torch.no_grad():
        net.mag_a.fill_(1.7)
    ttrain._apply_constraint(net)
    np.testing.assert_array_equal(net.mag_a.detach().numpy(),
                                  np.asarray(jconstraint(jnp.asarray([1.7], jnp.float32))))


def test_whole_steps_track_jax(jax_frontend_is_ports):
    """Four whole train steps from the same carried weights on the same
    batches (equal features): the first step's loss within 1e-5 relative
    of the JAX step's, the later ones within 1e-3 (Adam's first update is
    ~sign(g) * lr, so gradients that differ in their last bits can move an
    entry by lr)."""
    p = _jax_params(9)
    cfg = jbird.TuiNetConfig(**CFG)
    opt = jtrain.make_optimizer(1e-3, params=p)
    state = opt.init(p)
    jstep = jtrain.make_train_step(cfg, opt, sr=SR, hop_length=HOP)
    net = TuiNet.from_jax_params(p, TuiNetConfig(**CFG))
    topt = ttrain.make_optimizer(net, lr=1e-3)
    step = ttrain.make_train_step(sr=SR, hop_length=HOP)
    rng = np.random.RandomState(9)
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    for i in range(4):
        pcm, labels = _tone_batch(rng, 16)
        pj, state, loss_j, acc_j = jstep(pj, state, jnp.asarray(pcm), jnp.asarray(labels))
        loss, acc = step(net, topt, torch.from_numpy(pcm), torch.from_numpy(labels))
        np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5 if i == 0 else 1e-3)
    got, ref = net.to_jax_params(), jax.tree_util.tree_map(np.asarray, pj)
    for blk_g, blk_r in zip(got["blocks"], ref["blocks"]):  # the EMA ran on both sides
        for bn in ("bn1", "bn2"):
            np.testing.assert_allclose(blk_g[bn]["mean"], blk_r[bn]["mean"], rtol=1e-3,
                                       atol=1e-4)
    np.testing.assert_allclose(got["mag_a"], ref["mag_a"], rtol=1e-5)


def test_train_step_learns_and_bn_ema_converges_at_lr0(monkeypatch):
    """tests/test_parallel.py's checks through the port's step, on linear
    mel power (the trainer's dB features are <= 0, exactly so in the port,
    and TuiNet's clamp turns them into an all-zero input, on which a fresh
    net's activations are all 0: ROADMAP Queue 3): thirty steps learn and
    move every running statistic from (0, 1), variances positive; then at
    lr 0 on one fixed batch (momentum 0.8) the running statistics converge
    to the batch's, the eval forward reproduces the training forward's
    logits (within 5e-2) and accuracy, and AdamW moves no parameter."""
    from audio_analysis_torch.pipeline.frontend import spectrogram_grid

    computed = {}  # the lr-0 phase feeds one batch 60 times: its features once

    def linear_power(pcm, n_mels, sr, hop_length, level=None):
        if id(pcm) not in computed:
            with torch.no_grad():
                computed[id(pcm)] = (pcm, spectrogram_grid(
                    pcm, sr=sr, hop_length=hop_length, n_fft=4096, n_mels=n_mels,
                    mel_break=1750.0, htk=True, power=2.0, db_scale=False, normalize=True))
        return computed[id(pcm)][1]

    monkeypatch.setattr(ttrain, "features", linear_power)
    rng = np.random.RandomState(1)
    net, opt, step = ttrain.build_train(TuiNetConfig(**CFG), "cpu", sr=SR, hop_length=HOP,
                                        lr=1e-3, bn_momentum=0.9)
    losses = []
    for _ in range(30):
        pcm, labels = _tone_batch(rng, 16)
        loss, _ = step(net, opt, torch.from_numpy(pcm), torch.from_numpy(labels))
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])  # it learns
    for blk in net.blocks:
        for bn in (blk.bn1, blk.bn2):
            assert not torch.allclose(bn.mean, torch.zeros_like(bn.mean))
            assert not torch.allclose(bn.var, torch.ones_like(bn.var))
            assert (bn.var > 0).all()

    opt0 = ttrain.make_optimizer(net, lr=0.0)
    step0 = ttrain.make_train_step(sr=SR, hop_length=HOP, bn_momentum=0.8)
    pcm, labels = _tone_batch(rng, 32)
    pcm, labels = torch.from_numpy(pcm), torch.from_numpy(labels)
    head0 = net.head_w1.detach().clone()
    for _ in range(60):
        step0(net, opt0, pcm, labels)
    feats = ttrain.features(pcm, CFG["n_mels"], SR, HOP)
    with torch.no_grad():
        train_logits = net.train()(feats).numpy()
        eval_logits = net.eval()(feats).numpy()
    np.testing.assert_allclose(eval_logits, train_logits, rtol=5e-2, atol=5e-2)
    assert (np.argmax(eval_logits, 1) == labels.numpy()).mean() == \
        (np.argmax(train_logits, 1) == labels.numpy()).mean()
    torch.testing.assert_close(net.head_w1.detach(), head0, rtol=0, atol=0)


def test_new_modules_import_no_jax():
    """The modules this slice adds, in a fresh interpreter: neither jax nor
    the JAX package (nor h5py or tensorflow) is loaded."""
    code = (
        "import importlib, sys\n"
        "for m in ('audio_analysis_torch.parallel.train', 'audio_analysis_torch.parallel.finetune',\n"
        "          'audio_analysis_torch.io.keras_export', 'audio_analysis_torch.io.checkpoint',\n"
        "          'audio_analysis_torch.cli.train', 'audio_analysis_torch.cli.finetune'):\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'audio_analysis_tpu', 'h5py', 'tensorflow', 'optax'))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_build_train_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.build_train(TuiNetConfig(**CFG))
    from audio_analysis_torch.cli.train import run

    with pytest.raises(RuntimeError, match="CUDA"):
        run(["data", "out"])


def _analyse_json(run, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run(argv)
    res = json.loads(buf.getvalue())
    res.pop("processing_time_seconds")
    return res


def test_train_cli_to_both_analyse_clis(tmp_path):
    """tests/test_train_to_serve.py's data (two 9 s tones, two 9 s noises)
    through ``python -m audio_analysis_torch.cli.train --n-mels 32 --device
    cpu``; the checkpoint (the JAX layout and metadata) served by the
    port's analyse CLI and by the JAX package's gives equal result JSON,
    apart from processing_time_seconds."""
    from audio_analysis_torch.io.audio import write_wav

    sr = 48000
    rng = np.random.RandomState(0)
    data = tmp_path / "data"
    for label, make in [("bird", lambda t: 0.5 * np.sin(2 * np.pi * 3000 * t)),
                        ("noise", lambda t: 0.2 * rng.randn(len(t)))]:
        (data / label).mkdir(parents=True)
        for i in range(2):
            t = np.arange(9 * sr) / sr
            write_wav(data / label / f"{i}.wav", make(t).astype(np.float32), sr)
    out_dir = tmp_path / "model"
    r = subprocess.run(
        [sys.executable, "-m", "audio_analysis_torch.cli.train", str(data), str(out_dir),
         "--epochs", "2", "--batch", "8", "--n-mels", "32", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "dataset: 20 windows" in r.stdout and "epoch 1:" in r.stdout
    meta = json.loads((out_dir / "metadata.txt").read_text())
    assert meta["labels"] == ["bird", "noise"] and meta["net_channels"] == [64, 128, 256]
    params = jckpt.load_checkpoint_params(out_dir)
    assert params["stem"]["w"].shape == (3, 3, 1, 32)  # HWIO, the JAX layout
    assert not np.allclose(params["head"]["w2"], 0)

    t = np.arange(10 * sr) / sr
    rec = (0.01 * rng.randn(len(t))).astype(np.float32)
    m = (t > 2) & (t < 3.2)
    rec[m] += (0.6 * np.sin(2 * np.pi * (2800 * t[m] + 250 * (t[m] - 2) ** 2))).astype(np.float32)
    wav = tmp_path / "rec.wav"
    write_wav(wav, rec, sr)
    from audio_analysis_torch.cli.analyse import run as torch_run
    from audio_analysis_tpu.cli.analyse import run as jax_run

    argv = ["-o", str(wav), "--bird-model", str(out_dir), "--seed", "0"]
    ref = _analyse_json(jax_run, argv)
    got = _analyse_json(torch_run, argv + ["--device", "cpu"])
    assert ref["species_identify"], "the recording must give a track"
    assert got == ref
