"""The port's TuiNet (audio_analysis_torch.models.birdnet) carries the JAX
parameter tree across with from_jax_params and gives the JAX package's
logits (birdnet.apply) on the same seeded inputs; the NHWC layer ops keep
TF's asymmetric SAME padding."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_analysis_tpu.models import birdnet as jbird
from audio_analysis_tpu.models import layers as jlayers

from audio_analysis_torch.models import layers as tlayers
from audio_analysis_torch.models.birdnet import TuiNet, TuiNetConfig


def _params(cfg_kw, seed=0):
    """JAX-initialised parameters with non-trivial BN statistics, as numpy."""
    cfg = jbird.TuiNetConfig(**cfg_kw)
    p = jax.tree_util.tree_map(np.asarray, jbird.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.RandomState(seed)
    for blk in p["blocks"]:
        for bn in ("bn1", "bn2"):
            c = blk[bn]["mean"].shape[0]
            blk[bn]["mean"] = (0.1 * rng.randn(c)).astype(np.float32)
            blk[bn]["var"] = (1 + 0.1 * rng.rand(c)).astype(np.float32)
            blk[bn]["gamma"] = (1 + 0.1 * rng.randn(c)).astype(np.float32)
            blk[bn]["beta"] = (0.1 * rng.randn(c)).astype(np.float32)
    return cfg, p


def _logits_both(cfg_kw, x):
    cfg, p = _params(cfg_kw)
    ref = np.asarray(jbird.apply(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), cfg))
    net = TuiNet.from_jax_params(p, TuiNetConfig(**cfg_kw)).eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).float().numpy()
    return got, ref


@pytest.mark.parametrize("cfg_kw,shape", [
    (dict(num_classes=4, n_mels=32, channels=(8,), stem_channels=8, dense_units=16), (3, 32, 41, 1)),
    (dict(num_classes=5, n_mels=40, channels=(8, 16), stem_channels=8, dense_units=16), (2, 40, 57, 1)),
    (dict(), (2, 160, 226, 1)),  # the published width: 160 x 226, (64, 128, 256)
], ids=["narrow", "two-blocks", "full-width"])
def test_logits_match_jax_f32(rng, cfg_kw, shape):
    cfg_kw = dict(cfg_kw, dtype="float32")
    x = np.abs(rng.randn(*shape)).astype(np.float32) * 3.0
    got, ref = _logits_both(cfg_kw, x)
    assert got.shape == ref.shape == (shape[0], jbird.TuiNetConfig(**cfg_kw).num_classes)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_logits_match_jax_bf16(rng):
    """bfloat16 compute with float32 BN and head, as in the JAX package;
    the two frameworks round bf16 at different places, so the bound is
    bf16's own precision (2^-8 relative) over a few layers."""
    cfg_kw = dict(num_classes=4, n_mels=32, channels=(8, 16), stem_channels=8,
                  dense_units=16, dtype="bfloat16")
    x = np.abs(rng.randn(2, 32, 41, 1)).astype(np.float32) * 3.0
    got, ref = _logits_both(cfg_kw, x)
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-2 * np.abs(ref).max())


@pytest.mark.parametrize("h,w,stride", [(160, 226, 2), (80, 113, 1), (7, 9, 2)])
def test_conv2d_same_padding_matches_jax(rng, h, w, stride):
    x = rng.randn(2, h, w, 3).astype(np.float32)
    k = rng.randn(3, 3, 3, 4).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    ref = np.asarray(jlayers.conv2d(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                                    strides=(stride, stride)))
    got = tlayers.conv2d(torch.from_numpy(x), torch.from_numpy(k).permute(3, 2, 0, 1),
                         torch.from_numpy(b), strides=(stride, stride)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,w", [(80, 113), (40, 57), (5, 5)])
def test_max_pool_same_matches_jax(rng, h, w):
    x = rng.randn(2, h, w, 3).astype(np.float32)
    ref = np.asarray(jlayers.max_pool2d(jnp.asarray(x), (2, 2), (2, 2), "SAME"))
    got = tlayers.max_pool2d(torch.from_numpy(x), (2, 2), (2, 2), "SAME").numpy()
    np.testing.assert_array_equal(got, ref)


def test_same_pads_are_tf_asymmetric():
    assert tlayers.same_pads(160, 3, 2) == (0, 1)
    assert tlayers.same_pads(226, 3, 2) == (0, 1)
    assert tlayers.same_pads(113, 2, 2) == (0, 1)
    assert tlayers.same_pads(80, 3, 1) == (1, 1)


@pytest.mark.parametrize("activation,pool", [("softmax", None), ("sigmoid", 2), ("linear", None)])
def test_registry_dense_matches_jax(tmp_path, rng, activation, pool):
    """The registry's native dense branch (flat-vector heads)."""
    import json

    from audio_analysis_tpu.io.modelconfig import ModelConfig as JCfg
    from audio_analysis_tpu.models.registry import load_classifier as j_load

    from audio_analysis_torch.io.modelconfig import ModelConfig as TCfg
    from audio_analysis_torch.models.registry import load_classifier as t_load

    meta = {"architecture": "dense", "labels": ["a", "b", "c"], "output_activation": activation}
    if pool:
        meta["net_pool"] = pool
    (tmp_path / "metadata.txt").write_text(json.dumps(meta))
    d_in = pool or 12  # [N, S] -> [N, S//p, p] -> mean over the middle axis -> [N, p]
    np.savez(tmp_path / "weights.npz", **{
        "0/kernel": rng.randn(d_in, 6).astype(np.float32), "0/bias": rng.randn(6).astype(np.float32),
        "1/kernel": rng.randn(6, 3).astype(np.float32), "1/bias": rng.randn(3).astype(np.float32),
    })
    x = rng.randn(5, 12).astype(np.float32)
    ref = np.asarray(j_load(tmp_path, JCfg.load(tmp_path))(jnp.asarray(x)))
    with torch.no_grad():
        got = t_load(tmp_path, TCfg.load(tmp_path), "cpu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_registry_keras_archive_not_ported(tmp_path):
    """The registry refused Keras archives until the Keras executor was
    ported; now an archive, or a dir holding one, loads into a KerasModel,
    and a file that is no zip archive still raises."""
    import json
    import shutil
    import zipfile

    from audio_analysis_torch.io.modelconfig import ModelConfig
    from audio_analysis_torch.models import KerasModel
    from audio_analysis_torch.models.registry import load_classifier

    (tmp_path / "metadata.txt").write_text(json.dumps({"labels": ["a"]}))
    import audio_analysis_torch

    archive = Path(audio_analysis_torch.__file__).parent / "data" / "efficientnet_b0_160x226_zero.keras"
    shutil.copy(archive, tmp_path / "audioModel.keras")
    cfg = ModelConfig.load(tmp_path)
    for path in (tmp_path, tmp_path / "audioModel.keras"):
        assert isinstance(load_classifier(path, cfg, "cpu"), KerasModel)
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "audioModel.keras").write_bytes(b"")
    with pytest.raises(zipfile.BadZipFile):
        load_classifier(bad / "audioModel.keras", cfg, "cpu")
