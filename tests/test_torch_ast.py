"""The Audio Spectrogram Transformer (``models/ast.py``) against the
benchmark's plain reference (``benchmark/benchref/ast.py``, plain float32
torch, loaded from ``benchmark/`` as its own tests load it), on the CPU at a
tiny size: 2 blocks, width 64, 4 heads of 16, MLP 128, [32, 60] windows,
16 x 16 patches at stride 10 (a 2 x 5 grid, 12 tokens), seeded weights.

Float32 and bfloat16 agreement, three planted faults that the float32
agreement catches, the registry's route, one stream run through
``BatchAnalyzer`` against the reference analysis, and the module's spans."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]

from benchref import ast as ref_ast  # noqa: E402
from benchref.analyse import Model, analyse  # noqa: E402

from audio_analysis_torch.io.modelconfig import ModelConfig  # noqa: E402
from audio_analysis_torch.models import ast as port_ast  # noqa: E402
from audio_analysis_torch.models.registry import (  # noqa: E402
    _WithActivation,
    _load_uncached,
    load_classifier,
)

SR = 48000
DIM, DEPTH, HEADS, MLP, PATCH, STRIDE, LABELS = 64, 2, 4, 128, 16, 10, 5
N_MELS, FRAMES = 32, 60
MEAN, STD = -40.0, 15.0
# float32 on both sides, differing only in the order of their sums (SDPA
# against the written-out softmax, a convolution against unfold and one
# product): ~1e-7 on probabilities of ~0.2, far under the planted faults
F32_GAP = 1e-5
# bfloat16 operands carry 8 significant bits (relative rounding 2^-9) into
# every product of two blocks; float8_e4m3fn's 4 bits (2^-4) do not fit
BF16_GAP = 5e-3


def ref_weights(seed, depth=DEPTH, tokens=None):
    """The reference's dict: weights as ``weights.npz`` keys them (std
    scaled to each fan-in, so that the activations are of order one and a
    tanh GELU shows), and the numbers the reference reads."""
    g = torch.Generator().manual_seed(seed)
    n = lambda *shape, std=1.0: torch.randn(shape, generator=g) * std
    fg, tg = ref_ast.grid(N_MELS, FRAMES, PATCH, STRIDE)
    w = {"patch/w": n(PATCH, PATCH, 1, DIM, std=1.0 / PATCH), "patch/b": n(DIM, std=0.1),
         "cls": n(DIM), "dist": n(DIM), "pos": n(tokens or fg * tg + 2, DIM, std=0.5)}
    for i in range(depth):
        p = f"blocks/{i}/"
        for ln in ("ln1", "ln2"):
            w[p + ln + "/gamma"], w[p + ln + "/beta"] = 1.0 + n(DIM, std=0.1), n(DIM, std=0.1)
        for name, a, b in (("qkv", DIM, 3 * DIM), ("proj", DIM, DIM), ("fc1", DIM, MLP),
                           ("fc2", MLP, DIM)):
            w[p + name + "/w"], w[p + name + "/b"] = n(a, b, std=1.5 / a ** 0.5), n(b, std=0.1)
    for ln in ("norm", "head/ln"):
        w[ln + "/gamma"], w[ln + "/beta"] = 1.0 + n(DIM, std=0.1), n(DIM, std=0.1)
    w["head/w"], w["head/b"] = n(DIM, LABELS, std=1.0 / DIM ** 0.5), n(LABELS, std=0.1)
    w.update(heads=HEADS, stride=STRIDE, mean=MEAN, std=STD)
    return w


def meta_of(**extra):
    meta = {"architecture": "ast", "name": "ast-tiny", "labels": list("abcde"),
            "n_mels": N_MELS, "hop_length": 800, "segment_length": 1.0,
            "segment_stride": 0.5, "n_fft": 1024, "htk": True, "fmin": 50, "fmax": 11000,
            "break_freq": 1750, "power": 2, "db_scale": True, "normalize": True,
            "threshold": 0.5, "net_dim": DIM, "net_depth": DEPTH, "net_heads": HEADS,
            "net_mlp": MLP, "net_patch": PATCH, "net_patch_stride": STRIDE,
            "norm_mean": MEAN, "norm_std": STD, "net_dtype": "float32"}
    return {**meta, **extra}


def write_model(d, w, **extra):
    """metadata.txt and weights.npz of the reference's weights in `d`."""
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    (d / "metadata.txt").write_text(json.dumps(meta_of(**extra)))
    np.savez(d / "weights.npz", **{k: v.numpy() for k, v in w.items() if torch.is_tensor(v)})
    return d


def port_net(d):
    return _load_uncached(Path(d), ModelConfig.load(d)).eval()


def features(seed, n=6, frames=FRAMES):
    g = torch.Generator().manual_seed(1000 + seed)
    return MEAN + STD * torch.randn((n, N_MELS, frames, 1), generator=g)


@pytest.fixture(scope="module")
def weights():
    return ref_weights(7)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, weights):
    return write_model(tmp_path_factory.mktemp("ast") / "f32", weights)


def gap(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("seed", range(3))
def test_float32_matches_reference(model_dir, weights, seed):
    x = features(seed)
    with torch.no_grad():
        got, want = port_net(model_dir)(x), ref_ast.AST(weights)(x)
    assert gap(got, want) <= F32_GAP, gap(got, want)
    assert want.std(dim=0).max() > 1e-2  # the windows are told apart


def test_shorter_window_is_refused(model_dir, weights):
    x = features(3, frames=FRAMES - 20)  # 3 time patches of the 5 the embedding holds
    with torch.no_grad(), pytest.raises(ValueError, match="patch grid"):
        port_net(model_dir)(x)
    with pytest.raises(ValueError, match="patch grid"):
        ref_ast.AST(weights)(x)


def test_bfloat16_within_bound_that_fp8_exceeds(tmp_path, weights):
    net = port_net(write_model(tmp_path / "bf16", weights, net_dtype="bfloat16"))
    assert net.net.blocks[0].qkv.weight.dtype == torch.bfloat16
    x = features(4, n=16)
    with torch.no_grad():
        got, want = net(x), ref_ast.AST(weights)(x)
        fp8 = ref_ast.AST(weights, mode="fp8")(x)
    assert got.dtype == torch.float32
    assert gap(got, want) <= BF16_GAP, gap(got, want)
    assert gap(fp8, want) > BF16_GAP, gap(fp8, want)


def _dist_left_out(monkeypatch):
    monkeypatch.setattr(port_ast.AST, "pooled", staticmethod(lambda x: x[:, 0]))


def _tanh_gelu(monkeypatch):
    monkeypatch.setattr(port_ast._Block, "mlp", lambda self, h: self.fc2(
        torch.nn.functional.gelu(self.fc1(h), approximate="tanh")))


def _time_major(monkeypatch):
    monkeypatch.setattr(port_ast.AST, "tokens",
                        staticmethod(lambda x: x.transpose(2, 3).flatten(2).transpose(1, 2)))


@pytest.mark.parametrize("fault", (_dist_left_out, _tanh_gelu, _time_major),
                         ids=("dist_left_out", "tanh_gelu", "time_major"))
def test_planted_fault_fails_float32_agreement(model_dir, weights, monkeypatch, fault):
    fault(monkeypatch)
    x = features(0)
    with torch.no_grad():
        got, want = port_net(model_dir)(x), ref_ast.AST(weights)(x)
    assert gap(got, want) > F32_GAP, gap(got, want)  # the sound port reads ~2e-7


def test_load_classifier_routes_ast(model_dir, weights):
    cfg = ModelConfig.load(model_dir)
    assert (cfg.net_dim, cfg.net_heads, cfg.norm_std) == (DIM, HEADS, STD)
    model = load_classifier(model_dir, cfg, "cpu")
    assert isinstance(model, _WithActivation) and isinstance(model.net, port_ast.AST)
    assert model.net.cfg.grid == (2, 5) and model.net.cfg.tokens == 12
    assert load_classifier(model_dir, cfg, "cpu") is model  # cached
    x = features(5)
    with torch.no_grad():
        probs = model(x)
        assert gap(probs, ref_ast.AST(weights)(x)) <= F32_GAP
    assert torch.allclose(probs.sum(dim=-1), torch.ones(len(x)))


def test_published_widths_are_the_defaults():
    cfg = ModelConfig.from_meta({"architecture": "ast"})
    assert (cfg.net_dim, cfg.net_depth, cfg.net_heads, cfg.net_mlp, cfg.net_patch,
            cfg.net_patch_stride) == (768, 12, 12, 3072, 16, 10)
    ast_cfg = port_ast.ASTConfig()
    assert ast_cfg.grid == (15, 76) and ast_cfg.tokens == 1142


def test_checkpoint_of_other_depth_is_refused(tmp_path):
    d = write_model(tmp_path / "deep", ref_weights(1, depth=DEPTH + 1))
    with pytest.raises(ValueError, match="3 blocks"):
        port_net(d)
    d = write_model(tmp_path / "long", ref_weights(1, tokens=14))
    with pytest.raises(ValueError, match="pos"):
        port_net(d)


@pytest.mark.parametrize("arch", ("vit", "efficientnet"))
def test_unknown_architecture_is_refused(tmp_path, arch):
    d = write_model(tmp_path / arch, ref_weights(1), architecture=arch)
    with pytest.raises(ValueError, match="known are tuinet, dense, ast"):
        port_net(d)


def _recording(seed, seconds=8):
    """int16 PCM: noise and three calls, each a track."""
    rng = np.random.RandomState(seed)
    t = np.arange(seconds * SR) / SR
    y = 0.01 * rng.randn(len(t))
    for f0, t0, dur in [(3000, 1.5, 0.8), (2200, 4.0, 1.0), (4500, 6.0, 0.6)]:
        m = (t >= t0) & (t < t0 + dur)
        y[m] += 0.5 * np.sin(2 * np.pi * (f0 + 40 * seed) * t[m])
    return (np.clip(y, -1, 1) * 32767).astype(np.int16)


def test_stream_matches_reference_analysis(model_dir, weights, monkeypatch):
    """BatchAnalyzer.analyse_stream at the exact level with the float32
    AST: the per-track probabilities it hands to ``apply_thresholds`` agree
    with the reference analysis (its float64 DFTs, the same weights)."""
    from audio_analysis_torch.pipeline import serve

    for k in ("AAT_FAST", "AAT_PALLAS", "AAT_PALLAS_ALG"):
        monkeypatch.delenv(k, raising=False)
    torch.set_num_threads(4)
    calls = []
    original = serve.apply_thresholds
    monkeypatch.setattr(serve, "apply_thresholds", lambda tracks, p, w, cfg: (
        calls.append((np.array(p, copy=True), np.array(w, copy=True))),
        original(tracks, p, w, cfg))[1])
    recs = [_recording(0), _recording(1)]
    analyzer = serve.BatchAnalyzer([str(model_dir)], sr=SR, bucket_seconds=8, rng=None,
                                   device="cpu")
    results = [r for batch in analyzer.analyse_stream([recs]) for r in batch]
    assert len(results) == 2 and len(calls) == 2
    ref_model = Model(meta_of(), ref_ast.AST(weights))
    tracks = 0
    for rec, result, (probs, wpt) in zip(recs, results, calls):
        ref = analyse(rec, [ref_model], rng=None, device="cpu")
        ref_probs, ref_wpt = ref["probs"][0]
        assert len(result["species_identify"]) == len(ref["tracks"]) == len(probs)
        assert np.array_equal(wpt, ref_wpt)
        assert np.abs(probs - ref_probs).max() <= F32_GAP
        tracks += len(probs)
    assert tracks >= 3


def test_spans_once_a_forward(model_dir):
    net = port_net(model_dir)
    x = features(6, n=3)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        with torch.no_grad():
            net(x)
    marks = [(e.name, e.time_range.start, e.time_range.end, e.kwinputs) for e in prof.events()
             if e.name.startswith("span:infer.")]
    names = [m[0] for m in marks]
    assert sorted(names) == ["span:infer.embed", "span:infer.encoder", "span:infer.head"]
    embed, encoder, head = (next(m for m in marks if m[0] == f"span:infer.{s}")
                            for s in ("embed", "encoder", "head"))
    assert embed[2] <= encoder[1] and encoder[2] <= head[1]
    assert encoder[3].get("windows") == 3 and encoder[3].get("tokens") == 12
