"""The AST configuration (``configs/ast_b16.json``) on the CPU: its MAC
counter against the hand count, the reference's precision modes, the
attention roofline's and the encoder span's readers on hand-built runs,
and a whole tiny run of ``ast_b16.backlog_chorus`` (its widths cut in a
copy of the benchmark) that comes out correct, and not correct with a
track's probabilities altered or a fault planted in the model."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from conftest import BENCH, ROOT, tiny_root

from benchlib import counts, spec, traffic
from benchlib.tracing import Profile
from benchref import ast as ref_ast

CFG = json.loads((BENCH / "configs/ast_b16.json").read_text())
CELL = "ast_b16.backlog_chorus"
TINY = {"net_dim": 64, "net_depth": 2, "net_heads": 4, "net_mlp": 128}


def test_macs_by_hand():
    t = 15 * 76 + 2  # the [160, 769] window's 15 x 76 patches and two special tokens
    qkv, proj, mlp, attn = t * 768 * 2304, t * 768 * 768, 2 * t * 768 * 3072, 2 * t * t * 768
    hand = 1140 * 256 * 768 + 12 * (qkv + proj + mlp + attn) + 768 * 8
    assert t == 1142
    assert spec.load_architecture("ast").macs(CFG, CFG["models"][0]) == hand
    assert hand == pytest.approx(121.3e9, rel=5e-4)
    assert 12 * attn / hand == pytest.approx(0.198, abs=5e-4)  # attention's share


def _tiny_model(tmp_path, seed=3):
    """The architecture's own build at the tiny widths, on the CPU."""
    spec_ = {"metadata": dict(CFG["models"][0]["metadata"], **TINY)}
    mix = json.loads((BENCH / "traffic/backlog_chorus.json").read_text())["recording"]
    mix["seconds"] = 12
    pcm = traffic.make_pool(mix, 1, seed)[0]
    return spec.load_architecture("ast").build(spec_, ROOT, tmp_path / "m", seed, "cpu", pcm)


def _features(n=2):
    g = torch.Generator().manual_seed(5)
    return -30.0 + 12.0 * torch.randn((n, 160, 769, 1), generator=g)


def test_build_writes_what_the_program_reads(tmp_path):
    from audio_analysis_torch.io.modelconfig import ModelConfig
    from audio_analysis_torch.models.registry import _load_uncached

    model = _tiny_model(tmp_path)
    meta = json.loads((tmp_path / "m/metadata.txt").read_text())
    assert meta["norm_std"] > 0 and meta["norm_mean"] == model.net.w["mean"]
    meta["net_dtype"] = "float32"
    (tmp_path / "m/metadata.txt").write_text(json.dumps(meta))
    net = _load_uncached(tmp_path / "m", ModelConfig.load(tmp_path / "m")).eval()
    x = _features()
    with torch.no_grad():
        assert torch.allclose(net(x), model.net(x), atol=1e-5, rtol=0)


def test_reference_modes(tmp_path, monkeypatch):
    """float32 repeats itself bit for bit with TF32 off inside; fp8 moves
    the probabilities."""
    w = _tiny_model(tmp_path).net.w
    seen = []
    original = ref_ast.AST.forward

    def forward(self, x):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return original(self, x)

    monkeypatch.setattr(ref_ast.AST, "forward", forward)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        x = _features()
        with torch.no_grad():
            f32, again = ref_ast.AST(w)(x), ref_ast.AST(w, mode="float32")(x)
            fp8 = ref_ast.AST(w, mode="fp8")(x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.equal(f32, again)
    assert (f32 - fp8).abs().max() > 1e-4
    assert set(seen) == {(False, False)}


def test_tf32_mode_differs_on_the_card(tmp_path, cuda):
    w = {k: v.cuda() if torch.is_tensor(v) else v for k, v in _tiny_model(tmp_path).net.w.items()}
    x = _features().cuda()
    with torch.no_grad():
        assert (ref_ast.AST(w)(x) - ref_ast.AST(w, mode="tf32")(x)).abs().max() > 0


def _run(kernels):
    result = {"species_identify": [
        {"begin_s": 1.0, "end_s": 2.0, "freq_start": 1000.0, "freq_end": 3000.0},
        {"begin_s": 10.0, "end_s": 26.0, "freq_start": 500.0, "freq_end": 900.0}]}
    return SimpleNamespace(profile=Profile(kernels, [], 0.0, 1e4, 1), fed=[[1, 0]],
                           done=[([0, 1], [result, {"species_identify": []}], [], 0.0)],
                           pool=[np.zeros(60 * 48000, np.int16)] * 2,
                           cell=SimpleNamespace(config=CFG))


def test_attention_roofline_on_a_hand_built_profile():
    mod = spec.load_metric("attention_roofline.chorus")
    run = _run([("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits>", 0.0, 1000.0),
                ("fmha_cutlassF_bf16_aligned_64x128_rf_sm80", 2000.0, 2500.0),
                ("sm90_xmma_gemm_bf16bf16_bf16f32", 0.0, 5000.0)])
    # a 1 s track: one window; a 16 s track: windows at 0 and 5.12 s (the next would end
    # at 20.48 s, past the track); the other recording has none
    assert counts.windows_of(run.done[0][1][0], 60 * 48000, CFG) == 3
    ops = 3 * 12 * 4 * 1142 ** 2 * 768
    assert mod.work(3, 1142, 768, 12) == (ops, 3 * 12 * 4 * 1142 * 768 * 2)
    assert mod.read(run) == pytest.approx(100.0 * ops / 989e12 / 1.5e-3)


def test_attention_roofline_reads_none_without_attention():
    mod = spec.load_metric("attention_roofline.chorus")
    assert mod.read(_run([("sm90_xmma_gemm_bf16bf16_bf16f32", 0.0, 5000.0)])) is None
    run = _run([("pytorch_flash::flash_fwd_kernel", 0.0, 1000.0)])
    run.fed = None  # a run that keeps no record of what the stretch fed
    assert mod.read(run) is None


def test_encoder_reader_reads_its_span():
    mod = spec.load_metric("encoder_ms.chorus")
    marks = [("span:stretch", 0.0, 1e6), ("span:infer.encoder", 100.0, 2100.0),
             ("span:infer.forward", 0.0, 9000.0), ("span:infer.encoder", 5000.0, 6000.0)]
    assert mod.read(SimpleNamespace(profile=Profile([], marks, 0.0, 1e6, 2))) == 1.5
    assert mod.read(SimpleNamespace(profile=Profile([], marks[2:3], 0.0, 1e6, 2))) is None


def _tiny_cell_root(tmp_path):
    root = tiny_root(tmp_path)
    f = root / "benchmark/configs/ast_b16.json"
    cfg = json.loads(f.read_text())
    cfg["models"][0]["metadata"].update(TINY)
    f.write_text(json.dumps(cfg))
    return root


def _plant(monkeypatch, fault):
    """A fault in the program: every track's first label raised by 0.1,
    the [DIST] token left out of the pooled output, time-major tokens, or
    attention scaled by the model width's root in place of a head's."""
    import torch.nn.functional as F

    from audio_analysis_torch.models import ast as port_ast
    from audio_analysis_torch.pipeline import classify

    if fault == "answer_altered":
        original = classify._track_means

        def means(*args):
            out = original(*args).clone()
            out[:, 0] += 0.1
            return out

        monkeypatch.setattr(classify, "_track_means", means)
    elif fault == "no_dist":
        monkeypatch.setattr(port_ast.AST, "pooled", staticmethod(lambda x: x[:, 0]))
    elif fault == "time_major":
        monkeypatch.setattr(port_ast.AST, "tokens",
                            staticmethod(lambda x: x.transpose(2, 3).flatten(2).transpose(1, 2)))
    elif fault == "attention_scale":
        def attention(self, h):
            n, t, d = h.shape
            q, k, v = self.qkv(h).view(n, t, 3, self.heads, d // self.heads).permute(2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5)
            return self.proj(o.transpose(1, 2).reshape(n, t, d))

        monkeypatch.setattr(port_ast._Block, "attention", attention)


@pytest.mark.parametrize("fault", (None, "answer_altered", "no_dist", "time_major",
                                   "attention_scale"))
def test_tiny_run_of_the_cell(tmp_path, monkeypatch, fault):
    """Sound, the run is correct; with a planted fault, not: the weights'
    scale makes attention peaked enough for the order of the tokens, the
    [DIST] token and the attention scale to show."""
    import time

    from benchlib.harness import run_cell

    _plant(monkeypatch, fault)
    torch.set_num_threads(4)
    line, _ = run_cell(CELL, 2 ** 31 + 211, 20, False, time.perf_counter(), device="cpu",
                       root=_tiny_cell_root(tmp_path))
    assert line["compared"]["recordings_checked"]["value"] == 2, line["compared"]
    assert line["correct"] is (fault is None), line["compared"]
