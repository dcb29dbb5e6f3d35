"""The reference against the program on the CPU at small sizes: its
connected components, its detection, its EfficientNetB0 and TuiNet, on
seeded inputs and weights."""

import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
from conftest import BENCH, ROOT

from benchlib import traffic
from benchlib.fixtures import build_models
from benchref import dsp

CONFIGS = {p.stem: json.loads(p.read_text()) for p in (BENCH / "configs").glob("*.json")}


@pytest.mark.parametrize("seed", range(4))
def test_components_match_the_program(seed):
    from audio_analysis_torch.ops.components import _connected_components_numpy

    rng = np.random.RandomState(seed)
    mask = rng.rand(60, 90) < 0.35
    assert np.array_equal(dsp.components(mask), _connected_components_numpy(mask))


def recording(seed, seconds=12):
    mix = json.loads((BENCH / "traffic/cli_exact.json").read_text())["recording"]
    mix["seconds"], mix["silent_tail"]["from_s"] = seconds, [seconds - 3, seconds - 1]
    return traffic.make_pool(mix, 1, seed)[0]


@pytest.mark.parametrize("seed", range(2))
def test_detection_matches_the_program(seed):
    from audio_analysis_torch.detect.signal_noise import detect

    torch.set_num_threads(4)
    pcm = recording(seed)
    length, signals = detect(torch.from_numpy(pcm), 48000, level="exact")
    ref_length, ref_signals = dsp.detect(torch.from_numpy(pcm).float() / 32768.0, 48000)
    assert ref_length == length and signals
    assert [s.to_array(None) for s in ref_signals] == [s.to_array(None) for s in signals]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_classifiers_match_the_program(name):
    from audio_analysis_torch.io.modelconfig import ModelConfig
    from audio_analysis_torch.models.registry import _load_uncached

    torch.set_num_threads(4)
    pcm = recording(7, seconds=20)
    with tempfile.TemporaryDirectory() as d:
        made = build_models(CONFIGS[name], ROOT, Path(d), 11, "cpu", pcm)
        y = torch.from_numpy(pcm).float() / 32768.0
        windows = torch.stack([y[i * 48000 : i * 48000 + 144000] for i in range(6)])
        for model_dir, ref in made:
            meta = dict(ref.meta, net_dtype="float32")
            (model_dir / "metadata.txt").write_text(json.dumps(meta))
            net = _load_uncached(model_dir, ModelConfig.load(model_dir)).eval()
            feats = dsp.features(windows, meta)
            x = feats.repeat_interleave(3, dim=-1) if ref.is_efficientnet else feats
            with torch.no_grad():
                got, want = net(x).float(), ref.net(x)
            assert torch.allclose(got, want, atol=2e-5, rtol=0), (got - want).abs().max()
            assert want.std(dim=0).max() > 1e-3  # the windows are told apart
