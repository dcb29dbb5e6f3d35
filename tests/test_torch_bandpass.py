"""Band-passed tracks (models whose metadata sets ``filter_freq`` or
``filter_below``) through the port's ``classify_frames`` and
``BatchAnalyzer``, against the JAX package's single path and its
per-recording ``_infer_with_filters``: tracks identical, confidences within
1 (the port's band-pass is held to float64 scipy, the JAX package's float32
scan is off by up to ~6e-3 of the filtered signal's scale:
tests/test_torch_filters.py)."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (fixture writers and the result contract)

from audio_analysis_torch.pipeline import classify as tcl  # noqa: E402
from audio_analysis_torch.pipeline.serve import BatchAnalyzer  # noqa: E402

SR = 48000
LABELS = ["bird", "morepork", "human", "noise"]


def _rec(seed, tones, seconds=9):
    """Noise and slow up-sweeps (f0, t0, dur) at 0.5."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * SR)) / SR
    y = 0.01 * rng.randn(len(t)).astype(np.float32)
    for f0, t0, dur in tones:
        m = (t >= t0) & (t < t0 + dur)
        y[m] += (0.5 * np.sin(2 * np.pi * (f0 + 200 * (t[m] - t0)) * t[m])).astype(np.float32)
    return y


# detected as tracks ending below 6.5 kHz (one of them starting at 0 Hz: its
# filter is the low-pass branch), and one from ~7.2 to ~11 kHz
LOW = [(2000, 1.0, 1.0), (3000, 4.0, 1.0)]
HIGH = [(7500, 6.5, 1.0)]
REC = _rec(1, LOW + HIGH)
REC_LOW = _rec(1, LOW)
REC_HIGH = _rec(4, HIGH, seconds=8)  # no track below 6.5 kHz
# one recording a model: each band-passes two tracks of it (so the JAX
# side compiles its scan for one shape)
RECS = {"filter_below": REC, "filter_freq": REC_LOW}


def _model(d, **meta):
    """A narrow float32 TuiNet on linear mel power, its metadata updated
    with `meta`."""
    chip_smoke.write_tuinet_model(d, seed=5, channels=(8, 16), stem=8, dense=16, n_mels=40,
                                  labels=LABELS, threshold=0.1)
    p = Path(d) / "metadata.txt"
    p.write_text(json.dumps({**json.loads(p.read_text()), **meta}))
    return str(d)


MODELS = {"filter_below": dict(filter_below=6500), "filter_freq": dict(filter_freq=True)}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("bandpass")
    return {k: _model(d / k, **meta) for k, meta in MODELS.items()}


def _result(classify_res):
    tracks, length, signals, raw_length, _ = classify_res
    for t in tracks:
        t.set_master_tag()
    return {"duration": raw_length, "length": length,
            "signals": [s.to_array() for s in signals],
            "species_identify": [t.get_meta() for t in tracks]}


def _same(got, ref):
    got, ref = json.loads(json.dumps(got)), json.loads(json.dumps(ref))
    assert got["signals"] == ref["signals"]
    assert len(got["species_identify"]) == len(ref["species_identify"])
    chip_smoke.compare_results(got, ref, confidence_tol=1)


def _labelled(res):
    return sum(len(r["predictions"]) for t in res["species_identify"]
               for r in t.get("model_results", []))


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_classify_frames_matches_jax(models, kind):
    """The single-recording path: every low track is band-passed, and
    under filter_below the high track is not."""
    from audio_analysis_tpu.pipeline.classify import classify_frames as jax_classify_frames

    y = RECS[kind]
    plans = []
    real = tcl.filter_windows

    def spy(grid, recordings, sr):
        plans.extend(p for _, p, _ in recordings)
        return real(grid, recordings, sr)

    tcl.filter_windows = spy
    try:
        got = _result(tcl.classify_frames(y, SR, [models[kind]], False, rng=None, device="cpu"))
    finally:
        tcl.filter_windows = real
    ref = _result(jax_classify_frames(y, SR, [models[kind]], False, rng=None))
    _same(got, ref)
    assert _labelled(got) > 0
    (plan,) = plans
    n_low = sum(1 for t in got["species_identify"] if t["freq_end"] < 6500)
    expect = len(got["species_identify"]) if kind == "filter_freq" else n_low
    assert 0 < n_low and len(plan.filter_specs) == expect
    assert any(low <= 0 for _, low, _ in plan.filter_specs)


def test_classify_two_groups_reuse_filtered_features(models, tmp_path):
    """A pre-model group after the band-pass group reuses the first group's
    (filtered) features, as the reference does; equal to the JAX path."""
    from audio_analysis_tpu.pipeline.classify import classify_frames as jax_classify_frames

    pre = _model(tmp_path / "pre", pre_model=True, name="pre")
    y = REC
    got = _result(tcl.classify_frames(y, SR, [models["filter_below"], pre], False, rng=None,
                                      device="cpu"))
    ref = _result(jax_classify_frames(y, SR, [models["filter_below"], pre], False, rng=None))
    _same(got, ref)
    assert all(len(t["model_results"]) == 2 for t in got["species_identify"])


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_batch_matches_jax_infer_with_filters(models, kind):
    """BatchAnalyzer over a batch where, under filter_below, one recording
    has band-passed tracks and another none (the JAX package takes its
    per-recording ``_infer_with_filters`` for the whole batch; the port its
    one combined pass)."""
    from audio_analysis_tpu.pipeline.serve import BatchAnalyzer as JaxBatchAnalyzer

    recs = [RECS[kind], REC_HIGH]
    got = BatchAnalyzer([models[kind]], sr=SR, bucket_seconds=9, rng=np.random.RandomState(3),
                        device="cpu").analyse_recordings(recs)
    ref = JaxBatchAnalyzer([models[kind]], sr=SR, bucket_seconds=9,
                           rng=np.random.RandomState(3)).analyse_recordings(recs)
    for g, r in zip(got, ref):
        assert g["chirps"]["signals"] == r["chirps"]["signals"]
        assert g["species_identify"]
        chip_smoke.compare_results(json.loads(json.dumps(g)), json.loads(json.dumps(r)))


def test_batch_equals_single_path(models):
    """Each recording of a band-pass batch as the port's own single path
    gives it, seeded the same way."""
    recs = [REC_HIGH, REC]
    got = BatchAnalyzer([models["filter_below"]], sr=SR, bucket_seconds=9, rng=None,
                        device="cpu").analyse_recordings(recs)
    for y, g in zip(recs, got):
        ref = _result(tcl.classify_frames(y, SR, [models["filter_below"]], False, rng=None,
                                          device="cpu"))
        assert json.dumps(g["species_identify"]) == json.dumps(ref["species_identify"])


def test_filter_windows_matches_jax_gather_window_grid(models):
    """The grid of a plan with filtered tracks (``filter_windows`` over
    ``gather_windows``, as both paths build it) against the JAX package's
    ``gather_window_grid``: unfiltered rows equal, filtered rows within
    1e-2 of the filtered signal's scale, padding rows zero."""
    import importlib

    import jax.numpy as jnp

    from audio_analysis_torch.detect.signal import Signal
    from audio_analysis_torch.io.modelconfig import ModelConfig

    y = REC
    tracks = [Signal(0.8, 2.2, 0, 4500), Signal(3.8, 5.2, 1750, 5800),
              Signal(6.3, 7.8, 7200, 11000)]
    jcl = importlib.import_module("audio_analysis_tpu.pipeline.classify")
    cfg = ModelConfig.load(Path(models["filter_below"]))
    plan = tcl.plan_for_config(len(y), SR, tracks, cfg, rng=np.random.RandomState(0))
    assert [ti for ti, _, _ in plan.filter_specs] == [0, 1]
    padded = tcl.pad_plan_to_bucket(plan)
    yt = torch.from_numpy(y)
    got = tcl.filter_windows(tcl.gather_windows(yt, padded), [(yt, padded, 0)], SR)
    ref, _ = jcl.gather_window_grid(jnp.asarray(y), SR, plan)
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape and got.shape[0] % 64 == 0
    filt = np.isin(padded.track_index, [0, 1])
    np.testing.assert_array_equal(got[~filt], ref[~filt])
    scale = np.abs(ref[filt]).max()
    assert np.abs(got[filt] - ref[filt]).max() <= 1e-2 * scale
    assert not np.array_equal(got[filt], tcl.gather_windows(torch.from_numpy(y), padded)
                              .numpy()[filt])


def test_filter_windows_without_filtered_tracks_is_identity(models):
    from audio_analysis_torch.detect.signal import Signal
    from audio_analysis_torch.io.modelconfig import ModelConfig

    y = torch.from_numpy(_rec(9, HIGH))
    cfg = ModelConfig.load(Path(models["filter_below"]))
    plan = tcl.plan_for_config(len(y), SR, [Signal(6.3, 7.8, 7200, 11000)], cfg, rng=None)
    assert plan.filter_specs == []
    grid = tcl.gather_windows(y, plan)
    assert tcl.filter_windows(grid, [(y, plan, 0)], SR) is grid
