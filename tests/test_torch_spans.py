"""The port's spans (``utils/profiling.py::span``) at its layer boundaries,
on the CPU: outside a profiler no record is made; under ``torch.profiler``
the single-recording path and batch serving's stream mark every boundary
on the caller's thread, inside the stage that holds it, and the stream's
spans carry their batch's number; the analyse CLI writes its trace under
AAT_TRACE_DIR; a model is built under ``models.build`` only on a cache
miss; the result's ``timing`` keeps the stage names."""

import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from test_torch_serve import SR, _model, _rec  # noqa: E402

from audio_analysis_torch.io.audio import write_wav  # noqa: E402
from audio_analysis_torch.pipeline.serve import BatchAnalyzer  # noqa: E402
from audio_analysis_torch.utils.profiling import maybe_trace, span  # noqa: E402
from audio_analysis_torch.utils.runtime import StageTimer  # noqa: E402

DETECT = ["detect.enqueue", "detect.endscan", "detect.stft_mag", "detect.medians",
          "detect.morph", "detect.wait", "detect.ccl"]
INFER = ["infer.gather", "infer.frontend", "infer.forward", "infer.wait"]
# the single path's spans -> the stage that holds them (None: no stage)
SINGLE = {"upload": None, "models": None, "plan": None,
          **{s: "detect" for s in DETECT}, **{s: "infer" for s in INFER}}
STREAM = ["dispatch.stack", "dispatch.copy"] + DETECT + INFER


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return _model(tmp_path_factory.mktemp("spanmodel") / "m")


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    path = tmp_path_factory.mktemp("spanwav") / "rec.wav"
    write_wav(path, _rec(5), SR)
    return path


def _marks(prof):
    """(name, start us, end us, kwinputs) of every span and stage mark."""
    return [(e.name, e.time_range.start, e.time_range.end, e.kwinputs) for e in prof.events()
            if e.name.startswith(("span:", "stage:"))]


def _stage_of(mark, marks):
    """The innermost stage mark holding `mark`, None where none does."""
    holding = [m for m in marks if m[0].startswith("stage:") and m[1] <= mark[1]
               and mark[2] <= m[2]]
    return max(holding, key=lambda m: m[1])[0][len("stage:"):] if holding else None


def _stream(model_dir, n_batches):
    batches = [[(_rec(10 + 2 * k + j) * 30000).astype(np.int16) for j in range(2)]
               for k in range(n_batches)]
    analyzer = BatchAnalyzer([model_dir], sr=SR, bucket_seconds=9, rng=None, device="cpu")
    return list(analyzer.analyse_stream(batches))


def _cli(wav, model_dir, *extra):
    from audio_analysis_torch.cli.analyse import run

    return run([str(wav), "--bird-model", model_dir, "--device", "cpu", "--seed", "0", *extra])


@pytest.fixture(scope="module")
def single_marks(model_dir, wav):
    from audio_analysis_torch.pipeline.analysis import species_identify

    species_identify(str(wav), [model_dir], False, rng=np.random.RandomState(0), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = species_identify(str(wav), [model_dir], False, rng=np.random.RandomState(0),
                                  device="cpu")
    assert result["species_identify"], "the fixture must produce tracks"
    return _marks(prof)


@pytest.fixture(scope="module")
def stream_marks(model_dir):
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        results = _stream(model_dir, 2)
    assert len(results) == 2 and all(r["species_identify"] for b in results for r in b)
    return _marks(prof)


class _Refused:
    def __init__(self, *a, **k):
        raise AssertionError("a profiler record was made with no profiler recording")


@pytest.mark.parametrize("path", ["cli", "stream"])
def test_no_record_without_a_profiler(monkeypatch, model_dir, wav, path):
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _Refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _Refused)
    monkeypatch.setattr(torch.profiler, "record_function", _Refused)
    monkeypatch.delenv("AAT_TRACE_DIR", raising=False)
    monkeypatch.setenv("AAT_TIMINGS", "1")
    if path == "cli":
        result = _cli(wav, model_dir, "-o")
        assert result["species_identify"] and set(result["timing"]) == {
            "decode", "detect", "infer", "post"}
    else:
        assert all(r["species_identify"] for b in _stream(model_dir, 2) for r in b)


@pytest.mark.parametrize("name", sorted(SINGLE))
def test_single_path_marks_the_span_in_its_stage(single_marks, name):
    found = [m for m in single_marks if m[0] == f"span:{name}"]
    assert found, sorted({m[0] for m in single_marks})
    assert {_stage_of(m, single_marks) for m in found} == {SINGLE[name]}


def test_single_path_detection_children_nest_in_the_enqueue(single_marks):
    (enqueue,) = [m for m in single_marks if m[0] == "span:detect.enqueue"]
    children = [m for m in single_marks if m[0] in {f"span:{s}" for s in DETECT[1:5]}]
    assert len(children) == 4
    assert all(enqueue[1] <= m[1] and m[2] <= enqueue[2] for m in children)


def test_single_path_stages_keep_the_timer(single_marks):
    assert {m[0] for m in single_marks if m[0].startswith("stage:")} == {
        "stage:decode", "stage:detect", "stage:infer", "stage:post"}


@pytest.mark.parametrize("name", STREAM)
def test_stream_spans_carry_their_batch(stream_marks, name):
    found = [m for m in stream_marks if m[0] == f"span:{name}"]
    assert sorted(m[3].get("batch") for m in found) == [0, 1], found


def test_stream_stages_carry_their_batch(stream_marks):
    dispatch = [m for m in stream_marks if m[0] == "stage:dispatch"]
    assert sorted(m[3].get("batch") for m in dispatch) == [0, 1]
    # batch 1 is dispatched before batch 0 is finished
    finish0 = [m for m in stream_marks if m[0] == "span:detect.wait" and m[3]["batch"] == 0]
    assert max(m[1] for m in dispatch) < finish0[0][1]


def test_stream_plans_inside_the_plan_stage(monkeypatch, model_dir):
    """The combined plan over the batch and its padding to the bucket run
    in the ``plan`` stage."""
    from audio_analysis_torch.pipeline import serve

    class Timer(StageTimer):
        open = None

        @contextlib.contextmanager
        def stage(self, name):
            self.open = name
            with super().stage(name):
                yield
            self.open = None

    timer, seen = Timer(), []

    def watched(fn):
        def call(*a, **k):
            seen.append((fn.__name__, timer.open))
            return fn(*a, **k)
        return call

    monkeypatch.setattr(serve, "pad_plan_to_bucket", watched(serve.pad_plan_to_bucket))
    monkeypatch.setattr(BatchAnalyzer, "_combine_plans",
                        staticmethod(watched(BatchAnalyzer._combine_plans)))
    batches = [[(_rec(10 + j) * 30000).astype(np.int16) for j in range(2)]]
    analyzer = BatchAnalyzer([model_dir], sr=SR, bucket_seconds=9, rng=None, device="cpu")
    list(analyzer.analyse_stream(batches, timer=timer))
    assert sorted(seen) == [("_combine_plans", "plan"), ("pad_plan_to_bucket", "plan")]


def test_analyse_cli_writes_its_trace(monkeypatch, tmp_path, model_dir, wav):
    monkeypatch.setenv("AAT_TRACE_DIR", str(tmp_path / "traces"))
    _cli(wav, model_dir, "-o")
    trace = json.loads((tmp_path / "traces" / "analyse" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"span:detect.ccl", "span:upload", "span:write", "stage:infer"} <= names


def test_models_build_only_on_a_cache_miss(tmp_path):
    from audio_analysis_torch.io.modelconfig import ModelConfig
    from audio_analysis_torch.models.registry import load_classifier

    d = Path(_model(tmp_path / "fresh"))
    cfg = ModelConfig.load(d)
    counts = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            load_classifier(d, cfg, torch.device("cpu"))
        counts.append(sum(m[0] == "span:models.build" for m in _marks(prof)))
    assert counts == [1, 0]


def test_stage_timer_marks_keep_its_seconds():
    timer = StageTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage("detect"), span("detect.ccl"):
            pass
        with timer.stage("detect"):
            pass
    assert set(timer.stages) == {"detect"}
    names = [m[0] for m in _marks(prof)]
    assert names.count("stage:detect") == 2 and names.count("span:detect.ccl") == 1


def test_maybe_trace_inside_a_profiler_leaves_it_whole(monkeypatch, tmp_path):
    monkeypatch.setenv("AAT_TRACE_DIR", str(tmp_path))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with maybe_trace("inner"), span("inner"):
            torch.ones(4).sum()
        with span("after"):
            pass
    assert not (tmp_path / "inner").exists()
    assert {"span:inner", "span:after"} <= {m[0] for m in _marks(prof)}
