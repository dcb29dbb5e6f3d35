"""The port's tracing hooks (``audio_analysis_torch/utils/profiling.py``)
beside the JAX package's: ``maybe_trace`` does nothing without
AAT_TRACE_DIR and writes a torch.profiler trace under the label with it,
holding the spans opened inside; the JAX package's ``annotate`` keeps the
function's name and return value (the port marks regions with ``span``,
tests/test_torch_spans.py)."""

import json

import pytest
import torch

from audio_analysis_tpu.utils import profiling as jprofiling

from audio_analysis_torch.utils import profiling


@pytest.mark.parametrize("hooks", [profiling, jprofiling], ids=["port", "jax"])
def test_maybe_trace_is_a_no_op_without_the_variable(tmp_path, monkeypatch, hooks):
    monkeypatch.delenv("AAT_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with hooks.maybe_trace("label"):
        y = torch.ones(4).sum()
    assert float(y) == 4.0
    assert not any(tmp_path.iterdir())


def test_maybe_trace_writes_a_trace_under_the_label(tmp_path, monkeypatch):
    """On the CPU the trace holds the CPU operators run inside it, and the
    span's name and args."""
    monkeypatch.setenv("AAT_TRACE_DIR", str(tmp_path))

    with profiling.maybe_trace("analysis"):
        with profiling.span_args(batch=3), profiling.span("aat_region"):
            torch.matmul(torch.ones(8, 8), torch.ones(8, 8)).sum()
    files = list((tmp_path / "analysis").iterdir())
    assert [f.name for f in files] == ["trace.json"]
    events = json.loads(files[0].read_text())["traceEvents"]
    assert "aten::matmul" in {e.get("name") for e in events}
    (region,) = [e for e in events if e.get("name") == "span:aat_region"]
    assert region["args"]["batch"] == 3


@pytest.mark.parametrize("hooks", [jprofiling], ids=["jax"])
def test_annotate_keeps_name_and_return_value(hooks):
    @hooks.annotate("region")
    def scaled(x, k=2):
        return x * k

    assert scaled.__name__ == "scaled"
    assert scaled(3) == 6 and scaled(3, k=5) == 15
