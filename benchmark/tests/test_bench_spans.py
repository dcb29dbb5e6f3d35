"""The readers of the program's spans (``metrics/<stem>.py`` over
``benchlib/spans.py``) on a hand-built profile: each returns the mean
milliseconds a unit spends in its span, and None where the stretch holds
no such span (a program that marks none)."""

from types import SimpleNamespace

import pytest
from conftest import BENCH

from benchlib import spec
from benchlib.tracing import Profile

READERS = {  # the stem's reader -> the span it reads
    "stack_ms": "dispatch.stack",
    "detect_enqueue_ms": "detect.enqueue",
    "detect_wait_ms": "detect.wait",
    "ccl_ms": "detect.ccl",
    "forward_ms": "infer.forward",
    "infer_wait_ms": "infer.wait",
    "upload_ms": "upload",
    "models_ms": "models",
    "write_ms": "write",
}


def _run(marks, units):
    marks = [("span:stretch", 0.0, 1e6)] + marks
    return SimpleNamespace(profile=Profile([], marks, 0.0, 1e6, units))


@pytest.mark.parametrize("stem", sorted(READERS))
def test_reader_sums_its_span_over_units(stem):
    span = READERS[stem]
    marks = [  # us: 1.5 ms, 2.5 ms and 4 ms of the span, and others around it
        (f"span:{span}", 100.0, 1600.0),
        (f"stage:{span}", 0.0, 90000.0),
        (f"span:{span}.child", 200.0, 900.0),
        ("span:other", 0.0, 50000.0),
        (f"span:{span}", 5000.0, 7500.0),
        (f"span:{span}", 20000.0, 24000.0),
    ]
    reader = spec.load_metric(f"{stem}.cli")
    assert reader.read(_run(marks, units=2)) == pytest.approx(8.0 / 2)
    assert reader.read(_run(marks, units=4)) == pytest.approx(8.0 / 4)


@pytest.mark.parametrize("stem", sorted(READERS))
def test_reader_is_none_without_its_span(stem):
    marks = [("stage:detect", 0.0, 5000.0), ("stage:request", 0.0, 9000.0),
             (f"span:{READERS[stem]}x", 10.0, 20.0)]
    assert spec.load_metric(f"{stem}.backlog").read(_run(marks, units=3)) is None


def test_every_span_metric_has_its_reader():
    entries = {m["name"].rsplit(".", 1)[0] for m in spec.load_benchmark()["per_layer"]
               if m["source"] == "program_span"}
    assert set(READERS) <= entries
    assert all((BENCH / "metrics" / f"{stem}.py").is_file() for stem in READERS)
