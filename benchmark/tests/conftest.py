"""The benchmark's own tests: the harness, the traffic generator, the
counters and the reference on the CPU at small sizes, and the correctness
check driven through whole tiny runs. Tests that need the card take the
``cuda`` fixture, which skips without one.

    python -m pytest benchmark/tests -q
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def tiny_root(tmp_path, seconds=12):
    """A copy of BENCHMARK.json and benchmark/ whose mixes are cut to a
    size the CPU runs in a minute: short recordings, small pools and
    batches, two recordings checked."""
    root = tmp_path / "root"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    for f in (root / "benchmark" / "traffic").glob("*.json"):
        m = json.loads(f.read_text())
        m["pool"] = 4 if "batch" in m else 2
        if "batch" in m:
            m["batch"] = 2
        m["trace_units"] = 1
        m["check"]["recordings"] = 2
        rec = m["recording"]
        rec["seconds"] = seconds
        calls = rec["calls"]
        if "count" in calls:
            calls["count"] = [min(calls["count"][0], 3), min(calls["count"][1], 3)]
        rec["silent_tail"]["from_s"] = [seconds - 4, seconds - 1]
        f.write_text(json.dumps(m))
    for f in (root / "benchmark" / "limits").glob("*.json"):
        lim = json.loads(f.read_text())
        lim["recordings_checked"] = 2
        f.write_text(json.dumps(lim))
    return root
