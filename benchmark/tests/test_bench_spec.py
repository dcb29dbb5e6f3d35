"""BENCHMARK.json against the contract's shape, and every name in it
resolving to its file: configurations, mixes, limits and metric readers."""

import json
import re

import pytest
from conftest import BENCH, ROOT

from benchlib import spec
from benchlib.check import NUMBERS

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_sizes():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"}
    assert BENCHMARK["command"] == ["python3", "benchmark/run.py"]
    assert BENCHMARK["paths"] == ["benchmark"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (BENCHMARK["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("w", BENCHMARK["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves(w):
    cell = spec.load_cell(w["name"])
    assert cell.chips == 1 and w["chips"] == 1
    assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    assert callable(spec.load_driver(cell.mix["driver"]).Driver)
    exact = {"recordings_checked", "signals_mismatch", "tracks_mismatch", "windows_mismatch",
             "post_mismatch"}
    assert exact <= set(cell.limits) <= set(NUMBERS)
    assert {"prob_gap", "prob_rms", "prob_mean", "prob_median"} & set(cell.limits)
    assert all(cell.limits[k] == 0 for k in exact - {"recordings_checked"})
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("c", BENCHMARK["configs"], ids=lambda c: c["name"])
def test_every_config_resolves(c):
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"] and c["file"].startswith("benchmark/")
    assert cfg["reduced"] == c["reduced"] == []
    assert any(w["config"] == c["name"] for w in BENCHMARK["workloads"])
    arch = spec.load_architecture(cfg["architecture"])
    assert callable(arch.build) and all(arch.macs(cfg, m) > 0 for m in cfg["models"])
    for m in cfg["models"]:
        if "archive" in m:
            assert (ROOT / m["archive"]).is_file()


@pytest.mark.parametrize("m", BENCHMARK["per_layer"], ids=lambda m: m["name"])
def test_every_metric_resolves(m):
    mod = spec.load_metric(m["name"])
    # unit, layer, source and moves live in BENCHMARK.json alone
    assert not {"UNIT", "LAYER", "SOURCE", "MOVES"} & set(vars(mod))
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["source"] in spec.SOURCES
    e2e = {e["name"]: e for e in BENCHMARK["end_to_end"]}
    for w in m["workloads"]:
        assert w in e2e[m["moves"]].get("workloads", [w])
    assert callable(mod.read)


def test_end_to_end_metrics():
    names = {e["name"] for e in BENCHMARK["end_to_end"]}
    assert names == {"audio_s_per_s", "latency_p50_ms", "latency_p95_ms", "setup_s"}
    for e in BENCHMARK["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace") and UNIT.match(e["unit"])
        assert 0.01 <= e["bound"] <= 0.25
    assert {e["name"]: e["bound"] for e in BENCHMARK["end_to_end"]}["setup_s"] == 0.25


def test_a_new_mix_is_found_by_name(tmp_path):
    """A later PR adds a mix, its limits and a cell as files and entries;
    no file that exists is edited."""
    from conftest import tiny_root

    root = tiny_root(tmp_path)
    mix = json.loads((root / "benchmark/traffic/backlog_quiet.json").read_text())
    mix["recording"]["noise_rms"] = [0.02, 0.02]
    (root / "benchmark/traffic/backlog_loud.json").write_text(json.dumps(mix))
    (root / "benchmark/limits/tuinet.backlog_loud.json").write_text(
        (root / "benchmark/limits/tuinet.backlog_quiet.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tuinet.backlog_loud", "config": "tuinet",
                               "traffic": "backlog_loud", "chips": 1, "why": "louder noise"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("tuinet.backlog_loud", root)
    assert cell.mix["recording"]["noise_rms"] == [0.02, 0.02]
    assert cell.config["name"] == "tuinet"


def test_no_metric_file_without_an_entry():
    files = set((BENCH / "metrics").glob("*.py"))
    assert files == {spec.metric_file(m["name"]) for m in BENCHMARK["per_layer"]}


def test_a_metric_split_by_what_it_moves_shares_its_stem_reader(tmp_path):
    """``detect_ms.cli`` reads with ``metrics/detect_ms.py`` until a file
    of its own name is added."""
    from conftest import tiny_root

    root = tiny_root(tmp_path)
    assert spec.metric_file("detect_ms.cli", root) == root / "benchmark/metrics/detect_ms.py"
    own = root / "benchmark/metrics/detect_ms.train.py"
    own.write_text("def read(run):\n    return 1.0\n")
    assert spec.metric_file("detect_ms.train", root) == own
    assert spec.load_metric("detect_ms.train", root).read(None) == 1.0


def test_a_new_driver_is_found_by_name(tmp_path):
    """A mix that names a driver file added beside the others runs it; the
    harness is not edited."""
    from conftest import tiny_root

    root = tiny_root(tmp_path)
    (root / "benchmark/drivers/steps.py").write_text(
        "class Driver:\n    def __init__(self, cell, seed, device, workdir, trace):\n"
        "        self.seed = seed\n")
    assert spec.load_driver("steps", root).Driver(None, 5, "cpu", None, False).seed == 5
