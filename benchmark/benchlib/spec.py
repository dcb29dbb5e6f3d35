"""Everything a cell is made of, found by name: its entry in
``BENCHMARK.json``, its configuration file, its traffic mix
(``benchmark/traffic/<mix>.json``), the driver the mix names
(``benchmark/drivers/<driver>.py``), its configuration's architecture
(``benchmark/architectures/<architecture>.py``), its correctness limits
(``benchmark/limits/<workload>.json``) and its per-layer metrics' readers
(``benchmark/metrics/<metric>.py``). Nothing here knows a cell, a
configuration, an architecture, a mix, a driver or a metric by name.
"""

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(entry, workload):
    return "workloads" not in entry or workload in entry["workloads"]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's contents
    mix: dict  # the traffic file's contents
    limits: dict  # {number: limit}
    end_to_end: list  # entries of BENCHMARK.json's end_to_end this cell reports
    per_layer: list  # entries of per_layer this cell reports
    root: Path


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=json.loads((root / entry["file"]).read_text()),
        mix=json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((root / "benchmark" / "limits" / f"{workload}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        root=root,
    )


def _module(path: Path, prefix: str):
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(name: str, root: Path = ROOT):
    """The module ``benchmark/drivers/<name>.py``: its class ``Driver``."""
    return _module(root / "benchmark" / "drivers" / f"{name}.py", "bench_driver_")


def load_architecture(name: str, root: Path = ROOT):
    """The module ``benchmark/architectures/<name>.py``: ``build`` and ``macs``."""
    return _module(root / "benchmark" / "architectures" / f"{name}.py", "bench_arch_")


def metric_file(name: str, root: Path = ROOT) -> Path:
    """``benchmark/metrics/<name>.py``, else, for a metric split by the
    end-to-end metric it moves (``detect_ms.cli``), the reader of its stem
    (``metrics/detect_ms.py``)."""
    d = root / "benchmark" / "metrics"
    own = d / f"{name}.py"
    return own if own.is_file() or "." not in name else d / f"{name.rsplit('.', 1)[0]}.py"


def load_metric(name: str, root: Path = ROOT):
    """The reader of a per-layer metric: ``read(run) -> float or None``.
    Its unit, layer, source and ``moves`` are its entry's in BENCHMARK.json."""
    return _module(metric_file(name, root), "bench_metric_")
