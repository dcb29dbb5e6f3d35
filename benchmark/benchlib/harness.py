"""One run of one cell: set-up (the pool of recordings, the models, the
program loaded and warmed on every shape the cell's traffic gives it), the
measured window, with ``--trace 1`` a profiled stretch after it, then the
check of what the window produced against the reference, and the result
line.
"""

import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

from benchlib import check
from benchlib.spec import ROOT, load_cell, load_driver, load_metric

FORBIDDEN = ("jax", "jaxlib", "flax", "audio_analysis_tpu")


def jax_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def run_cell(workload, seed, seconds, trace, t_start, device="cuda", root=ROOT):
    """The result line's dict (``correct`` and the metrics), for one run."""
    cell = load_cell(workload, root)
    workdir = Path(tempfile.mkdtemp(prefix="aat-bench-"))
    try:
        driver = load_driver(cell.mix["driver"], cell.root).Driver(cell, seed, device, workdir,
                                                                   trace)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        e2e = driver.window(seconds)
        e2e["setup_s"] = setup_s
        if device == "cuda":
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        else:
            peak = 0
        if trace:
            driver.stretch(int(cell.mix["trace_units"]))
        numbers = driver.judge()
        correct, rows = check.verdict(numbers, cell.limits)
        print("checked " + json.dumps(numbers), file=sys.stderr, flush=True)
        metrics = {}
        if trace:
            for m in cell.per_layer:
                value = load_metric(m["name"], cell.root).read(driver)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
        line = {
            "correct": bool(correct), "attempted": driver.attempted, "failed": 0,
            "metrics": metrics,
            "device": {"platform": "gpu" if device == "cuda" else "cpu",
                       "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                       "count": cell.chips, "memory_peak_bytes": int(peak)},
        }
        if trace:
            p = driver.profile
            line["device"]["busy_s"] = p.busy_s
            line["device"]["window_s"] = p.window_s
            line["breakdown"] = {"device_ops": p.top_ops(10), "idle_gaps": p.idle_gaps(10)}
        line["compared"] = check.compared(rows)
        return line, rows
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
