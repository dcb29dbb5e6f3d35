"""Stage timing, environment flags and the process's resident set
(host-only copy of the JAX package's utils/runtime.py, without its XLA
compilation cache)."""

import os
import time
from contextlib import contextmanager

from audio_analysis_torch.utils.profiling import mark


def env_flag(name):
    """Tri-state env flag: True/False when set, None when absent."""
    v = os.environ.get(name)
    if v is None or v == "":
        return None
    return v.lower() in ("1", "true", "on", "yes")


def timings_on() -> bool:
    """AAT_TIMINGS: per-stage wall clock in the results. Only 1/true/on turn
    it on (not env_flag's "yes"), as in the JAX package's analysis and
    serving."""
    return os.environ.get("AAT_TIMINGS", "").lower() in ("1", "true", "on")


def fast_mode() -> bool:
    """AAT_FAST=1 — the throughput preset: the bf16 tensor-core frontend
    (``pipeline/frontend.py::frontend_level``). Individual knobs
    (AAT_PALLAS) override the preset in either direction. Read at call time
    so a warm process can A/B."""
    return bool(env_flag("AAT_FAST"))


def rss_mb() -> float:
    """This process's resident set in MB (0.0 where /proc is unreadable):
    the batch daemon's --recycle-rss-mb check."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


class StageTimer:
    """Per-stage wall-clock timing (decode/detect/infer/post),
    surfaced alongside the reference's processing_time_seconds. Each stage
    is also ``stage:<name>`` on a recording profiler's timeline
    (``utils/profiling.py::mark``)."""

    def __init__(self):
        self.stages = {}

    @contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            with mark(f"stage:{name}"):
                yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0

    def as_dict(self, decimals=3):
        return {k: round(v, decimals) for k, v in self.stages.items()}
