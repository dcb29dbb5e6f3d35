"""Stage timing and environment flags (host-only copy of the JAX
package's utils/runtime.py, without its XLA compilation cache)."""

import os
import time
from contextlib import contextmanager


def env_flag(name):
    """Tri-state env flag: True/False when set, None when absent."""
    v = os.environ.get(name)
    if v is None or v == "":
        return None
    return v.lower() in ("1", "true", "on", "yes")


class StageTimer:
    """Per-stage wall-clock timing (decode/detect/infer/post),
    surfaced alongside the reference's processing_time_seconds."""

    def __init__(self):
        self.stages = {}

    @contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0

    def as_dict(self, decimals=3):
        return {k: round(v, decimals) for k, v in self.stages.items()}
