"""The harness's own spans and the reduction of a profiled stretch.

``Timer`` stands in for the program's ``StageTimer`` (its ``stage(name)``
context manager and ``as_dict``): it adds up each stage's host seconds and
counts, and, while a profile records, marks each stage and span in the
profiler's trace so that idle gaps on the device can be named by what the
host was doing.

``profile_stretch`` runs a steady stretch of whole units of work under
``torch.profiler`` and reduces it: the device's busy time (the union of
its operations' intervals), the stretch's wall, the device operations by
name, and the idle gaps labelled with the innermost span or stage open on
the host at the gap's start.
"""

import contextlib
import time
from dataclasses import dataclass

import torch


class Timer:
    def __init__(self):
        self.stages = {}
        self.counts = {}
        self.profiling = False

    @contextlib.contextmanager
    def stage(self, name):
        mark = (torch.profiler.record_function(f"stage:{name}") if self.profiling
                else contextlib.nullcontext())
        t0 = time.perf_counter()
        try:
            with mark:
                yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0
            self.counts[name] = self.counts.get(name, 0) + 1

    span = stage

    def as_dict(self, decimals=3):
        return {k: round(v, decimals) for k, v in self.stages.items()}

    def mean_ms(self, name):
        n = self.counts.get(name, 0)
        return 1e3 * self.stages[name] / n if n else None


@dataclass
class Profile:
    kernels: list  # (name, start us, end us) of every device operation
    marks: list  # (name, start us, end us) of the host's stages and spans
    start_us: float
    end_us: float
    units: int  # whole units of work (batches, requests, steps) in the stretch

    @property
    def window_s(self):
        return (self.end_us - self.start_us) / 1e6

    def busy_intervals(self):
        out = []
        for a, b in sorted((a, b) for _, a, b in self.kernels):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernel_time(self, substring):
        """(launches, device seconds) of the operations whose name holds
        ``substring``."""
        hits = [(a, b) for name, a, b in self.kernels if substring in name]
        return len(hits), sum(b - a for a, b in hits) / 1e6

    def top_ops(self, n=10):
        by = {}
        for name, a, b in self.kernels:
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n=10):
        """Idle device seconds by the host mark open at each gap's start."""
        edges, at = [], self.start_us
        for a, b in self.busy_intervals():
            if a > at:
                edges.append((at, a))
            at = max(at, b)
        if self.end_us > at:
            edges.append((at, self.end_us))
        by = {}
        for a, b in edges:
            open_ = [m for m in self.marks if m[1] <= a < m[2] and m[0] != "span:stretch"]
            label = max(open_, key=lambda m: m[1])[0] if open_ else "host:outside marks"
            by[label] = by.get(label, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def profile_stretch(fn, timer: Timer, units: int) -> Profile:
    """fn() (which does `units` whole units of work) under torch.profiler,
    to a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    timer.profiling = True
    try:
        with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                                          else [])) as prof:
            with torch.profiler.record_function("span:stretch"):
                fn()
                sync()
    finally:
        timer.profiling = False
    kernels, marks = [], []
    for e in prof.events():
        if e.name.startswith(("stage:", "span:")):
            # the marks also appear on the device's timeline as annotations
            if e.device_type != torch.autograd.DeviceType.CUDA:
                marks.append((e.name, e.time_range.start, e.time_range.end))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((e.name, e.time_range.start, e.time_range.end))
    stretch = [m for m in marks if m[0] == "span:stretch"]
    if not stretch:
        raise RuntimeError("the profiler recorded no stretch")
    return Profile(kernels, marks, stretch[0][1], stretch[0][2], units)
