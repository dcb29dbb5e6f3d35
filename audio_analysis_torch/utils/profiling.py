"""Tracing hooks (the JAX package's utils/profiling.py: the reference only
records wall-clock processing_time_seconds, src/analyse.py:451-453).

Same API and the same call sites as the JAX package's: none in the
pipeline; a caller wraps what it wants traced."""

import contextlib
import functools
import logging
import os


@contextlib.contextmanager
def maybe_trace(label="analysis"):
    """Capture a ``torch.profiler`` trace (CPU and, where there is one, CUDA
    activity) into ``$AAT_TRACE_DIR/<label>/trace.json`` (Chrome trace
    format: chrome://tracing or Perfetto) when AAT_TRACE_DIR is set;
    otherwise a no-op."""
    trace_dir = os.environ.get("AAT_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(trace_dir, label)
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logging.info("capturing torch.profiler trace to %s", path)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(path, "trace.json"))


def annotate(name):
    """Decorator: wrap a function in a named profiler region
    (``torch.profiler.record_function``)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            from torch.profiler import record_function

            with record_function(name):
                return fn(*a, **k)

        return wrapped

    return deco
