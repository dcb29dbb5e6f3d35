"""Tracing hooks (the JAX package's utils/profiling.py: the reference only
records wall-clock processing_time_seconds, src/analyse.py:451-453).

``span`` marks a region of the program on ``torch.profiler``'s timeline,
the clock on which the device's kernels are laid, so that a trace names
what the host was doing around each kernel and each idle gap. Outside a
recording profiler a span costs one check of the profiler's state: no
record is made and no clock is read. Spans open on the caller's thread
(the profiler does not record ranges opened in worker threads).
``StageTimer.stage`` (utils/runtime.py) marks its stages the same way,
as ``stage:<name>``.

``maybe_trace`` writes such a trace under ``$AAT_TRACE_DIR``; the analyse
CLI (``cli/analyse.py::run``) runs inside it."""

import contextlib
import contextvars
import logging
import os

import torch

# the args every mark opened in this context carries (``span_args``)
_ARGS = contextvars.ContextVar("aat_span_args", default=None)


def recording():
    """Whether a profiler records on this thread: the one check a mark costs
    when none does, and the guard for an arg that costs more to compute."""
    return torch._C._autograd._profiler_enabled()


@contextlib.contextmanager
def mark(label, **args):
    """``label`` on the profiler's timeline while a profiler records on this
    thread, with ``args`` over those of the enclosing ``span_args`` as the
    record's keyword inputs; otherwise nothing but the check.
    (``record_function``'s string args never reach the trace:
    ``_RecordFunctionFast`` keeps keyword inputs when the profiler records
    shapes, as ``maybe_trace``'s does, and costs less under a profiler.)"""
    if not recording():
        yield
        return
    args = {**(_ARGS.get() or {}), **args}
    with torch._C._profiler._RecordFunctionFast(label, (), args):
        yield


def span(name, **args):
    """A region of the program, ``span:<name>`` on the timeline, with
    ``args`` (see ``mark``)."""
    return mark(f"span:{name}", **args)


@contextlib.contextmanager
def span_args(**args):
    """Every mark opened inside carries ``args`` (over an enclosing
    ``span_args``'s): batch serving's stream sets ``batch=k``, since three
    batches' dispatch, queue and collect interleave on one thread."""
    token = _ARGS.set({**(_ARGS.get() or {}), **args})
    try:
        yield
    finally:
        _ARGS.reset(token)


@contextlib.contextmanager
def maybe_trace(label="analysis"):
    """Capture a ``torch.profiler`` trace (CPU and, where there is one, CUDA
    activity, with the spans and their args) into
    ``$AAT_TRACE_DIR/<label>/trace.json`` (Chrome trace format:
    chrome://tracing or Perfetto) when AAT_TRACE_DIR is set; otherwise, or
    inside a profiler that already records (which keeps the spans), a
    no-op."""
    trace_dir = os.environ.get("AAT_TRACE_DIR")
    if not trace_dir or recording():
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(trace_dir, label)
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logging.info("capturing torch.profiler trace to %s", path)
    with profile(activities=activities, record_shapes=True) as prof:
        yield
    prof.export_chrome_trace(os.path.join(path, "trace.json"))
