"""The program's own spans in a profiled stretch: ``utils/profiling.py::span``
marks ``span:<name>`` on ``torch.profiler``'s timeline, which
``tracing.py::profile_stretch`` keeps among the stretch's marks. Each
reader of a span's time is ``metrics/<stem>.py``, one line over
``mean_ms``."""


def mean_ms(run, name):
    """Mean milliseconds a unit of the stretch (a batch, a request) spent in
    the span ``name``: the sum of its marks' durations over the stretch's
    units; None where the program marks no such span (a program without
    spans)."""
    p = run.profile
    durations = [end - start for mark, start, end in p.marks if mark == f"span:{name}"]
    return sum(durations) / 1e3 / p.units if durations else None
