"""Mean host milliseconds a batch of the profiled stretch spends stacking
its recordings into pinned memory (and encoding them, with the wire codec
on): the program's ``dispatch.stack`` span (``pipeline/serve.py::_prepare``)."""

from benchlib.spans import mean_ms


def read(run):
    return mean_ms(run, "dispatch.stack")
