"""Mean host milliseconds a request of the profiled stretch spends reading
its models' configs and looking its classifiers up in the cache: the
program's ``models`` spans (``pipeline/classify.py::classify_frames``)."""

from benchlib.spans import mean_ms


def read(run):
    return mean_ms(run, "models")
