"""Mean milliseconds a request of the profiled stretch spends copying its
recording to the device: the program's ``upload`` span
(``pipeline/classify.py::classify_frames``)."""

from benchlib.spans import mean_ms


def read(run):
    return mean_ms(run, "upload")
