"""Mean host milliseconds a request of the profiled stretch spends writing
its result (the sidecar JSON beside the WAV): the program's ``write`` span
(``cli/analyse.py::run``)."""

from benchlib.spans import mean_ms


def read(run):
    return mean_ms(run, "write")
