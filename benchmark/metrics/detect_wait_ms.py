"""Mean milliseconds a unit of the profiled stretch (a batch, a request)
spends with the host blocked on the copy of detection's mask: the
program's ``detect.wait`` span (``detect/signal_noise.py::detect_batch_finish``)."""

from benchlib.spans import mean_ms


def read(run):
    return mean_ms(run, "detect.wait")
