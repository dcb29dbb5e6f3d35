"""Mean host milliseconds a unit of the profiled stretch (a batch, a
request) spends in the native connected-component labelling of its
recordings' masks (in host threads): the program's ``detect.ccl`` span
(``detect/signal_noise.py::detect_batch_finish``)."""

from benchlib.spans import mean_ms


def read(run):
    return mean_ms(run, "detect.ccl")
