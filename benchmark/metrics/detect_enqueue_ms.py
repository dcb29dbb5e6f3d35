"""Mean host milliseconds a unit of the profiled stretch (a batch, a
request) spends queueing detection on the device (end-scan, |STFT|,
medians, morphology, the mask's copy): the program's ``detect.enqueue``
span (``detect/signal_noise.py::detect_batch_dispatch``)."""

from benchlib.spans import mean_ms


def read(run):
    return mean_ms(run, "detect.enqueue")
