"""Mean milliseconds a unit of the profiled stretch (a batch, a request)
spends with the host blocked on the readback of its track probabilities:
the program's ``infer.wait`` spans (``pipeline/classify.py::classify_frames``,
``pipeline/serve.py::_finish_local``)."""

from benchlib.spans import mean_ms


def read(run):
    return mean_ms(run, "infer.wait")
