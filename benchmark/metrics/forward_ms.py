"""Mean host milliseconds a unit of the profiled stretch (a batch, a
request) spends calling its classifiers, taking the ensemble mean and the
per-track means: the program's ``infer.forward`` spans
(``pipeline/classify.py::run_group``, one a model group)."""

from benchlib.spans import mean_ms


def read(run):
    return mean_ms(run, "infer.forward")
