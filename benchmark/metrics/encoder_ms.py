"""Mean host milliseconds a unit of the profiled stretch (a batch) spends
queueing the AST's transformer blocks: the program's ``infer.encoder``
spans (``models/ast.py``, one a model group a batch, inside
``infer.forward``)."""

from benchlib.spans import mean_ms


def read(run):
    return mean_ms(run, "infer.encoder")
