"""Mean milliseconds a unit of the window's work (a backlog's batch, a CLI
request) spends in the program's ``infer`` stage: the stream's timer in a
backlog, the result's ``timing.infer`` in the CLI."""


def read(run):
    return run.stage_ms("infer")
