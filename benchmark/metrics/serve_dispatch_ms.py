"""Mean host milliseconds a batch spends in the stream's ``dispatch`` stage
(stacking, the copy and queueing the batch's detection), from the timer the
harness passes to ``analyse_stream``."""


def read(run):
    return run.stage_ms("dispatch")
