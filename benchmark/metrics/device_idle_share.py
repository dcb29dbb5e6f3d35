"""The share of the profiled stretch of whole units of work (batches,
requests) in which no operation ran on the card: 1 - (the union of the
device operations' intervals) / (the stretch's wall), in %."""


def read(run):
    p = run.profile
    return 100.0 * (1.0 - p.busy_s / p.window_s) if p.window_s > 0 else None
