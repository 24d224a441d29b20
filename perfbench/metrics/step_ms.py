"""Train step (``train/train_step.py`` → ``models/``): the median of the
trainer's per-step ``time_s`` over the window, in ms (a host clock that
ends at the step's ``float(loss)``)."""

import statistics


def read(run):
    return 1000.0 * statistics.median(m["time_s"] for m in run.steps) if run.steps else None
