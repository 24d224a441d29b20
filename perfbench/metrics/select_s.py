"""Selection (``core/craig.py`` → ``core/engines/matrix.py``): the
refresh's ``selection_time_s``, the mean over the refreshes published in
the window."""


def read(run):
    v = [r["meta"]["selection_time_s"] for r in run.refreshes]
    return sum(v) / len(v) if v else None
