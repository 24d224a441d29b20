"""Device: the share of the traced window in which no operation ran on the
card (``torch.profiler``'s device activity), in %."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
