"""Seconds from a refresh's submit to its publication, the mean over the
refreshes published in the window.  Host clock, taken by the benchmark's
wrappers around ``AsyncRefresher.submit`` and ``CoresetSampler.stage``."""


def read(run):
    done = [r["t_publish"] - r["t_submit"] for r in run.refreshes]
    return sum(done) / len(done) if done else None
