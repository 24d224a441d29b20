"""Extract (``core/extract.py::ProxyExtractor``): the refresh's
``extract_time_s`` (ends in a device synchronise), the mean over the
refreshes published in the window."""


def read(run):
    v = [r["meta"]["extract_time_s"] for r in run.refreshes]
    return sum(v) / len(v) if v else None
