"""Data (``data/pipeline.py``: ``CoresetSampler.next_batch``, the corpus's
``batch``, ``to_device``): the median over the window's steps of the time
the program's ``step.data`` span covers, which the trainer's step record
keeps as ``data_time_s``, in ms.  Nothing where the records lack it."""

import statistics


def read(run):
    t = [m["data_time_s"] for m in run.steps if "data_time_s" in m]
    return 1000.0 * statistics.median(t) if t else None
