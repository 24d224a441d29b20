"""Seconds from the process's start to the window's: imports, kernel
libraries (built in a checkout's first run), corpus, weights, the trainer
and the mix's first epoch.  Host clock."""


def read(run):
    return run.setup_s
