"""Entry layer (``train/trainer.py::Trainer._install_refresh``,
``core/refresh.py``): seconds the training loop waited at an epoch
boundary for the refresh in flight, the mean over the window's installs
(the trainer's ``install_stall_s`` records and the window's closing
wait)."""


def read(run):
    return sum(run.stalls) / len(run.stalls) if run.stalls else None
