"""Training loop with CRAIG refresh (port of ``repro.train``)."""
from repro_torch.train.train_step import make_select_step, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig", "make_train_step", "make_select_step"]
