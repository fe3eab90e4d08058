"""Training of the port (see ``repro.train``): checkpoints and the
fault-tolerant Trainer."""
from .checkpoint import Checkpointer, latest_step, restore, save
from .loop import Trainer, TrainerConfig, make_train_step

__all__ = ["Trainer", "TrainerConfig", "make_train_step", "Checkpointer",
           "save", "restore", "latest_step"]
