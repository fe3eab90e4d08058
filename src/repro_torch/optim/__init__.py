"""Optimizers and schedules of the port (see ``repro.optim``)."""
from .adamw import (AdamWConfig, adamw_init, adamw_update,
                    clip_by_global_norm, global_norm, sgd_init, sgd_update)
from .schedule import SCHEDULES, constant, get_schedule, warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "clip_by_global_norm", "sgd_init", "sgd_update", "warmup_cosine",
           "constant", "get_schedule", "SCHEDULES"]
