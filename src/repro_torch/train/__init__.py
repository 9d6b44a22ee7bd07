"""LM training, as the reference's ``repro/train``: AdamW and the train
step, on the params' device."""
from .optimizer import (OptConfig, adamw_init, adamw_update, global_norm,
                        lr_schedule)
from .train_step import init_train_state, make_train_step

__all__ = ["OptConfig", "adamw_init", "adamw_update", "lr_schedule",
           "global_norm", "make_train_step", "init_train_state"]
