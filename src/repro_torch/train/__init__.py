"""LM training, as the reference's ``repro/train``: AdamW and the train
step, on the params' device or sharded on a ``DeviceMesh``."""
from .optimizer import (OptConfig, adamw_init, adamw_update,
                        adamw_update_sharded, global_norm, lr_schedule,
                        sharded_global_norm)
from .train_step import init_train_state, make_train_step, shard_train_state

__all__ = ["OptConfig", "adamw_init", "adamw_update", "adamw_update_sharded",
           "lr_schedule", "global_norm", "sharded_global_norm",
           "make_train_step", "init_train_state", "shard_train_state"]
