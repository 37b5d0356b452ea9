"""Distribution layer of the port: the optimizer and the train step
(single device; sharding and collectives come with the distributed
slice)."""

from .optimizer import (AdamWConfig, OptState, adamw_update, global_norm,
                        init_opt_state, lr_schedule)
from .steps import make_train_step

__all__ = ["AdamWConfig", "OptState", "adamw_update", "global_norm",
           "init_opt_state", "lr_schedule", "make_train_step"]
