"""Distribution layer of the port: the optimizer and the step functions
(single device; sharding and collectives come with the distributed
slice)."""

from .optimizer import (AdamWConfig, OptState, adamw_update, global_norm,
                        init_opt_state, lr_schedule)
from .steps import (decode_inputs_abstract, input_specs, make_decode_step,
                    make_prefill_step, make_train_step, trace_cell,
                    train_batch_abstract)

__all__ = ["AdamWConfig", "OptState", "adamw_update", "global_norm",
           "init_opt_state", "lr_schedule", "make_train_step",
           "make_prefill_step", "make_decode_step", "trace_cell",
           "train_batch_abstract", "decode_inputs_abstract", "input_specs"]
