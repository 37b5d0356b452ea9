"""Training substrate of the port: checkpoints in the reference's format
and the fault-tolerant trainer."""
from .checkpoint import (AsyncCheckpointer, latest_checkpoint,
                         restore_checkpoint, save_checkpoint)
from .trainer import StepDeadlineExceeded, Trainer, TrainerConfig
__all__ = ["AsyncCheckpointer", "latest_checkpoint", "restore_checkpoint",
           "save_checkpoint", "StepDeadlineExceeded", "Trainer",
           "TrainerConfig"]
