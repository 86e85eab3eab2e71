"""Losses, the train step and the trainer loop.  Port of
``src/repro/train``."""

from repro_torch.train.loss import lm_loss
from repro_torch.train.step import (
    TrainStepConfig,
    make_train_state,
    make_train_step,
)
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = [
    "lm_loss", "TrainStepConfig", "make_train_step", "make_train_state",
    "Trainer", "TrainerConfig",
]
