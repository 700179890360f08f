"""azoom_torch.train: on-the-fly training batches (``data``) and the train
loop with checkpoints and resume (``loop``), with the names of azoom.train."""

from azoom_torch.train.data import synth_batch
from azoom_torch.train.loop import (
    TrainState,
    bce_loss,
    create_state,
    fit,
    make_train_step,
    mask_accuracy,
)

__all__ = [
    "synth_batch",
    "TrainState",
    "bce_loss",
    "create_state",
    "fit",
    "make_train_step",
    "mask_accuracy",
]
