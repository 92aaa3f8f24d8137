"""Training: the train state, its sharding specs and the step function."""

from .step import (
    TrainState,
    batch_pspecs,
    init_train_state,
    loss_and_grads,
    make_train_step,
    train_state_specs,
)

__all__ = ["TrainState", "batch_pspecs", "init_train_state", "loss_and_grads",
           "make_train_step", "train_state_specs"]
