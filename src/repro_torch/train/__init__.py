"""Training: the train state and the step function."""

from .step import TrainState, init_train_state, loss_and_grads, make_train_step

__all__ = ["TrainState", "init_train_state", "loss_and_grads", "make_train_step"]
