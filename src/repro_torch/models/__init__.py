"""Model code as plain functions over nested dicts of tensors."""

from .model import decode_step, forward, init_decode_state, loss

__all__ = ["decode_step", "forward", "init_decode_state", "loss"]
