"""Optimizer state keys the checkpoint manager needs; the AdamW update
itself comes with the training slice of the port."""

from .adamw import MOMENT_KEYS, is_moment_path

__all__ = ["MOMENT_KEYS", "is_moment_path"]
