"""ZipNN-compressed checkpoints (delta and moment chains, atomic async
saves, CRC-checked restores) and the model-hub transfer model."""

from .manager import CheckpointConfig, CheckpointManager

__all__ = ["CheckpointConfig", "CheckpointManager"]
