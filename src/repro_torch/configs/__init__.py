"""Architecture configs: one module per architecture + registry."""

from .base import ModelConfig, get_config

__all__ = ["ModelConfig", "get_config"]
