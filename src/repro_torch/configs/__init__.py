"""Architecture configs: one module per architecture + registry."""

from .base import ModelConfig, get_config, list_archs, SHAPES, shape_cells

__all__ = ["ModelConfig", "get_config", "list_archs", "SHAPES", "shape_cells"]
