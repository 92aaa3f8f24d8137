"""Distribution: logical-axis sharding rules onto ``DeviceMesh`` and
DTensor placements, elastic re-sharding (``sharding.device_put_tree``),
and compressed gradient exchange."""

from . import sharding
from .grad_sync import GradSync, WireStats, straggler_reissue_plan

__all__ = ["sharding", "GradSync", "WireStats", "straggler_reissue_plan"]
