"""Distribution: compressed gradient exchange.  The reference's sharding
rules and elastic re-sharding come with the distributed slice."""

from .grad_sync import GradSync, WireStats, straggler_reissue_plan

__all__ = ["GradSync", "WireStats", "straggler_reissue_plan"]
