"""AdamW: its config, schedule, state and update, and the state keys the
checkpoint manager chains as moments."""

from .adamw import (
    MOMENT_KEYS,
    AdamWConfig,
    apply_updates,
    init_opt_state,
    is_moment_path,
    lr_schedule,
)

__all__ = ["AdamWConfig", "MOMENT_KEYS", "init_opt_state", "is_moment_path",
           "apply_updates", "lr_schedule"]
