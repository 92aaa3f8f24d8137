"""AdamW's state layout, as far as checkpoints need it.

The optimizer keeps fp32 moments ``m`` and ``v`` in trees that mirror the
parameters.  The checkpoint manager stores those moments as XOR deltas
against the *previous save* (not the periodic base): moments are EMAs, so
step-over-step deltas are far sparser than weight deltas.  This module
holds the keys that tell it which leaves are moments.  The update rule,
its config and the learning-rate schedule come with the training slice of
the port.
"""

from __future__ import annotations

from typing import Tuple

__all__ = ["MOMENT_KEYS", "is_moment_path"]

# Top-level keys of the optimizer state's tree.
MOMENT_KEYS: Tuple[str, ...] = ("m", "v")


def is_moment_path(key: str, moment_keys: Tuple[str, ...] = MOMENT_KEYS) -> bool:
    """True when a flat checkpoint key addresses an optimizer moment.

    Matches ``m/...`` / ``v/...`` (an optimizer state saved alone) and
    ``<anything>/m/...`` one level down (the train-state layout
    ``opt/m/...``); a *parameter* named ``m`` deeper in the tree never
    matches.
    """
    parts = key.split("/")
    return bool(parts) and (
        parts[0] in moment_keys or (len(parts) > 1 and parts[1] in moment_keys)
    )
