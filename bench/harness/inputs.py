"""The benchmark's inputs, drawn from the seed: weights, the context in the
KV caches, each round's first tokens and the requests the check samples.

The same seed gives the same tensors on the same kind of device, so the
reference draws its copy again after the program is gone instead of
keeping one beside it.  Weights are drawn on the device in two large
calls (the layer stacks, then the rest), in the type they are served in:
every matrix, table and bias ``N(0, 0.02**2)``, every norm's gain
``1 + N(0, 0.02**2)``.
"""

from __future__ import annotations

import math
import zlib
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

WEIGHT_STD = 0.02        # every leaf: standard_normal * 0.02 (a gain: 1 + that)


def derive(seed: int, *salt: Any) -> int:
    """A 63-bit seed of its own for each use of ``seed`` (names hashed with
    CRC-32, so the same salt gives the same seed in every process)."""
    words = [int(seed) & (2 ** 64 - 1)]
    for s in salt:
        words.append(zlib.crc32(s.encode()) if isinstance(s, str) else int(s))
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """``(path, leaf)`` pairs of a nested dict, in sorted-key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(leaves(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)])
    return out


def _put(tree: Dict[str, Any], path: Tuple[str, ...], value: Any) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def is_gain(path: Tuple[str, ...]) -> bool:
    """Whether the leaf at ``path`` is a norm's gain."""
    return path[-1] == "g"


def weights(shapes: Dict[str, Any], seed: int, device, dtype: torch.dtype) -> Dict[str, Any]:
    """Weights of ``shapes`` in ``dtype``: every leaf ``standard_normal *
    WEIGHT_STD``, a norm's gain ``1 +`` that, from one draw for the layer
    stacks (top-level keys ending in ``layers``) and one for the rest.
    Biases and gains are drawn like the rest, so that a program that drops
    or misapplies one serves other tokens."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    tree: Dict[str, Any] = {}
    flat = leaves(shapes)
    for stacks in (True, False):
        group = [(p, s) for p, s in flat if p[0].endswith("layers") == stacks]
        total = sum(math.prod(s) for _, s in group)
        if not total:
            continue
        buf = torch.randn(total, generator=gen, dtype=dtype, device=device).mul_(WEIGHT_STD)
        at = 0
        for p, s in group:
            n = math.prod(s)
            leaf = buf[at: at + n].view(s)
            if is_gain(p):
                leaf.add_(1.0)
            _put(tree, p, leaf)
            at += n
    return tree


def context_std(conf: Dict[str, Any]) -> float:
    """The spread of a key or value entry that a layer computes from a
    normed input of unit scale: ``WEIGHT_STD * sqrt(d_model)``."""
    return WEIGHT_STD * math.sqrt(conf["d_model"])


def caches(ref, conf: Dict[str, Any], traffic: Dict[str, Any], seed: int, device
           ) -> Dict[str, torch.Tensor]:
    """The reference family's decode caches (``ref.cache_shapes``) for
    ``batch`` sequences of ``context + output_tokens`` positions, in bf16,
    every entry ``N(0, context_std**2)``, drawn in sorted-name order; the
    first ``context`` positions are each sequence's context, the rest is
    written by the decode."""
    shapes = ref.cache_shapes(conf, traffic["batch"], traffic["context"] + traffic["output_tokens"])
    gen = torch.Generator(device=device).manual_seed(derive(seed, "context"))
    out = {}
    for name in sorted(shapes):
        t = torch.randn(shapes[name], generator=gen, dtype=torch.bfloat16, device=device)
        out[name] = t.mul_(context_std(conf))
    return out


def first_tokens(conf: Dict[str, Any], traffic: Dict[str, Any], seed: int, rnd: int) -> torch.Tensor:
    """Round ``rnd``'s first token of every sequence: (B, 1) int32 on the host."""
    gen = torch.Generator().manual_seed(derive(seed, "tokens", rnd))
    return torch.randint(0, conf["vocab_size"], (traffic["batch"], 1), generator=gen,
                         dtype=torch.int32)


def sample(seed: int, n_rounds: int, batch: int, k: int) -> List[Tuple[int, int]]:
    """``k`` finished requests ``(round, sequence)`` drawn from the seed
    without replacement, from ``n_rounds`` finished rounds of ``batch``."""
    rng = np.random.default_rng(derive(seed, "sample"))
    picks = rng.choice(n_rounds * batch, size=min(k, n_rounds * batch), replace=False)
    return sorted((int(p) // batch, int(p) % batch) for p in picks)
