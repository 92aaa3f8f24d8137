"""Deterministic synthetic data: the batches the reference's pipeline makes.

A port of ``repro.data.pipeline``.  Every batch is a function of ``(arch,
shape, step)``: a numpy generator seeded with ``SeedSequence([seed, step,
hash(cfg.name) & 0x7FFFFFFF])`` draws it on the host, so the port and the
reference give the same batch for the same inputs in one process.
Python salts ``hash`` of a ``str`` per process (unless ``PYTHONHASHSEED``
is set), so two processes give other batches for the same step: the
reference's claim that any host can regenerate any batch holds only where
the hash seed is fixed.  Tokens follow a Zipf law over the vocabulary.

The vlm batch is patch embeddings (a quarter of the sequence, a multiple
of 4), text tokens and the M-RoPE positions ``pos_thw``: ``t = 0`` and an
``h``, ``w`` grid over ``int(sqrt(s_img))²`` patches (repeated or cut to
``s_img``), then the text at ``max(h) + 1 + i`` on all three.  The audio
batch is frame embeddings.  ``batch_specs`` gives each key's ``(shape,
torch dtype)`` without drawing anything.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from .. import _util

__all__ = ["DataConfig", "make_batch", "batch_specs", "data_stream"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2            # token distribution skew
    vlm_img_frac: float = 0.25     # fraction of the sequence that is patches


def _vlm_split(cfg, dc: DataConfig) -> Tuple[int, int]:
    s_img = max(int(dc.seq_len * dc.vlm_img_frac) // 4 * 4, 4)
    return s_img, dc.seq_len - s_img


def batch_specs(cfg, dc: DataConfig) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``(shape, dtype)`` of each key of one global batch."""
    B, S = dc.global_batch, dc.seq_len
    i32 = torch.int32
    if cfg.family == "vlm":
        s_img, s_txt = _vlm_split(cfg, dc)
        return {
            "tokens": ((B, s_txt), i32),
            "patches": ((B, s_img, cfg.frontend_dim), torch.bfloat16),
            "labels": ((B, s_txt), i32),
            "pos_thw": ((B, S, 3), i32),
        }
    if cfg.family == "audio":
        return {
            "frames": ((B, S, cfg.frontend_dim), torch.bfloat16),
            "labels": ((B, S), i32),
        }
    return {"tokens": ((B, S), i32), "labels": ((B, S), i32)}


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(torch.bfloat16)


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def make_batch(cfg, dc: DataConfig, step: int, *, device: Any = "cuda") -> Dict[str, torch.Tensor]:
    """The global batch for ``step``, drawn on the host and put on
    ``device``."""
    dev = _util.resolve_device(device)
    rng = np.random.default_rng(
        np.random.SeedSequence([dc.seed, step, hash(cfg.name) & 0x7FFFFFFF])
    )
    B, S = dc.global_batch, dc.seq_len

    def zipf_tokens(shape):
        # zipf over vocab, clipped; cheap + heavy-tailed like text
        z = rng.zipf(dc.zipf_a, size=shape)
        return np.minimum(z - 1, cfg.vocab_size - 1).astype(np.int32)

    if cfg.family == "vlm":
        s_img, s_txt = _vlm_split(cfg, dc)
        toks = zipf_tokens((B, s_txt))
        labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
        # M-RoPE positions: an h x w grid for the patches, then the text
        g = int(np.sqrt(s_img))
        hh, ww = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
        grid = np.stack([np.zeros_like(hh), hh, ww], -1).reshape(-1, 3)
        grid = np.resize(grid, (s_img, 3))
        txt0 = grid[:, 1].max() + 1
        tpos = txt0 + np.arange(s_txt)
        pos = np.concatenate([grid, np.stack([tpos, tpos, tpos], -1)], 0)
        out = {
            "tokens": _i32(toks),
            "patches": _bf16(rng.standard_normal((B, s_img, cfg.frontend_dim)) * 0.5),
            "labels": _i32(labels),
            "pos_thw": _i32(np.broadcast_to(pos[None], (B, S, 3))),
        }
    elif cfg.family == "audio":
        out = {
            "frames": _bf16(rng.standard_normal((B, S, cfg.frontend_dim)) * 0.5),
            "labels": _i32(zipf_tokens((B, S))),
        }
    else:
        toks = zipf_tokens((B, S + 1))
        out = {"tokens": _i32(toks[:, :-1]), "labels": _i32(toks[:, 1:])}
    return {k: v.to(dev) for k, v in out.items()}


def data_stream(cfg, dc: DataConfig, start_step: int = 0, *,
                device: Any = "cuda") -> Iterator[Dict[str, torch.Tensor]]:
    """Resumable stream: restart at any step and get identical batches
    (in one process: see the module's note on ``hash``)."""
    step = start_step
    while True:
        yield make_batch(cfg, dc, step, device=device)
        step += 1
