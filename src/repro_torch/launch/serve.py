"""Serving entry point: restore a ZipNN checkpoint (or draw random weights),
batch requests, greedy-decode.

    python -m repro_torch.launch.serve --arch granite_20b --reduced \
        --ckpt-dir DIR --batch 4 --prompt-len 16 --gen 32 [--device cpu]
    python -m repro_torch.launch.serve --arch zamba2_7b --ckpt-dir DIR

The checkpoint is one the port's (or the reference's: the bytes are the
same) ``CheckpointManager`` wrote, with the model's params under
``"params"``; it restores on ``--device`` (default ``cuda``: K1 and K2
decode it there).  Without ``--ckpt-dir`` the params are
:func:`repro_torch.models.model.init_params` of ``--seed``.  Prompts are
random tokens from ``--seed``.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import _util
from ..checkpoint import CheckpointConfig, CheckpointManager
from ..configs import get_config
from ..models.model import init_params
from ..serve.step import greedy_generate


def main(argv: Optional[List[str]] = None, *,
         params_out: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Parse ``argv``, restore or draw the params and generate; returns the
    generated tokens, (batch, gen).  When ``params_out`` is a dict, the
    params served are put in it (the restored tree, to check a restore)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", type=str, default="repro_gpt_100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only — nothing to decode")
    dev = _util.resolve_device(args.device)

    if args.ckpt_dir:
        mgr = CheckpointManager(CheckpointConfig(args.ckpt_dir, device=dev))
        step, tree = mgr.restore(device_resident=True)
        params = tree["params"]
        print(f"[serve] restored step {step} from ZipNN checkpoint")
    else:
        params = init_params(cfg, args.seed, device=dev)
        print("[serve] random init (no --ckpt-dir)")
    if params_out is not None:
        params_out.update(params)

    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    ).to(dev)
    t0 = time.perf_counter()
    out, _ = greedy_generate(cfg, params, prompt, args.gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"[serve] generated {args.batch}x{args.gen} tokens on {dev} in {dt:.1f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print("first sequence:", out[0].tolist())
    return out


if __name__ == "__main__":
    main()
