"""Training entry point with ZipNN checkpoints: a port of ``repro.launch.train``.

    python -m repro_torch.launch.train --arch repro_gpt_100m --reduced \\
        --steps 100 --batch 8 --seq 256 --ckpt-dir DIR --ckpt-every 20 [--device cpu]

* auto-resume from the newest valid checkpoint under ``--ckpt-dir``
  (torn saves skipped), restored onto ``--device`` (default ``cuda``: K1
  and K2 decode it on the card);
* async ZipNN saves every ``--ckpt-every`` steps (XOR deltas against the
  last base, a base every ``--base-every`` saves, the AdamW moments as
  deltas against the previous save; K3 and K7 encode card-resident
  leaves), and a blocking save at the end (unless the loop's last save,
  or the checkpoint resumed from, holds that step already: then the end
  waits for the save in flight; either way a save that failed raises
  there);
* batches from the deterministic pipeline keyed by step, so a resumed run
  sees the batches the uninterrupted one would have (within one process:
  ``data.pipeline`` seeds with ``hash(cfg.name)``, which Python salts per
  process).

The learning-rate schedule warms up over ``max(steps // 20, 2)`` steps and
decays to ``--steps``, as the reference's.  Checkpoints hold the train
state ``{"params", "opt": {"m", "v"}, "step"}`` in the reference's bytes.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import torch

from .. import _util
from ..checkpoint import CheckpointConfig, CheckpointManager
from ..configs import get_config
from ..core import zipnn
from ..core.options import CodecOptions
from ..data import DataConfig, make_batch
from ..optim import AdamWConfig
from ..train import init_train_state, make_train_step


def main(argv: Optional[List[str]] = None, *, zipnn_config: Optional[zipnn.ZipNNConfig] = None,
         options: Optional[CodecOptions] = None,
         state_out: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Parse ``argv`` and train; returns a summary: the ``start`` step,
    ``losses`` (one float a step run, in order), ``tokens_per_s`` over the
    run, ``resume_s`` (the restore's seconds, None without one) and
    ``ckpt`` (the manager's ``stats()``).  ``zipnn_config`` and
    ``options`` go to the checkpoint manager; when ``state_out`` is a dict,
    the final train state is put in it."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", type=str, default="repro_gpt_100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--base-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = _util.resolve_device(args.device)
    dc = DataConfig(seq_len=args.seq, global_batch=args.batch, seed=args.seed)
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                       total_steps=args.steps)
    step_fn = make_train_step(cfg, ocfg, microbatches=args.microbatches)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    mgr = None
    state = None
    start = 0
    resume_s = None
    if args.ckpt_dir:
        ckw = {"base_every": args.base_every, "device": dev, "options": options}
        if zipnn_config is not None:
            ckw["zipnn"] = zipnn_config
        mgr = CheckpointManager(CheckpointConfig(args.ckpt_dir, **ckw))
        latest = mgr.latest_step()
        if latest is not None:
            print(f"[resume] restoring step {latest} from {args.ckpt_dir}")
            t0 = time.perf_counter()
            _, state = mgr.restore(latest, device_resident=True)
            sync()
            resume_s = time.perf_counter() - t0
            start = int(state["step"])
    if state is None:
        state = init_train_state(cfg, args.seed, device=dev)

    losses: List[torch.Tensor] = []
    t0 = time.time()
    tokens_done = 0
    for step in range(start, args.steps):
        batch = make_batch(cfg, dc, step, device=dev)
        state, metrics = step_fn(state, batch)
        losses.append(metrics["loss"])
        tokens_done += args.batch * args.seq
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            dt = time.time() - t0
            print(
                f"step {step+1:5d} loss={float(metrics['loss']):.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} "
                f"lr={float(metrics['lr']):.2e} tok/s={tokens_done/dt:,.0f}"
            )
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, state)          # async, off critical path
    sync()
    run_s = time.time() - t0
    if mgr:
        if start < args.steps and args.steps % args.ckpt_every:
            mgr.save(args.steps, state, blocking=True)
        mgr.wait()          # the last save is on disk; a failed one raises here
        for s in mgr.stats():
            print(f"[ckpt] step={s['step']:5d} kind={s['kind']:5s} "
                  f"compressed_to={s['ratio_pct']:.1f}%")
    if state_out is not None:
        state_out.update(state)
    return {"start": start, "losses": [float(x) for x in losses],
            "tokens_per_s": tokens_done / run_s if tokens_done else None,
            "resume_s": resume_s, "ckpt": mgr.stats() if mgr else []}


if __name__ == "__main__":
    main()
