"""Time the plain decode step and the compressed ring of this checkout
against another checkout's on one CUDA card, in turns.

    python3 src/repro_torch/serve/serve_compare.py --other OTHER_CHECKOUT [--rounds 2]

from the checkout's root.  ``OTHER_CHECKOUT`` is a second tree of the
repository (a ``git archive`` of another commit, unpacked).  Each round
runs one process per tree in the order other, this, this, other; a
process imports ``repro_torch`` from its tree's ``src`` and drives it as
``chip_smoke.py``'s main path does: ``repro_gpt_100m`` at its published
size with random weights (``standard_normal * 0.02``, seed 0), its
serving store built on the card with payload feeds, then B=4 requests of
16 prompt + 16 greedy tokens through the plain step and through ring 2,
three times each in turns after one warm run of each.  It checks that
the ring's logits equal the plain step's bit for bit, and reports tokens/s
(host clock, the card synchronised) for each run.  Prints one JSON line
per process and a summary of the medians per (path, tree).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# <checkout>/src/repro_torch/serve/serve_compare.py
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), *[os.pardir] * 3))
REPS = 3                               # timed runs of each path a process


def worker(src: str) -> dict:
    sys.path.insert(0, ROOT)
    import chip_smoke                  # this tree's inputs (it puts this src first)
    import numpy as np
    import torch

    sys.path.insert(0, src)            # so that tree's package comes first
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.core import zipnn
    from repro_torch.core.options import CodecOptions
    from repro_torch.models.model import param_shapes
    from repro_torch.serve import (
        CompressedParamStore, greedy_generate, make_compressed_serve_step,
    )

    if not os.path.samefile(os.path.dirname(repro_torch.__file__),
                            os.path.join(src, "repro_torch")):
        raise RuntimeError(f"imported {repro_torch.__file__}, not the package under {src}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = get_config("repro_gpt_100m")
    rng = np.random.default_rng(chip_smoke.SEED)
    params = chip_smoke.random_params(param_shapes(cfg), rng, dev)
    store = CompressedParamStore.from_params(
        params, zipnn.ZipNNConfig(backend="huffman"),
        options=CodecOptions(threads=-1, backend="device"), payload_feed=True, device=dev,
    )
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (chip_smoke.BATCH, chip_smoke.PROMPT)).astype(np.int32)
    ).to(dev)
    cstep = make_compressed_serve_step(cfg, store, ring=chip_smoke.RING)
    tokens = chip_smoke.BATCH * (chip_smoke.PROMPT + chip_smoke.STEPS)

    def run(path):
        logits: list = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if path == "ring":
            greedy_generate(cfg, None, prompt, chip_smoke.STEPS, serve_step=cstep,
                            logits_out=logits)
        else:
            greedy_generate(cfg, params, prompt, chip_smoke.STEPS, logits_out=logits)
        torch.cuda.synchronize()
        return tokens / (time.perf_counter() - t0), logits

    _, plain_logits = run("plain")                 # warm runs, not timed
    _, ring_logits = run("ring")
    for t, (a, b) in enumerate(zip(plain_logits, ring_logits)):
        if not torch.isfinite(a).all() or not torch.equal(a.view(torch.int32),
                                                          b.view(torch.int32)):
            raise AssertionError(f"step {t}: ring logits differ from the plain step")
    out: dict = {"src": src, "plain tokens/s": [], "ring tokens/s": []}
    for _ in range(REPS):
        for path in ("plain", "ring"):
            out[f"{path} tokens/s"].append(run(path)[0])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path = [p for p in sys.path if os.path.abspath(p or ".") != here]   # run as a file
    if args.worker:
        print(json.dumps(worker(args.worker)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("serve_compare: no CUDA device available", file=sys.stderr)
        return 1
    trees = {"other": os.path.join(os.path.abspath(args.other), "src"),
             "this": os.path.join(ROOT, "src")}
    readings: dict = {}
    for _ in range(args.rounds):
        for tree in ("other", "this", "this", "other"):
            res = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--worker", trees[tree]], capture_output=True, text=True)
            if res.returncode:
                print(res.stdout + res.stderr, file=sys.stderr)
                raise RuntimeError(f"the {tree} tree's run failed")
            row = json.loads(res.stdout.strip().splitlines()[-1])
            print(json.dumps({"tree": tree, **row}), flush=True)
            for key, vals in row.items():
                if key != "src":
                    readings.setdefault((key, tree), []).extend(vals)
    for (key, tree), vals in sorted(readings.items()):
        print(f"{key:16s} {tree:5s} median {statistics.median(vals):.2f} "
              f"(all {[round(v, 2) for v in vals]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
