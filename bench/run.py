"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which also end standard error.  Without a card, or with fewer than the
cell asks for, or without the program, it exits 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _env() -> None:
    """Caches inside the checkout, and no JAX behind a library's back."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    for p in (ROOT / "bench", ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    import torch

    from harness import cell as cells
    from harness import runner

    cell = cells.load(args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {args.workload} needs {chips} CUDA card(s); {n} present", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"bench: the program is not in this checkout: {e}", file=sys.stderr)
        return 2
    result, rec = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), T_START)
    if rec["trace"] and rec["trace"]["steps"]:
        t = rec["trace"]
        print(f"trace: {t['steps']} steps, {len(t['decode'])} decode and {len(t['compute'])} "
              f"compute device events, {t['unattributed']} of them attributed by stream",
              file=sys.stderr)
    found = runner.forbidden_modules(sys.modules)
    if found:
        print(f"bench: the run loaded {found}; the port must not load JAX or the JAX package",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
