"""Readings that the limits of ``checks/<workload>.json`` are set from.

    python3 bench/calibrate.py --workload <name> --seeds 1,2,3 --seconds 5 [--control 1]

For each seed, in one process, a run of the cell as ``run.py`` makes it
(set-up, a window of ``--seconds``, the round under way finished, the
sampled requests judged), and with ``--control 1`` the control's reading
over the same requests (the reference with every weight product's
operands in float8 e4m3), judged by the harness's own comparison against
the cell's limits (``checks/<workload>.json``).  One JSON line a seed on
standard output.  Exits 1 if the control comes out correct on any seed.
The benchmark's own runs never compute the control.
"""

import argparse
import json
import sys
import time

from run import _env


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    import torch

    from harness import cell as cells
    from harness import check, runner

    cell = cells.load(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    control_passed = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result, rec = runner.run(cell, seed, args.seconds, False, torch.device("cuda", 0), t0,
                                 control=bool(args.control))
        r = rec["reading"]
        ctl = check.judge_control(r, cell.limits) if args.control else None
        if ctl and ctl["correct"]:
            control_passed.append(seed)
        print(json.dumps({"workload": args.workload, "seed": seed, "logit_gap": r["logit_gap"],
                          "per_request": r["per_request"], "correct": result["correct"],
                          "control": r.get("control"),
                          "control_correct": ctl["correct"] if ctl else None,
                          "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    if control_passed:
        print(f"calibrate: the control came out correct on seeds {control_passed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
