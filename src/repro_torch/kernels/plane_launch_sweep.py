"""Time launch shapes of the plane producer (K3, ``csrc/plane.cu``) on one
CUDA card.

    PYTHONPATH=src python3 -m repro_torch.kernels.plane_launch_sweep \
        [--only H32T128V2S0,...] [--rounds 3]

from the checkout's root.  Each variant is the source with its
``HIST_LANES`` (threads that share a histogram copy), ``THREADS`` and
``VECTORS`` constants replaced, built with the package's ``nvcc`` flags
and launched through its C entry point with ``S`` 16-byte vectors a thread
a tile (``S0``: the launcher sizes the tiles to about one wave, as the
package launches it).
Cases: bf16 and bf16 with a base at a 3072x768 leaf, fp32 at the leaf, and
bf16 at layer 0's batch as the store build launches it (each leaf padded
to whole 131,072-element chunks).  Every variant is checked against
``plane_producer_plain`` (planes and histograms), then timed in rounds,
variants interleaved, by ``chip_smoke.py``'s ``profiled_ms`` (device time
alone, L2 evicted before each launch).  Prints one line per (case,
variant), fastest first, with every round's reading in microseconds.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

# <checkout>/src/repro_torch/kernels/plane_launch_sweep.py: chip_smoke.py is at the root
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), *[os.pardir] * 3))

# (threads a histogram copy, threads a block, vectors in flight, steps)
VARIANTS = (
    [(h, t, v, 0) for h in (32, 16, 8) for t in (128, 256) for v in (2, 4)]
    + [(32, 128, v, s) for v in (2, 4) for s in (2, 8)]
)


def name(lanes, threads, vectors, steps):
    return f"H{lanes}T{threads}V{vectors}S{steps}"


def source(src: str, lanes: int, threads: int, vectors: int) -> str:
    for const, value in (("HIST_LANES", lanes), ("THREADS", threads), ("VECTORS", vectors)):
        line = next(l for l in src.splitlines() if l.startswith(f"constexpr int {const} = "))
        src = src.replace(line, f"constexpr int {const} = {value};")
    return src


def main() -> int:
    import torch

    from . import _build
    from .fused_plane import plane_producer_plain

    sys.path.insert(0, ROOT)
    import chip_smoke                   # its timing helpers and inputs, so both time alike

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--only", help="comma-separated variant names to keep (e.g. H32T128V2S0)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("plane_launch_sweep: no CUDA device available", file=sys.stderr)
        return 1
    variants = [v for v in VARIANTS if not args.only or name(*v) in args.only.split(",")]
    src = (_build.CSRC / "plane.cu").read_text()
    tmp = tempfile.mkdtemp(prefix="plane_sweep_")
    nvcc = _build.nvcc_path()
    procs = {}
    for lanes, threads, vectors, _ in variants:
        key = f"H{lanes}T{threads}V{vectors}"
        if key in procs:
            continue
        cu = os.path.join(tmp, f"{key}.cu")
        with open(cu, "w") as f:
            f.write(source(src, lanes, threads, vectors))
        procs[key] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", os.path.join(tmp, f"lib{key}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        fn = ctypes.CDLL(os.path.join(tmp, f"lib{key}.so")).plane_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[key] = fn

    print(chip_smoke.phase_card())
    dev = torch.device("cuda", 0)
    batch = chip_smoke.layer_batch(chip_smoke.layer0_params(dev))
    cases = {
        "bf16": (*chip_smoke.k3_inputs(dev, 2, False, chip_smoke.SEED + 11), 2),
        "bf16+base": (*chip_smoke.k3_inputs(dev, 2, True, chip_smoke.SEED + 11), 2),
        "fp32": (*chip_smoke.k3_inputs(dev, 4, False, chip_smoke.SEED + 11), 4),
        "bf16 layer batch": (batch, None, chip_smoke.BF16_CHUNK, 2),
    }
    stream = torch.cuda.current_stream(dev).cuda_stream
    res: dict = {}
    for case, (x, base, chunk, itemsize) in cases.items():
        n = x.numel()
        want = plane_producer_plain(x, base, itemsize=itemsize, chunk_elems=chunk)
        planes = torch.empty((itemsize, n), dtype=torch.uint8, device=dev)
        hists = torch.zeros((n // chunk, itemsize, 256), dtype=torch.int32, device=dev)
        runs = {}
        for lanes, threads, vectors, steps in variants:
            fn = libs[f"H{lanes}T{threads}V{vectors}"]

            def run(fn=fn, st=steps):
                hists.zero_()
                rc = fn(x.data_ptr(), None if base is None else base.data_ptr(),
                        planes.data_ptr(), hists.data_ptr(), n, chunk, st, itemsize, stream)
                if rc:
                    raise RuntimeError(f"launch failed: {rc}")
            run()
            torch.cuda.synchronize()
            key = name(lanes, threads, vectors, steps)
            if not (torch.equal(planes, want[0]) and torch.equal(hists, want[1])):
                raise AssertionError(f"{key} disagrees with the plain version on {case}")
            runs[key] = run
        for _ in range(args.rounds):
            for key, run in runs.items():
                ms = chip_smoke.profiled_ms(run, r"(?<!un)plane_kernel", 20)
                if ms is not None:
                    res.setdefault((case, key), []).append(ms * 1e3)
    for case in cases:
        rows = sorted(((sum(v) / len(v), k, v) for (c, k), v in res.items() if c == case))
        for mean, key, v in rows:
            print(f"{case} {key}: mean {mean:.3f} us ({' '.join(f'{x:.3f}' for x in v)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
