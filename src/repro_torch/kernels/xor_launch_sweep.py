"""Time launch shapes of the XOR kernel (K5/K10, ``csrc/xor_delta.cu``)
against ``torch.bitwise_xor`` on one CUDA card.

    PYTHONPATH=src python3 -m repro_torch.kernels.xor_launch_sweep \
        [--baseline other_xor_delta.cu] [--only T128V8,...] [--rounds 5]

from the checkout's root.
Each variant is the source with its ``THREADS`` and
``VECTORS_PER_THREAD`` constants replaced (the grid is sized so that each
thread walks about that many 16-byte vectors), built with the package's ``nvcc``
flags and launched through its C entry point on int16 and int32 operands
of the main path's 3072x768 leaf.  Every variant is checked against
``a ^ b`` (and K10's count against the changed bytes), then timed in
rounds, variants and the library call interleaved, by ``chip_smoke.py``'s
``profiled_ms`` (device time alone, L2 evicted before each launch).
Each ``--baseline`` adds another version of the source as it stands.  Prints
one line per (dtype, variant), fastest first, with every round's reading.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

# <checkout>/src/repro_torch/kernels/xor_launch_sweep.py: chip_smoke.py is at the root
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), *[os.pardir] * 3))

# (threads a block, vectors a thread)
SHAPES = [(t, v) for t in (128, 256) for v in (1, 2, 3, 4, 6, 8, 12)]


def variant(src: str, threads: int, vectors: int) -> str:
    for name, value in (("THREADS", threads), ("VECTORS_PER_THREAD", vectors)):
        line = next(l for l in src.splitlines() if l.startswith(f"constexpr int {name} = "))
        src = src.replace(line, f"constexpr int {name} = {value};")
    return src


def main() -> int:
    import torch

    from . import _build

    sys.path.insert(0, ROOT)
    import chip_smoke                   # its timing helpers, so both time alike

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", action="append", default=[],
                    help="another xor_delta.cu to time as it stands (repeatable)")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--only", help="comma-separated variant names to keep (e.g. T128V6)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("xor_launch_sweep: no CUDA device available", file=sys.stderr)
        return 1
    src = (_build.CSRC / "xor_delta.cu").read_text()
    sources = {f"T{t}V{v}": variant(src, t, v) for t, v in SHAPES}
    if args.only:
        keep = set(args.only.split(","))
        sources = {k: v for k, v in sources.items() if k in keep}
    for path in args.baseline:
        sources[os.path.basename(path)] = open(path).read()
    tmp = tempfile.mkdtemp(prefix="xor_sweep_")
    nvcc = _build.nvcc_path()
    procs = {}
    for key, text in sources.items():
        cu = os.path.join(tmp, f"{key}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[key] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", os.path.join(tmp, f"lib{key}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    launch = {}
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        fn = ctypes.CDLL(os.path.join(tmp, f"lib{key}.so")).xor_delta_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        launch[key] = fn

    print(chip_smoke.phase_card())
    dev = torch.device("cuda", 0)
    n = chip_smoke.LEAF[0] * chip_smoke.LEAF[1]
    res: dict = {}
    for dt in (torch.int16, torch.int32):
        g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
        # zipnn: allow(det-random): seeded input of a timing sweep; it feeds no blob
        a = torch.randint(-2**15, 2**15, (n,), dtype=dt, device=dev, generator=g)
        b = a.clone()
        # zipnn: allow(det-random): seeded input of a timing sweep; it feeds no blob
        b[::3] = torch.randint(-2**15, 2**15, (b[::3].numel(),), dtype=dt, device=dev, generator=g)
        d = torch.empty_like(a)
        count = torch.zeros((), dtype=torch.int32, device=dev)
        nbytes = n * a.element_size()
        stream = torch.cuda.current_stream(dev).cuda_stream
        runs = {}
        for key, fn in launch.items():
            def run(fn=fn, c=None):
                rc = fn(a.data_ptr(), b.data_ptr(), d.data_ptr(), c, nbytes, 1, stream)
                if rc:
                    raise RuntimeError(f"launch failed: {rc}")
            count.zero_()
            run(c=count.data_ptr())
            torch.cuda.synchronize()
            if not torch.equal(d, a ^ b) or int(count) != int((d.view(torch.uint8) != 0).sum()):
                raise AssertionError(f"{key} disagrees with a ^ b")
            runs[key] = run
        runs["torch.bitwise_xor"] = lambda: torch.bitwise_xor(a, b)
        names = {k: r"xor_kernel<false>" for k in launch} | {"torch.bitwise_xor": r"BitwiseXor"}
        for _ in range(args.rounds):
            for key, run in runs.items():
                ms = chip_smoke.profiled_ms(run, names[key], 20)
                if ms is not None:
                    res.setdefault((str(dt), key), []).append(ms * 1e3)
    for dt in ("torch.int16", "torch.int32"):
        rows = sorted(((sum(v) / len(v), k, v) for (t, k), v in res.items() if t == dt))
        for mean, key, v in rows:
            print(f"{dt} {key}: mean {mean:.3f} us ({' '.join(f'{x:.3f}' for x in v)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
