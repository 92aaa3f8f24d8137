"""Time the plane consumer's pipeline shapes (K2/K11, ``csrc/unplane.cu``)
on one CUDA card.

    PYTHONPATH=src python3 -m repro_torch.kernels.unplane_launch_sweep \
        [--baseline other_unplane.cu [--baseline-smem 8192,32768]] \
        [--only T256S2B8I32W32,vector,...] \
        [--cases "bf16 leaf,fp32 hubert w_in"] [--rounds 3]

from the checkout's root.  A variant ``T<threads>S<stages>B<blocks>I<KiB>W<tiles>``
is the source with its ``THREADS``, ``STAGES`` (tiles in flight a block),
``BLOCKS_PER_SM`` and ``TILE_IN_BYTES`` (``I`` KiB of planes and base a
stage) constants replaced, built with the package's ``nvcc`` flags, and
launched through its C entry point with the tiles that
``fused_unplane._unplane_plan`` gives with the same ``TILE_IN_BYTES``,
waves of ``W`` tiles an SM and no call left to the vector path; ``--only``
takes any such name.  ``vector`` is the source as it stands launched with
no tiles: 16-element groups from 16-byte loads, the path the plan gives a
small bf16 call.  Variants whose stages do not fit in shared memory are
reported and skipped.  Each ``--baseline`` adds another version of the
source as it stands with the first design's C entry point (no tiles: the
kernel plans its own launch), such as the parent commit's;
``--baseline-smem`` also launches each with dynamic shared memory it does
not use, to show what asking for shared memory alone costs.  Cases: the
four variants (bf16 / fp32, with and without a base) at 768x768, at the
main path's 3072x768 leaf, at 2.75, 3.15 and 3.6 million and at 2^22
and 2^23 elements (where the vector path gives way to the pipeline), bf16 at 2^28 elements (a large
leaf), fp32 at hubert_xlarge's ``w_in`` stack (314,572,800 elements) and
fp32 with a base at the train state's largest moment window (56,623,104
elements).  Every variant is checked bit for bit against
``plane_consumer_plain``, then timed in rounds, variants interleaved, by
``chip_smoke.py``'s ``device_ms`` (CUDA events, L2 evicted before each
launch) and, under 300 MB, ``profiled_ms`` (device time alone).  Prints
one line per (case, variant), fastest first, with every round's reading
in microseconds and the share of the bytes bound.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile

# <checkout>/src/repro_torch/kernels/unplane_launch_sweep.py: chip_smoke.py is at the root
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), *[os.pardir] * 3))

# (threads a block, stages, blocks an SM, stage input KiB, tiles an SM a wave)
VARIANTS = list(dict.fromkeys([(256, s, b, i, w * b) for s in (2, 3, 4) for b in (1, 2, 4) for i in (16, 32)
             for w in (1, 2)]
            + [(t, s, b, i, w * b) for t in (128, 256) for s in (2, 3) for b in (4, 8)
               for i in (8, 16) for w in (2, 4) if (t, b, w) != (256, 4, 2)]
            + [(256, s, 8, i, s * 8) for s in (2, 3, 4) for i in (8, 32)]))
VARIANT_NAME = re.compile(r"T(\d+)S(\d+)B(\d+)I(\d+)W(\d+)")
VECTOR = "vector"
CASES = {                     # name: (elements, itemsize, with a base)
    **{f"{d}{'+base' if b else ''} {label}": (n, w, b)
       for d, w in (("bf16", 2), ("fp32", 4)) for b in (False, True)
       for label, n in (("768x768", 768 * 768), ("leaf", 3072 * 768), ("2.75M", 2_750_000),
                        ("3.15M", 3_150_000), ("3.6M", 3_600_000), ("2^22", 1 << 22),
                        ("2^23", 1 << 23))},
    "bf16 2^28": (1 << 28, 2, False),
    "fp32 hubert w_in": (48 * 1280 * 5120, 4, False),
    "fp32+base train window": (56_623_104, 4, True),
}


def name(threads, stages, blocks, in_kib, waves):
    return f"T{threads}S{stages}B{blocks}I{in_kib}W{waves}"


def lib_key(threads, stages, blocks, in_kib, _waves):
    return f"T{threads}S{stages}B{blocks}I{in_kib}"


def source(src: str, threads: int, stages: int, blocks: int, in_kib: int) -> str:
    for const, value in (("THREADS", threads), ("STAGES", stages), ("BLOCKS_PER_SM", blocks),
                         ("TILE_IN_BYTES", in_kib << 10)):
        line = next(l for l in src.splitlines() if l.startswith(f"constexpr int {const} = "))
        src = src.replace(line, f"constexpr int {const} = {value};")
    return src


def plan_for(n, itemsize, with_base, sms, in_kib, waves):
    """``_unplane_plan`` with a variant's constants, never the vector path."""
    from . import fused_unplane as fu

    saved = fu.TILE_IN_BYTES, fu.WAVE_TILES, fu.VECTOR_TILES_PER_SM
    fu.TILE_IN_BYTES, fu.WAVE_TILES, fu.VECTOR_TILES_PER_SM = in_kib << 10, waves, {2: 0, 4: 0}
    try:
        return fu._unplane_plan(n, itemsize, with_base, True, sms)
    finally:
        fu.TILE_IN_BYTES, fu.WAVE_TILES, fu.VECTOR_TILES_PER_SM = saved


def main() -> int:
    import torch

    from . import _build
    from .fused_unplane import ELEM_DTYPES, Plan, plane_consumer_plain

    sys.path.insert(0, ROOT)
    import chip_smoke                   # its timing helpers, so both time alike

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", action="append", default=[],
                    help="another unplane.cu to time as it stands (repeatable)")
    ap.add_argument("--baseline-smem", default="",
                    help="comma-separated byte counts: each baseline also launched with that "
                         "much dynamic shared memory, unused (at most 48 KB)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--only", help="comma-separated variant names to time "
                                   "(e.g. T256S2B8I32W32,vector); default: the whole sweep")
    ap.add_argument("--cases", help="comma-separated case names to keep")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("unplane_launch_sweep: no CUDA device available", file=sys.stderr)
        return 1
    only = args.only.split(",") if args.only else [name(*v) for v in VARIANTS] + [VECTOR]
    variants = [tuple(int(x) for x in VARIANT_NAME.fullmatch(o).groups())
                for o in only if o != VECTOR]
    cases = {k: v for k, v in CASES.items() if not args.cases or k in args.cases.split(",")}
    src = (_build.CSRC / "unplane.cu").read_text()
    tmp = tempfile.mkdtemp(prefix="unplane_sweep_")
    nvcc = _build.nvcc_path()
    procs = {}
    for v in variants:
        key = lib_key(*v)
        if key in procs:
            continue
        cu = os.path.join(tmp, f"{key}.cu")
        with open(cu, "w") as f:
            f.write(source(src, *v[:4]))
        procs[key] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", os.path.join(tmp, f"lib{key}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if VECTOR in only:
        procs[VECTOR] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", os.path.join(tmp, f"lib{VECTOR}.so"),
             str(_build.CSRC / "unplane.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for i, path in enumerate(args.baseline):
        text = open(path).read()
        for smem in [0] + [int(v) for v in args.baseline_smem.split(",") if v]:
            key = f"baseline{i}" + (f"+smem{smem}" if smem else "")
            cu = os.path.join(tmp, f"{key}.cu")
            with open(cu, "w") as f:
                f.write(text.replace("THREADS, 0, stream>>>", f"THREADS, {smem}, stream>>>"))
            procs[key] = subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-o", os.path.join(tmp, f"lib{key}.so"), cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            print(f"{key}: {path}" + (f" launched with {smem} B of dynamic shared memory "
                                      f"it does not use" if smem else ""))
    libs = {}
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {key}: {line.strip()}")
        fn = ctypes.CDLL(os.path.join(tmp, f"lib{key}.so")).unplane_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + (
            [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p] if key.startswith("baseline")
            else [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                  ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[key] = fn

    print(chip_smoke.phase_card())
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 25)
    res: dict = {}
    for case, (n, itemsize, with_base) in cases.items():
        planes = [torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev, generator=g)
                  for _ in range(itemsize)]
        dt = ELEM_DTYPES[itemsize]
        base = (torch.randint(torch.iinfo(dt).min, torch.iinfo(dt).max, (n,), dtype=dt,
                              device=dev, generator=g) if with_base else None)
        want = plane_consumer_plain(planes, base, itemsize=itemsize)
        out = torch.empty(n, dtype=dt, device=dev)
        nbytes = (2 + with_base) * itemsize * n
        bound, _ = chip_smoke.bound_ms(nbytes, chip_smoke.K2_OPS_PER_ELEMENT * n)
        ptrs = [p.data_ptr() for p in planes] + [None] * (4 - itemsize)
        bptr = None if base is None else base.data_ptr()
        runs = {}
        shapes = [(name(*v), libs[lib_key(*v)], plan_for(n, itemsize, with_base, sms, *v[3:]))
                  for v in variants]
        if VECTOR in libs:
            shapes.append((VECTOR, libs[VECTOR], Plan(0, 0, n - n % 16, n % 16)))
        shapes += [(k, fn, None) for k, fn in libs.items() if k.startswith("baseline")]
        for key, fn, plan in shapes:

            def run(fn=fn, plan=plan):
                tail = (stream,) if plan is None else (plan.tiles, plan.tile, stream)
                rc = fn(*ptrs, bptr, out.data_ptr(), n, itemsize, *tail)
                if rc:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")
            out.zero_()
            try:
                run()
            except RuntimeError as e:
                print(f"{case} {key}: skipped ({e}; {plan})")
                continue
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{key} disagrees with the plain version on {case}")
            runs[key] = (run, plan)
        del want
        for _ in range(args.rounds):
            for key, (run, plan) in runs.items():
                ev = chip_smoke.device_ms(run, 20 if nbytes < 300_000_000 else 5)
                dv = chip_smoke.profiled_ms(run, r"unplane_kernel", 20, nbytes)
                r = res.setdefault((case, key), {"ev": [], "dv": [], "bound": bound,
                                                 "plan": plan})
                r["ev"].append(ev * 1e3)
                if dv is not None:
                    r["dv"].append(dv * 1e3)
        del planes, base, out
        torch.cuda.empty_cache()
    for case in cases:
        rows = sorted(((sum(r["dv"] or r["ev"]) / len(r["dv"] or r["ev"]), k, r)
                       for (c, k), r in res.items() if c == case), key=lambda t: t[0])
        for mean, key, r in rows:
            print(f"{case} {key} ({r['plan']}): "
                  f"{'device' if r['dv'] else 'events'} mean {mean:.3f} us, "
                  f"{100 * r['bound'] * 1e3 / mean:.1f}% of the bound "
                  f"{r['bound'] * 1e3:.3f} us; events "
                  f"{' '.join(f'{x:.3f}' for x in r['ev'])}; device "
                  f"{' '.join(f'{x:.3f}' for x in r['dv'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
