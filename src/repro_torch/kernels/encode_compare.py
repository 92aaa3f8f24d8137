"""Time the encode kernels K3 (plane producer) and K7/K8 (Huffman bit-pack),
and the byte histograms K9/K6, of this checkout against another checkout's
on one CUDA card, in turns.

    python3 src/repro_torch/kernels/encode_compare.py --other OTHER_CHECKOUT [--rounds 2]

from the checkout's root.  ``OTHER_CHECKOUT`` is a second tree of the
repository (a ``git archive`` of another commit, unpacked).  Each round
runs one process per tree in the order other, this, this, other; a
process imports ``repro_torch`` from its tree's ``src`` (building its
kernels there at first use), checks every case against the plain version
and times it with ``chip_smoke.py``'s helpers from this checkout, so both
trees are timed alike: ``device_ms`` (CUDA events around each call, L2
evicted before it) and ``profiled_ms`` (the kernel's device time alone).  Cases: K3 in its
four variants at a 3072x768 leaf and bf16 at layer 0's batch as the store
build launches it (each leaf padded to 131,072-element chunks); K7 on the
leaf's 18 exponent chunks of 131,072 symbols; K8 on the same plane at
8,192-symbol chunks; K9 on the exponent plane of the ops path's leaf and
K6 on it at 131,072-byte chunks, each call as its wrapper makes it
(allocation and any zeroing included in the events).  Prints one JSON
line per process and a summary of the medians per (case, tree).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

# <checkout>/src/repro_torch/kernels/encode_compare.py
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), *[os.pardir] * 3))


def worker(src: str) -> dict:
    sys.path.insert(0, ROOT)
    import chip_smoke                  # this tree's timing helpers (it puts this src first)
    import torch

    sys.path.insert(0, src)            # so that tree's package comes first
    from repro_torch import kernels as K

    here = os.path.join(src, "repro_torch", "kernels")
    if not os.path.samefile(os.path.dirname(K.__file__), here):
        raise RuntimeError(f"imported {K.__file__}, not the package under {src}")

    dev = torch.device("cuda", 0)
    out = {"src": src}
    k3_cases = [(f"K3 {'bf16' if s == 2 else 'fp32'}{'+base' if b else ''}",
                 *chip_smoke.k3_inputs(dev, s, b, chip_smoke.SEED + 11), s)
                for s in (2, 4) for b in (False, True)]
    batch = chip_smoke.layer_batch(chip_smoke.layer0_params(dev))
    k3_cases.append(("K3 bf16 layer batch", batch, None, chip_smoke.BF16_CHUNK, 2))
    for key, x, base, chunk, itemsize in k3_cases:
        def run(x=x, base=base, chunk=chunk, itemsize=itemsize):
            return K.plane_producer(x, base, itemsize=itemsize, chunk_elems=chunk)

        got, want = run(), K.plane_producer_plain(x, base, itemsize=itemsize, chunk_elems=chunk)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{key} disagrees with its plain version")
        out[key] = (chip_smoke.device_ms(run, 50),
                    chip_smoke.profiled_ms(run, r"(?<!un)plane_kernel", 20))

    (syms, pids, lens, codes), n_exp = chip_smoke.k7_inputs(dev)
    exp = syms[: n_exp * chip_smoke.BF16_CHUNK].contiguous()
    pids, lens, codes = pids[:n_exp].contiguous(), lens[:1].contiguous(), codes[:1].contiguous()
    for key, run, plain in (
        ("K7", lambda: K.bitpack_encode_chunks(exp, pids, lens, codes,
                                               chunk_syms=chip_smoke.BF16_CHUNK),
         lambda: K.bitpack_encode_chunks_plain(exp, pids, lens, codes,
                                               chunk_syms=chip_smoke.BF16_CHUNK)),
        ("K8", lambda: K.bitpack_encode_chunks_single(exp, lens[0], codes[0],
                                                      chunk_syms=chip_smoke.K8_CHUNK),
         lambda: K.bitpack_encode_chunks_single_plain(exp, lens[0], codes[0],
                                                      chunk_syms=chip_smoke.K8_CHUNK)),
    ):
        if not all(torch.equal(a, b) for a, b in zip(run(), plain())):
            raise AssertionError(f"{key} disagrees with its plain version")
        out[key] = (chip_smoke.device_ms(run, 20),
                    chip_smoke.profiled_ms(run, r"bitpack_kernel", 20))

    plane = chip_smoke.ops_inputs(dev)["exp"]
    for key, run, plain in (
        ("K9", lambda: K.byte_histogram(plane), lambda: K.byte_histogram_plain(plane)),
        ("K6", lambda: K.chunk_histogram(plane, chip_smoke.BF16_CHUNK),
         lambda: K.chunk_histogram_plain(plane, chip_smoke.BF16_CHUNK)),
    ):
        if not torch.equal(run(), plain()):
            raise AssertionError(f"{key} disagrees with its plain version")
        out[key] = (chip_smoke.device_ms(run, 50),
                    chip_smoke.profiled_ms(run, r"hist_kernel", 20))
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
        print("encode_compare: no CUDA device available", file=sys.stderr)
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
            for key, val in row.items():
                if key != "src":
                    readings.setdefault((key, tree), []).append(val)
    for (key, tree), vals in sorted(readings.items()):
        ev = [v[0] for v in vals]
        dv = [v[1] for v in vals if v[1] is not None]
        print(f"{key:22s} {tree:5s} events median {statistics.median(ev):.5f} ms "
              f"(all {[round(v, 5) for v in ev]}), device time alone median "
              f"{statistics.median(dv) if dv else None} (all {[round(v, 5) for v in dv]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
