"""Time the encode kernels K3 (plane producer) and K7/K8 (Huffman bit-pack),
the byte histograms K9/K6, and the plane consumer K2 with K11 (the same
kernel without a base), of this checkout against another checkout's on
one CUDA card, in turns.

    python3 src/repro_torch/kernels/encode_compare.py --other OTHER_CHECKOUT \
        [--rounds 2] [--only K2,K11]

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
(allocation and any zeroing included in the events).  K2 in its four
variants (bf16 / fp32, with and without a base) and K11 bf16 / fp32 at
the 3072x768 leaf; K2 bf16 at a 768x768 attention projection (48 of the
main path's 108 K2 launches a ring step); K2 fp32 at hubert_xlarge's ``w_in`` stack (314,572,800
elements), fp32 with a base at the train state's largest window of f32
moments as a restore batches them (``train_moment_window``), and bf16 at
zamba2_7b's ``in_proj`` stack (4,074,749,952 elements, past 2^32 bytes);
planes and bases from a seeded generator on the card, every case held
bit for bit against ``plane_consumer_plain`` (the large ones slice by
slice), launches of 300 MB or more timed by events only.  ``--only``
keeps the cases whose names start with one of its prefixes.  Prints one
JSON line per process and a summary of the medians per (case, tree),
with each K2/K11 case's share of its bytes bound
(``(2 + base) x itemsize x n`` bytes at 3.35 TB/s).
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
LEAF_ELEMS = 3072 * 768
ATTN_ELEMS = 768 * 768           # an attention projection of repro_gpt_100m
HUBERT_W_IN = 48 * 1280 * 5120
ZAMBA2_IN_PROJ = 13 * 6 * 3584 * 14576
PLAIN_SLICE = 1 << 27            # elements a plain check holds at once on the large cases


def train_moment_window() -> int:
    """Elements of the largest K2 launch over the train state's f32
    moments (``opt/mu`` then ``opt/nu`` of repro_gpt_100m, sorted keys) as
    ``zipnn.decompress_pytree`` batches a restore: a window closes before
    a leaf that would take it past ``MAX_BATCH_BYTES``."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.core.device_plane import MAX_BATCH_BYTES
    from repro_torch.models.model import param_shapes

    def sizes(tree):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from sizes(tree[k])
            else:
                yield 4 * math.prod(tree[k])

    windows, acc = [], 0
    for nb in list(sizes(param_shapes(get_config("repro_gpt_100m")))) * 2:
        if acc and acc + nb > MAX_BATCH_BYTES:
            windows.append(acc)
            acc = 0
        acc += nb
    return max(windows + [acc]) // 4


def k2_cases() -> dict:
    """K2/K11 case name: (kernel, elements, itemsize, with a base)."""
    cases = {f"K2 {'bf16' if w == 2 else 'fp32'}{'+base' if b else ''}": ("K2", LEAF_ELEMS, w, b)
             for w in (2, 4) for b in (False, True)}
    cases.update({"K2 bf16 768x768": ("K2", ATTN_ELEMS, 2, False),
                  "K11 bf16": ("K11", LEAF_ELEMS, 2, False),
                  "K11 fp32": ("K11", LEAF_ELEMS, 4, False),
                  "K2 fp32 hubert w_in": ("K2", HUBERT_W_IN, 4, False),
                  "K2 fp32+base train window": ("K2", train_moment_window(), 4, True),
                  "K2 bf16 zamba2 in_proj": ("K2", ZAMBA2_IN_PROJ, 2, False)})
    return cases


def k2_bound_ms(n: int, itemsize: int, with_base: bool) -> float:
    return (2 + with_base) * itemsize * n / 3.35e12 * 1e3


def worker_k2(dev, K, chip_smoke, keep) -> dict:
    """K2 and K11 cases: (events ms, device ms or None) each."""
    import torch

    out = {}
    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 25)
    for key, (kernel, n, itemsize, with_base) in k2_cases().items():
        if not keep(key):
            continue
        dt = torch.int16 if itemsize == 2 else torch.int32
        planes = [torch.empty(n, dtype=torch.uint8, device=dev) for _ in range(itemsize)]
        base = torch.empty(n, dtype=dt, device=dev) if with_base else None
        for a in range(0, n, 1 << 30):
            for p in planes:
                p[a:a + (1 << 30)].random_(0, 256, generator=g)
            if base is not None:
                base[a:a + (1 << 30)].random_(torch.iinfo(dt).min, torch.iinfo(dt).max,
                                              generator=g)
        if kernel == "K11":
            ungroup = K.ungroup_bf16 if itemsize == 2 else K.ungroup_fp32

            def run(planes=planes, ungroup=ungroup):
                return ungroup(*planes)
        else:
            def run(planes=planes, base=base, itemsize=itemsize):
                return K.plane_consumer(planes, base, itemsize=itemsize)
        got = run()
        for a in range(0, n, PLAIN_SLICE):
            want = K.plane_consumer_plain([p[a:a + PLAIN_SLICE] for p in planes],
                                          None if base is None else base[a:a + PLAIN_SLICE],
                                          itemsize=itemsize)
            if not torch.equal(got[a:a + PLAIN_SLICE], want):
                raise AssertionError(f"{key} disagrees with the plain version at {a}")
        del got, want
        nbytes = (2 + with_base) * itemsize * n
        reps = 50 if n <= LEAF_ELEMS else 5
        out[key] = (chip_smoke.device_ms(run, reps),
                    chip_smoke.profiled_ms(run, r"unplane_kernel", 20, nbytes))
        del planes, base
        torch.cuda.empty_cache()
    return out


def worker(src: str, only) -> dict:
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

    def keep(key):
        return not only or any(key.startswith(p) for p in only)

    out.update(worker_k2(dev, K, chip_smoke, keep))
    out["unplane_resources"] = chip_smoke.kernel_resources("unplane")     # that tree's
    k3_cases = [(f"K3 {'bf16' if s == 2 else 'fp32'}{'+base' if b else ''}",
                 *chip_smoke.k3_inputs(dev, s, b, chip_smoke.SEED + 11), s)
                for s in (2, 4) for b in (False, True)]
    batch = chip_smoke.layer_batch(chip_smoke.layer0_params(dev))
    k3_cases.append(("K3 bf16 layer batch", batch, None, chip_smoke.BF16_CHUNK, 2))
    for key, x, base, chunk, itemsize in k3_cases:
        if not keep(key):
            continue

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
        if not keep(key):
            continue
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
        if not keep(key):
            continue
        if not torch.equal(run(), plain()):
            raise AssertionError(f"{key} disagrees with its plain version")
        out[key] = (chip_smoke.device_ms(run, 50),
                    chip_smoke.profiled_ms(run, r"hist_kernel", 20))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", help="comma-separated case-name prefixes to keep (e.g. K2,K11)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path = [p for p in sys.path if os.path.abspath(p or ".") != here]   # run as a file
    only = args.only.split(",") if args.only else []
    if args.worker:
        print(json.dumps(worker(args.worker, only)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("encode_compare: no CUDA device available", file=sys.stderr)
        return 1
    trees = {"other": os.path.join(os.path.abspath(args.other), "src"),
             "this": os.path.join(ROOT, "src")}
    readings: dict = {}
    resources: dict = {}
    for _ in range(args.rounds):
        for tree in ("other", "this", "this", "other"):
            res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                                  trees[tree]] + (["--only", args.only] if only else []),
                                 capture_output=True, text=True)
            if res.returncode:
                print(res.stdout + res.stderr, file=sys.stderr)
                raise RuntimeError(f"the {tree} tree's run failed")
            row = json.loads(res.stdout.strip().splitlines()[-1])
            print(json.dumps({"tree": tree, **row}), flush=True)
            for key, val in row.items():
                if key == "unplane_resources":
                    resources[tree] = val
                elif key != "src":
                    readings.setdefault((key, tree), []).append(val)
    for tree, lines in resources.items():
        for line in lines:
            print(f"K2 resources ({tree}): {line}")
    sys.path.insert(0, trees["this"])
    k2 = k2_cases()
    for (key, tree), vals in sorted(readings.items()):
        ev = [v[0] for v in vals]
        dv = [v[1] for v in vals if v[1] is not None]
        share = ""
        if key in k2:
            b = k2_bound_ms(*k2[key][1:])
            best = statistics.median(dv) if dv else statistics.median(ev)
            share = (f"; bound {b:.6f} ms, {100 * b / best:.1f}% of it "
                     f"({'device time' if dv else 'events'})")
        print(f"{key:26s} {tree:5s} events median {statistics.median(ev):.5f} ms "
              f"(all {[round(v, 5) for v in ev]}), device time alone median "
              f"{statistics.median(dv) if dv else None} (all {[round(v, 5) for v in dv]})"
              f"{share}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
