"""Time K1's self-synchronising decode (``csrc/huffdecode.cu``) at several
segment sizes on one CUDA card.

    PYTHONPATH=src python3 -m repro_torch.kernels.k1_segment_sweep \
        [--shape 3072x768 --shape 6144x24576] [--seg 480,512,544,1024] [--reps 10]

from the checkout's root.  For each shape a random bf16 leaf
(``standard_normal * 0.02``, seed 0, as ``chip_smoke.py`` draws the main
path's weights) is encoded on the card at the default 256 KiB chunking and
its payload feed built; the index pass and the one-shot decode are then
timed at each segment size by ``chip_smoke.py``'s ``k1_serial_forms``
(CUDA events with L2 evicted before each launch, and the device time alone
from the profiler), beside the chain baseline at the default size and
checked bit for bit against it.  Sizes off a power of two put a warp's
segments on different shared-memory banks of the staged words: 512 bits is
16 words, so the 32 lanes of a warp start on two banks.  Prints the LUT
width and one line per (shape, size).
"""

from __future__ import annotations

import argparse
import os
import sys

# <checkout>/src/repro_torch/kernels/k1_segment_sweep.py: chip_smoke.py is at the root
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), *[os.pardir] * 3))
SEGMENTS = (480, 512, 528, 544, 1008, 1024, 1056, 2048)


def main() -> int:
    import numpy as np
    import torch

    from ..core import zipnn
    from ..core.options import CodecOptions
    from .huffdecode import SEG_BITS

    sys.path.insert(0, ROOT)
    import chip_smoke                   # its timing helpers, so both time alike

    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", action="append", default=[],
                    help="a leaf shape, e.g. 3072x768 (repeatable; default 3072x768 and "
                         "6144x24576)")
    ap.add_argument("--seg", default=",".join(map(str, SEGMENTS)),
                    help="comma-separated segment sizes in bits")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_segment_sweep: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    chip_smoke.phase_card()
    chip_smoke.phase_build()
    cfg = zipnn.ZipNNConfig(backend="huffman")
    shapes = [tuple(int(x) for x in s.split("x")) for s in args.shape] or [(3072, 768),
                                                                          (6144, 24576)]
    for shape in shapes:
        rng = np.random.default_rng(chip_smoke.SEED)
        leaf = torch.from_numpy((rng.standard_normal(shape) * 0.02).astype(np.float32))
        leaf = leaf.to(torch.bfloat16).to(dev)
        ct = zipnn.compress_array(leaf, cfg, options=CodecOptions(backend="device"), device=dev)
        feed = zipnn.build_array_feed(ct, cfg, device=dev)
        k1 = feed.launch_args()
        n_out = k1.pop("out_bytes")
        k1.pop("sync")
        sync_off = k1.pop("sync_off")
        print(f"{shape}: {k1['counts'].numel()} chunks, {k1['words'].numel()} words, "
              f"LUT width {k1['luts'].shape[1].bit_length() - 1} bits", flush=True)
        for seg in (int(x) for x in args.seg.split(",")):
            f = chip_smoke.k1_serial_forms(k1, sync_off, n_out, dev, reps=args.reps,
                                           seg_bits=seg, chain=seg == SEG_BITS, plain=False)
            i, o = f["index_pass"], f["one_shot"]
            print(f"{shape} {seg}-bit segments: index pass {i['ms']:.5f} ms (device "
                  f"{i['kernel_ms_profiler']}), one-shot {o['ms']:.5f} ms (device "
                  f"{o['kernel_ms_profiler']}), rounds max {f['rounds']['max']}"
                  + (f"; chain {i['chain_ms']:.4f} / {o['chain_ms']:.4f} ms" if i["chain_ms"]
                     else ""), flush=True)
        del feed, ct, leaf, k1
    return 0


if __name__ == "__main__":
    sys.exit(main())
