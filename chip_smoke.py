#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU and
check it end to end.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, in order; any failure raises and the script exits non-zero
without printing the final line:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: ``nvcc`` of every kernel source (one process each, in parallel);
3. kernels against their plain PyTorch versions on the card, bit-exact:
   K1 (Huffman decode) on a 768x768 bf16 leaf at 8 KiB chunks, plus a
   corrupted payload that must raise; K2 (plane consumer), all four
   variants, at a 768x3072 leaf's size;
4. the port's CUDA decode step against its CPU run on the reduced config
   (a small-input reference, within a stated bf16 tolerance);
5. the main path: repro_gpt_100m at full width (12 layers, d_model 768,
   vocab 32000, bf16, random weights from a seed) served compressed-
   resident — ``CompressedParamStore.from_params(..., payload_feed=True)``
   + ``make_compressed_serve_step`` + ``greedy_generate`` — for B=4
   requests of a 16-token prompt and 16 greedy tokens, against the plain
   decode step on the same requests: logits bit-identical, K1/K2 launch
   counts equal to the layer plan's, no payload upload after the store
   build, at most ``ring`` decoded layers resident;
6. report: store sizes, tokens/s, the ``kernels`` JSON line, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
BATCH, PROMPT, STEPS, RING = 4, 16, 16, 2
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
# Both kernels are integer shifts, masks and adds: they issue on the INT32
# lanes, 64 per SM x 132 SMs x 1.98 GHz boost clock on an H100 SXM.
INT32_OPS_PER_S = 64 * 132 * 1.98e9
K1_OPS_PER_SYMBOL = 12           # window build, LUT index, gather, store, cursor add
K2_OPS_PER_ELEMENT = 6           # join, rotate, (xor), store
# CUDA vs CPU decode_step, largest logit gap over the largest logit.  Set
# between the sound port's reading (1.4e-7 on the card) and bf16 controls
# (logits rounded to bf16: ~4e-3; attention in bf16: ~1e-3 on the CPU,
# tests/test_torch_model.py); the card's own bf16-rounding control is
# checked to read above it.
LOGIT_REL_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    import torch

    fn()                                        # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_params(shapes, rng, device):
    """Weights as the reference's serving benchmark makes them:
    ``standard_normal * 0.02`` per leaf in sorted-key order, cast to bf16."""
    import torch

    if isinstance(shapes, dict):                 # shape tuples are the leaves
        return {k: random_params(shapes[k], rng, device) for k in sorted(shapes)}
    a = (rng.standard_normal(shapes) * 0.02).astype(np.float32)
    return torch.from_numpy(a).to(torch.bfloat16).to(device)


def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    if not smi:
        raise RuntimeError("nvidia-smi reported no card")
    log(smi[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi[0]


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(libs)}")
    for name, text in sorted(_build.build_log.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


def phase_k1(dev):
    """K1 kernel vs plain on a real leaf; a corrupted payload must raise."""
    import torch

    from repro_torch.core import codec, container, device_entropy, zipnn
    from repro_torch.kernels import huffdecode_chunks, huffdecode_chunks_plain

    rng = np.random.default_rng(SEED + 1)
    leaf = torch.from_numpy(
        (rng.standard_normal((768, 768)) * 0.02).astype(np.float32)
    ).to(torch.bfloat16)
    cfg = zipnn.ZipNNConfig(backend="huffman", chunk_param_bytes=8 << 10)
    ct = zipnn.compress_array(leaf, cfg)
    meta, mv = container.unpack_stream(ct.blob)
    payloads = [
        [container.payload_view(meta, mv, p, c) for c in range(len(meta.entries[p]))]
        for p in range(meta.n_planes)
    ]
    params = codec.CodecParams(chunk_bytes=meta.chunk_bytes, backend="huffman")
    feed = device_entropy.PayloadFeed(meta.entries, payloads, meta.tables, params, device=dev)
    args = feed.launch_args()
    if args is None:
        raise AssertionError("K1 check leaf has no HUFF chunks")
    n_out = args.pop("out_bytes")
    out_k = torch.zeros(n_out, dtype=torch.uint8, device=dev)
    out_p = torch.zeros(n_out, dtype=torch.uint8, device=dev)
    cur_k = huffdecode_chunks(**args, out=out_k)
    cur_p = huffdecode_chunks_plain(**args, out=out_p)
    torch.cuda.synchronize()
    if not torch.equal(out_k, out_p) or not torch.equal(cur_k, cur_p):
        raise AssertionError("K1 kernel and plain version disagree")
    err = int((out_k.to(torch.int32) - out_p.to(torch.int32)).abs().max())
    back = zipnn.decompress_array(ct, cfg, device_resident=True, device=dev)
    if not torch.equal(back.cpu().view(torch.int16), leaf.view(torch.int16)):
        raise AssertionError("K1+K2 decode of the check leaf is not bit-exact")
    log(f"K1 vs plain: {int(args['counts'].numel())} chunks of "
        f"{meta.chunk_bytes} symbols, symbols and cursors equal")

    # Corruption: truncate one HUFF payload and re-seal its CRC, so only
    # the kernel's cursor check can catch it.
    entries = [[codec.ChunkEntry(e.method, e.comp_len, e.raw_len, e.crc) for e in pe]
               for pe in meta.entries]
    bad = [list(pl) for pl in payloads]
    p, c = next((p, c) for p in range(len(entries)) for c in range(len(entries[p]))
                if entries[p][c].method == codec.Method.HUFF)
    bad[p][c] = bad[p][c][:-2]
    entries[p][c].comp_len = len(bad[p][c])
    entries[p][c].crc = zlib.crc32(bad[p][c])
    try:
        device_entropy.decode_planes(entries, bad, meta.tables, params, device=dev)
    except ValueError as e:
        log(f"K1 corrupted payload raised: {e}")
    else:
        raise AssertionError("a truncated HUFF payload decoded without error")
    flipped = bytearray(ct.blob)
    flipped[meta.payload_offsets[p][c]] ^= 0x40
    try:
        zipnn.decompress_array(zipnn.CompressedTensor(bytes(flipped), ct.dtype, ct.shape),
                               cfg, device_resident=True, device=dev)
    except IOError as e:
        log(f"K1 flipped payload raised: {e}")
    else:
        raise AssertionError("a flipped payload byte decoded without error")
    return err


def phase_k2(dev):
    """K2 kernel vs plain, all four variants, at a 768x3072 leaf's size."""
    import torch

    from repro_torch.kernels import plane_consumer, plane_consumer_plain

    n = 768 * 3072
    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    err = 0
    for itemsize, dt in ((2, torch.int16), (4, torch.int32)):
        planes = [torch.randint(0, 256, (n,), dtype=torch.uint8, generator=g).to(dev)
                  for _ in range(itemsize)]
        base = torch.randint(-2**15 if itemsize == 2 else -2**31,
                             2**15 if itemsize == 2 else 2**31, (n,),
                             dtype=dt, generator=g).to(dev)
        for b in (None, base):
            k = plane_consumer(planes, b, itemsize=itemsize)
            p = plane_consumer_plain(planes, b, itemsize=itemsize)
            torch.cuda.synchronize()
            if not torch.equal(k, p):
                raise AssertionError(f"K2 itemsize {itemsize} base={b is not None} disagrees")
            err = max(err, int((k.to(torch.int64) - p.to(torch.int64)).abs().max()))
    log(f"K2 vs plain: 4 variants at n={n}, equal")
    return err


def phase_small_reference(dev):
    """The CUDA decode step against the CPU one on the reduced config."""
    import torch

    from repro_torch import _util
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_decode_state
    from repro_torch.models.model import param_shapes

    cfg = get_config("repro_gpt_100m").reduced()
    params_cpu = random_params(param_shapes(cfg), np.random.default_rng(SEED + 3), "cpu")
    params_gpu = _util.tree_map(lambda t: t.to(dev), params_cpu)
    toks = np.random.default_rng(SEED + 4).integers(0, cfg.vocab_size, (4, 2, 1))
    sc = init_decode_state(cfg, 2, 4, start_pos=0, device="cpu")
    sg = init_decode_state(cfg, 2, 4, start_pos=0, device=dev)
    worst = control = 0.0
    for t in toks:
        tk = torch.from_numpy(t.astype(np.int32))
        lc, sc = decode_step(cfg, params_cpu, sc, tk)
        lg, sg = decode_step(cfg, params_gpu, sg, tk.to(dev))
        lg = lg.cpu()
        if lg.shape != (2, 1, cfg.vocab_size) or not torch.isfinite(lg).all():
            raise AssertionError("CUDA logits are not finite or have the wrong shape")
        scale = float(lc.abs().max())
        diff = float((lg - lc).abs().max())
        worst = max(worst, diff / scale)
        # control: the same logits rounded to bf16, as an unembed without
        # f32 accumulation would give them
        control = max(control, float((lg.to(torch.bfloat16).float() - lc).abs().max()) / scale)
        if diff > LOGIT_REL_TOL * scale:
            raise AssertionError(f"CUDA vs CPU logits differ by {diff} (scale {scale})")
    if control <= 10 * LOGIT_REL_TOL:
        raise AssertionError(f"bf16 control reads {control}: the limit would not catch it")
    log(f"reduced config, CUDA vs CPU decode_step: max |diff| / max |logit| = {worst:.3e} "
        f"(limit {LOGIT_REL_TOL:g}; bf16-rounded control {control:.3e})")


def phase_main(dev, cfg, zcfg):
    """Serve ``cfg`` (repro_gpt_100m at full width) through the compressed
    ring, coded with ``zcfg``."""
    import torch

    from repro_torch import _util
    from repro_torch.core import device_entropy
    from repro_torch.core.options import CodecOptions
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import decode_step, init_decode_state
    from repro_torch.models.model import param_shapes
    from repro_torch.serve import (
        CompressedParamStore, greedy_generate, make_compressed_serve_step,
    )

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    params = random_params(param_shapes(cfg), rng, dev)
    log(f"params: {sum(t.numel() for t in _util.tree_leaves(params))} bf16 "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    store = CompressedParamStore.from_params(
        params, zcfg, options=CodecOptions(threads=-1), payload_feed=True, device=dev,
    )
    torch.cuda.synchronize()
    log(f"store build (host compress + feed upload + warmup): "
        f"{time.perf_counter() - t0:.1f} s")
    feeds = store.feeds("layers")
    missing = sum(f is None for layer in feeds for f in layer)
    if len(feeds) != cfg.n_layers or missing:
        raise AssertionError(f"{missing} stacked leaves have no payload feed")

    # Every decoded layer equals the original weights bit for bit.
    for i in range(cfg.n_layers):
        got = _util.tree_leaves(store.decode_layer("layers", i))
        want = _util.tree_leaves(_util.tree_map(lambda a, i=i: a[i], params["layers"]))
        store.release("layers", i)
        for g, w in zip(got, want):
            if not torch.equal(g.view(torch.int16), w.view(torch.int16)):
                raise AssertionError(f"layer {i} does not decode bit-exactly")
    store.reset_peak()
    parts = {"words": 0, "luts": 0, "index": 0}
    for f in (f for layer in feeds for f in layer):
        a = f.launch_args() or {}
        for k in ("words", "luts"):
            parts[k] += a[k].numel() * a[k].element_size() if k in a else 0
        parts["index"] += sum(a[k].numel() * a[k].element_size()
                              for k in ("word_off", "plane_ids", "counts", "out_off") if k in a)
    parts["splice"] = store.device_payload_bytes - sum(parts.values())
    log(f"device payload bytes by part: {parts}")
    log(f"store: ratio_pct {store.ratio_pct:.3f} comp_bytes {store.comp_bytes} "
        f"device_payload_bytes {store.device_payload_bytes} raw_bytes {store.raw_bytes} "
        f"static_bytes {store.static_bytes} footprint_bytes(ring={RING}) "
        f"{store.footprint_bytes(RING)} plain_weight_bytes {store.raw_bytes + store.static_bytes}")

    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    ).to(dev)
    # Warm the plain path (cuBLAS handles, allocator) before anything is timed.
    s = init_decode_state(cfg, BATCH, PROMPT + STEPS, start_pos=0, device=dev)
    decode_step(cfg, params, s, prompt[:, :1])
    torch.cuda.synchronize()

    cstep = make_compressed_serve_step(cfg, store, ring=RING)
    device_entropy.reset_transfer_stats()
    reset_launch_counts()
    ring_logits: list = []
    t0 = time.perf_counter()
    ring_tokens, _ = greedy_generate(
        cfg, None, prompt, STEPS, serve_step=cstep, logits_out=ring_logits
    )
    torch.cuda.synchronize()
    t_ring = time.perf_counter() - t0
    launches = launch_counts()
    uploads = device_entropy.transfer_stats()

    plain_logits: list = []
    t0 = time.perf_counter()
    plain_tokens, _ = greedy_generate(cfg, params, prompt, STEPS, logits_out=plain_logits)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0

    n_steps = PROMPT + STEPS
    if len(ring_logits) != n_steps or len(plain_logits) != n_steps:
        raise AssertionError("wrong number of decode steps")
    for t, (a, b) in enumerate(zip(plain_logits, ring_logits)):
        if a.shape != (BATCH, 1, cfg.vocab_size) or not torch.isfinite(a).all():
            raise AssertionError(f"step {t}: logits not finite or wrong shape")
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"step {t}: ring logits differ from the plain step")
    if not torch.equal(ring_tokens, plain_tokens):
        raise AssertionError("ring tokens differ from the plain step")
    per_step = {
        "huffdecode_chunks": sum(f.n_launches["huffdecode_chunks"] for l in feeds for f in l),
        "plane_consumer": sum(f.n_launches["plane_consumer"] for l in feeds for f in l),
    }
    for name, n in per_step.items():
        if launches[name] == 0 or launches[name] != n * n_steps:
            raise AssertionError(
                f"{name}: {launches[name]} launches, layer plan predicts {n * n_steps}"
            )
    if uploads["payload_uploads"]:
        raise AssertionError(f"ring uploaded payloads after warmup: {uploads}")
    if store.peak_resident > RING:
        raise AssertionError(f"peak residency {store.peak_resident} > ring {RING}")
    tokens = BATCH * n_steps
    log(f"served {BATCH} requests x ({PROMPT} prompt + {STEPS} greedy) tokens; "
        f"logits bit-identical at all {n_steps} steps; peak_resident {store.peak_resident}; "
        f"payload uploads after build {uploads['payload_uploads']}")
    log(f"tokens/s plain_step {tokens / t_plain:.2f} ({t_plain:.3f} s)  "
        f"compressed_ring {tokens / t_ring:.2f} ({t_ring:.3f} s)")
    log(f"launches per step: {per_step} (main-path run: {launches})")
    return store, launches, per_step, n_steps


def measure_k1(store, dev):
    """K1 at a main-path shape: the feed of layer 0's largest weight (a
    3072x768 MLP weight, 18 chunks)."""
    import torch

    from repro_torch.kernels import huffdecode_chunks, huffdecode_chunks_plain

    layer0 = store.feeds("layers")[0]
    sizes = [int(np.prod(f.shape)) for f in layer0]
    feed = layer0[int(np.argmax(sizes))]
    args = feed.launch_args()
    n_out = args.pop("out_bytes")
    out = torch.empty(n_out, dtype=torch.uint8, device=dev)
    ms = cuda_ms(lambda: huffdecode_chunks(**args, out=out), reps=5)
    out_p = torch.empty(n_out, dtype=torch.uint8, device=dev)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    cur_p = huffdecode_chunks_plain(**args, out=out_p)
    stop.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(stop)
    cur_k = huffdecode_chunks(**args, out=out)
    torch.cuda.synchronize()
    symbols = int(args["counts"].sum())
    syms_equal = all(
        torch.equal(out[o:o + n], out_p[o:o + n])
        for o, n in zip(args["out_off"].tolist(), args["counts"].tolist())
    )
    if not syms_equal or not torch.equal(cur_k, cur_p):
        raise AssertionError("K1 kernel and plain version disagree at the main-path shape")
    nbytes = sum(t.numel() * t.element_size() for t in args.values()) + symbols + 4 * cur_k.numel()
    b, by = bound_ms(nbytes, K1_OPS_PER_SYMBOL * symbols)
    log(f"K1 at {tuple(feed.shape)}: {args['counts'].numel()} chunks, {symbols} symbols, "
        f"{args['words'].numel() * 4} payload bytes; kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, "
        f"bound {b:.6f} ms ({by})")
    return ms, plain_ms, b, by


def measure_k2(dev):
    """K2 at a main-path shape: the bf16 no-base variant, 768x3072 elements."""
    import torch

    from repro_torch.kernels import plane_consumer, plane_consumer_plain

    n = 768 * 3072
    g = torch.Generator(device="cpu").manual_seed(SEED + 5)
    planes = [torch.randint(0, 256, (n,), dtype=torch.uint8, generator=g).to(dev) for _ in range(2)]
    ms = cuda_ms(lambda: plane_consumer(planes, itemsize=2), reps=50)
    plain_ms = cuda_ms(lambda: plane_consumer_plain(planes, itemsize=2), reps=10)
    b, by = bound_ms(2 * n + 2 * n, K2_OPS_PER_ELEMENT * n)
    log(f"K2 at n={n} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.6f} ms ({by})")
    return ms, plain_ms, b, by


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # fails outside a checkout of the repository: nothing else is importable
    from repro_torch.configs import get_config
    from repro_torch.core import zipnn
    from repro_torch.kernels import reset_launch_counts

    torch.backends.cuda.matmul.allow_tf32 = False     # f32 products stay f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    phase_card()
    phase_build()
    k1_err = phase_k1(dev)
    k2_err = phase_k2(dev)
    phase_small_reference(dev)
    store, launches, per_step, n_steps = phase_main(
        dev, get_config("repro_gpt_100m"), zipnn.ZipNNConfig(backend="huffman")
    )
    k1 = measure_k1(store, dev)
    k2 = measure_k2(dev)
    reset_launch_counts()

    kernels = [
        {"name": "huffdecode_chunks", "route": "cuda",
         "source": "src/repro_torch/csrc/huffdecode.cu",
         "replaces": "src/repro/kernels/huffdecode.py:92",
         "launches": launches["huffdecode_chunks"],
         "launches_per_step": per_step["huffdecode_chunks"], "max_abs_err": k1_err,
         "ms": k1[0], "plain_ms": k1[1], "bound_ms": k1[2], "bound_by": k1[3],
         "library_ms": None},
        {"name": "plane_consumer", "route": "cuda",
         "source": "src/repro_torch/csrc/unplane.cu",
         "replaces": "src/repro/kernels/fused_unplane.py:83",
         "launches": launches["plane_consumer"],
         "launches_per_step": per_step["plane_consumer"], "max_abs_err": k2_err,
         "ms": k2[0], "plain_ms": k2[1], "bound_ms": k2[2], "bound_by": k2[3],
         "library_ms": None},
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
