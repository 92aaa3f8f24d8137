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
   variants, at a 768x3072 leaf's size; K3 (plane producer), all four
   variants with their histograms, at the same size; K7 (Huffman
   bit-pack) on the exponent and mantissa planes of a 3072x768 bf16 leaf
   at 131,072-symbol chunks under three tables, plus a chunk that expands
   past its capacity and a zero-padded partial final chunk;
4. the port's CUDA decode step against its CPU run on the reduced config
   (a small-input reference, within a stated bf16 tolerance);
5. the main path: repro_gpt_100m at full width (12 layers, d_model 768,
   vocab 32000, bf16, random weights from a seed).  The store builds on
   the card (its default ``device="cuda"``) from the card-resident params —
   ``CompressedParamStore.from_params(..., options=CodecOptions(threads=-1,
   backend="device"), payload_feed=True)``: K3 planes each layer, K7 packs
   the Huffman chunks — and its 108 stacked leaves' blobs must equal a
   host-built store's byte for byte with no HUFF-symbol upload.  Then
   ``make_compressed_serve_step`` + ``greedy_generate`` serve B=4
   requests of a 16-token prompt and 16 greedy tokens against the plain
   decode step on the same requests: logits bit-identical, K1/K2 launch
   counts equal to the layer plan's, no payload upload after the store
   build, at most ``ring`` decoded layers resident;
6. delta at full width: the 12 layers' stacks after one simulated
   fine-tuning step (``new = bf16(base + 1e-4 * N(0, 1))``) delta-coded on
   the card must equal the host's blobs and decode back to ``new`` bit
   for bit on the card;
7. fp32: the f32 copy of layers 0-1 of the stacks (cut to two layers only
   to bound the host side's time) encoded on the card must equal the
   host's blobs and round-trip bit-exactly;
8. report: store sizes, build times, tokens/s, the ``kernels`` JSON line,
   and last ``{"ok": true, "device": {...}}``.
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
# K3 per element and plane: extract, store, shared atomic; plus load,
# (xor), rotate
K3_OPS_PER_ELEMENT = {2: 4 + 3 * 2, 4: 4 + 3 * 4}
# K7 per symbol: two table lookups, its share of the block scan, position
# add, field shift and OR (one or two shared atomics), the word store
K7_OPS_PER_SYMBOL = 12
BF16_CHUNK = 1 << 17             # plane chunk of the default 256 KiB parameter chunks
LEAF = (3072, 768)               # the largest weight of a repro_gpt_100m layer
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


def max_abs_diff(a, b) -> int:
    """Largest |a - b| of two integer tensors of one shape, in int64."""
    import torch

    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


def _weights(shape, seed, dtype):
    """``standard_normal * 0.02`` as ``dtype``, made on the host from a seed."""
    import torch

    a = (np.random.default_rng(seed).standard_normal(shape) * 0.02).astype(np.float32)
    return torch.from_numpy(a).to(dtype)


def k3_inputs(dev, itemsize, with_base, seed):
    """K3 at a 3072x768 leaf's size: weight bits (and a base) on the card."""
    import torch

    dt = torch.int16 if itemsize == 2 else torch.int32
    wdt = torch.bfloat16 if itemsize == 2 else torch.float32
    x = _weights(LEAF, seed, wdt).reshape(-1).view(dt).to(dev)
    base = _weights(LEAF, seed + 1, wdt).reshape(-1).view(dt).to(dev) if with_base else None
    return x, base, BF16_CHUNK if itemsize == 2 else BF16_CHUNK // 2


def phase_k3(dev):
    """K3 kernel vs plain, all four variants, planes and histograms."""
    import torch

    from repro_torch.kernels import plane_producer, plane_producer_plain

    err = 0
    for itemsize in (2, 4):
        for with_base in (False, True):
            x, base, chunk = k3_inputs(dev, itemsize, with_base, SEED + 6)
            pk, hk = plane_producer(x, base, itemsize=itemsize, chunk_elems=chunk)
            pp, hp = plane_producer_plain(x, base, itemsize=itemsize, chunk_elems=chunk)
            torch.cuda.synchronize()
            if not torch.equal(pk, pp) or not torch.equal(hk, hp):
                raise AssertionError(f"K3 itemsize {itemsize} base={with_base} disagrees")
            if int(hk.sum()) != x.numel() * itemsize:
                raise AssertionError("K3 histograms do not count every byte")
            err = max(err, max_abs_diff(pk, pp), max_abs_diff(hk, hp))
    log(f"K3 vs plain: 4 variants at n={LEAF[0] * LEAF[1]}, planes and histograms equal")
    return err


def k7_inputs(dev):
    """K7's check inputs: the exponent and mantissa planes of a 3072x768
    bf16 leaf (18 chunks each), a chunk that expands past its capacity and
    a zero-padded partial final chunk, under three tables."""
    import torch

    from repro_torch.core import bitlayout, huffman

    leaf = _weights(LEAF, SEED + 8, torch.bfloat16)
    exp, man = bitlayout.to_planes(
        leaf.view(torch.uint8).numpy().reshape(-1), bitlayout.layout_for("bfloat16")
    )
    skew = (np.arange(BF16_CHUNK) % 7).astype(np.uint8)
    tables = []
    for sample in (exp, man, skew):
        lens = huffman.code_lengths(np.bincount(sample, minlength=256) + 1)
        tables.append((lens, huffman.canonical_codes(lens)))
    rng = np.random.default_rng(SEED + 9)
    partial = np.zeros(BF16_CHUNK, np.uint8)
    partial[:70_000] = skew[:70_000]
    syms = np.concatenate([exp, man, rng.integers(0, 256, BF16_CHUNK).astype(np.uint8), partial])
    n_exp = exp.size // BF16_CHUNK
    pids = np.asarray([0] * n_exp + [1] * n_exp + [2, 2], dtype=np.int32)
    lens = np.stack([t[0] for t in tables]).astype(np.int32)
    codes = np.stack([t[1] for t in tables]).astype(np.int32)
    return [torch.from_numpy(a).to(dev) for a in (syms, pids, lens, codes)], n_exp


def phase_k7(dev):
    """K7 kernel vs plain: words and bit counts, bit for bit."""
    import torch

    from repro_torch.kernels import bitpack_encode_chunks, bitpack_encode_chunks_plain

    args, n_exp = k7_inputs(dev)
    wk, nk = bitpack_encode_chunks(*args, chunk_syms=BF16_CHUNK)
    wp, np_ = bitpack_encode_chunks_plain(*args, chunk_syms=BF16_CHUNK)
    torch.cuda.synchronize()
    if not torch.equal(nk, np_) or not torch.equal(wk, wp):
        raise AssertionError("K7 kernel and plain version disagree")
    if int(nk[2 * n_exp]) <= 8 * BF16_CHUNK:
        raise AssertionError("K7 check: the expanding chunk did not expand")
    log(f"K7 vs plain: {nk.numel()} chunks of {BF16_CHUNK} symbols under 3 tables "
        f"(bits of the expanding chunk {int(nk[2 * n_exp])} > capacity {8 * BF16_CHUNK}; "
        f"partial chunk {int(nk[-1])} bits), words and bit counts equal")
    return max(max_abs_diff(wk, wp), max_abs_diff(nk, np_))


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
    """Build ``cfg``'s store (repro_gpt_100m at full width) on the card,
    coded with ``zcfg``, against host-built blobs, and serve it through the
    compressed ring."""
    import torch

    from repro_torch import _util
    from repro_torch.core import device_entropy, zipnn
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

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host_store = CompressedParamStore.from_params(
        params, zcfg, options=CodecOptions(threads=-1), device=dev
    )
    t_host = time.perf_counter() - t0

    # Main path, part 1: the serving store builds on the card — K3 planes
    # each layer, K7 packs the Huffman chunks, K1/K2 warm each feed.  The
    # store's device is left at its default, "cuda".  The encode ends
    # where the first feed starts; the clock is read there, the card
    # synchronised.
    feeds_from: list = []
    build_array_feed = zipnn.build_array_feed

    def timed_feed(*args, **kwargs):
        if not feeds_from:
            torch.cuda.synchronize()
            feeds_from.append(time.perf_counter())
        return build_array_feed(*args, **kwargs)

    device_entropy.reset_transfer_stats()
    reset_launch_counts()
    zipnn.build_array_feed = timed_feed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store = CompressedParamStore.from_params(
            params, zcfg, options=CodecOptions(threads=-1, backend="device"),
            payload_feed=True,
        )
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
    finally:
        zipnn.build_array_feed = build_array_feed
    t_dev = feeds_from[0] - t0
    build_launches = launch_counts()
    build_uploads = device_entropy.transfer_stats()
    if store.device != dev:
        raise AssertionError(f"the default store device resolved to {store.device}, not {dev}")
    n_leaves = huff_leaves = 0
    for i in range(cfg.n_layers):
        want = [c.blob for c in host_store.manifest("layers", i)["leaves"]]
        if [c.blob for c in store.manifest("layers", i)["leaves"]] != want:
            raise AssertionError(f"layer {i}: blobs built on the card differ from the host's")
        n_leaves += len(want)
        huff_leaves += sum(has_huff(b) for b in want)
    if build_uploads["symbol_uploads"]:
        raise AssertionError(f"the device build uploaded HUFF symbols: {build_uploads}")
    build_plan = {"plane_producer": cfg.n_layers, "bitpack_encode_chunks": huff_leaves}
    for name, n in build_plan.items():
        if build_launches[name] == 0 or build_launches[name] != n:
            raise AssertionError(
                f"{name}: {build_launches[name]} launches in the store build, plan {n}"
            )
    raw_mb = store.raw_bytes / 1e6
    log(f"store build: {n_leaves} stacked leaves, blobs built on the card equal the host's "
        f"byte for byte; HUFF-symbol uploads {build_uploads['symbol_uploads']}; "
        f"build launches {build_plan}")
    log(f"encode of {raw_mb:.1f} MB of stacks: host {t_host:.3f} s ({raw_mb / t_host:.1f} MB/s), "
        f"card {t_dev:.3f} s ({raw_mb / t_dev:.1f} MB/s); serving store on the card "
        f"(encode + feed upload + warmup) {t_build:.3f} s")
    del host_store
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
    return store, params, launches, per_step, n_steps, build_launches, build_plan


def has_huff(blob: bytes) -> bool:
    from repro_torch.core import codec, container

    meta, _ = container.unpack_stream(blob)
    return any(e.method == codec.Method.HUFF for pe in meta.entries for e in pe)


def phase_delta(dev, zcfg, params):
    """Delta at full width: the 12 layers' stacks after one simulated
    fine-tuning step at lr 1e-4, coded on the card and on the host."""
    import torch

    from repro_torch import _util
    from repro_torch.core import device_entropy, zipnn
    from repro_torch.core.options import CodecOptions
    from repro_torch.kernels import launch_counts, reset_launch_counts

    bases = _util.tree_leaves(params["layers"])
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    news = [
        (b.float() + 1e-4 * torch.randn(b.shape, generator=g, device=dev)).to(torch.bfloat16)
        for b in bases
    ]
    t0 = time.perf_counter()
    host = zipnn.delta_compress_batched(
        [n.cpu() for n in news], [b.cpu() for b in bases], zcfg,
        options=CodecOptions(threads=-1),
    )
    t_host = time.perf_counter() - t0
    device_entropy.reset_transfer_stats()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cts = zipnn.delta_compress_batched(
        news, bases, zcfg, options=CodecOptions(threads=-1, backend="device"), device=dev,
    )
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    launches = launch_counts()
    if [c.blob for c in cts] != [c.blob for c in host]:
        raise AssertionError("delta blobs coded on the card differ from the host's")
    if device_entropy.transfer_stats()["symbol_uploads"] or launches["plane_producer"] != 1:
        raise AssertionError(f"delta encode: launches {launches}, "
                             f"uploads {device_entropy.transfer_stats()}")
    for ct, b, n in zip(cts, bases, news):
        out = zipnn.delta_decompress(ct, b, zcfg, device_resident=True, device=dev)
        if out.device != dev or not torch.equal(out.view(torch.int16), n.view(torch.int16)):
            raise AssertionError(f"delta of shape {ct.shape} does not decode to new bit for bit")
    raw = sum(n.numel() * n.element_size() for n in news)
    comp = sum(c.nbytes for c in cts)
    changed = sum(int((n.view(torch.int16) != b.view(torch.int16)).sum())
                  for n, b in zip(news, bases))
    log(f"delta: {len(cts)} stacked leaves, {raw / 1e6:.1f} MB, {changed} of "
        f"{raw // 2} elements changed; ratio {100.0 * comp / raw:.3f}% ({comp} B); blobs "
        f"coded on the card equal the host's and decode to new bit for bit on the card; "
        f"encode host {t_host:.3f} s ({raw / 1e6 / t_host:.1f} MB/s), card {t_dev:.3f} s "
        f"({raw / 1e6 / t_dev:.1f} MB/s); launches {launches}")


def phase_fp32(dev, zcfg, params):
    """fp32: the f32 copy of layers 0-1 of the stacks (about 75 MB), coded
    on the card and on the host.  Two layers only bound the host side's
    time; K3's 4-byte variant and K7 at 65,536-symbol chunks run here."""
    import torch

    from repro_torch import _util
    from repro_torch.core import device_entropy, zipnn
    from repro_torch.core.options import CodecOptions
    from repro_torch.kernels import launch_counts, reset_launch_counts

    tree = _util.tree_map(lambda a: a[:2].float().contiguous(), params["layers"])
    t0 = time.perf_counter()
    host = zipnn.compress_pytree(
        _util.tree_map(lambda a: a.cpu(), tree), zcfg, options=CodecOptions(threads=-1)
    )
    t_host = time.perf_counter() - t0
    device_entropy.reset_transfer_stats()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = zipnn.compress_pytree(
        tree, zcfg, options=CodecOptions(threads=-1, backend="device"), device=dev
    )
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    launches = launch_counts()
    if [c.blob for c in got["leaves"]] != [c.blob for c in host["leaves"]]:
        raise AssertionError("fp32 blobs coded on the card differ from the host's")
    huff = sum(has_huff(c.blob) for c in got["leaves"])
    if (launches["plane_producer"] != 1 or launches["bitpack_encode_chunks"] != huff
            or device_entropy.transfer_stats()["symbol_uploads"]):
        raise AssertionError(f"fp32 encode: launches {launches}, HUFF leaves {huff}")
    back = zipnn.decompress_pytree(got, zcfg, device_resident=True, device=dev)
    for a, b in zip(_util.tree_leaves(back), _util.tree_leaves(tree)):
        if a.device != dev or not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError("fp32 round trip is not bit-exact")
    raw = got["raw_bytes"]
    log(f"fp32 (layers 0-1, {raw / 1e6:.1f} MB; cut to two layers to bound the host side's "
        f"time): blobs coded on the card equal the host's, round trip bit-exact on the card; "
        f"ratio {100.0 * got['comp_bytes'] / raw:.3f}%; encode host {t_host:.3f} s "
        f"({raw / 1e6 / t_host:.1f} MB/s), card {t_dev:.3f} s ({raw / 1e6 / t_dev:.1f} MB/s); "
        f"launches {launches}")


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


def measure_k3(dev):
    """K3 in all four variants at a 3072x768 leaf's size; the bf16 variant
    without a base is the one the main path's store build runs."""
    from repro_torch.kernels import plane_producer, plane_producer_plain

    out = {}
    for itemsize in (2, 4):
        for with_base in (False, True):
            x, base, chunk = k3_inputs(dev, itemsize, with_base, SEED + 11)
            ms = cuda_ms(lambda: plane_producer(x, base, itemsize=itemsize, chunk_elems=chunk),
                         reps=50)
            plain_ms = cuda_ms(
                lambda: plane_producer_plain(x, base, itemsize=itemsize, chunk_elems=chunk),
                reps=5)
            n = x.numel()
            nbytes = n * itemsize * (3 if with_base else 2) + (n // chunk) * itemsize * 256 * 4
            b, by = bound_ms(nbytes, K3_OPS_PER_ELEMENT[itemsize] * n)
            key = f"{'bf16' if itemsize == 2 else 'fp32'}{'+base' if with_base else ''}"
            out[key] = (ms, plain_ms, b, by)
            log(f"K3 {key} at n={n} (chunks of {chunk}): kernel {ms:.5f} ms, plain "
                f"{plain_ms:.4f} ms, bound {b:.6f} ms ({by}, {nbytes} B)")
    return out


def measure_k7(dev):
    """K7 at the main path's shape: the 18 exponent-plane chunks of a
    3072x768 bf16 leaf under its own table (its mantissa plane is stored
    raw, so this is the whole launch the build makes for such a leaf)."""
    import torch

    from repro_torch.kernels import bitpack_encode_chunks, bitpack_encode_chunks_plain

    (syms, pids, lens, codes), n_exp = k7_inputs(dev)
    syms = syms[: n_exp * BF16_CHUNK].contiguous()
    pids = pids[:n_exp].contiguous()
    lens, codes = lens[:1].contiguous(), codes[:1].contiguous()
    run = lambda: bitpack_encode_chunks(syms, pids, lens, codes, chunk_syms=BF16_CHUNK)  # noqa: E731
    ms = cuda_ms(run, reps=20)
    plain_ms = cuda_ms(
        lambda: bitpack_encode_chunks_plain(syms, pids, lens, codes, chunk_syms=BF16_CHUNK),
        reps=3)
    words, nbits = run()
    torch.cuda.synchronize()
    n = syms.numel()
    nbytes = n + words.numel() * 4 + 4 * nbits.numel() + 4 * pids.numel() + 2 * 4 * 256
    b, by = bound_ms(nbytes, K7_OPS_PER_SYMBOL * n)
    log(f"K7 at {n_exp} chunks of {BF16_CHUNK} exponent symbols ({int(nbits.sum())} bits): "
        f"kernel {ms:.5f} ms, plain {plain_ms:.4f} ms, bound {b:.6f} ms ({by})")
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
    k3_err = phase_k3(dev)
    k7_err = phase_k7(dev)
    phase_small_reference(dev)
    zcfg = zipnn.ZipNNConfig(backend="huffman")
    store, params, launches, per_step, n_steps, build_launches, build_plan = phase_main(
        dev, get_config("repro_gpt_100m"), zcfg
    )
    k1 = measure_k1(store, dev)
    k2 = measure_k2(dev)
    del store
    phase_delta(dev, zcfg, params)
    phase_fp32(dev, zcfg, params)
    k3 = measure_k3(dev)["bf16"]
    k7 = measure_k7(dev)
    reset_launch_counts()

    no_library = "no single PyTorch call computes it"
    kernels = [
        {"name": "huffdecode_chunks", "route": "cuda",
         "source": "src/repro_torch/csrc/huffdecode.cu",
         "replaces": "src/repro/kernels/huffdecode.py:92",
         "launches": launches["huffdecode_chunks"],
         "launches_per_step": per_step["huffdecode_chunks"], "max_abs_err": k1_err,
         "ms": k1[0], "plain_ms": k1[1], "bound_ms": k1[2], "bound_by": k1[3],
         "library_ms": None, "library": no_library},
        {"name": "plane_consumer", "route": "cuda",
         "source": "src/repro_torch/csrc/unplane.cu",
         "replaces": "src/repro/kernels/fused_unplane.py:83",
         "launches": launches["plane_consumer"],
         "launches_per_step": per_step["plane_consumer"], "max_abs_err": k2_err,
         "ms": k2[0], "plain_ms": k2[1], "bound_ms": k2[2], "bound_by": k2[3],
         "library_ms": None, "library": no_library},
        {"name": "plane_producer", "route": "cuda",
         "source": "src/repro_torch/csrc/plane.cu",
         "replaces": "src/repro/kernels/fused_plane.py:52",
         "launches": build_launches["plane_producer"],
         "launches_per_build": build_plan["plane_producer"], "max_abs_err": k3_err,
         "ms": k3[0], "plain_ms": k3[1], "bound_ms": k3[2], "bound_by": k3[3],
         "library_ms": None, "library": no_library},
        {"name": "bitpack_encode_chunks", "route": "cuda",
         "source": "src/repro_torch/csrc/bitpack.cu",
         "replaces": "src/repro/kernels/bitpack.py:116",
         "launches": build_launches["bitpack_encode_chunks"],
         "launches_per_build": build_plan["bitpack_encode_chunks"], "max_abs_err": k7_err,
         "ms": k7[0], "plain_ms": k7[1], "bound_ms": k7[2], "bound_by": k7[3],
         "library_ms": None, "library": no_library},
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
