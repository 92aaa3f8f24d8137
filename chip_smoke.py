#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU and
check it end to end.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, in order; any failure raises and the script exits non-zero
without printing the final line:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: ``nvcc`` of every kernel source (one process each, in parallel);
3. kernels against their plain PyTorch versions on the card, bit-exact:
   K1 (Huffman decode) on a 768x768 bf16 leaf at 8 KiB chunks in its three
   launch forms (the sync decode from a feed's sync index; the one-shot
   decode and the index pass, both K1's self-synchronising kernel), and
   against the chain baseline (one thread a chunk), plus a corrupted
   payload that must raise at a one-shot decode and at a feed's build; K2 (plane consumer), all four
   variants, at a 768x3072 leaf's size, at a ragged size, across its
   largest tile and as misaligned plane views, each on the kernel path
   its plan names (bulk copies, 16-byte groups or elements), with the
   kernel's registers and shared memory; K3 (plane producer), all four
   variants with their histograms, at the same size; K7 (Huffman
   bit-pack) on the exponent and mantissa planes of a 3072x768 bf16 leaf
   at 131,072-symbol chunks under three tables, plus a chunk that expands
   past its capacity and a zero-padded partial final chunk; then K7 and K8
   under ``torch.cuda.set_sync_debug_mode("error")`` (their CUDA path reads
   nothing back to the host), K7 with a bad plane id and a length-16 row
   that it must flag with ``nbits = -1``;
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
   counts equal to the layer plan's (the sync decode only; the index pass
   once per leaf at build), no payload upload after the store build, at
   most ``ring`` decoded layers resident.  Then the sync decode on all 108
   leaves against its plain version and the one-shot kernel, and one
   ``torch.profiler`` session over a few ring steps: each step's decode and
   compute device time and the card's idle share;
6. delta at full width: the 12 layers' stacks after one simulated
   fine-tuning step (``new = bf16(base + 1e-4 * N(0, 1))``) delta-coded on
   the card must equal the host's blobs and decode back to ``new`` bit
   for bit on the card;
7. the ops kernels against their plain versions on the card, bit-exact,
   at a 3072x768 leaf (2,359,296 elements) in bf16 and its fp32 copy: K4
   and K11 (byte-group and its inverse, both widths, a round trip), K5
   (XOR, u16 and u32) and K10 (XOR delta with its changed-byte count) on
   a fine-tuned copy, K6 (chunk histograms at 131,072 bytes) and K9 (byte
   histogram) on the exponent plane, K8 (single-table bit-pack) on that
   plane at 8,192-symbol chunks under the host codec's table;
8. the ops path: ``repro_torch.kernels.ops`` over all 108 stacked leaves
   of the main path's params and the delta phase's fine-tuned copy —
   exponent histograms (paper Fig. 2) equal to numpy's of the host planes,
   bit-exact ungroup round trips (bf16 and fp32), chunk histograms, the
   XOR delta's changed bytes (Fig. 8a) equal to numpy's count, and for
   layer 0's 9 leaves ``ops.huffman_encode_chunks`` of the exponent plane
   equal to the host encoder's bytes; one ``torch.profiler`` session over
   the pass sums its kernels' device time.  Then the statistics
   (``core.stats``) over the same 108 leaves on the card: exponent
   histograms, plane reports, ``theoretical_ratio`` of the largest leaf,
   ``classify_model``, ``byte_entropy`` of a plane and Fig. 2 over the
   whole model, their K4 and K9 launches against the plan, each result
   equal (histograms and floats) to the same function over the downloaded
   leaves on the CPU; and the baselines (``core.baselines``: zlib 6 and 1,
   Huffman-only, fast-LZ, EE+zlib; on the host, ``ee_zlib`` of the card
   tensor with K4's planes) over one 3072x768 leaf, their bytes from the
   card tensor equal to the host bytes', ratio and MB/s beside ZipNN's on
   the card for the same bytes;
9. fp32: the f32 copy of layers 0-1 of the stacks (cut to two layers only
   to bound the host side's time) encoded on the card must equal the
   host's blobs and round-trip bit-exactly;
10. measurements, every kernel timed one way: CUDA events around each
    launch with L2 evicted before it (``device_ms``) and the device time
    alone from ``torch.profiler`` (``profiled_ms``), for K1 (the sync
    decode at 256, 512 and 1,024 symbols a sub-stream; the index pass and
    the one-shot decode beside the chain baseline in turns, and at 512,
    544, 1,024 and 2,048-bit segments), K2, K3 (at the
    leaf and at a layer's batch as the store build launches it) and K7 at
    the main path's shapes and the ops kernels at the 3072x768 leaf, beside
    their plain versions and ``torch.bitwise_xor`` (K5) and
    ``torch.bincount`` (K9);
11. files: the main path's stacks (226.5 MB of bf16) as one raw stream
    through ``compress_file`` on the card (``backend="device"``, 64 MiB
    frames, two in flight: K3 and K7 a frame) must equal the host's file,
    and ``decompress_file`` on the card (K1's one-shot decode and K2 a
    frame) must give the stream back; the frozen
    ``tests/fixtures/bf16_stream.znns`` decodes on the card;
12. checkpoints: repro_gpt_100m's params on the card with fp32 AdamW
    moments for every parameter, three async saves on the card
    (``base_every=3``: base, delta, delta; the state updated in place
    right after each save returns), then ``restore(device_resident=True)``
    must equal the last state bit for bit; ``shard_restore`` of the same
    step onto a (1, 1) ``DeviceMesh("cuda")`` (a one-process NCCL group on
    an in-memory store, destroyed after) under ``train_state_specs``: every
    leaf a DTensor with its spec's placements and ``full_tensor()`` equal
    bit for bit to the restore's, K1's one-shot decode and K2 launched as
    in the restore, no more bytes copied to the host than the restore's
    own reads (from a profiler trace of each), its seconds beside the
    restore's; the same saves of layers 0-1
    of the stacks and their moments on the card and on the host must write
    equal bytes.  The main path of the forward pass: ``make_prefill`` over
    the params that restore just made on the card (K1's one-shot decode and
    K2 counted from before the restore to after the prefill), held at B=4,
    S=128 against the plain decode loop's logits of the same prompt, both
    on those params with the reference's norms (gains 1): the largest gap
    under 5e-2 of the largest logit (MoE 1e-1, the hybrid 3e-1; the
    reference's ``atol = rtol = 8e-2`` a reading), with a control (one
    block's output zeroed) that must fail the same comparison, then
    timed at B=4 x S=2,048 (tokens/s, peak card memory) and profiled (device
    time in matmuls, the flash loop, the SSD scan, the MoE dispatch and
    combine, the rest; the card's idle share);
13. granite_20b at its published widths (d_model 6144, 48 heads of 128,
    one KV head, d_ff 24576, vocab 49,152, 32,768 learned positions,
    layernorm, GELU, QKV bias), cut in depth to 4 of its 52 layers, random
    bf16 weights drawn on the card (``models.model.init_params``, seed 0):
    the store built on the card as in phase 5 (layer 0's 15 blobs against
    the host's encode of each leaf; every decoded leaf of every layer
    against its param; K3 launches as the batch cap splits each layer, K7
    as its chunk cap splits each leaf, the index pass once per Huffman
    leaf, all planned from the blobs); the ring at ``tiles`` 1 and 4
    against the plain step on B=4 requests of 16 + 16 tokens (logits
    bit-identical, no payload upload, at most ``ring x tiles`` tile slots,
    K1/K2 launches equal to the plan); a profiler trace of 4 ring steps at
    each; the ring at ``tiles=4`` with a ``KVCacheStore`` at the reference's
    defaults (hot window 256, blocks of 64) over a 384-token prompt and 32
    greedy tokens against the plain step over the untiered cache (logits
    bit-identical at all 416 steps, each evicted block's blob equal to the
    host's encode of it, K3/K7 at eviction and K1's one-shot decode and K2
    in the reassembly equal to the block plan); then K1 (sync decode, index
    pass, one-shot decode), K2, K3 and K7 at the 6144x24576 ``w_in`` leaf
    against their plain versions and their bounds (K1's index pass and
    one-shot decode beside the chain baseline); prefill held at B=1,
    S=1,088 (past the 1,024 kv block, padded) and timed at B=4 x 2,048;
14. olmoe_1b_7b whole at its published size (16 layers, d_model 2048, 16
    heads of 128, 64 experts of 2048x1024, top-8, vocab 50,304, routers
    f32; 13,842,386,944 B): the same store checks (layer 0's 10 blobs
    against the host's; every leaf of layers 0 and 15 decoded; the expert
    leaf is exactly K3's 256 MiB batch cap and K7's 1,024-chunk cap, so the
    plans test both edges), the ring at ``tiles`` 1 and 4 against the
    plain step with traces, and K1/K2/K3/K7 at an expert leaf and at a
    router leaf (f32: K2's and K3's 4-byte paths); prefill held at B=4,
    S=64 at a capacity factor where nothing drops (at the config's 1.25
    each side drops other pairs: a reading with the drops, not held) and
    timed at B=4 x 2,048;
15. deepseek_v2_236b at its published widths (d_model 5120, 128 heads, MLA
    with a 512-wide latent and 64-wide rope key, 160 routed experts of
    5120x1536 top-6 and 2 shared, vocab 102,400), cut in depth to 2 of its
    60 layers, the dense layer and one MoE layer (10,718,996,480 B): every
    blob but the three expert leaves' against the host's encode; every leaf
    of both layers decoded against its param, the 2,516,582,400-byte expert
    leaves included (K3, K7 in 10 launches, K1's index pass and sync
    decode and K2, with offsets past 2^31 bytes); the ring at ``tiles`` 1
    and 4; the ring with the MLA KV tier over a 320-token prompt and 16
    greedy tokens (latent blocks of (4, 64, 512) and (4, 64, 64)); K1's sync
    decode at the expert leaf against its plain version over all 9,600
    chunks, and K2/K3/K7 there (against their plain versions over the first
    1,024 chunks) and at the router; prefill (MLA's 192/128 head) held at
    B=2, S=64 as olmoe's, with the mean gap under 5e-2 too, and timed at
    B=2 x 1,024;
16. mamba2_130m whole at its published size (24 layers, d_model 768,
    d_inner 1536, 24 SSM heads of 64, state 128, vocab 50,280, untied
    head; 335,200,512 B): the store built on the card against the host's
    encode of layer 0 (its f32 ``A_log`` / ``D`` / ``dt_bias`` blobs
    included), every leaf of layers 0 and 23 decoded against its param, the
    ring at ``tiles`` 1 and 4 against the plain step (logits and the final
    ``ssm_state`` / ``ssm_conv`` bit-identical) with traces
    ``build/mamba2_ring_trace_t{1,4}.json``, K1/K2/K3/K7 at the 768x3352
    ``in_proj`` leaf (20 exponent chunks) and K2's fp32 path at ``A_log``;
    prefill held at B=1, S=200 (two SSD chunks, padded) and timed at B=4 x
    2,048;
17. zamba2_7b whole at its published size (81 Mamba2 layers as 13 groups of
    6 and a 3-layer tail, the shared attention block; 13,502,316,096 B),
    served from a ZipNN checkpoint restored on the card: the plain
    ``greedy_generate`` gives reference tokens; one ``CheckpointManager``
    base of the params saved on the card (K3 a leaf, K7 as its chunk cap
    splits each leaf: 31 launches for the 8,149,499,904-byte ``in_proj``
    stack of 31,088 exponent chunks), its ``mamba_tail`` blobs against the
    host's save of that subtree (cut to it to bound the host's encode
    time); ``python -m repro_torch.launch.serve --arch zamba2_7b --ckpt-dir
    DIR`` (through ``main``) restores on the card (K1's one-shot decode,
    K2): every restored leaf equals the saved one bit for bit and the
    tokens equal the plain step's; K1/K2/K3/K7 at the 8.15 GB leaf; about
    9 GB under ``build/chip_zamba2_ckpt``, removed at the end.  Before the
    checkpoint, prefill of the phase's prompt held against the plain
    ``greedy_generate`` logits, timed at B=1 x 8,192 (past the shared
    block's 4,096 window), and its first 4,096 positions held against the
    prefill of those alone (the control's prefix must fail).  Every prefill
    hold runs on the params with the reference's norms, as phase 12's;
18. qwen2_vl_2b whole at its published size (28 layers, d_model 1536, 12
    heads of 128, 2 KV heads, d_ff 8960, vocab 151,936, QKV bias, M-RoPE
    sections (16, 24, 24), θ 1e6, untied head; 3,557,788,672 B of bf16):
    the store built on the card against the host's encode of layer 0
    (``frontend_proj`` stays static), every leaf of layers 0 and 27
    decoded, the ring at ``tiles`` 1 and 4 against the plain step with
    traces; the prefill of ``data.make_batch``'s 512 patches and 1,536
    text tokens a sequence (B=4) timed and profiled; ``make_prefill`` of 2
    of the 28 layers (full width, the reference's norms) on the card
    against the CPU at B=1, S=256 (64 patches, an 8x8 grid) within
    ``CARD_REL_TOL_FULL``, with plain RoPE (``mrope=False``) as the control
    that must go over it; K1/K2/K3/K7 at layer 0's ``w_gate`` (1536x8960,
    105 exponent chunks);
19. hubert_xlarge whole at its published size (48 layers, d_model 1280, 16
    heads of 80, d_ff 5120, layernorm, GELU, QKV bias, 32,768 learned
    positions, a 512-wide audio front end, vocab 504; 3,953,387,520 B of
    f32): one ``CheckpointManager`` base saved on the card
    (``CodecOptions(threads=-1, backend="device")``: K3's fp32 variant and
    K7, launches against the plan from the blobs), layers 0-1 of the
    stacks saved on the card and on the host with equal bytes,
    ``restore(device_resident=True)`` (K1's one-shot decode, K2's 4-byte
    path) bit for bit; the prefill of ``make_batch``'s frames (B=4, S=2,048)
    from the restored params timed and profiled; 2 of the 48 layers on
    the card against the CPU at B=1, S=512, with a causal copy of the
    config as the control; K1/K2/K3/K7 at the 1.26 GB ``w_in`` stack
    (timed by events only, as every launch over a leaf of 300 MB or more);
    about 4 GB under ``build/chip_hubert_ckpt``, removed at the end;
20. train: repro_gpt_100m whole at its published size trained through
    ``repro_torch.launch.train.main`` on the card (B=8 x S=2,048, past
    ``q_block`` 512 and ``kv_block`` 1,024, so both loops of the flash
    backward run several blocks; 12 steps at lr 1e-3; ZipNN checkpoints
    saved on the card every 4 steps with ``--base-every 2``: a base, a
    delta with the moments chained against the previous save, a base; K3
    and K7 launches of each save against the plan from its blobs); the
    loss at step 1 within 0.5-2.5 x ln(vocab) and falling; the step-12
    checkpoint restored on the card (K1's one-shot decode, K2) equal to the
    trained state bit for bit; 4 more steps of the in-memory state (the
    uninterrupted run: tokens/s, peak card memory beside the state resident
    before the step, one step under ``torch.profiler`` split into matmuls,
    flash forward, flash backward, fused CE, optimizer and the rest); a
    second ``main`` on the same directory to step 16 resumes at 12 and its
    losses must equal the uninterrupted run's (within 1e-6, bit-identity
    recorded); ``GradSync`` of one step's gradients packed on the card and
    unpacked back onto it bit for bit (launches against the plan), layers
    0-1 against the host's blobs; one step of repro_gpt_100m cut to 2
    layers on the card against the CPU (B=1 x 256, every gradient leaf
    within ``CARD_GRAD_REL``; attention without its causal mask as the
    control that must go over it); one step of olmoe_1b_7b at its published
    widths cut to 2 of 16 layers (~1.05 B parameters; B=4 x 2,048, the
    fused CE at vocab 50,304, capacity factor 1.25: two runs' gradients
    bit-identical and finite, then the AdamW update).  Both ``main`` calls
    run in one process, since ``data.make_batch`` seeds with
    ``hash(cfg.name)``; ~1.6 GB a save under ``build/chip_train_ckpt``,
    removed at the end;
21. report: store sizes, build times, tokens/s, file and checkpoint times,
    each phase's seconds and peak card memory, a prefill summary line, a
    train summary line, the ``kernels`` JSON line, and last ``{"ok": true,
    "device": {...}}``.  Each prefill's profiler trace goes to
    ``build/<label>_prefill_trace.json``, the train step's to
    ``build/train_step_trace.json``.
"""

from __future__ import annotations

import json
import math
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
# The ops kernels, per byte moved: K4/K11 rotate and permute (about 2);
# K5/K10 XOR, and for K10 a byte compare, a population count and an add
# per word (at most 1); K6/K9 shift, mask, address add and a shared atomic (4, as
# the compiled kernel's SASS has them)
BYTEGROUP_OPS_PER_BYTE = 2
XOR_OPS_PER_BYTE = 1
HIST_OPS_PER_BYTE = 4
# The ops kernels' demangled names (K11 is K2's unplane_kernel)
OPS_KERNELS = r"::group_(bf16|fp32)\(|unplane_kernel|xor_kernel|hist_kernel|bitpack_kernel"
# The kernels the file and checkpoint paths run: K1's one-shot decode (the
# self-synchronising kernel), K2, K3 and K7; and the chain baseline K1 kept
# for the measurements, which no path may launch
FILE_CKPT_KERNELS = ("huffdecode_serial", "plane_consumer", "plane_producer",
                     "bitpack_encode_chunks", "huffdecode_chain")
ADAMW_BETAS = (0.9, 0.95)        # the reference's AdamWConfig b1, b2
K8_CHUNK = 1 << 13               # the reference's ops.huffman_encode_chunks default
L2_SCRUB_BYTES = 128 << 20       # read between timed launches: over twice the 50 MB L2
BF16_CHUNK = 1 << 17             # plane chunk of the default 256 KiB parameter chunks
LEAF = (3072, 768)               # the largest weight of a repro_gpt_100m layer
# CUDA vs CPU decode_step, largest logit gap over the largest logit.  Set
# between the sound port's reading (1.4e-7 on the card) and bf16 controls
# (logits rounded to bf16: ~4e-3; attention in bf16: ~1e-3 on the CPU,
# tests/test_torch_model.py); the card's own bf16-rounding control is
# checked to read above it.
LOGIT_REL_TOL = 1e-4
# Launches over leaves this large are timed by events only: the profiler
# has dropped some of their device events (K3/K7 at granite's 302 MB
# ``w_in``, K2/K3 at zamba2's stack) and read them below their bounds.
PROFILER_MAX_BYTES = 300_000_000


def log(msg: str) -> None:
    print(msg, flush=True)


def device_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean milliseconds per call of ``fn`` on the card, CUDA events around
    each call.  Before each call a read of ``L2_SCRUB_BYTES`` evicts the
    50 MB L2 cache, so its inputs come from device memory, as the bytes
    bound assumes; the calls are queued behind a ~10 ms sleep kernel so
    that the host's time to enqueue them (Python, ctypes) does not show.
    A ``fn`` that synchronises inside still waits, and its gaps are timed.
    ``warm``: one untimed call first."""
    import torch

    if warm:
        fn()
    scrub = torch.ones(L2_SCRUB_BYTES, dtype=torch.uint8, device="cuda")
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)               # cycles: ~10 ms at 1.98 GHz
    for start, stop in events:
        scrub.max()
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / reps


def kernel_device_ms(prof, kernel: str):
    """(summed device ms, launches) of the kernels whose demangled name
    matches the regex ``kernel`` in a finished ``torch.profiler`` session."""
    import re

    hits = [(getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0), e.count)
            for e in prof.key_averages() if re.search(kernel, e.key)]
    return sum(us for us, _ in hits) / 1e3, sum(c for us, c in hits if us)


def profiled_ms(fn, kernel: str, reps: int, nbytes: int = 0):
    """Mean device time in ms per call of the kernels whose demangled name
    matches the regex ``kernel``, as ``torch.profiler`` (CUPTI) reports
    them, with L2 evicted before each call; None when three profiling
    sessions in a row report no matching device time (a session now and
    then records none), and None unread for a launch over a leaf of
    ``nbytes`` >= ``PROFILER_MAX_BYTES`` (the profiler drops events
    there).  Launch latency and host gaps are not in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if nbytes >= PROFILER_MAX_BYTES:
        return None
    fn()
    scrub = torch.ones(L2_SCRUB_BYTES, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                scrub.max()
                fn()
            torch.cuda.synchronize()
        ms, _ = kernel_device_ms(prof, kernel)
        if ms:
            return ms / reps
    return None


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
    """K1's three launch forms vs their plain versions and the chain
    baseline on a real leaf (the index pass and the one-shot decode, both
    the self-synchronising kernel, and the sync decode); a corrupted
    payload must raise, at a one-shot decode and at a feed's build."""
    import torch

    from repro_torch.core import codec, container, device_entropy, zipnn
    from repro_torch.kernels import (
        huffdecode_chain, huffdecode_chunks, huffdecode_chunks_plain, huffdecode_index,
        huffdecode_index_plain, huffdecode_serial,
    )

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
    sync, sync_off = args.pop("sync"), args.pop("sync_off")
    outs = [torch.zeros(n_out, dtype=torch.uint8, device=dev) for _ in range(7)]
    cur = [
        huffdecode_chunks(**args, out=outs[0], sync=sync, sync_off=sync_off),
        huffdecode_chunks_plain(**args, out=outs[1], sync=sync, sync_off=sync_off),
        huffdecode_serial(**args, out=outs[2]),
        huffdecode_chunks_plain(**args, out=outs[3]),
    ]
    cur_i, sync_i = huffdecode_index(**args, out=outs[4], sync_off=sync_off)
    cur_ip, sync_ip = huffdecode_index_plain(**args, out=outs[5], sync_off=sync_off)
    cur_c, sync_c = huffdecode_chain(**args, out=outs[6], sync_off=sync_off)
    cur_n, sync_n = huffdecode_index(**args, out=None, sync_off=sync_off)   # no symbols
    torch.cuda.synchronize()
    if not all(torch.equal(outs[0], o) for o in outs[1:]) or not all(
            torch.equal(cur[0], c) for c in cur[1:] + [cur_i, cur_ip, cur_c, cur_n]):
        raise AssertionError("K1's launch forms, their plain versions and the chain disagree")
    if not all(torch.equal(x, sync) for x in (sync_i, sync_ip, sync_c, sync_n)):
        raise AssertionError("K1's index pass, its plain version and the chain disagree on "
                             "the index")
    err = max(max_abs_diff(outs[0], o) for o in outs[1:])
    back = zipnn.decompress_array(ct, cfg, device_resident=True, device=dev)
    if not torch.equal(back.cpu().view(torch.int16), leaf.view(torch.int16)):
        raise AssertionError("K1+K2 decode of the check leaf is not bit-exact")
    log(f"K1 vs plain: {int(args['counts'].numel())} chunks of {meta.chunk_bytes} symbols, "
        f"{sync.numel()} sync points; the sync decode, the one-shot decode and the index pass "
        f"(with and without symbols) equal their plain versions and the chain baseline "
        f"(symbols, cursors, index)")

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
    for what, build in (
        ("one-shot decode", device_entropy.decode_planes),
        ("feed build", device_entropy.PayloadFeed),
    ):
        try:
            build(entries, bad, meta.tables, params, device=dev)
        except ValueError as e:
            log(f"K1 corrupted payload raised at the {what}: {e}")
        else:
            raise AssertionError(f"a truncated HUFF payload passed the {what}")
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


def k2_path(fn, run, planes, base, itemsize, dev) -> str:
    """Launch ``run`` (one K2/K11 launch counted on ``fn``) once and name
    the path it took, from ``fn.launches_by_path``, with the plan's split
    and the shared memory a block asked for."""
    import torch

    from repro_torch.kernels.fused_unplane import _unplane_plan, smem_bytes

    before = dict(fn.launches_by_path)
    run()
    torch.cuda.synchronize()
    took = [k for k, v in fn.launches_by_path.items() if v != before[k]]
    if len(took) != 1:
        raise AssertionError(f"{fn.__name__}: one launch counted on paths {took}")
    ptrs = [t.data_ptr() for t in planes] + ([] if base is None else [base.data_ptr()])
    plan = _unplane_plan(planes[0].numel(), itemsize, base is not None,
                         all(p % 16 == 0 for p in ptrs),
                         torch.cuda.get_device_properties(dev).multi_processor_count)
    if plan.path != took[0]:
        raise AssertionError(f"{fn.__name__}: took the {took[0]} path, the plan names "
                             f"{plan.path}")
    smem = smem_bytes(itemsize, base is not None, plan.tile) if plan.tiles else 0
    return (f"{took[0]} ({plan.tiles} tiles of {plan.tile}, {plan.vec_elems} in groups of 16, "
            f"{plan.tail} alone; {smem} B of shared memory a block)")


def kernel_resources(name: str) -> list:
    """Registers and static shared memory of each kernel in the package's
    built library ``name`` (``cuobjdump --dump-resource-usage``, the
    toolkit's, beside ``nvcc``), one line a kernel; the library is built
    first when missing."""
    import re

    from repro_torch.kernels import _build

    lib = _build.build([name])[name]
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "--dump-resource-usage", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    lines, fn = [], None
    for line in text.splitlines():
        if line.strip().startswith("Function "):
            m = re.search(r"([a-z_]*kernel)(?:ILi(\d+)ELb(\d))?", line)
            fn = m.group(1) + (f"<{m.group(2)}, {'true' if m.group(3) == '1' else 'false'}>"
                               if m.group(2) else "") if m else line.strip()
        elif fn and "REG:" in line:
            lines.append(f"{fn}: {line.strip()}")
            fn = None
    return lines


def phase_k2(dev):
    """K2 kernel vs plain, all four variants: at a 768x3072 leaf's size, at
    a ragged n, at an n that crosses the largest tile, at an n past the
    most that a bf16 call leaves to the vector path, and with the planes
    as views at offset n of one buffer (n % 16 != 0: misaligned, as
    ``_ResidentStream.planes`` cuts them), each launch on the path its plan
    names; then the kernel's registers and shared memory, on a line of
    their own."""
    import torch

    from repro_torch.kernels import plane_consumer, plane_consumer_plain
    from repro_torch.kernels.fused_unplane import (
        MIN_TILE, TILE_IN_BYTES, VECTOR_TILES_PER_SM, smem_bytes,
    )

    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    err, paths = 0, {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for itemsize, dt in ((2, torch.int16), (4, torch.int32)):
        for with_base in (False, True):
            tile = TILE_IN_BYTES // (itemsize * (2 if with_base else 1))
            for label, n in (("leaf", 768 * 3072), ("ragged", 100_003),
                             ("crossing the tile", 3 * tile + 7),
                             ("past the vector path",
                              VECTOR_TILES_PER_SM[itemsize] * sms * MIN_TILE + 3 * tile + 7),
                             ("views at n", 100_003)):
                planes = [torch.randint(0, 256, (n,), dtype=torch.uint8, generator=g).to(dev)
                          for _ in range(itemsize)]
                if label == "views at n":
                    buf = torch.cat(planes)
                    planes = [buf[k * n:(k + 1) * n] for k in range(itemsize)]
                b = (torch.randint(torch.iinfo(dt).min, torch.iinfo(dt).max, (n,), dtype=dt,
                                   generator=g).to(dev) if with_base else None)
                out = []
                path = k2_path(plane_consumer,
                               lambda: out.append(plane_consumer(planes, b, itemsize=itemsize)),
                               planes, b, itemsize, dev)
                p = plane_consumer_plain(planes, b, itemsize=itemsize)
                torch.cuda.synchronize()
                key = f"{'bf16' if itemsize == 2 else 'fp32'}{'+base' if with_base else ''} {label}"
                if not torch.equal(out[0], p):
                    raise AssertionError(f"K2 {key} (n={n}, {path}) disagrees")
                want = {"views at n": "element", "past the vector path": "bulk"}
                if not path.startswith(want.get(label, "bulk" if itemsize == 4 else "vector")):
                    raise AssertionError(f"K2 {key}: took {path}")
                err = max(err, max_abs_diff(out[0], p))
                paths[key] = path
    log(f"K2 vs plain: 4 variants at the leaf, ragged, crossing the tile, past the vector "
        f"path and as misaligned views, equal; paths: {json.dumps(paths)}")
    log(f"K2 unplane_kernel resources (cuobjdump): {'; '.join(kernel_resources('unplane'))}; "
        f"dynamic shared memory a block at the largest tile: "
        + ", ".join(f"{'bf16' if w == 2 else 'fp32'}{'+base' if hb else ''} "
                    f"{smem_bytes(w, hb, TILE_IN_BYTES // (w * (2 if hb else 1)))} B"
                    for w in (2, 4) for hb in (False, True)))
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


def phase_k7_sync_free(dev):
    """K7 and K8 on the card read nothing back to the host: both wrappers
    run with ``torch.cuda.set_sync_debug_mode("error")``, which raises at a
    synchronising call.  The same K7 call carries a chunk whose plane id
    names no row and one whose row holds a length-16 code: the kernel flags
    both (``nbits = -1``), and the rest equal the plain version."""
    import torch

    from repro_torch.kernels import (
        bitpack_encode_chunks, bitpack_encode_chunks_plain, bitpack_encode_chunks_single,
        bitpack_encode_chunks_single_plain,
    )

    (syms, _, lens, codes), n_exp = k7_inputs(dev)
    bad_lens = torch.cat([lens, lens[:1].clone()])
    bad_lens[-1, int(torch.argmax(bad_lens[-1]))] = 16
    bad_codes = torch.cat([codes, codes[:1]])
    head = syms[: 2 * BF16_CHUNK]
    k7_syms = torch.cat([head, head])
    k7_pids = torch.tensor([0, 1, 99, bad_lens.shape[0] - 1], dtype=torch.int32, device=dev)
    exp = syms[: n_exp * BF16_CHUNK]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        # control: reading the table's extremes on the host, as a check of
        # its lengths there would, raises in this mode
        try:
            int(lens.max())
        except RuntimeError:
            pass
        else:
            raise AssertionError("the sync debug mode did not catch a device-to-host read")
        wk, nk = bitpack_encode_chunks(k7_syms, k7_pids, bad_lens, bad_codes,
                                       chunk_syms=BF16_CHUNK)
        w8, n8 = bitpack_encode_chunks_single(exp, lens[0], codes[0], chunk_syms=K8_CHUNK)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    wp, np_ = bitpack_encode_chunks_plain(head, k7_pids[:2].clone(), lens, codes,
                                          chunk_syms=BF16_CHUNK)
    w8p, n8p = bitpack_encode_chunks_single_plain(exp, lens[0], codes[0], chunk_syms=K8_CHUNK)
    torch.cuda.synchronize()
    if nk[2:].tolist() != [-1, -1] or wk[2:].any():
        raise AssertionError(
            f"K7 did not flag the bad plane id and the length-16 row: {nk.tolist()}")
    if not (torch.equal(nk[:2], np_) and torch.equal(wk[:2], wp)
            and torch.equal(n8, n8p) and torch.equal(w8, w8p)):
        raise AssertionError("K7/K8 under the sync debug mode disagree with their plain versions")
    log(f"K7 and K8 wrappers ran with torch.cuda.set_sync_debug_mode('error'): no host round "
        f"trip; K7 flagged a bad plane id and a length-16 row (nbits {nk.tolist()}), K8 "
        f"{n8.numel()} chunks equal")


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


def check_same_run(label, plain_logits, plain_tokens, logits, tokens, n_steps, vocab):
    """A served run against the plain step's on the same requests: every
    step's logits finite, of shape (BATCH, 1, vocab) and bit-identical,
    and the same greedy tokens."""
    import torch

    if len(logits) != n_steps or len(plain_logits) != n_steps:
        raise AssertionError(f"{label}: wrong number of decode steps")
    for t, (a, b) in enumerate(zip(plain_logits, logits)):
        if a.shape != (BATCH, 1, vocab) or not torch.isfinite(a).all():
            raise AssertionError(f"{label} step {t}: logits not finite or wrong shape")
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"{label} step {t}: logits differ from the plain step")
    if not torch.equal(tokens, plain_tokens):
        raise AssertionError(f"{label}: tokens differ from the plain step")


def phase_main(dev, cfg, zcfg):
    """Build ``cfg``'s store (repro_gpt_100m at full width) on the card,
    coded with ``zcfg``, against host-built blobs, and serve it through the
    compressed ring."""
    import torch

    from repro_torch import _util
    from repro_torch.core import device_entropy, zipnn
    from repro_torch.core.options import CodecOptions
    from repro_torch.kernels import launch_counts, plane_consumer, reset_launch_counts
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
        params, zcfg, options=CodecOptions(threads=-1, backend="host"), device=dev
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
    # K1's index pass (the self-synchronising kernel) once a feed
    build_plan = {"plane_producer": cfg.n_layers, "bitpack_encode_chunks": huff_leaves,
                  "huffdecode_index": huff_leaves}
    if build_launches["huffdecode_serial"] or build_launches["huffdecode_chain"]:
        raise AssertionError(f"the store build ran a K1 form other than the index pass: "
                             f"{build_launches}")
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
    parts = {"words": 0, "luts": 0, "index": 0, "sync": 0}
    for f in (f for layer in feeds for f in layer):
        a = f.launch_args() or {}
        for k in ("words", "luts"):
            parts[k] += a[k].numel() * a[k].element_size() if k in a else 0
        parts["index"] += sum(a[k].numel() * a[k].element_size()
                              for k in ("word_off", "plane_ids", "counts", "out_off") if k in a)
        parts["sync"] += sum(a[k].numel() * a[k].element_size()
                             for k in ("sync", "sync_off") if k in a)
    parts["splice"] = store.device_payload_bytes - sum(parts.values())
    log(f"device payload bytes by part: {parts}; the sync index is "
        f"{parts['sync'] / store.device_payload_bytes:.4%} of them")
    if parts["sync"] > 0.01 * store.device_payload_bytes:
        raise AssertionError("the sync index takes more than 1% of the feeds' bytes")
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
    k2_paths = dict(plane_consumer.launches_by_path)
    uploads = device_entropy.transfer_stats()

    plain_logits: list = []
    t0 = time.perf_counter()
    plain_tokens, _ = greedy_generate(cfg, params, prompt, STEPS, logits_out=plain_logits)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0

    n_steps = PROMPT + STEPS
    check_same_run("ring", plain_logits, plain_tokens, ring_logits, ring_tokens, n_steps,
                   cfg.vocab_size)
    per_step = {
        "huffdecode_chunks": sum(f.n_launches["huffdecode_chunks"] for l in feeds for f in l),
        "plane_consumer": sum(f.n_launches["plane_consumer"] for l in feeds for f in l),
    }
    for name, n in per_step.items():
        if launches[name] == 0 or launches[name] != n * n_steps:
            raise AssertionError(
                f"{name}: {launches[name]} launches, layer plan predicts {n * n_steps}"
            )
    if launches["huffdecode_serial"] or launches["huffdecode_index"] or launches["huffdecode_chain"]:
        raise AssertionError(f"the ring ran a K1 form other than the sync decode: {launches}")
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
    log(f"launches per step: {per_step} (main-path run: {launches}; K2 by path {k2_paths})")
    return store, params, launches, per_step, n_steps, build_launches, build_plan, k2_paths


def check_k1_leaves(store, dev):
    """The sync decode on every leaf of the main path against its plain
    version and the one-shot (self-synchronising) kernel: symbols and final
    cursors; and the feed's index against the index form run again."""
    import torch

    from repro_torch.kernels import (
        huffdecode_chunks, huffdecode_chunks_plain, huffdecode_index, huffdecode_serial,
    )

    n = symbols = 0
    for layer in store.feeds("layers"):
        for feed in layer:
            args = feed.launch_args()
            if args is None:
                continue
            n_out = args.pop("out_bytes")
            sync, sync_off = args.pop("sync"), args.pop("sync_off")
            outs = [torch.zeros(n_out, dtype=torch.uint8, device=dev) for _ in range(3)]
            cur = [huffdecode_chunks(**args, out=outs[0], sync=sync, sync_off=sync_off),
                   huffdecode_chunks_plain(**args, out=outs[1], sync=sync, sync_off=sync_off),
                   huffdecode_serial(**args, out=outs[2])]
            cur_i, sync_i = huffdecode_index(**args, out=None, sync_off=sync_off)
            torch.cuda.synchronize()
            if not all(torch.equal(outs[0], o) for o in outs[1:]) or not all(
                    torch.equal(cur[0], c) for c in cur[1:] + [cur_i]) or not torch.equal(
                    sync_i, sync):
                raise AssertionError(f"K1 sync decode disagrees on a leaf of shape {feed.shape}")
            n += 1
            symbols += int(args["counts"].sum())
    log(f"K1 sync decode on all {n} leaves of the main path ({symbols} symbols): symbols and "
        f"final cursors equal its plain version and the one-shot kernel; the index form "
        f"rebuilds each feed's index")
    return n


def profile_ring(dev, cfg, store, steps=6, tiles=1, name="ring_trace"):
    """One ``torch.profiler`` run over ``steps`` ring steps (B=BATCH,
    ``tiles`` decode jobs a layer), each ended by a synchronize: per step
    the device time of the decode (the side stream: K1, K2 and the splice
    copies) and of the compute (every other stream), and the card's idle
    share (wall time the device runs nothing).  The trace goes to
    build/<name>.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import init_decode_state
    from repro_torch.serve import make_compressed_serve_step

    rng = np.random.default_rng(SEED + 14)
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (steps + 1, BATCH, 1)).astype(np.int32)).to(dev)
    cstep = make_compressed_serve_step(cfg, store, ring=RING, tiles=tiles)
    state = init_decode_state(cfg, BATCH, steps + 1, start_pos=0, device=dev)
    _, state = cstep(state, toks[0])                        # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(steps):
            with record_function(f"ring_step_{t}"):
                _, state = cstep(state, toks[t + 1])
                torch.cuda.synchronize()
    path = os.path.join(ROOT, "build", f"{name}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("name", "").startswith("ring_step_")
             and e.get("cat") == "user_annotation"}
    dev_ev = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    side = {e["args"].get("stream") for e in dev_ev if "huffdecode_sync_kernel" in e["name"]}
    if len(spans) != steps or not dev_ev or len(side) != 1:
        raise AssertionError(f"ring trace: {len(spans)} step spans, {len(dev_ev)} device "
                             f"events, decode streams {side}")
    rows = []
    for t in range(steps):
        lo, hi = spans[f"ring_step_{t}"]
        inside = [e for e in dev_ev if lo <= e["ts"] and e["ts"] + e["dur"] <= hi]
        busy, end = 0.0, lo
        for e in sorted(inside, key=lambda e: e["ts"]):          # union of intervals
            a, b = max(e["ts"], end), e["ts"] + e["dur"]
            if b > a:
                busy += b - a
                end = b
        decode = sum(e["dur"] for e in inside if e["args"].get("stream") in side)
        k1 = sum(e["dur"] for e in inside if "huffdecode_sync_kernel" in e["name"])
        compute = sum(e["dur"] for e in inside if e["args"].get("stream") not in side)
        rows.append({"step_ms": (hi - lo) / 1e3, "decode_ms": decode / 1e3, "k1_ms": k1 / 1e3,
                     "compute_ms": compute / 1e3, "idle": 1 - busy / (hi - lo)})
    mean = {k: sum(r[k] for r in rows) / steps for k in rows[0]}
    log(f"{name} over {steps} steps (B={BATCH}, tiles={tiles}, profiler on, a synchronize ending each "
        f"step): mean step {mean['step_ms']:.4f} ms, decode (side stream) "
        f"{mean['decode_ms']:.4f} ms of which K1 {mean['k1_ms']:.4f} ms, compute "
        f"{mean['compute_ms']:.4f} ms, card idle {mean['idle']:.4%} of the step")
    log(f"{name} per step: " + json.dumps(rows))
    return mean


def huff_chunks(blob: bytes) -> int:
    """The blob's Huffman-coded chunks, over all its planes."""
    from repro_torch.core import codec, container

    meta, _ = container.unpack_stream(blob)
    return sum(e.method == codec.Method.HUFF for pe in meta.entries for e in pe)


def has_huff(blob: bytes) -> bool:
    return huff_chunks(blob) > 0


def k7_launches(blob: bytes) -> int:
    """K7 launches that encoding ``blob``'s leaf on the card takes:
    ``core.device_entropy.encode_planes`` packs at most
    ``MAX_BATCH_BYTES // (2 * chunk bytes)`` Huffman chunks a launch (the
    blob's own plane chunk: 131,072 bytes for bf16, 65,536 for f32)."""
    from repro_torch.core import container
    from repro_torch.core.device_plane import MAX_BATCH_BYTES

    meta, _ = container.unpack_stream(blob)
    per_launch = max(1, MAX_BATCH_BYTES // (2 * meta.chunk_bytes))
    return -(-huff_chunks(blob) // per_launch)


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
        options=CodecOptions(threads=-1, backend="host"),
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
    if launches["huffdecode_chain"]:
        raise AssertionError("the delta path launched K1's chain baseline")
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
    return news


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
        _util.tree_map(lambda a: a.cpu(), tree), zcfg,
        options=CodecOptions(threads=-1, backend="host"),
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


def _path_launches():
    """The counts of the kernels the file and checkpoint paths run (K1's
    one-shot form, K2, K3, K7) and of the chain baseline (0 on every path)."""
    from repro_torch.kernels import launch_counts

    c = launch_counts()
    return {k: c[k] for k in FILE_CKPT_KERNELS}


def _same_file(a: str, b: str) -> bool:
    import filecmp

    return filecmp.cmp(a, b, shallow=False)


def phase_file(dev, zcfg, params):
    """The ZNS1 file engine at full width: the main path's stacks
    (226.5 MB of bf16) as one raw stream through ``compress_file`` on the
    card (K3 and K7 per 64 MiB frame, two frames in flight) and on the
    host, and again with no backend given (the ``"auto"`` default must put
    the frames on the card); the files must be equal, and
    ``decompress_file`` on the card (K1 one-shot and K2 per frame) must
    give the stream back.  Then the frozen
    ``tests/fixtures/bf16_stream.znns`` decodes on the card."""
    import io
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import _util
    from repro_torch.core import engine, zipnn
    from repro_torch.core.options import CodecOptions
    from repro_torch.kernels import reset_launch_counts

    work = os.path.join(ROOT, "build", "chip_file")
    os.makedirs(work, exist_ok=True)
    src, card, auto, host, back = (os.path.join(work, n) for n in (
        "stacks.raw", "card.znns", "auto.znns", "host.znns", "back.raw"))
    try:
        with open(src, "wb") as f:
            for leaf in _util.tree_leaves(params["layers"]):
                f.write(leaf.reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
        raw_mb = os.path.getsize(src) / 1e6
        card_opts = CodecOptions(threads=-1, backend="device")
        host_opts = CodecOptions(threads=-1, backend="host")
        # the host's Huffman decoder runs each worker's chunks in a Python
        # loop of one step a symbol, so a pool only adds contention: serial
        host_dec = CodecOptions(threads=0, backend="host")
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw_b, comp_b = engine.compress_file(src, card, "bfloat16", zcfg, options=card_opts,
                                             pipeline_depth=2, device=dev)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        n = engine.decompress_file(card, back, zcfg, options=card_opts, device=dev)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        launches = _path_launches()
        frames = sum(1 for _ in engine.frame_records(card))
        plan = {"huffdecode_serial": frames, "plane_consumer": frames,
                "plane_producer": frames, "bitpack_encode_chunks": frames,
                "huffdecode_chain": 0}
        if launches != plan:
            raise AssertionError(f"file path launches {launches}, plan {plan}")
        if n != raw_b or not _same_file(src, back):
            raise AssertionError("the file decoded on the card differs from the stream")
        # the device time, again, and the "auto" default: with no backend
        # given, every frame is host bytes and encodes on the card
        reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            engine.compress_file(src, auto, "bfloat16", zcfg,
                                 options=CodecOptions(threads=-1), device=dev)
            torch.cuda.synchronize()
        enc_device = device_breakdown(prof)
        by_default = _path_launches()
        if by_default["plane_producer"] != frames or by_default["bitpack_encode_chunks"] != frames:
            raise AssertionError(f"the default file encode did not run on the card: {by_default}")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            engine.decompress_file(card, back, zcfg, options=card_opts, device=dev)
            torch.cuda.synchronize()
        dec_device = device_breakdown(prof)
        reset_launch_counts()
        t0 = time.perf_counter()
        engine.compress_file(src, host, "bfloat16", zcfg, options=host_opts)
        t_henc = time.perf_counter() - t0
        os.remove(back)
        t0 = time.perf_counter()
        engine.decompress_file(host, back, zcfg, options=host_dec)
        t_hdec = time.perf_counter() - t0
        if any(_path_launches().values()):
            raise AssertionError("the host file path launched a kernel")
        if not (_same_file(card, host) and _same_file(auto, host) and _same_file(src, back)):
            raise AssertionError("the file written on the card differs from the host's")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"file: {raw_mb:.1f} MB of stacks, {frames} frames of {engine.DEFAULT_WINDOW >> 20} "
        f"MiB, ratio {100.0 * comp_b / raw_b:.3f}% ({comp_b} B); the files written on the card "
        f"(backend \"device\", and the \"auto\" default) equal the host's and it decodes to the stream on the card; encode card {t_enc:.3f} s "
        f"({raw_mb / t_enc:.1f} MB/s), host {t_henc:.3f} s ({raw_mb / t_henc:.1f} MB/s); decode "
        f"card {t_dec:.3f} s ({raw_mb / t_dec:.1f} MB/s), host {t_hdec:.3f} s "
        f"({raw_mb / t_hdec:.1f} MB/s); launches {launches}; device ms (a second run of each "
        f"under the profiler) encode {enc_device}, decode {dec_device}")

    with open(os.path.join(ROOT, "tests", "fixtures", "meta.json")) as f:
        fx = next(x for x in json.load(f)["fixtures"] if x["kind"] == "stream")
    with open(os.path.join(ROOT, "tests", "fixtures", fx["raw"]), "rb") as f:
        want = f.read()
    reset_launch_counts()
    out = io.BytesIO()
    engine.decompress_file(os.path.join(ROOT, "tests", "fixtures", fx["blob"]), out,
                           zipnn.ZipNNConfig(**fx["config"]),
                           options=CodecOptions(backend="device"), device=dev)
    k2 = _path_launches()["plane_consumer"]
    if out.getvalue() != want or not k2:
        raise AssertionError(f"the frozen ZNS1 fixture does not decode on the card (K2 {k2})")
    log(f"file: tests/fixtures/{fx['blob']} decodes bit-exactly on the card "
        f"({k2} K2 launches; its zlib chunks decode on the host)")
    return {"launches": launches, "frames": frames, "raw_mb": raw_mb,
            "encode_s": {"card": t_enc, "host": t_henc},
            "decode_s": {"card": t_dec, "host": t_hdec},
            "encode_device_ms": enc_device, "decode_device_ms": dec_device}


class timed_calls:
    """Within the block, add the seconds spent in each of ``names`` of
    ``module`` (called through the module, as the checkpoint manager calls
    the codec) to ``self.seconds``."""

    def __init__(self, module, names):
        self.module, self.names, self.seconds = module, names, {n: 0.0 for n in names}

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.names}

        def wrap(name, fn):
            def timed(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    self.seconds[name] += time.perf_counter() - t0
            return timed

        for n, fn in self.saved.items():
            setattr(self.module, n, wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)


def device_breakdown(prof):
    """Device ms by kernel of one ``torch.profiler`` session (CUDA only)."""
    parts = {"K1": r"huffdecode_\w*kernel", "K2": r"unplane_kernel", "K3": r"(?<!un)plane_kernel",
             "K7": r"bitpack_kernel", "copies": r"Memcpy|Memset", "all": r"."}
    return {k: round(kernel_device_ms(prof, rx)[0], 4) for k, rx in parts.items()}


def chunk_methods(directory, step):
    """Chunks of each method (huff, zlib, store, zero) in one step's blobs."""
    from repro_torch.core import codec, container

    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        entries = json.load(f)["entries"]
    counts: dict = {}
    with open(os.path.join(d, "data.bin"), "rb") as f:
        for e in entries:
            f.seek(e["offset"])
            meta, _ = container.unpack_stream(f.read(e["size"]))
            for pe in meta.entries:
                for c in pe:
                    name = codec.Method.NAMES[c.method]
                    counts[name] = counts.get(name, 0) + 1
    return counts


def adamw_state(dev, params, seed):
    """A train state ``{"params": copy of params, "opt": {"m", "v"},
    "step"}`` (the layout of ``train.init_train_state``): fp32 moments
    after a few EMA steps (the reference's AdamWConfig: b1 0.9, b2 0.95)
    over seeded gradients of scale 1e-3, and the int32 step count."""
    import torch

    from repro_torch import _util

    gen = torch.Generator(device=dev).manual_seed(seed)
    state = {
        "params": _util.tree_map(lambda t: t.clone(), params),
        "opt": {"m": _util.tree_map(lambda t: torch.zeros(t.shape, device=dev), params),
                "v": _util.tree_map(lambda t: torch.zeros(t.shape, device=dev), params)},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
    for _ in range(3):
        train_step(state, gen)
    return state, gen


def train_step(state, gen):
    """One simulated step, in place: params as ``phase_delta`` moves them
    (``bf16(p + 1e-4 * N(0, 1))``), moments one EMA step on a new
    gradient."""
    import torch

    from repro_torch import _util

    b1, b2 = ADAMW_BETAS
    for p, m, v in zip(*(_util.tree_leaves(t) for t in (
            state["params"], state["opt"]["m"], state["opt"]["v"]))):
        g = 1e-3 * torch.randn(p.shape, generator=gen, device=p.device)
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        p.copy_((p.float() + 1e-4 * torch.randn(p.shape, generator=gen, device=p.device))
                .to(p.dtype))
    state["step"].add_(1)


def _run_saves(directory, dev, zcfg, states, backend, update=None):
    """Three saves at base_every=3, async; ``update(i)`` runs right after
    save i returns (the training thread's next step).  Returns the manager
    and per save (seconds until save() returned, seconds until the save
    was on disk)."""
    import torch

    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.core.options import CodecOptions

    mgr = CheckpointManager(CheckpointConfig(
        directory, base_every=3, async_save=True,
        options=CodecOptions(threads=-1, backend=backend), zipnn=zcfg, device=dev))
    times = []
    for i, state in enumerate(states):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(i, state(i) if callable(state) else state)
        t_ret = time.perf_counter() - t0
        if update is not None:
            update(i)
        mgr.wait()
        times.append((t_ret, time.perf_counter() - t0))
    return mgr, times


def phase_checkpoint(dev, zcfg, params):
    """Checkpoints at full width: repro_gpt_100m's params on the card with
    AdamW moments m/v in fp32 for every parameter; three async saves on the
    card (base, delta, delta: K3 with the XOR fused in, K7), the state
    updated in place by a simulated step right after each save returns;
    then ``restore(device_resident=True)`` (K1 one-shot, K2 with and
    without a base) must equal the last state bit for bit.  The same saves
    of layers 0-1 of the stacks and their moments (cut to bound the host's
    time) on the card and on the host must write equal bytes."""
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import _util
    from repro_torch.configs import get_config
    from repro_torch.core import zipnn
    from repro_torch.kernels import reset_launch_counts

    state, gen = adamw_state(dev, params, SEED + 20)
    raw = sum(t.numel() * t.element_size() for _, t in _util.tree_flatten_with_keys(state))
    work = os.path.join(ROOT, "build", "chip_ckpt")
    shutil.rmtree(work, ignore_errors=True)
    small = []

    def cut(tree):           # layers 0-1 of the stacks and their moments
        return {"params": {"layers": _util.tree_map(lambda t: t[:2].clone(),
                                                    tree["params"]["layers"])},
                "opt": {k: {"layers": _util.tree_map(lambda t: t[:2].clone(),
                                                     tree["opt"][k]["layers"])}
                        for k in ("m", "v")}}

    def update(i):
        if i < 2:
            train_step(state, gen)

    def at(i):
        small.append(cut(state))
        return state

    try:
        reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof, timed_calls(
                zipnn, ("compress_array", "delta_compress_batched")) as enc:
            mgr, times = _run_saves(os.path.join(work, "card"), dev, zcfg, [at] * 3, "device",
                                    update)
            torch.cuda.synchronize()
        save_launches = _path_launches()
        save_device = device_breakdown(prof)
        methods = [chunk_methods(os.path.join(work, "card"), i) for i in range(3)]
        held = mgr.held_bytes()
        stats = mgr.stats()
        reset_launch_counts()
        torch.cuda.synchronize()
        with timed_calls(zipnn, ("delta_decompress", "decompress_pytree")) as dec:
            t0 = time.perf_counter()
            step, tree = mgr.restore(device_resident=True)
            torch.cuda.synchronize()
            t_restore = time.perf_counter() - t0
        restore_launches = _path_launches()
        # this slice's main path: prefill from the params just restored
        # on the card (K1's one-shot decode and K2 made them)
        prefill, prefill_peak = run_prefill(dev, get_config("repro_gpt_100m"), tree["params"],
                                            "repro_gpt_100m", SEED + 23)
        prefill_launches = _path_launches()
        if prefill_launches != restore_launches:
            raise AssertionError(f"the prefill launched codec kernels: {restore_launches} -> "
                                 f"{prefill_launches}")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mgr.restore(device_resident=True)
            torch.cuda.synchronize()
            t_restore_prof = time.perf_counter() - t0
        restore_device = device_breakdown(prof)
        restore_copies = memcpy_bytes(prof, "restore_trace")
        got, want = _util.tree_flatten_with_keys(tree), _util.tree_flatten_with_keys(state)
        if step != 2 or [k for k, _ in got] != [k for k, _ in want]:
            raise AssertionError(f"restore gave step {step} with keys {[k for k, _ in got][:5]}")
        for (k, a), (_, b) in zip(got, want):
            if not (a.device == dev and a.dtype == b.dtype and a.shape == b.shape and torch.equal(
                    a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))):
                raise AssertionError(f"restored {k} differs from the saved state")
        # this slice's path: the same step restored onto a (1, 1) card mesh
        shard = check_shard_restore(dev, mgr, tree, restore_launches, restore_copies,
                                    t_restore_prof)
        for name, n in ((k, save_launches[k]) for k in ("plane_producer", "bitpack_encode_chunks")):
            if not n:
                raise AssertionError(f"{name} never launched in the card saves")
        for name, n in ((k, restore_launches[k]) for k in ("huffdecode_serial", "plane_consumer")):
            if not n:
                raise AssertionError(f"{name} never launched in the card restore")
        if save_launches["huffdecode_chain"] or restore_launches["huffdecode_chain"]:
            raise AssertionError("the checkpoint path launched K1's chain baseline")
        del tree, got
        disk = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(work) for f in fs)
        shutil.rmtree(work)

        card_s, card_t = _run_saves(os.path.join(work, "small_card"), dev, zcfg, small, "device")
        host_s, host_t = _run_saves(os.path.join(work, "small_host"), dev, zcfg, small, "host")
        for i in range(3):
            for name in ("manifest.json", "data.bin"):
                a, b = (os.path.join(work, d, f"step_{i}", name) for d in ("small_card", "small_host"))
                if not _same_file(a, b):
                    raise AssertionError(f"step {i} {name}: the card's bytes differ from the host's")
        small_raw = sum(t.numel() * t.element_size()
                        for _, t in _util.tree_flatten_with_keys(small[0]))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"checkpoint: repro_gpt_100m params and fp32 m/v, {raw / 1e6:.1f} MB a save, 3 async "
        f"saves on the card (base_every 3): seconds to return / to disk per save "
        f"{[(round(a, 4), round(b, 4)) for a, b in times]}; ratio_pct per save "
        f"{[(s['kind'], round(s['ratio_pct'], 3)) for s in stats]}; {disk} B on disk; "
        f"restore(device_resident=True) of step 2 {t_restore:.3f} s, bit-exact on the card; "
        f"launches: saves {save_launches}, restore {restore_launches}; bytes the manager holds "
        f"for the next save {held}")
    log(f"checkpoint, where the time goes: the 3 saves (CUDA profiler on) {sum(b for _, b in times):.3f} s, "
        f"of it in the encode calls {({k: round(v, 3) for k, v in enc.seconds.items()})}, "
        f"device ms {save_device}; chunks by method per save {methods}; the restore "
        f"{t_restore:.3f} s, of it in the decode calls "
        f"{({k: round(v, 3) for k, v in dec.seconds.items()})}, device ms (a second restore "
        f"under the profiler) {restore_device}")
    log(f"checkpoint, layers 0-1 and their moments ({small_raw / 1e6:.1f} MB a save; cut to "
        f"bound the host's time): card and host write equal bytes at all 3 steps; seconds to "
        f"disk per save card {[round(b, 4) for _, b in card_t]}, host "
        f"{[round(b, 4) for _, b in host_t]}")
    return {"save_launches": save_launches, "restore_launches": restore_launches,
            "shard_restore": shard,
            "save_s": times, "restore_s": t_restore, "held_bytes": held,
            "save_device_ms": save_device, "restore_device_ms": restore_device,
            "prefill": prefill, "prefill_launches": prefill_launches,
            "peak_card_bytes": max(prefill_peak, torch.cuda.max_memory_allocated(dev))}


def memcpy_bytes(prof, name):
    """Bytes each way of the copies in a finished ``torch.profiler``
    session, from its trace (``build/<name>.json``; the trace's copy
    events carry their bytes): ``{"DtoH": .., "HtoD": .., "DtoD": ..}``."""
    path = os.path.join(ROOT, "build", f"{name}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {"DtoH": 0, "HtoD": 0, "DtoD": 0}
    for e in events:
        if e.get("cat") == "gpu_memcpy":
            kind = next((k for k in out if k in e.get("name", "")), None)
            if kind is not None:
                out[kind] += int(e.get("args", {}).get("bytes", 0))
    return out


def check_shard_restore(dev, mgr, want_tree, restore_launches, restore_copies, t_restore_prof):
    """``shard_restore`` of the manager's newest step onto a (1, 1)
    ``DeviceMesh("cuda")`` under ``train_state_specs``: every leaf a DTensor
    with the specs' placements, its shard on the card, ``full_tensor()``
    equal bit for bit to ``restore(device_resident=True)``'s leaf; K1's
    one-shot decode and K2 launched as the restore's plan; no more bytes
    copied to the host than the restore's own reads (its cursors), from a
    profiler trace of each."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import _util
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.train import train_state_specs

    with mesh_mod.local_process_group("nccl"):
        mesh = mesh_mod.make_host_mesh(device_type="cuda")
        specs = train_state_specs(get_config("repro_gpt_100m"), mesh)
        reset_launch_counts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step, tree = mgr.shard_restore(None, mesh, specs)
            torch.cuda.synchronize()
            t_shard = time.perf_counter() - t0
        launches = _path_launches()
        copies = memcpy_bytes(prof, "shard_restore_trace")
        got, want = _util.tree_flatten_with_keys(tree), dict(_util.tree_flatten_with_keys(want_tree))
        if sorted(k for k, _ in got) != sorted(want):
            raise AssertionError("shard_restore gave another tree than restore")
        sharded = 0
        for key, leaf in got:
            spec = specs
            for part in key.split("/"):
                spec = spec[part]
            w = want[key]
            if not (isinstance(leaf, DTensor) and leaf.to_local().device == dev
                    and list(leaf.placements) == sharding.placements(spec, mesh)):
                raise AssertionError(f"shard_restore: {key} is not laid out as its spec {spec}")
            full = leaf.full_tensor()
            if not (full.dtype == w.dtype and full.shape == w.shape and torch.equal(
                    full.reshape(-1).view(torch.uint8), w.reshape(-1).view(torch.uint8))):
                raise AssertionError(f"shard_restore: {key} differs from restore's")
            sharded += any(a is not None for a in spec)
        del tree, got
    if launches != restore_launches:
        raise AssertionError(f"shard_restore launches {launches}, the restore's {restore_launches}")
    if not copies["HtoD"] or copies["DtoH"] > restore_copies["DtoH"]:
        raise AssertionError(f"shard_restore copied {copies} (the restore alone: "
                             f"{restore_copies}): a leaf went to the host")
    raw = sum(t.numel() * t.element_size() for t in want.values())
    log(f"shard_restore of step {step} onto a (1, 1) DeviceMesh('cuda') under "
        f"train_state_specs: {len(want)} leaves as DTensors with their specs' placements "
        f"({sharded} with a mesh axis in the spec), each full_tensor() equal bit for bit to "
        f"restore(device_resident=True); {t_shard:.3f} s against the restore's "
        f"{t_restore_prof:.3f} s, both under the CUDA profiler; launches {launches} (the "
        f"restore's plan); copies {copies} against the restore's {restore_copies} "
        f"({raw} B of leaves: none went to the host)")
    return {"step": step, "seconds": t_shard, "restore_seconds": t_restore_prof,
            "launches": launches, "copies": copies, "restore_copies": restore_copies,
            "leaves": len(want), "sharded_specs": sharded}


def ops_inputs(dev):
    """The ops kernels' inputs at a 3072x768 leaf (2,359,296 elements): its
    bf16 bits, the same weights after one fine-tuning step at lr 1e-4 (some
    bytes change, most exponent bytes do not), the fp32 copies of both, and
    the leaf's exponent plane with the table the host codec builds for it."""
    import torch

    from repro_torch.core import bitlayout, codec

    x = _weights(LEAF, SEED + 12, torch.bfloat16)
    g = torch.Generator().manual_seed(SEED + 13)
    new = (x.float() + 1e-4 * torch.randn(LEAF, generator=g)).to(torch.bfloat16)
    exp, _ = bitlayout.to_planes(
        x.view(torch.uint8).numpy().reshape(-1), bitlayout.layout_for("bfloat16")
    )
    pc = codec.PlaneCodec(codec.CodecParams(chunk_bytes=K8_CHUNK, backend="huffman"))
    pc.build_table(exp)

    def card(t, dt):
        return t.reshape(-1).view(dt).to(dev)

    return {
        "x16": card(x, torch.int16), "new16": card(new, torch.int16),
        "x32": card(x.float(), torch.int32), "new32": card(new.float(), torch.int32),
        "exp": torch.from_numpy(exp).to(dev),
        "lens": torch.from_numpy(pc.table.astype(np.int32)).to(dev),
        "codes": torch.from_numpy(pc.codes.astype(np.int32)).to(dev),
    }


def phase_ops(dev):
    """K4-K6 and K8-K11 against their plain versions on the card, bit for
    bit; returns each kernel's measured max |kernel - plain|."""
    import torch

    from repro_torch import kernels as K

    t = ops_inputs(dev)
    errs: dict = {}

    def same(name, got, want):
        got = list(got) if isinstance(got, tuple) else [got]
        want = list(want) if isinstance(want, tuple) else [want]
        if len(got) != len(want) or not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: kernel and plain version disagree")
        errs[name] = max(errs.get(name, 0), *(max_abs_diff(a, b) for a, b in zip(got, want)))

    for x, grp, grp_plain, ungrp, ungrp_plain in (
        (t["x16"], K.bytegroup_bf16, K.bytegroup_bf16_plain, K.ungroup_bf16, K.ungroup_bf16_plain),
        (t["x32"], K.bytegroup_fp32, K.bytegroup_fp32_plain, K.ungroup_fp32, K.ungroup_fp32_plain),
    ):
        planes = grp(x)
        same("bytegroup", planes, grp_plain(x))
        back = ungrp(*planes)
        same("ungroup", back, ungrp_plain(*planes))
        if not torch.equal(back, x):
            raise AssertionError(f"K4 -> K11 round trip of {x.dtype} bits is not bit-exact")
    for a, b in ((t["new16"], t["x16"]), (t["new32"], t["x32"])):
        same("xor_elems", K.xor_elems(a, b), K.xor_elems_plain(a, b))
    a, b = t["new32"], t["x32"]
    (dk, ck), (dp, cp) = K.xor_delta_u32(a, b), K.xor_delta_u32_plain(a, b)
    same("xor_delta_u32", (dk, ck), (dp, cp))
    changed = int(ck)
    if not 0 < changed < 2 * a.numel():          # the fp32 copy's low two bytes are zero
        raise AssertionError(f"K10 check: {changed} changed bytes, want some and not all")
    exp = t["exp"]
    same("chunk_histogram", K.chunk_histogram(exp, BF16_CHUNK),
         K.chunk_histogram_plain(exp, BF16_CHUNK))
    same("byte_histogram", K.byte_histogram(exp), K.byte_histogram_plain(exp))
    args = (exp, t["lens"], t["codes"])
    wk, nk = K.bitpack_encode_chunks_single(*args, chunk_syms=K8_CHUNK)
    same("bitpack_encode_chunks_single", (wk, nk),
         K.bitpack_encode_chunks_single_plain(*args, chunk_syms=K8_CHUNK))
    log(f"ops kernels vs plain at n={exp.numel()}: K4/K11 bf16 and fp32 (round trip bit-exact), "
        f"K5 u16 and u32, K10 ({changed} changed bytes of {4 * a.numel()}), K6 at "
        f"{BF16_CHUNK}-byte chunks, K9, K8 ({nk.numel()} chunks of {K8_CHUNK} symbols, "
        f"{int(nk.sum())} bits): all equal; max_abs_err {errs}")
    return errs


def phase_ops_path(dev, cfg, params, news):
    """The ops path over every stacked leaf of the main path's params and the
    delta phase's fine-tuned copy, checked against numpy on the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import _util
    from repro_torch.core import bitlayout, codec, huffman
    from repro_torch.kernels import (
        chunk_histogram, launch_counts, ops, reset_launch_counts, xor_elems,
    )

    layout = bitlayout.layout_for("bfloat16")
    bases = _util.tree_leaves(params["layers"])
    if len(bases) != len(news):
        raise AssertionError("the fine-tuned copy has another tree than the params")
    n_leaves = changed_bytes = changed_elems = encoded = 0
    reset_launch_counts()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(cfg.n_layers):
            for stack, new_stack in zip(bases, news):
                x = stack[i].reshape(-1).view(torch.int16)
                nw = new_stack[i].reshape(-1).view(torch.int16)
                n = x.numel()
                exp, frac = ops.bytegroup_bf16(x)
                hist = ops.byte_histogram(exp)
                chunks = chunk_histogram(exp, BF16_CHUNK)
                back = ops.ungroup_bf16(exp, frac)
                x32 = stack[i].float().reshape(-1).view(torch.int32)
                planes = ops.bytegroup_fp32(x32)
                back32 = ops.ungroup_fp32(*planes)
                d16 = xor_elems(nw, x)
                d32 = xor_elems(new_stack[i].float().reshape(-1).view(torch.int32), x32)
                delta, changed = ops.xor_delta_u32(nw.view(torch.int32), x.view(torch.int32))
                halves = d32.view(torch.int16).view(-1, 2)       # fp32 bits: bf16 bits << 16
                if not (torch.equal(back, x) and torch.equal(back32, x32)
                        and torch.equal(planes[0], exp) and torch.equal(chunks.sum(0), hist)
                        and torch.equal(delta.view(torch.int16), d16)
                        and torch.equal(halves[:, 1], d16) and not halves[:, 0].any()):
                    raise AssertionError(f"layer {i}, leaf of shape {tuple(stack.shape[1:])}: "
                                         f"the ops disagree on the card")
                x_host, nw_host = x.cpu().numpy(), nw.cpu().numpy()
                exp_host, _ = bitlayout.to_planes(x_host.view(np.uint8), layout)
                keys = (np.arange(n) // BF16_CHUNK) * 256 + exp_host
                want_chunks = np.bincount(keys, minlength=chunks.shape[0] * 256).reshape(-1, 256)
                want_changed = int(np.count_nonzero(
                    nw_host.view(np.uint8) != x_host.view(np.uint8)))
                if not (np.array_equal(exp.cpu().numpy(), exp_host)
                        and np.array_equal(hist.cpu().numpy(),
                                           np.bincount(exp_host, minlength=256))
                        and np.array_equal(chunks.cpu().numpy(), want_chunks)
                        and int(changed) == want_changed):
                    raise AssertionError(f"layer {i}, leaf of shape {tuple(stack.shape[1:])}: "
                                         f"the ops disagree with numpy")
                if i == 0:
                    pc = codec.PlaneCodec(
                        codec.CodecParams(chunk_bytes=K8_CHUNK, backend="huffman"))
                    pc.build_table(exp_host)
                    got = ops.huffman_encode_chunks(exp, pc.table, pc.codes, chunk_syms=K8_CHUNK)
                    counts = [min(K8_CHUNK, n - o) for o in range(0, n, K8_CHUNK)]
                    want = huffman.encode_chunks(exp_host, np.asarray(counts), pc.table, pc.codes)
                    if got != want:
                        raise AssertionError(
                            f"leaf of shape {tuple(stack.shape[1:])}: "
                            f"ops.huffman_encode_chunks differs from the host encoder")
                    if any(len(g) >= c for g, c in zip(got, counts)):
                        raise AssertionError("a chunk of the K8 check did not shrink")
                    encoded += len(got)
                n_leaves += 1
                changed_bytes += want_changed
                changed_elems += int(np.count_nonzero(nw_host != x_host))
        torch.cuda.synchronize()
    t_pass = time.perf_counter() - t0
    ops_ms, ops_n = kernel_device_ms(prof, OPS_KERNELS)
    all_ms, all_n = kernel_device_ms(prof, ".")
    launches = {k: v for k, v in launch_counts().items() if v}
    per_leaf = ("bytegroup_bf16", "byte_histogram", "chunk_histogram", "ungroup_bf16",
                "bytegroup_fp32", "ungroup_fp32", "xor_delta_u32")
    plan = {k: n_leaves for k in per_leaf}
    plan["xor_elems"] = 2 * n_leaves
    plan["bitpack_encode_chunks_single"] = n_leaves // cfg.n_layers
    if launches != plan:
        raise AssertionError(f"ops path launches {launches}, plan {plan}")
    log(f"ops path: {n_leaves} stacked leaves; exponent histograms equal numpy's of the host "
        f"planes, bf16 and fp32 round trips bit-exact, chunk histograms equal; changed bytes "
        f"{changed_bytes} of {sum(2 * b.numel() for b in bases)} "
        f"(Fig. 8a), changed elements {changed_elems}; layer 0's {n_leaves // cfg.n_layers} "
        f"exponent planes coded by ops.huffman_encode_chunks equal the host encoder's "
        f"{encoded} chunks; {t_pass:.3f} s with host checks; launches {launches}")
    if ops_ms:
        log(f"ops path device time (one profiler session over the pass, its host time "
            f"{t_pass:.3f} s): the ops kernels {ops_ms:.4f} ms over {ops_n} launches; "
            f"everything on the card, copies for the host checks included, {all_ms:.4f} ms "
            f"over {all_n} operations, so the card is idle {1 - all_ms / 1e3 / t_pass:.4%} "
            f"of the pass")
    else:
        log("ops path device time: not measured (the profiler session recorded none)")
    return launches


def _same_stats(label, got, want):
    """Two results of one stats function (dicts, lists of dicts, floats,
    strings; histograms as numpy arrays) equal entry for entry."""
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{label}: keys {sorted(got)} against {sorted(want)}")
        for k in want:
            _same_stats(f"{label}[{k}]", got[k], want[k])
    elif isinstance(want, list):
        if len(got) != len(want):
            raise AssertionError(f"{label}: {len(got)} entries against {len(want)}")
        for i, (a, b) in enumerate(zip(got, want)):
            _same_stats(f"{label}[{i}]", a, b)
    elif isinstance(want, np.ndarray):
        if not (isinstance(got, np.ndarray) and np.array_equal(got, want)):
            raise AssertionError(f"{label}: the card's counts differ from the CPU's")
    elif got != want or type(got) is not type(want):
        raise AssertionError(f"{label}: the card's {got!r} against the CPU's {want!r}")


def phase_stats(dev, cfg, params, zcfg):
    """The statistics (``core.stats``) over the main path's 108 stacked
    leaves on the card (K4 planes, K9 counts), each result equal to the
    same function over the downloaded leaves on the CPU; then the
    baselines (``core.baselines``) over one 3072x768 leaf against ZipNN's
    ratio and speed on the same bytes (paper Table 3 in miniature)."""
    import torch

    from repro_torch import _util
    from repro_torch.core import baselines, bitlayout, stats, zipnn
    from repro_torch.core.options import CodecOptions
    from repro_torch.kernels import launch_counts, reset_launch_counts

    layout = bitlayout.layout_for("bfloat16")
    leaves = [stack[i] for i in range(cfg.n_layers) for stack in _util.tree_leaves(params["layers"])]
    n = len(leaves)
    big = max(range(n), key=lambda i: leaves[i].numel())
    largest = leaves[big]
    whole = torch.cat([t.reshape(-1) for t in leaves])          # Fig. 2 over the whole model

    def run(xs, model):
        return {"exponent_histogram": [stats.exponent_histogram(x) for x in xs],
                "plane_report": [stats.plane_report(x) for x in xs],
                "theoretical_ratio": stats.theoretical_ratio(xs[big]),
                "classify_model": stats.classify_model(xs),
                "byte_entropy": stats.byte_entropy(stats.kernel_planes(xs[big], layout)[0]),
                "fig2": stats.exponent_histogram(model)}

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    card = run(leaves, whole)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    counts = launch_counts()
    launches = {k: counts[k] for k in ("bytegroup_bf16", "byte_histogram")}
    # per leaf: exponent_histogram K4 + K9, plane_report K4 + 2 K9; then
    # theoretical_ratio K4 + 2 K9, classify_model K4 + K9 on each of the 8
    # largest leaves, byte_entropy of a plane K4 + K9, Fig. 2 K4 + K9
    plan = {"bytegroup_bf16": 2 * n + 1 + 8 + 1 + 1, "byte_histogram": 3 * n + 2 + 8 + 1 + 1}
    if launches != plan or any(v for k, v in counts.items() if k not in plan):
        raise AssertionError(f"stats launches {counts}, plan {plan}")
    host = [t.cpu() for t in leaves]
    t0 = time.perf_counter()
    cpu = run(host, whole.cpu())
    t_cpu = time.perf_counter() - t0
    _same_stats("stats", card, cpu)
    del whole
    fig2 = card["fig2"]
    per_leaf = card["exponent_histogram"]
    ct = zipnn.compress_array(largest, zcfg, options=CodecOptions(threads=-1, backend="device"),
                              device=dev)
    log(f"stats ({n} stacked leaves of repro_gpt_100m on the card, K4 planes and K9 counts, "
        f"{t_card:.3f} s; the same functions over the downloaded leaves on the CPU "
        f"{t_cpu:.3f} s, every histogram and float equal): Fig. 2 over the whole model "
        f"{fig2['distinct_values']} distinct exponents ({fig2['min_exp']}-{fig2['max_exp']}), "
        f"top-12 mass {fig2['top12_mass']!r}; per leaf {min(h['distinct_values'] for h in per_leaf)}"
        f"-{max(h['distinct_values'] for h in per_leaf)} distinct, top-12 mass "
        f"{min(h['top12_mass'] for h in per_leaf)!r}-{max(h['top12_mass'] for h in per_leaf)!r}; "
        f"classify_model {card['classify_model']!r}; theoretical_ratio of the largest leaf "
        f"{tuple(largest.shape)} {card['theoretical_ratio']!r}% beside its ZipNN ratio "
        f"{100.0 * len(ct.blob) / (largest.numel() * 2)!r}%; exponent plane entropy "
        f"{card['byte_entropy']!r} bits; launches {launches}, plan {plan}")

    # the baselines, on the host, over one 3072x768 leaf's bytes
    leaf = next(t for t in leaves if tuple(t.shape) == LEAF)
    raw = leaf.reshape(-1).view(torch.uint8).cpu().numpy().tobytes()
    rows = {}
    for name, fn in baselines.BASELINES.items():
        if fn(leaf) != fn(raw):
            raise AssertionError(f"baseline {name}: a card tensor's bytes differ from the host's")
        size, t_c = baselines.run_baseline(name, raw)
        out, t_d = baselines.decompress_time(name, raw)
        if out != raw:
            raise AssertionError(f"baseline {name} does not round-trip")
        rows[name] = (100.0 * size / len(raw), len(raw) / 1e6 / t_c, len(raw) / 1e6 / t_d)
    reset_launch_counts()
    t0 = time.perf_counter()
    ee_card = baselines.ee_zlib(leaf, "bfloat16")
    t_ee_card = time.perf_counter() - t0
    if launch_counts()["bytegroup_bf16"] != 1:
        raise AssertionError("ee_zlib of a card tensor did not split its planes with K4")
    t0 = time.perf_counter()
    ee_host = baselines.ee_zlib(raw, "bfloat16")
    t_ee_host = time.perf_counter() - t0
    if ee_card != ee_host:
        raise AssertionError("ee_zlib of the card tensor differs from the host bytes' blob")
    rows["ee_zlib (K4 on the card)"] = (100.0 * len(ee_card) / len(raw), len(raw) / 1e6 / t_ee_card,
                                        None)
    rows["ee_zlib (host)"] = (100.0 * len(ee_host) / len(raw), len(raw) / 1e6 / t_ee_host, None)
    opts = CodecOptions(threads=-1, backend="device")
    zipnn.compress_array(leaf, zcfg, options=opts, device=dev)            # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ct = zipnn.compress_array(leaf, zcfg, options=opts, device=dev)
    torch.cuda.synchronize()
    t_zc = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = zipnn.decompress_array(ct, zcfg, device_resident=True, device=dev)
    torch.cuda.synchronize()
    t_zd = time.perf_counter() - t0
    if not torch.equal(back.view(torch.int16), leaf.view(torch.int16)):
        raise AssertionError("ZipNN's round trip of the baselines' leaf is not bit-exact")
    rows["ZipNN (card)"] = (100.0 * len(ct.blob) / len(raw), len(raw) / 1e6 / t_zc,
                            len(raw) / 1e6 / t_zd)
    log(f"baselines over one {LEAF[0]}x{LEAF[1]} bf16 leaf ({len(raw)} B; the baselines run "
        f"on the host, ZipNN encodes and decodes on the card): ratio %, compress MB/s, "
        f"decompress MB/s: {json.dumps({k: [round(v, 3) if v is not None else None for v in r] for k, r in rows.items()})}; "
        f"every baseline's bytes from the card tensor equal the host bytes'")
    return {"launches": launches, "plan": plan, "seconds": t_card, "cpu_seconds": t_cpu,
            "fig2": {k: fig2[k] for k in ("distinct_values", "top12_mass", "min_exp", "max_exp")},
            "classify_model": card["classify_model"],
            "theoretical_ratio": card["theoretical_ratio"], "baselines": rows}


def k1_serial_forms(args, sync_off, n_out, dev, reps, seg_bits=None, chain=True, plain=True,
                    leaf_bytes=0):
    """K1's self-synchronising kernel at one feed's inputs (``args``: its
    ``launch_args()`` without ``out_bytes``, ``sync`` and ``sync_off``), in
    its two forms: the index pass (index and cursors, as a feed's build
    runs it) and the one-shot decode (symbols and cursors, as restores and
    file frames run it), at ``seg_bits`` (default ``SEG_BITS``).  With
    ``chain``, beside the chain baseline (one thread a chunk) in the same
    call, in turns (chain, index, one-shot, one-shot, index, chain), each
    bit for bit against it; with ``plain``, against the plain version and
    timed beside it.  Bounds count each input read once and each output
    written once (the index pass writes no symbol), and one decode of every
    symbol; the synchronisation rounds each chunk took are read from the
    kernel's counter.  ``leaf_bytes`` (the stored leaf's) at or over
    ``PROFILER_MAX_BYTES`` leaves the device times unread."""
    import torch

    from repro_torch.kernels import (
        huffdecode_chain, huffdecode_index, huffdecode_selfsync_plain, huffdecode_serial,
    )
    from repro_torch.kernels.huffdecode import SEG_BITS, SYNC_EVERY

    seg = SEG_BITS if seg_bits is None else seg_bits
    out_s, out_c = (torch.zeros(n_out, dtype=torch.uint8, device=dev) for _ in range(2))
    index = lambda: huffdecode_index(**args, out=None, sync_off=sync_off,  # noqa: E731
                                     seg_bits=seg)
    one = lambda: huffdecode_serial(**args, out=out_s, seg_bits=seg)  # noqa: E731
    chain_index = lambda: huffdecode_chain(**args, out=out_c, sync_off=sync_off)  # noqa: E731
    chain_one = lambda: huffdecode_chain(**args, out=out_c)  # noqa: E731
    t = {"chain_index": [], "index": [], "one_shot": [], "chain_one_shot": []}
    turns = (["chain_index"] if chain else []) + ["index", "one_shot", "one_shot", "index"] + (
        ["chain_index", "chain_one_shot"] if chain else [])
    fns = {"chain_index": chain_index, "index": index, "one_shot": one,
           "chain_one_shot": chain_one}
    for name in turns:
        t[name].append(device_ms(fns[name], 2 if name.startswith("chain") else reps))
    ms = {k: sum(v) / len(v) for k, v in t.items() if v}
    dev_ms = {"index": profiled_ms(index, r"huffdecode_selfsync_kernel", reps, leaf_bytes),
              "one_shot": profiled_ms(one, r"huffdecode_selfsync_kernel", reps, leaf_bytes)}
    if chain:
        dev_ms["chain_index"] = profiled_ms(chain_index, r"huffdecode_chain_kernel", 1,
                                            leaf_bytes)
        dev_ms["chain_one_shot"] = profiled_ms(chain_one, r"huffdecode_chain_kernel", 1,
                                               leaf_bytes)
    rounds = torch.full_like(args["counts"], -1)
    cur_s = huffdecode_serial(**args, out=out_s, seg_bits=seg, rounds=rounds)
    cur_i, sync_i = index()
    if chain:
        cur_c, sync_c = chain_index()
        torch.cuda.synchronize()
        if not (torch.equal(out_s, out_c) and torch.equal(cur_s, cur_c)
                and torch.equal(cur_i, cur_c) and torch.equal(sync_i, sync_c)):
            raise AssertionError(f"K1's self-synchronising decode at {seg}-bit segments "
                                 f"disagrees with the chain")
    plain_ms = None
    if plain:
        out_p = torch.zeros(n_out, dtype=torch.uint8, device=dev)
        got = []
        plain_ms = device_ms(lambda: got.append(huffdecode_selfsync_plain(
            **args, out=out_p, sync_off=sync_off, sync_every=SYNC_EVERY, seg_bits=seg)),
            1, warm=False)
        if not (torch.equal(out_p, out_s) and torch.equal(got[0][0], cur_s)
                and torch.equal(got[0][1], sync_i)):
            raise AssertionError(f"K1's self-synchronising decode at {seg}-bit segments "
                                 f"disagrees with its plain version")
        del out_p, got
    r = rounds.cpu().numpy()
    if r.min() < 0:
        raise AssertionError("K1's round counter was not written for every chunk")
    symbols = int(args["counts"].sum())
    common = sum(args[k].numel() * args[k].element_size()
                 for k in ("words", "word_off", "plane_ids", "counts", "luts"))
    cursors = 4 * args["counts"].numel()
    index_bytes = common + sync_off.numel() * 8 + sync_i.numel() * 4 + cursors
    one_bytes = common + args["out_off"].numel() * 8 + symbols + cursors
    ops = K1_OPS_PER_SYMBOL * symbols
    b_i, by_i = bound_ms(index_bytes, ops)
    b_o, by_o = bound_ms(one_bytes, ops)
    return {
        "seg_bits": seg, "chunks": int(args["counts"].numel()), "symbols": symbols,
        "rounds": {"max": int(r.max()), "mean": float(r.mean()),
                   "histogram": {int(k): int(v) for k, v in zip(*np.unique(r, return_counts=True))}},
        "index_pass": {"ms": ms["index"], "kernel_ms_profiler": dev_ms["index"],
                       "bound_ms": b_i, "bound_by": by_i, "bytes": index_bytes,
                       "plain_ms": plain_ms, "turns": t["index"],
                       "chain_ms": ms.get("chain_index"),
                       "chain_kernel_ms_profiler": dev_ms.get("chain_index")},
        "one_shot": {"ms": ms["one_shot"], "kernel_ms_profiler": dev_ms["one_shot"],
                     "bound_ms": b_o, "bound_by": by_o, "bytes": one_bytes,
                     "plain_ms": plain_ms, "turns": t["one_shot"],
                     "chain_ms": ms.get("chain_one_shot"),
                     "chain_kernel_ms_profiler": dev_ms.get("chain_one_shot")},
    }


def log_serial_forms(label, f):
    i, o = f["index_pass"], f["one_shot"]
    log(f"K1 self-synchronising decode at {label}: {f['chunks']} chunks, {f['symbols']} "
        f"symbols, {f['seg_bits']}-bit segments, rounds after the first pass max "
        f"{f['rounds']['max']} mean {f['rounds']['mean']:.3f}; index pass {i['ms']:.5f} ms "
        f"(device time alone {i['kernel_ms_profiler']}; chain {i['chain_ms']} ms, device "
        f"{i['chain_kernel_ms_profiler']}), bound {i['bound_ms']:.6f} ms ({i['bound_by']}); "
        f"one-shot {o['ms']:.5f} ms (device time alone {o['kernel_ms_profiler']}; chain "
        f"{o['chain_ms']} ms, device {o['chain_kernel_ms_profiler']}), bound "
        f"{o['bound_ms']:.6f} ms ({o['bound_by']}); plain {i['plain_ms']} ms")


def measure_k1(store, dev):
    """K1 at a main-path shape, the feed of layer 0's largest weight (a
    3072x768 MLP weight, 18 chunks): the sync decode the ring runs, timed
    in turns beside its plain version, then at 256, 512 and 1,024 symbols
    per sub-stream with the index bytes each costs; the self-synchronising
    kernel's index pass and one-shot decode beside the chain baseline in
    the same call (``k1_serial_forms``), then at 512, 544, 1,024 and
    2,048-bit segments, the fastest noted."""
    import torch

    from repro_torch.kernels import huffdecode_chunks, huffdecode_chunks_plain, huffdecode_index
    from repro_torch.kernels.huffdecode import SEG_BITS, SYNC_EVERY, sync_offsets

    layer0 = store.feeds("layers")[0]
    sizes = [int(np.prod(f.shape)) for f in layer0]
    feed = layer0[int(np.argmax(sizes))]
    args = feed.launch_args()
    n_out = args.pop("out_bytes")
    sync, sync_off = args.pop("sync"), args.pop("sync_off")
    out, out_p = (torch.zeros(n_out, dtype=torch.uint8, device=dev) for _ in range(2))
    run = lambda: huffdecode_chunks(**args, out=out, sync=sync, sync_off=sync_off)  # noqa: E731
    s_a = device_ms(run, 20)
    s_b = device_ms(run, 20)
    ms = (s_a + s_b) / 2
    kernel_ms = profiled_ms(run, r"huffdecode_sync_kernel", 10)
    plain = []
    plain_ms = device_ms(lambda: plain.append(huffdecode_chunks_plain(
        **args, out=out_p, sync=sync, sync_off=sync_off)), 3)
    cur_k = run()
    torch.cuda.synchronize()
    if not (torch.equal(out, out_p) and torch.equal(cur_k, plain[0])):
        raise AssertionError("K1's sync decode and its plain version disagree at the "
                             "main-path shape")
    symbols = int(args["counts"].sum())
    inputs = sum(t.numel() * t.element_size() for t in args.values())
    sync_bytes = sync.numel() * 4 + sync_off.numel() * 8
    # each input read once (the index too), symbols and cursors written once
    nbytes = inputs + sync_bytes + symbols + 4 * cur_k.numel()
    b, by = bound_ms(nbytes, K1_OPS_PER_SYMBOL * symbols)
    log(f"K1 at {tuple(feed.shape)}: {args['counts'].numel()} chunks, {symbols} symbols, "
        f"{args['words'].numel() * 4} payload bytes, {sync.numel()} sync points every "
        f"{SYNC_EVERY} symbols ({sync_bytes} B of index); sync decode {ms:.5f} ms ({s_a:.5f} "
        f"then {s_b:.5f}; device time alone, profiler: {kernel_ms}), plain {plain_ms:.2f} ms; "
        f"bound {b:.6f} ms ({by}, {nbytes} B)")

    forms = k1_serial_forms(args, sync_off, n_out, dev, reps=10)
    log_serial_forms(str(tuple(feed.shape)), forms)
    seg_sweep = {}
    for seg in (512, 544, 1024, 2048):
        f = forms if seg == SEG_BITS else k1_serial_forms(
            args, sync_off, n_out, dev, reps=10, seg_bits=seg, chain=False, plain=False)
        seg_sweep[seg] = {"index_ms": f["index_pass"]["ms"], "one_shot_ms": f["one_shot"]["ms"],
                          "index_kernel_ms_profiler": f["index_pass"]["kernel_ms_profiler"],
                          "one_shot_kernel_ms_profiler": f["one_shot"]["kernel_ms_profiler"],
                          "rounds": f["rounds"]}
    fastest = min(seg_sweep, key=lambda k: seg_sweep[k]["index_ms"] + seg_sweep[k]["one_shot_ms"])
    log(f"K1 self-synchronising decode by segment bits at {tuple(feed.shape)} (the paths run "
        f"{SEG_BITS}; fastest {fastest}): {seg_sweep}")

    sweep = {}
    counts_h = args["counts"].cpu().numpy()
    for every in (256, 512, 1024):
        off = torch.from_numpy(sync_offsets(counts_h, every)).to(dev)
        _, idx = huffdecode_index(**args, out=None, sync_off=off, sync_every=every)
        out_s = torch.zeros(n_out, dtype=torch.uint8, device=dev)
        go = lambda: huffdecode_chunks(  # noqa: E731
            **args, out=out_s, sync=idx, sync_off=off, sync_every=every)
        t_ms = device_ms(go, 20)
        t_kernel = profiled_ms(go, r"huffdecode_sync_kernel", 10)
        torch.cuda.synchronize()
        if not (torch.equal(out_s, out) and torch.equal(go(), cur_k)):
            raise AssertionError(f"K1 sync decode at {every} symbols a sub-stream disagrees")
        sweep[every] = {"ms": t_ms, "kernel_ms_profiler": t_kernel,
                        "index_bytes": idx.numel() * 4 + off.numel() * 8}
    log(f"K1 sync decode by symbols per sub-stream at {tuple(feed.shape)}: {sweep}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "kernel_ms_profiler": kernel_ms, "sweep": sweep, "serial_forms": forms,
            "seg_sweep": seg_sweep, "seg_fastest": fastest}


def measure_k2(dev):
    """K2 at a main-path shape: the bf16 no-base variant, 768x3072 elements."""
    import torch

    from repro_torch.kernels import plane_consumer, plane_consumer_plain

    n = 768 * 3072
    g = torch.Generator(device="cpu").manual_seed(SEED + 5)
    planes = [torch.randint(0, 256, (n,), dtype=torch.uint8, generator=g).to(dev) for _ in range(2)]
    run = lambda: plane_consumer(planes, itemsize=2)  # noqa: E731
    path = k2_path(plane_consumer, run, planes, None, 2, dev)
    ms = device_ms(run, 50)
    kernel_ms = profiled_ms(run, r"unplane_kernel", 20)
    plain_ms = device_ms(lambda: plane_consumer_plain(planes, itemsize=2), 10)
    b, by = bound_ms(2 * n + 2 * n, K2_OPS_PER_ELEMENT * n)
    log(f"K2 at n={n} bf16, {path}: kernel {ms:.5f} ms (device time alone, profiler: "
        f"{kernel_ms}), plain {plain_ms:.4f} ms, bound {b:.6f} ms ({by})")
    return ms, plain_ms, b, by, kernel_ms, path


def layer0_params(dev, seed=SEED):
    """Layer 0's weights alone (stacks one layer deep), made as
    :func:`random_params` makes the model's."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import param_shapes

    def one(d):
        return {k: one(v) for k, v in d.items()} if isinstance(d, dict) else (1, *d[1:])

    shapes = one(param_shapes(get_config("repro_gpt_100m"))["layers"])
    return {"layers": random_params(shapes, np.random.default_rng(seed), dev)}


def layer_batch(params):
    """Layer 0's bf16 leaves as ``core.device_plane.produce_planes_batched``
    hands them to K3 in the store build: each leaf's element bits padded
    with zeros to whole 131,072-element chunks, back to back."""
    import torch

    from repro_torch import _util

    parts = []
    for stack in _util.tree_leaves(params["layers"]):
        x = stack[0].reshape(-1).view(torch.int16)
        parts += [x, x.new_zeros(-x.numel() % BF16_CHUNK)]
    return torch.cat(parts)


def measure_k3(dev, params):
    """K3 in all four variants at a 3072x768 leaf's size, then the bf16
    variant without a base (the one the main path's store build runs) at a
    layer's batch, the shape it is launched at there."""
    import torch

    from repro_torch.kernels import plane_producer, plane_producer_plain

    cases = [(f"{'bf16' if itemsize == 2 else 'fp32'}{'+base' if with_base else ''}",
              *k3_inputs(dev, itemsize, with_base, SEED + 11), itemsize)
             for itemsize in (2, 4) for with_base in (False, True)]
    cases.append(("bf16 layer batch", layer_batch(params), None, BF16_CHUNK, 2))
    out = {}
    for key, x, base, chunk, itemsize in cases:
        def run(x=x, base=base, chunk=chunk, itemsize=itemsize):
            return plane_producer(x, base, itemsize=itemsize, chunk_elems=chunk)

        ms = device_ms(run, 50)
        kernel_ms = profiled_ms(run, r"(?<!un)plane_kernel", 20)
        plain_ms = device_ms(
            lambda: plane_producer_plain(x, base, itemsize=itemsize, chunk_elems=chunk), 5)
        pk, hk = run()
        pp, hp = plane_producer_plain(x, base, itemsize=itemsize, chunk_elems=chunk)
        if not (torch.equal(pk, pp) and torch.equal(hk, hp)):
            raise AssertionError(f"K3 {key} disagrees with its plain version")
        n = x.numel()
        nbytes = n * itemsize * (3 if base is not None else 2) + (n // chunk) * itemsize * 256 * 4
        b, by = bound_ms(nbytes, K3_OPS_PER_ELEMENT[itemsize] * n)
        out[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                    "kernel_ms_profiler": kernel_ms, "n": n, "bytes": nbytes}
        log(f"K3 {key} at n={n} (chunks of {chunk}): kernel {ms:.5f} ms (device time "
            f"alone, profiler: {kernel_ms}), plain {plain_ms:.4f} ms, bound {b:.6f} ms "
            f"({by}, {nbytes} B)")
    return out


def measure_k7(dev):
    """K7 at the main path's shape: the 18 exponent-plane chunks of a
    3072x768 bf16 leaf under its own table (its mantissa plane is stored
    raw, so this is the whole launch the build makes for such a leaf)."""
    import torch

    from repro_torch.kernels import bitpack_encode_chunks, bitpack_encode_chunks_plain
    from repro_torch.kernels.bitpack import segments

    (syms, pids, lens, codes), n_exp = k7_inputs(dev)
    syms = syms[: n_exp * BF16_CHUNK].contiguous()
    pids = pids[:n_exp].contiguous()
    lens, codes = lens[:1].contiguous(), codes[:1].contiguous()
    run = lambda: bitpack_encode_chunks(syms, pids, lens, codes, chunk_syms=BF16_CHUNK)  # noqa: E731
    ms = device_ms(run, 20)
    kernel_ms = profiled_ms(run, r"bitpack_kernel", 20)
    plain_ms = device_ms(
        lambda: bitpack_encode_chunks_plain(syms, pids, lens, codes, chunk_syms=BF16_CHUNK), 3)
    words, nbits = run()
    torch.cuda.synchronize()
    n = syms.numel()
    nbytes = n + words.numel() * 4 + 4 * nbits.numel() + 4 * pids.numel() + 2 * 4 * 256
    b, by = bound_ms(nbytes, K7_OPS_PER_SYMBOL * n)
    log(f"K7 at {n_exp} chunks of {BF16_CHUNK} exponent symbols ({int(nbits.sum())} bits, "
        f"{n_exp * segments(BF16_CHUNK)} blocks): kernel {ms:.5f} ms (device time alone, "
        f"profiler: {kernel_ms}), plain {plain_ms:.4f} ms, bound {b:.6f} ms ({by})")
    return ms, plain_ms, b, by, kernel_ms


def measure_ops(dev):
    """The ops kernels at the 3072x768 leaf: ``device_ms`` means per launch,
    the device time alone from the profiler, beside each one's bound, its
    plain version and, where one PyTorch call computes the same function,
    that call (``torch.bitwise_xor`` for K5, ``torch.bincount`` for K9).
    Keys: K4/K11 and K5 by variant."""
    import torch

    from repro_torch import kernels as K

    t = ops_inputs(dev)
    n = t["x16"].numel()
    exp, lens, codes = t["exp"], t["lens"], t["codes"]
    rows: dict = {}

    def row(key, kernel, plain, nbytes, ops, name, library=None, library_name=None, reps=50):
        # kernel, library, library, kernel: the two compared in turns
        k_a = device_ms(kernel, reps)
        lib = [device_ms(library, reps) for _ in range(2)] if library else []
        ms = (k_a + device_ms(kernel, reps)) / 2
        library_ms = sum(lib) / 2 if library else None
        plain_ms = device_ms(plain, 5)
        kernel_ms = profiled_ms(kernel, name, 20)
        library_kernel_ms = profiled_ms(library, library_name, 20) if library_name else None
        b, by = bound_ms(nbytes, ops)
        rows[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                     "library_ms": library_ms, "bytes": nbytes,
                     "kernel_ms_profiler": kernel_ms,
                     "library_kernel_ms_profiler": library_kernel_ms}
        lib_txt = (f", library {library_ms:.5f} ms ({lib[0]:.5f}, {lib[1]:.5f}; device time "
                   f"alone {library_kernel_ms})" if library else "")
        log(f"{key} at n={n}: kernel {ms:.5f} ms ({k_a:.5f} then the second; device time "
            f"alone, profiler: {kernel_ms}), plain {plain_ms:.4f} ms{lib_txt}, bound {b:.6f} ms "
            f"({by}, {nbytes} B)")

    for tag, w, x, grp, grp_plain, ungrp, ungrp_plain in (
        ("bf16", 2, t["x16"], K.bytegroup_bf16, K.bytegroup_bf16_plain,
         K.ungroup_bf16, K.ungroup_bf16_plain),
        ("fp32", 4, t["x32"], K.bytegroup_fp32, K.bytegroup_fp32_plain,
         K.ungroup_fp32, K.ungroup_fp32_plain),
    ):
        planes = grp(x)
        nbytes = 2 * w * n
        row(f"K4 {tag}", lambda: grp(x), lambda: grp_plain(x), nbytes,
            BYTEGROUP_OPS_PER_BYTE * nbytes, rf"::group_{tag}\(")
        row(f"K11 {tag}", lambda: ungrp(*planes), lambda: ungrp_plain(*planes), nbytes,
            BYTEGROUP_OPS_PER_BYTE * nbytes, r"unplane_kernel")
        rows[f"K11 {tag}"]["path"] = k2_path(ungrp, lambda: ungrp(*planes), list(planes), None,
                                             w, dev)
        log(f"K11 {tag} took the {rows[f'K11 {tag}']['path']} path")
    for tag, w, a, b in (("u16", 2, t["new16"], t["x16"]), ("u32", 4, t["new32"], t["x32"])):
        row(f"K5 {tag}", lambda: K.xor_elems(a, b), lambda: K.xor_elems_plain(a, b), 3 * w * n,
            XOR_OPS_PER_BYTE * 3 * w * n, r"xor_kernel<false>",
            library=lambda: torch.bitwise_xor(a, b), library_name=r"BitwiseXor")
    a, b = t["new32"], t["x32"]
    row("K10", lambda: K.xor_delta_u32(a, b), lambda: K.xor_delta_u32_plain(a, b),
        12 * n + 4, XOR_OPS_PER_BYTE * 12 * n, r"xor_kernel<true>")
    nb = exp.numel()
    row("K6", lambda: K.chunk_histogram(exp, BF16_CHUNK),
        lambda: K.chunk_histogram_plain(exp, BF16_CHUNK),
        nb + -(-nb // BF16_CHUNK) * 256 * 4, HIST_OPS_PER_BYTE * nb, r"hist_kernel")
    row("K9", lambda: K.byte_histogram(exp), lambda: K.byte_histogram_plain(exp),
        nb + 256 * 4, HIST_OPS_PER_BYTE * nb, r"hist_kernel",
        library=lambda: torch.bincount(exp, minlength=256), library_name=r"[Hh]istogram")
    c = nb // K8_CHUNK
    # symbols in, words out (raw-size capacity), bit counts, the row ids the
    # wrapper makes, one table
    row("K8", lambda: K.bitpack_encode_chunks_single(exp, lens, codes, chunk_syms=K8_CHUNK),
        lambda: K.bitpack_encode_chunks_single_plain(exp, lens, codes, chunk_syms=K8_CHUNK),
        nb + nb + 4 * c + 4 * c + 2 * 4 * 256, K7_OPS_PER_SYMBOL * nb, r"bitpack_kernel",
        reps=20)
    return rows


GRANITE_LAYERS = 4               # granite_20b cut in depth from 52; every width as published
TILES = (1, 4)                   # the ring's decode jobs a layer, in the served phases
W_IN = (6144, 24576)             # granite_20b's widest leaf: one MLP weight
KV_PROMPT, KV_GEN = 384, 32      # granite: 416 positions, blocks evict after 320 and 384
DS_KV_PROMPT, DS_KV_GEN = 320, 16  # deepseek: 336 positions, one block evicts after 320
KV_HOT, KV_BLOCK = 256, 64       # the reference KVCacheStore's defaults
DEEPSEEK_LAYERS = 2              # deepseek_v2_236b cut in depth from 60: its dense layer, one MoE layer
DS_PLAIN_PREFIX = 1 << 27        # elements of deepseek's expert leaf held against plain K3/K7/K2


# Prefill: the reference's decode-vs-forward limit (tests/test_models.py),
# a reading, and its MLA rule's mean gap under 5e-2, held (its equal argmax
# is printed: see ``hold_prefill``)
PREFILL_ATOL = PREFILL_RTOL = 8e-2
PREFILL_MLA_MEAN = 5e-2
# Every hold runs on params whose norms are the reference's
# (``reference_norms``; on ``init_params``' 0.02 gains no block shows in
# the logits) and holds the largest gap under PREFILL_REL_LIMIT of the
# largest logit, set per family between the sound prefills' largest reading
# and the control's smallest (``CONTROL_LEAF``), which must go over it;
# each hold prints both (PERF.md, section 6, keeps the readings).  The
# hybrid's is the widest: zamba2's 81 layers at gains 1 carry every
# rounding difference up to the logits, so that two prefills of one prefix
# whose products differ only in shape differ by several 1e-2.  MoE's is the
# next: a near-tie in a router picks another expert on one side, and that
# position then moves by several 1e-2 of the largest logit.  The
# reference's rule is a reading: its 8e-2 is absolute, set for logits of
# about 1, and at gains 1 and full width the largest logits reach 3-9, so
# rounding alone takes a small logit past it.
PREFILL_REL_LIMIT = {"dense": 5e-2, "ssm": 5e-2, "moe": 1e-1, "hybrid": 3e-1}
# the control: the first layer's (hybrid: group 0's first layer's) mixer
# output projection zeroed, so that one block's output is lost
CONTROL_LEAF = {"dense": (("layers", "attn", "wo", "w"), (0,)),
                "moe": (("moe_layers", "moe", "experts", "w_down"), (0,)),
                "ssm": (("layers", "mamba", "out_proj", "w"), (0,)),
                "hybrid": (("mamba_groups", "mamba", "out_proj", "w"), (0, 0))}
# (hold B, hold S, timed B, timed S) per phase: each timed S crosses q_block
# 512 and kv_block 1,024 (zamba2's also the shared block's 4,096 window)
PREFILL_SHAPES = {
    "repro_gpt_100m": (4, 128, 4, 2048),
    "granite": (1, 1088, 4, 2048),           # 1,088 > kv_block, not a multiple of 512
    "olmoe": (4, 64, 4, 2048),
    "deepseek": (2, 64, 2, 1024),
    "mamba2": (1, 200, 4, 2048),             # 200: two SSD chunks of 128, padded
    "zamba2": (BATCH, PROMPT, 1, 8192),
}
PREFILL_KINDS = ("matmuls", "attention", "ssd_scan", "moe_dispatch", "rest")
GEMM_KERNELS = r"gemm|nvjet|xmma|cutlass|splitKreduce"


class prefill_ranges:
    """Within the block each call of the flash loop, the SSD scan and the
    MoE dispatch and combine runs inside a ``record_function`` range named
    for its kind (the model code looks each of them up in its module at
    call time), so a trace can attribute the kernels each one launches."""

    def __enter__(self):
        from torch.profiler import record_function

        from repro_torch.models import attention, moe, ssm

        self.sites = [(attention, "flash_attention", "attention"), (ssm, "ssd_scan", "ssd_scan"),
                      (moe, "dispatch", "moe_dispatch"), (moe, "combine", "moe_dispatch")]
        self.saved = [getattr(m, n) for m, n, _ in self.sites]

        def wrap(fn, kind):
            def ranged(*a, **k):
                with record_function(kind):
                    return fn(*a, **k)
            return ranged

        for (m, n, kind), fn in zip(self.sites, self.saved):
            setattr(m, n, wrap(fn, kind))
        return self

    def __exit__(self, *exc):
        for (m, n, _), fn in zip(self.sites, self.saved):
            setattr(m, n, fn)


class count_drops:
    """Within the block, the token-expert pairs each MoE dispatch drops
    and the pairs it routes, summed on the card (read at the end), and
    each dispatch's experts ``idx`` (T, K) in call order.  Like
    ``prefill_ranges`` it rebinds ``moe.dispatch``, so ``routed`` raises
    where an MoE forward ran no dispatch through it."""

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.fn = moe, moe.dispatch
        self.dropped, self.pairs, self.idx = [], 0, []

        def counted(xt, idx, C, E):
            buf, sort, pos = self.fn(xt, idx, C, E)
            self.idx.append(idx)
            self.dropped.append((pos < 0).sum())
            self.pairs += pos.numel()
            return buf, sort, pos

        moe.dispatch = counted
        return self

    def __exit__(self, *exc):
        self.moe.dispatch = self.fn

    def total(self) -> int:
        return int(sum(self.dropped).item()) if self.dropped else 0

    def routed(self, label) -> list:
        """[dropped, routed] pairs; raises when no dispatch was seen."""
        if not self.pairs:
            raise AssertionError(f"{label}: the MoE forward ran no dispatch through moe.dispatch")
        return [self.total(), self.pairs]


def rerouted(pre, dec, B, S):
    """(B, S) bool: the positions whose token took another set of experts
    in some MoE layer in the prefill (``pre``: one dispatch a layer over
    all B * S tokens) than in the decode loop (``dec``: one a layer a step
    over B tokens; steps past the S-th ignored)."""
    import torch

    L = len(pre.idx)
    a = torch.stack(pre.idx).reshape(L, B, S, -1)
    b = torch.stack(dec.idx[: S * L]).reshape(S, L, B, -1).permute(1, 2, 0, 3)
    return (a.sort(-1).values != b.sort(-1).values).any(-1).any(0)


def prompt_tokens(dev, cfg, B, S, seed):
    import torch

    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)


def control_params(cfg, params):
    """``params`` with ``CONTROL_LEAF``'s slice zeroed (a copy of that leaf;
    every other leaf shared)."""
    path, at = CONTROL_LEAF[cfg.family]

    def walk(node, i):
        if i == len(path):
            t = node.clone()
            t[at] = 0
            return t
        return {**node, path[i]: walk(node[path[i]], i + 1)}

    return walk(params, 0)


def gap_row(got, want, keep=None):
    """``got`` (B, S, V) against ``want``: the largest gap, over the largest
    |want|, the mean gap, the entries over the reference's rule, and the
    largest gap over the largest |want| at the positions ``keep`` (B, S)
    marks."""
    gap = (got - want).abs()
    top = want.abs().max()
    row = {"max_gap": float(gap.max()), "max_gap_rel": float(gap.max() / top),
           "mean_gap": float(gap.mean()),
           "over_reference_rule": int((gap > PREFILL_ATOL + PREFILL_RTOL * want.abs()).sum())}
    if keep is not None and bool(keep.any()):
        row["max_gap_rel_kept"] = float(gap[keep].max() / top)
    return row


def held_ok(cfg, row) -> bool:
    """``gap_row``'s row within the family's hold."""
    return row["max_gap_rel"] < PREFILL_REL_LIMIT[cfg.family] and (
        not cfg.mla or row["mean_gap"] < PREFILL_MLA_MEAN)


def hold_rule(cfg) -> str:
    return (f"largest gap < {PREFILL_REL_LIMIT[cfg.family]} of the largest logit"
            + (f", mean gap < {PREFILL_MLA_MEAN}" if cfg.mla else ""))


def hold_prefill(cfg, params, tokens, label, held=True):
    """``make_prefill`` over ``tokens`` (B, S) against the port's plain
    ``greedy_generate`` (the decode step a token at a time) over the same
    prompt on the card, at every position, both on ``reference_norms`` of
    ``params``.  Held as ``PREFILL_REL_LIMIT`` says (``held_ok``); the
    control (one block's output zeroed, ``control_params``) through the
    same comparison must fail.  The reference's MLA rule asks for equal
    argmax too; here the positions where the argmax differs are printed
    with the decode's margin between the two choices, not failed: at full
    width with random weights the top two logits of a 102,400-token
    vocabulary can lie closer than the two paths' rounding gap.  Also:
    whether the first greedy token agrees (where it does not, the
    prefill's top-two margin there), and for MoE the pairs each side's
    dispatches dropped, the share of positions whose token took other
    experts on the two sides, and the largest gap at the other positions.
    ``held=False`` prints the reading only (MoE at the config's capacity
    factor: each side drops other pairs, so the two compute different
    functions)."""
    import torch

    from repro_torch.models.model import reference_norms
    from repro_torch.serve import greedy_generate, make_prefill

    params = reference_norms(params)
    B, S = tokens.shape
    with count_drops() as pre_drops:
        fwd = make_prefill(cfg)(params, {"tokens": tokens})
    with count_drops() as dec_drops:
        steps: list = []
        first, _ = greedy_generate(cfg, params, tokens, 1, logits_out=steps)
    dec, first = torch.cat(steps[:S], dim=1), first[:, 0]
    del steps
    if dec.shape != fwd.shape or not torch.isfinite(fwd).all():
        raise AssertionError(f"{label} prefill: logits {tuple(fwd.shape)} against the decode "
                             f"loop's {tuple(dec.shape)}, or not finite")
    keep = None
    if cfg.moe:
        keep = ~rerouted(pre_drops, dec_drops, B, S)
    row = dict({"B": B, "S": S, "top_logit": float(dec.abs().max())},
               **gap_row(fwd, dec, keep))
    gap = (fwd - dec).abs()
    a_fwd, a_dec = fwd.argmax(-1), dec.argmax(-1)
    differ = (a_fwd != a_dec).nonzero().tolist()
    row["argmax_equal_share"] = 1 - len(differ) / (B * S)
    # the decode's margin between its choice and the prefill's, and the gap there
    row["argmax_differs"] = [
        {"at": [b, s], "decode_margin": float(dec[b, s, a_dec[b, s]] - dec[b, s, a_fwd[b, s]]),
         "gap_there": float(gap[b, s].max())} for b, s in differ]
    del gap
    nxt = fwd[:, -1].argmax(-1)
    agree = nxt.to(first.dtype) == first
    row["first_token_agrees"] = int(agree.sum())
    if not bool(agree.all()):
        top2 = fwd[:, -1].topk(2, dim=-1).values
        row["top2_margin_where_differs"] = [float(m) for m in (top2[:, 0] - top2[:, 1])[~agree]]
    if cfg.moe:
        row["dropped_pairs"] = {"prefill": pre_drops.routed(label),
                                "decode": dec_drops.routed(label)}
        row["rerouted_share"] = float((~keep).float().mean())
    del fwd
    if not held:
        log(f"{label} prefill B={B} S={S} against the plain decode loop (a reading, not held): "
            + json.dumps(row))
        return row
    with count_drops() as ctl_drops:
        ctl = make_prefill(cfg)(control_params(cfg, params), {"tokens": tokens})
    row["control"] = gap_row(ctl, dec, ~rerouted(ctl_drops, dec_drops, B, S) if cfg.moe else None)
    del ctl
    log(f"{label} prefill B={B} S={S} against the plain decode loop ({hold_rule(cfg)}; the "
        f"control, {'.'.join(CONTROL_LEAF[cfg.family][0])} zeroed, must fail): "
        + json.dumps(row))
    if held_ok(cfg, row["control"]):
        raise AssertionError(f"{label}: the control passes the prefill's hold: {row}")
    if not held_ok(cfg, row):
        raise AssertionError(f"{label} prefill disagrees with the decode loop: {row}")
    return row


def trace_split(prof, name, kinds, call_name, label):
    """Device time of one profiled call by kind, from its trace (written to
    build/``name``): each kernel goes to the ``record_function`` range of
    ``kinds`` its launch was enqueued in, else to "matmuls" (a GEMM kernel)
    or "rest"; and the card's idle share of the ``call_name`` range's wall
    time."""
    import bisect
    import re

    path = os.path.join(ROOT, "build", name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e.get("name") in kinds)
    call = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e.get("name") == call_name]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    dev_ev = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if len(call) != 1 or not dev_ev:
        raise AssertionError(f"{label} trace: {len(call)} call spans, "
                             f"{len(dev_ev)} device events")
    starts = [a for a, _, _ in spans]
    split = {k: 0.0 for k in kinds}
    for e in dev_ev:
        kind = None
        t = launch.get(e.get("args", {}).get("correlation"))
        if t is not None:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and spans[i][0] <= t <= spans[i][1]:
                kind = spans[i][2]
        if kind is None:
            kind = "matmuls" if re.search(GEMM_KERNELS, e["name"]) else "rest"
        split[kind] += e["dur"] / 1e3
    busy, end = 0.0, 0.0
    for e in sorted(dev_ev, key=lambda e: e["ts"]):             # union of intervals
        a, b = max(e["ts"], end), e["ts"] + e["dur"]
        if b > a:
            busy += b - a
            end = b
    wall = call[0]["dur"]
    return {"device_ms": {k: round(v, 4) for k, v in split.items()},
            "device_ms_total": round(sum(split.values()), 4), "wall_ms": wall / 1e3,
            "idle": 1 - busy / wall, "kernels": len(dev_ev)}


def profile_prefill(dev, cfg, prefill, params, batch, label):
    """One ``torch.profiler`` run over one prefill (ended by a
    synchronize): device time by kind (matmuls outside the ranges below,
    the flash loop's ops, the SSD scan, the MoE dispatch and combine, the
    rest) and the card's idle share of the call's wall time.  A kernel
    belongs to the range its launch was enqueued in.  Raises where a range
    that ``cfg``'s family runs holds no device time (``prefill_ranges``
    rebinds the model's functions, so a call that no longer goes through
    them shows here).  The trace goes to build/<label>_prefill_trace.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with prefill_ranges(), profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as prof:
        with record_function("prefill_call"):
            prefill(params, batch)
            torch.cuda.synchronize()
    out = trace_split(prof, f"{label}_prefill_trace.json", PREFILL_KINDS, "prefill_call",
                      f"{label} prefill")
    split = out["device_ms"]
    log(f"{label} prefill under the profiler: " + json.dumps(out))
    need = ["matmuls"] + (["attention"] if cfg.family != "ssm" else []) \
        + (["ssd_scan"] if cfg.family in ("ssm", "hybrid") else []) \
        + (["moe_dispatch"] if cfg.moe else [])
    empty = [k for k in need if not split[k]]
    if empty:
        raise AssertionError(f"{label} prefill trace: no device time under {empty}")
    return out


def time_prefill(dev, cfg, params, B, S, seed, label, batch=None):
    """``make_prefill`` at B x S: the aux loss (and for MoE the dropped
    pairs) from a first, warm-up forward, then one synchronised prefill
    timed on the host clock (tokens/s = B * S over its seconds) with the
    card's peak memory during it, then one under the profiler
    (``profile_prefill``).  ``batch`` defaults to random tokens from
    ``seed`` (the vlm and audio phases pass ``data.make_batch``'s).
    Returns the readings and the card's peak before this (the peak count
    restarts here)."""
    import torch

    from repro_torch.models import forward
    from repro_torch.serve import make_prefill

    phase_peak = torch.cuda.max_memory_allocated(dev)
    if batch is None:
        batch = {"tokens": prompt_tokens(dev, cfg, B, S, seed)}
    with count_drops() as drops:
        logits, aux = forward(cfg, params, batch)
    if logits.shape != (B, S, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"{label} prefill B={B} S={S}: logits {tuple(logits.shape)} "
                             "not finite or of another shape")
    del logits
    prefill = make_prefill(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    del logits
    out = {"B": B, "S": S, "seconds": seconds, "tokens_per_s": B * S / seconds,
           "peak_card_bytes": peak, "resident_bytes": resident, "aux": float(aux)}
    if cfg.moe:
        out["dropped_pairs"], out["routed_pairs"] = drops.routed(label)
    log(f"{label} prefill B={B} S={S}: {seconds:.4f} s, {out['tokens_per_s']:.1f} tokens/s, "
        f"card peak {peak} B ({resident} B resident before it), aux {out['aux']}"
        + (f", {out['dropped_pairs']} of {out['routed_pairs']} token-expert pairs dropped"
           if cfg.moe else ""))
    out["profile"] = profile_prefill(dev, cfg, prefill, params, batch, label)
    return out, phase_peak


def run_prefill(dev, cfg, params, label, seed, hold_tokens=None):
    """The phase's prefill: held against the plain decode loop at
    PREFILL_SHAPES' hold size (MoE at a capacity factor where no pair
    drops on either side, as the reference holds it; at the config's
    factor, where each side drops its own pairs, a reading only), then
    timed at the timed size.  Returns (readings, the card's peak before)."""
    import dataclasses

    hb, hs, tb, ts = PREFILL_SHAPES[label]
    tokens = hold_tokens if hold_tokens is not None else prompt_tokens(dev, cfg, hb, hs, seed)
    out = {}
    if cfg.moe:
        # C = int(T * K / E * cf) + 1 >= T + 1 for every T: no expert overflows
        held = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
        out["hold"] = hold_prefill(held, params, tokens, label + " (no drops)")
        out["default_cf"] = hold_prefill(
            cfg, params, tokens, f"{label} (capacity factor {cfg.capacity_factor})", held=False)
    else:
        out["hold"] = hold_prefill(cfg, params, tokens, label)
    out["timed"], phase_peak = time_prefill(dev, cfg, params, tb, ts, seed + 1, label)
    return out, phase_peak


def causal_prefix(dev, cfg, params, label, seed):
    """The prefill at PREFILL_SHAPES' timed size, cut to its first half,
    against the prefill of that half alone (the attention is causal, so
    they compute the same function), on ``reference_norms`` of ``params``:
    held as ``hold_prefill`` holds, and the control's half (one block's
    output zeroed) against the same whole must fail."""
    from repro_torch.models.model import reference_norms
    from repro_torch.serve import make_prefill

    _, _, B, S = PREFILL_SHAPES[label]
    params = reference_norms(params)
    tokens = prompt_tokens(dev, cfg, B, S, seed)
    prefill = make_prefill(cfg)
    whole = prefill(params, {"tokens": tokens})[:, : S // 2]
    half = prefill(params, {"tokens": tokens[:, : S // 2]})
    row = dict({"S": S, "prefix": S // 2}, **gap_row(half, whole))
    del half
    row["control"] = gap_row(prefill(control_params(cfg, params),
                                     {"tokens": tokens[:, : S // 2]}), whole)
    log(f"{label} prefill of {S} tokens, first {S // 2} positions against the prefill of "
        f"those alone ({hold_rule(cfg)}; the control must fail): " + json.dumps(row))
    if held_ok(cfg, row["control"]):
        raise AssertionError(f"{label}: the control passes the causal hold {row}")
    if not held_ok(cfg, row):
        raise AssertionError(f"{label}: the prefill's prefix differs from its own prefill {row}")
    return row


def k3_windows(sizes, cap):
    """K3 launches for one batch of same-layout leaves of ``sizes`` bytes:
    ``core.device_plane.produce_planes_batched`` closes a window before a
    leaf that would take it past ``cap``."""
    n, acc = 1, 0
    for nb in sizes:
        if acc and acc + nb > cap:
            n, acc = n + 1, 0
        acc += nb
    return n


def kv_visible_blocks(n_pos, hot, block):
    """Cold blocks per (key, layer) that the step at each position reads,
    as ``KVCacheStore.append`` evicts them."""
    out, cold = [], 0
    for p in range(n_pos):
        out.append(cold // block)
        if p + 1 - cold >= hot + block:
            cold += block
    return out


def bits(t):
    """A tensor's bits as integers of its width, for exact comparison."""
    import torch

    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[
        t.element_size()])


def free_card():
    """Drop the card memory an earlier phase left cached, and start the
    peak count anew."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def build_plan(store):
    """The build's launches, planned from the store's blobs: K3 per layer
    and dtype as the batch cap splits it, K7 per Huffman leaf as its
    per-launch chunk cap splits it, K1's index pass (the
    self-synchronising kernel) per Huffman leaf; no other K1 form."""
    from repro_torch.core import bitlayout
    from repro_torch.core.device_plane import MAX_BATCH_BYTES

    plan = {"plane_producer": 0, "bitpack_encode_chunks": 0, "huffdecode_index": 0,
            "huffdecode_serial": 0, "huffdecode_chain": 0}
    for key in store.stack_keys:
        for i in range(store.n_layers(key)):
            leaves = store.manifest(key, i)["leaves"]
            groups: dict = {}
            for ct in leaves:
                groups.setdefault(ct.dtype, []).append(
                    int(np.prod(ct.shape)) * bitlayout.LAYOUTS[ct.dtype].itemsize)
            plan["plane_producer"] += sum(k3_windows(g, MAX_BATCH_BYTES) for g in groups.values())
            plan["bitpack_encode_chunks"] += sum(k7_launches(ct.blob) for ct in leaves)
            plan["huffdecode_index"] += sum(has_huff(ct.blob) for ct in leaves)
    return plan


def build_served_store(dev, zcfg, cfg, params, label, host_pick, check_layers):
    """The serving store built on the card from ``params``: its launches
    equal to the plan from its blobs, no HUFF-symbol upload, a payload
    feed for every leaf, the blobs of the leaves ``host_pick(key, i,
    path)`` chooses equal to the host's encode of each, and every leaf of
    the layers ``check_layers`` (``(key, i)`` pairs) decoded on the card
    equal to its param bit for bit."""
    import torch

    from repro_torch import _util
    from repro_torch.core import device_entropy, zipnn
    from repro_torch.core.options import CodecOptions
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import CompressedParamStore

    device_entropy.reset_transfer_stats()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store = CompressedParamStore.from_params(
        params, zcfg, options=CodecOptions(threads=-1, backend="device"), payload_feed=True,
    )
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    build = launch_counts()
    if device_entropy.transfer_stats()["symbol_uploads"]:
        raise AssertionError(f"the {label} build uploaded HUFF symbols")
    plan = build_plan(store)
    for name, n in plan.items():
        if build[name] != n:
            raise AssertionError(f"{label} build: {name} {build[name]} launches, plan {n}")
    missing = sum(f is None for key in store.stack_keys for layer in store.feeds(key)
                  for f in layer)
    if missing:
        raise AssertionError(f"{label}: {missing} stacked leaves have no payload feed")

    t0 = time.perf_counter()
    host_opts = CodecOptions(threads=-1, backend="host")
    checked = 0
    for key in store.stack_keys:
        for i in range(store.n_layers(key)):
            layer = _util.tree_map(lambda a, i=i: a[i], params[key])
            cts = store.manifest(key, i)["leaves"]
            for (path, leaf), ct in zip(_util.tree_flatten_with_keys(layer), cts):
                if not host_pick(key, i, path):
                    continue
                host = zipnn.compress_array(leaf.cpu(), zcfg, options=host_opts, device="cpu")
                if host.blob != ct.blob:
                    raise AssertionError(f"{label} {key} {i} {path}: the card's blob differs "
                                         "from the host's")
                checked += 1
    t_host = time.perf_counter() - t0
    for key, i in check_layers:
        got = _util.tree_leaves(store.decode_layer(key, i))
        ref = _util.tree_leaves(_util.tree_map(lambda a, i=i: a[i], params[key]))
        store.release(key, i)
        if len(got) != len(ref) or not all(torch.equal(bits(g), bits(w))
                                           for g, w in zip(got, ref)):
            raise AssertionError(f"{label} {key} layer {i} does not decode bit-exactly")
        del got, ref
    store.reset_peak()
    sizes = {
        "ratio_pct": store.ratio_pct, "comp_bytes": store.comp_bytes,
        "device_payload_bytes": store.device_payload_bytes, "raw_bytes": store.raw_bytes,
        "static_bytes": store.static_bytes, "footprint_bytes": store.footprint_bytes(RING),
        "plain_bytes": store.raw_bytes + store.static_bytes,
        "max_layer_raw_bytes": store.max_layer_raw_bytes,
        "payload_bytes_by_stack": {
            key: sum(f.device_bytes for layer in store.feeds(key) for f in layer)
            for key in store.stack_keys},
        "raw_bytes_by_stack": {
            key: sum(store.manifest(key, i)["raw_bytes"] for i in range(store.n_layers(key)))
            for key in store.stack_keys},
    }
    log(f"{label} store on the card in {t_build:.3f} s ({store.raw_bytes / 1e6 / t_build:.1f} "
        f"MB/s of stacks, encode + feed upload + index pass); build launches {plan}, equal to "
        f"the plan from the blobs; {checked} blobs equal the host's encode ({t_host:.3f} s on "
        f"the host); every decoded leaf of {list(check_layers)} equals its param")
    log(f"{label} store: {sizes}")
    return store, {"build_s": t_build, "host_check_s": t_host, "host_checked_leaves": checked,
                   "store": sizes, "build_launches": plan, "launches": dict(build)}


def per_step_plan(store):
    """K1 sync decodes and K2 launches of one ring step: every feed's."""
    feeds = [f for key in store.stack_keys for layer in store.feeds(key) for f in layer]
    return {"huffdecode_chunks": sum(f.n_launches["huffdecode_chunks"] for f in feeds),
            "plane_consumer": sum(f.n_launches["plane_consumer"] for f in feeds)}


def add_launches(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def run_rings(dev, cfg, store, params, label, out, seed):
    """The ring at each of TILES against the plain step on B=BATCH
    requests of PROMPT + STEPS tokens: logits bit-identical, every entry
    of the final decode state (caches, or an SSM model's recurrent state
    and conv history) bit-identical, no payload upload and no K1 form but
    the sync decode, at most ``RING x tiles`` slots resident, K1/K2
    launches equal to the plan; then a profiler trace of 4 ring steps at
    each."""
    import torch

    from repro_torch.core import device_entropy
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import decode_step, init_decode_state
    from repro_torch.serve import greedy_generate, make_compressed_serve_step

    prompt = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)).to(dev)
    s = init_decode_state(cfg, BATCH, PROMPT + STEPS, start_pos=0, device=dev)
    decode_step(cfg, params, s, prompt[:, :1])                # warm the plain path
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    plain_logits: list = []
    t0 = time.perf_counter()
    plain_tokens, plain_state = greedy_generate(cfg, params, prompt, STEPS,
                                                logits_out=plain_logits)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    n_steps = PROMPT + STEPS
    per_step = per_step_plan(store)
    # card bytes above what the phase holds anyway (params and payloads)
    out.update({"plain_tokens_per_s": BATCH * n_steps / t_plain, "plain_s": t_plain,
                "ring": {}, "per_step": per_step, "held_card_bytes": base,
                "plain_peak_extra_bytes": torch.cuda.max_memory_allocated(dev) - base})
    for tiles in TILES:
        cstep = make_compressed_serve_step(cfg, store, ring=RING, tiles=tiles)
        store.reset_peak()
        device_entropy.reset_transfer_stats()
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        logits: list = []
        t0 = time.perf_counter()
        tokens, state = greedy_generate(cfg, None, prompt, STEPS, serve_step=cstep,
                                        logits_out=logits)
        torch.cuda.synchronize()
        t_ring = time.perf_counter() - t0
        extra = torch.cuda.max_memory_allocated(dev) - base
        launches = launch_counts()
        uploads = device_entropy.transfer_stats()["payload_uploads"]
        check_same_run(f"{label} ring tiles={tiles}", plain_logits, plain_tokens, logits,
                       tokens, n_steps, cfg.vocab_size)
        if sorted(state) != sorted(plain_state) or not all(
                torch.equal(bits(state[k]), bits(plain_state[k])) for k in plain_state):
            raise AssertionError(f"{label} ring tiles={tiles}: the final decode state differs "
                                 "from the plain step's")
        del state
        for name, n in per_step.items():
            if launches[name] != n * n_steps:
                raise AssertionError(f"{label} tiles={tiles} {name}: {launches[name]} "
                                     f"launches, plan {n * n_steps}")
        if (launches["huffdecode_serial"] or launches["huffdecode_index"]
                or launches["huffdecode_chain"] or uploads):
            raise AssertionError(f"{label} ring: a K1 form other than the sync decode, or "
                                 f"uploads: {launches}, {uploads}")
        if store.peak_resident > RING * tiles:
            raise AssertionError(f"{label} peak residency {store.peak_resident} > "
                                 f"{RING} x {tiles}")
        out["ring"][tiles] = {"tokens_per_s": BATCH * n_steps / t_ring, "s": t_ring,
                              "peak_resident": store.peak_resident,
                              "peak_extra_bytes": extra}
        add_launches(out["launches"], launches)
        log(f"{label} ring tiles={tiles}: logits bit-identical at all {n_steps} steps and the "
            f"final {sorted(k for k in plain_state if k != 'pos')} too, peak "
            f"resident {store.peak_resident} (at most {RING * tiles}), payload uploads 0; "
            f"{BATCH * n_steps / t_ring:.2f} tokens/s ({t_ring:.3f} s) against plain "
            f"{BATCH * n_steps / t_plain:.2f} ({t_plain:.3f} s); card bytes at peak over the "
            f"{base} held: ring {extra}, plain {out['plain_peak_extra_bytes']}")
    out["trace"] = {t: profile_ring(dev, cfg, store, steps=4, tiles=t,
                                    name=f"{label}_ring_trace_t{t}") for t in TILES}


def run_kv_tier(dev, zcfg, cfg, store, params, label, out, n_prompt, n_gen, seed, tiles=4):
    """The ring at ``tiles`` with a ``KVCacheStore`` at the reference's
    defaults over ``n_prompt + n_gen`` positions against the plain step
    over the untiered cache: logits bit-identical at every step, each
    evicted block's blob equal to the host's encode of it, the K3/K7
    launches at eviction and K1's one-shot decode and K2 in the reassembly
    equal to the block plan."""
    import torch

    from repro_torch.core import device_entropy, zipnn
    from repro_torch.core.options import CodecOptions
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_decode_state
    from repro_torch.serve import KVCacheStore, greedy_generate, make_compressed_serve_step

    L = cfg.n_layers
    n_pos = n_prompt + n_gen
    prompt = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (BATCH, n_prompt)).astype(np.int32)).to(dev)
    plain_logits: list = []
    t0 = time.perf_counter()
    plain_tokens, plain_state = greedy_generate(cfg, params, prompt, n_gen,
                                                logits_out=plain_logits)
    torch.cuda.synchronize()
    t_plain_kv = time.perf_counter() - t0
    kv = KVCacheStore(init_decode_state(cfg, BATCH, n_pos, start_pos=0, device=dev),
                      hot_window=KV_HOT, block_len=KV_BLOCK, config=zcfg)
    cstep = make_compressed_serve_step(cfg, store, ring=RING, tiles=tiles, kv_store=kv)
    store.reset_peak()
    device_entropy.reset_transfer_stats()
    reset_launch_counts()
    logits: list = []
    t0 = time.perf_counter()
    tokens, _ = greedy_generate(cfg, None, prompt, n_gen, serve_step=cstep, logits_out=logits)
    torch.cuda.synchronize()
    t_kv = time.perf_counter() - t0
    launches = launch_counts()
    uploads = device_entropy.transfer_stats()
    check_same_run(f"{label} KV tier", plain_logits, plain_tokens, logits, tokens, n_pos,
                   cfg.vocab_size)
    visible = kv_visible_blocks(n_pos + 1, KV_HOT, KV_BLOCK)    # [n_pos]: after the last step
    if kv.n_cold_blocks < 1 or kv.n_cold_blocks != visible.pop():
        raise AssertionError(f"{label} KV tier: {kv.n_cold_blocks} cold blocks")
    kv_huff, kv_k7 = {}, 0
    for key in kv.keys:
        for j in range(L):
            for b, ct in enumerate(kv.cold_blocks(key, j)):
                block = plain_state[key][j][:, b * KV_BLOCK:(b + 1) * KV_BLOCK].contiguous()
                host_blob = zipnn.compress_array(
                    block.cpu(), zcfg, options=CodecOptions(backend="host")).blob
                if ct.blob != host_blob:
                    raise AssertionError(f"{label} KV block {key} {j} {b}: the card's blob "
                                         "differs from the host's")
                kv_huff[(key, j, b)] = has_huff(ct.blob)
                kv_k7 += k7_launches(ct.blob)
    per_step = out["per_step"]
    kv_plan = {
        "plane_producer": len(kv_huff),
        "bitpack_encode_chunks": kv_k7,
        "huffdecode_serial": sum(kv_huff[(k, j, b)] for v in visible for k in kv.keys
                                 for j in range(L) for b in range(v)),
        "plane_consumer": per_step["plane_consumer"] * n_pos + len(kv.keys) * L * sum(visible),
        "huffdecode_chunks": per_step["huffdecode_chunks"] * n_pos,
        "huffdecode_index": 0,
        "huffdecode_chain": 0,
    }
    for name, n in kv_plan.items():
        if launches[name] != n:
            raise AssertionError(f"{label} KV tier: {name} {launches[name]} launches, plan {n}")
    if store.peak_resident > RING * tiles or kv.peak_hot_positions > KV_HOT + KV_BLOCK:
        raise AssertionError(f"{label} KV tier residency: {store.peak_resident} tile slots, "
                             f"{kv.peak_hot_positions} hot positions")
    add_launches(out["launches"], launches)
    out["kv"] = {
        "positions": n_pos, "tiles": tiles, "tokens_per_s": BATCH * n_pos / t_kv, "s": t_kv,
        "plain_tokens_per_s": BATCH * n_pos / t_plain_kv, "plain_s": t_plain_kv,
        "cold_blocks": kv.n_cold_blocks, "cold_comp_bytes": kv.cold_comp_bytes,
        "cold_raw_bytes": kv.cold_raw_bytes, "hot_bytes": kv.hot_bytes,
        "full_cache_bytes": kv.full_cache_bytes, "resident_bytes": kv.resident_bytes(1),
        "peak_hot_positions": kv.peak_hot_positions,
        "peak_inflight_blocks": kv.peak_inflight_blocks, "launches": kv_plan,
        "payload_uploads": uploads["payload_uploads"], "keys": list(kv.keys),
        "block_shapes": [list(kv.cold_blocks(k, 0)[0].shape) for k in kv.keys],
    }
    log(f"{label} KV tier (hot {KV_HOT}, block {KV_BLOCK}, tiles={tiles}, caches {kv.keys}): "
        f"logits bit-identical at all {n_pos} steps; {kv.n_cold_blocks} cold blocks a (key, "
        f"layer), each equal to the host's encode; launches equal the plan {kv_plan}; "
        f"{BATCH * n_pos / t_kv:.2f} tokens/s ({t_kv:.3f} s) against plain "
        f"{BATCH * n_pos / t_plain_kv:.2f} ({t_plain_kv:.3f} s)")
    log(f"{label} KV tier bytes: {out['kv']}")


def served_params(dev, cfg, label):
    """``init_params(cfg, SEED)`` on the card, with its byte count."""
    import torch

    from repro_torch import _util
    from repro_torch.models.model import init_params

    params = init_params(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    leaves = _util.tree_leaves(params)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    log(f"{label}: {sum(t.numel() for t in leaves)} parameters, {n_bytes} B plain "
        f"({cfg.n_layers} layers, d_model {cfg.d_model})")
    return params, n_bytes


def phase_granite(dev, zcfg):
    """granite_20b at its published widths, cut to GRANITE_LAYERS layers:
    the store built on the card against the host's layer-0 blobs, every
    decoded leaf against its param, the ring at each of TILES against the
    plain step, a profiler trace, and the ring with the KV tier over
    KV_PROMPT + KV_GEN positions against the plain step over the untiered
    cache."""
    import dataclasses

    import torch

    from repro_torch import _util
    from repro_torch.configs import get_config

    free_card()
    cfg = dataclasses.replace(get_config("granite_20b"), n_layers=GRANITE_LAYERS)
    L = cfg.n_layers
    t_start = time.perf_counter()
    params, _ = served_params(dev, cfg, "granite_20b")
    per_layer = sum(t[0].numel() for t in _util.tree_leaves(params["layers"]))
    if per_layer != 379_121_920:
        raise AssertionError(f"granite_20b layer has {per_layer} parameters")
    store, out = build_served_store(
        dev, zcfg, cfg, params, "granite", lambda key, i, path: i == 0,
        [("layers", i) for i in range(L)])
    # the same store at the published 52 layers, from this run's per-layer bytes
    sizes = out["store"]
    sizes["footprint_bytes_52"] = int(52 * store.device_payload_bytes / L + store.static_bytes
                                      + RING * store.max_layer_raw_bytes)
    sizes["plain_bytes_52"] = 52 * store.raw_bytes // L + store.static_bytes
    run_rings(dev, cfg, store, params, "granite", out, SEED + 20)
    run_kv_tier(dev, zcfg, cfg, store, params, "granite", out, KV_PROMPT, KV_GEN, SEED + 21)
    out["prefill"], peak = run_prefill(dev, cfg, params, "granite", SEED + 22)
    shapes = [tuple(ct.shape) for ct in store.manifest("layers", 0)["leaves"]]
    out["kernels"] = measure_leaf_kernels(
        dev, store.feeds("layers")[0][shapes.index(W_IN)], params["layers"]["mlp"]["w_in"][0],
        "granite w_in")
    out["peak_card_bytes"] = max(peak, torch.cuda.max_memory_allocated(dev))
    out["phase_s"] = time.perf_counter() - t_start
    log(f"granite phase: {out['phase_s']:.1f} s, peak card memory {out['peak_card_bytes']} B")
    return out


def leaf_feed(store, key, i, path):
    """The payload feed of the leaf at ``path`` of layer ``i`` of ``key``."""
    from repro_torch import _util

    layer = _util.tree_unflatten(store.manifest(key, i)["treedef"],
                                 list(range(len(store.manifest(key, i)["leaves"]))))
    j = layer
    for k in path.split("/"):
        j = j[k]
    return store.feeds(key)[i][j]


def leaf_of(params, key, i, path):
    t = params[key]
    for k in path.split("/"):
        t = t[k]
    return t[i]


def phase_olmoe(dev, zcfg):
    """olmoe_1b_7b whole at its published size (16 layers, 64 experts of
    2048x1024, top-8, routers f32): the store built on the card against
    the host's encode of layer 0, every leaf of layers 0 and 15 decoded
    against its param, the ring at each of TILES against the plain step,
    profiler traces, and K1/K2/K3/K7 at an expert leaf (exactly one K3
    window and one K7 launch: 256 MiB, 1,024 exponent chunks) and at a
    router leaf (f32)."""
    import torch

    from repro_torch.configs import get_config

    free_card()
    cfg = get_config("olmoe_1b_7b")
    t_start = time.perf_counter()
    params, n_bytes = served_params(dev, cfg, "olmoe_1b_7b")
    if n_bytes != 13_842_386_944:
        raise AssertionError(f"olmoe_1b_7b holds {n_bytes} B")
    store, out = build_served_store(
        dev, zcfg, cfg, params, "olmoe", lambda key, i, path: i == 0,
        [("moe_layers", 0), ("moe_layers", cfg.n_layers - 1)])
    out["plain_bytes_on_card"] = n_bytes
    run_rings(dev, cfg, store, params, "olmoe", out, SEED + 30)
    out["prefill"], peak = run_prefill(dev, cfg, params, "olmoe", SEED + 32)
    out["kernels"] = {
        "expert": measure_leaf_kernels(
            dev, leaf_feed(store, "moe_layers", 0, "moe/experts/w_gate"),
            leaf_of(params, "moe_layers", 0, "moe/experts/w_gate"), "olmoe w_gate"),
        "router": measure_leaf_kernels(
            dev, leaf_feed(store, "moe_layers", 0, "moe/router/w"),
            leaf_of(params, "moe_layers", 0, "moe/router/w"), "olmoe router", reps=20),
    }
    out["peak_card_bytes"] = max(peak, torch.cuda.max_memory_allocated(dev))
    out["phase_s"] = time.perf_counter() - t_start
    log(f"olmoe phase: {out['phase_s']:.1f} s, peak card memory {out['peak_card_bytes']} B")
    return out


def phase_deepseek(dev, zcfg):
    """deepseek_v2_236b at its published widths, cut in depth to
    DEEPSEEK_LAYERS (the dense layer and one MoE layer: MLA, 160 experts
    of 5120x1536, 2 shared): the store built on the card against the
    host's encode of every leaf but the three expert leaves, every leaf of
    both layers decoded against its param (the 2,516,582,400-byte expert
    leaves through K3, K7, K1's index pass and sync decode and K2), the
    ring at each of TILES and the ring with the MLA KV tier against the
    plain step, and K1/K2/K3/K7 at the expert leaf (K1's sync decode
    against its plain version over all 9,600 chunks) and the router."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config

    free_card()
    cfg = dataclasses.replace(get_config("deepseek_v2_236b"), n_layers=DEEPSEEK_LAYERS)
    t_start = time.perf_counter()
    params, n_bytes = served_params(dev, cfg, "deepseek_v2_236b")
    if n_bytes != 10_718_996_480:
        raise AssertionError(f"deepseek_v2_236b x{DEEPSEEK_LAYERS} holds {n_bytes} B")
    store, out = build_served_store(
        dev, zcfg, cfg, params, "deepseek",
        lambda key, i, path: not path.startswith("moe/experts/"),
        [("dense_layers", 0), ("moe_layers", 0)])
    out["plain_bytes_on_card"] = n_bytes
    # the same store at the published 60 layers (1 dense, 59 MoE), from this
    # run's per-layer bytes
    sizes = out["store"]
    moe_payload = sizes["payload_bytes_by_stack"]["moe_layers"]
    moe_raw = sizes["raw_bytes_by_stack"]["moe_layers"]
    sizes["footprint_bytes_60"] = (sizes["payload_bytes_by_stack"]["dense_layers"]
                                   + 59 * moe_payload + store.static_bytes
                                   + RING * store.max_layer_raw_bytes)
    sizes["plain_bytes_60"] = (sizes["raw_bytes_by_stack"]["dense_layers"] + 59 * moe_raw
                               + store.static_bytes)
    log(f"deepseek at 60 layers from these bytes: footprint (ring {RING}) "
        f"{sizes['footprint_bytes_60']} B against {sizes['plain_bytes_60']} B plain")
    run_rings(dev, cfg, store, params, "deepseek", out, SEED + 40)
    run_kv_tier(dev, zcfg, cfg, store, params, "deepseek", out, DS_KV_PROMPT, DS_KV_GEN,
                SEED + 41)
    out["prefill"], peak = run_prefill(dev, cfg, params, "deepseek", SEED + 42)
    out["kernels"] = {
        "expert": measure_leaf_kernels(
            dev, leaf_feed(store, "moe_layers", 0, "moe/experts/w_gate"),
            leaf_of(params, "moe_layers", 0, "moe/experts/w_gate"), "deepseek w_gate",
            plain_prefix=DS_PLAIN_PREFIX, reps=3),
        "router": measure_leaf_kernels(
            dev, leaf_feed(store, "moe_layers", 0, "moe/router/w"),
            leaf_of(params, "moe_layers", 0, "moe/router/w"), "deepseek router", reps=20),
    }
    out["peak_card_bytes"] = max(peak, torch.cuda.max_memory_allocated(dev))
    out["phase_s"] = time.perf_counter() - t_start
    log(f"deepseek phase: {out['phase_s']:.1f} s, peak card memory {out['peak_card_bytes']} B")
    return out


def measure_k2_leaf(dev, x, label, reps=20):
    """K2 alone at one leaf's exact size, as a ring decode of the leaf
    launches it (a leaf with no Huffman-coded chunk runs no K1): its planes
    from K3's plain version, then K2 against its plain version and its
    bound."""
    import torch

    from repro_torch.kernels import plane_consumer, plane_consumer_plain, plane_producer_plain
    from repro_torch.kernels.fused_plane import ELEM_DTYPES

    itemsize = x.element_size()
    e = x.reshape(-1).view(ELEM_DTYPES[itemsize])
    n = e.numel()
    planes, _ = plane_producer_plain(e, itemsize=itemsize, chunk_elems=n)
    pl = [planes[p].contiguous() for p in range(itemsize)]
    k2 = lambda: plane_consumer(pl, itemsize=itemsize)  # noqa: E731
    path = k2_path(plane_consumer, k2, pl, None, itemsize, dev)
    ms = device_ms(k2, reps)
    kernel_ms = profiled_ms(k2, r"unplane_kernel", 5)
    plain_ms = device_ms(lambda: plane_consumer_plain(pl, itemsize=itemsize), 1)
    if not (torch.equal(k2(), e) and torch.equal(plane_consumer_plain(pl, itemsize=itemsize), e)):
        raise AssertionError(f"K2 disagrees at the {label} leaf")
    b, by = bound_ms(2 * itemsize * n, K2_OPS_PER_ELEMENT * n)
    log(f"K2 at {label} {tuple(x.shape)} ({x.dtype}), {path}: kernel {ms:.5f} ms (device time "
        f"alone {kernel_ms}), plain {plain_ms:.4f} ms, bound {b:.6f} ms ({by}, "
        f"{2 * itemsize * n} B)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "kernel_ms_profiler": kernel_ms, "bytes": 2 * itemsize * n, "plain_elems": n,
            "path": path}


def phase_mamba2(dev, zcfg):
    """mamba2_130m whole at its published size (24 layers, d_model 768,
    d_inner 1536, 24 SSM heads of 64, state 128, vocab 50,280, untied head;
    335,200,512 B): the store built on the card against the host's encode
    of layer 0 (its three f32 ``ssm`` leaves included), every leaf of
    layers 0 and 23 decoded against its param, the ring at each of TILES
    against the plain step (logits and the final ``ssm_state`` /
    ``ssm_conv`` bit-identical), profiler traces, K1/K2/K3/K7 at the
    768x3352 ``in_proj`` leaf and K2's fp32 path at ``A_log``."""
    import torch

    from repro_torch.configs import get_config

    free_card()
    cfg = get_config("mamba2_130m")
    t_start = time.perf_counter()
    params, n_bytes = served_params(dev, cfg, "mamba2_130m")
    if n_bytes != 335_200_512:
        raise AssertionError(f"mamba2_130m holds {n_bytes} B")
    store, out = build_served_store(
        dev, zcfg, cfg, params, "mamba2", lambda key, i, path: i == 0,
        [("layers", 0), ("layers", cfg.n_layers - 1)])
    leaves = store.manifest("layers", 0)["leaves"]
    f32 = sum(ct.dtype == "float32" for ct in leaves)
    if out["host_checked_leaves"] != len(leaves) or f32 != 3:
        raise AssertionError(f"mamba2 layer 0: {out['host_checked_leaves']} of {len(leaves)} "
                             f"blobs checked, {f32} f32 leaves")
    out["plain_bytes_on_card"] = n_bytes
    run_rings(dev, cfg, store, params, "mamba2", out, SEED + 50)
    out["prefill"], peak = run_prefill(dev, cfg, params, "mamba2", SEED + 52)
    out["kernels"] = {
        "in_proj": measure_leaf_kernels(
            dev, leaf_feed(store, "layers", 0, "mamba/in_proj/w"),
            leaf_of(params, "layers", 0, "mamba/in_proj/w"), "mamba2 in_proj", reps=20),
        "A_log": {"K2": measure_k2_leaf(dev, leaf_of(params, "layers", 0, "mamba/ssm/A_log"),
                                        "mamba2 A_log")},
    }
    out["peak_card_bytes"] = max(peak, torch.cuda.max_memory_allocated(dev))
    out["phase_s"] = time.perf_counter() - t_start
    log(f"mamba2 phase: {out['phase_s']:.1f} s, peak card memory {out['peak_card_bytes']} B")
    return out


ZAMBA_BIG = "params/mamba_groups/mamba/in_proj/w"   # (13, 6, 3584, 14576) bf16, 8.15 GB


def checkpoint_entries(directory, step):
    """A checkpoint's manifest entries by key, and its ``data.bin`` path."""
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    return {e["key"]: e for e in manifest["entries"]}, os.path.join(d, "data.bin")


def read_blob(path, entry):
    with open(path, "rb") as f:
        f.seek(entry["offset"])
        blob = f.read(entry["size"])
    if len(blob) != entry["size"] or zlib.crc32(blob) != entry["crc"]:
        raise AssertionError(f"{entry['key']}: short read or CRC mismatch")
    return blob


def phase_zamba2(dev, zcfg):
    """zamba2_7b whole at its published size (81 Mamba2 layers as 13 groups
    of 6 plus a 3-layer tail, the shared attention block; 13,502,316,096
    B), from a ZipNN checkpoint restored on the card: the plain
    ``greedy_generate`` (B=BATCH, PROMPT + STEPS tokens) gives reference
    tokens; one ``CheckpointManager`` base of ``{"params": ...}`` is saved
    on the card (K3 a leaf, K7 as its chunk cap splits each leaf: 31
    launches for the 8,149,499,904-byte ``in_proj`` stack); the host's save
    of the ``mamba_tail`` subtree writes the same blobs as the card's save
    of those leaves (the host check is cut to that subtree, 3 layers at
    full width, to bound the host's encode time); ``launch.serve.main``
    restores the checkpoint on the card (K1's one-shot decode a Huffman
    leaf, K2 a window of same-dtype leaves) and decodes: every restored
    leaf equals the saved one bit for bit and the tokens equal the plain
    step's; then K1 (sync decode, index pass, one-shot decode), K2, K3 and
    K7 at the 8.15 GB leaf against their plain versions and bounds.  The
    checkpoint directory is removed at the end."""
    import shutil

    import torch

    from repro_torch import _util
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import zipnn
    from repro_torch.core.device_plane import MAX_BATCH_BYTES
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import greedy_generate

    free_card()
    cfg = get_config("zamba2_7b")
    t_start = time.perf_counter()
    params, n_bytes = served_params(dev, cfg, "zamba2_7b")
    if n_bytes != 13_502_316_096:
        raise AssertionError(f"zamba2_7b holds {n_bytes} B")
    big = params["mamba_groups"]["mamba"]["in_proj"]["w"]
    if tuple(big.shape) != (13, 6, 3584, 14576) or big.numel() * 2 != 8_149_499_904:
        raise AssertionError(f"zamba2 in_proj stack {tuple(big.shape)}")
    out = {"plain_bytes_on_card": n_bytes, "launches": {}}

    # the serving entry point's prompt: its --seed (0) draws it
    prompt = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_tokens, _ = greedy_generate(cfg, params, prompt, STEPS)
    torch.cuda.synchronize()
    out["plain_s"] = time.perf_counter() - t0
    out["plain_tokens_per_s"] = BATCH * (PROMPT + STEPS) / out["plain_s"]
    log(f"zamba2 plain greedy_generate on the card: B={BATCH}, {PROMPT} + {STEPS} tokens in "
        f"{out['plain_s']:.3f} s ({out['plain_tokens_per_s']:.2f} tokens/s); first sequence "
        f"{plain_tokens[0].tolist()}")
    # prefill: the same prompt against the decode loop, then timed past the
    # shared block's window, whose first half must be the prefill of that
    # half alone (the attention is causal)
    out["prefill"], prefill_peak = run_prefill(dev, cfg, params, "zamba2", SEED + 60,
                                               hold_tokens=prompt)
    out["prefill"]["causal"] = causal_prefix(dev, cfg, params, "zamba2", SEED + 61)

    work = os.path.join(ROOT, "build", "chip_zamba2_ckpt")
    shutil.rmtree(work, ignore_errors=True)
    card_dir, host_dir = os.path.join(work, "card"), os.path.join(work, "host")
    try:
        mgr = CheckpointManager(CheckpointConfig(card_dir, zipnn=zcfg, device=dev))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        mgr.save(0, {"params": params}, blocking=True)
        torch.cuda.synchronize()
        out["save_s"] = time.perf_counter() - t0
        save_launches = launch_counts()
        out["save_peak_card_bytes"] = torch.cuda.max_memory_allocated(dev)
        del mgr                                     # and the base it holds on the card
        free_card()
        entries, data = checkpoint_entries(card_dir, 0)
        flat = _util.tree_flatten_with_keys({"params": params})
        if sorted(entries) != sorted(k for k, _ in flat):
            raise AssertionError("zamba2 checkpoint keys differ from the params'")
        # the save's plan from its blobs: K3 once a leaf (a leaf over the
        # batch cap is its own window), K7 as each leaf's chunk cap splits it
        huff, k7 = {}, {}
        for key, e in entries.items():
            blob = read_blob(data, e)
            huff[key], k7[key] = huff_chunks(blob), k7_launches(blob)
            del blob
        save_plan = {"plane_producer": len(entries), "bitpack_encode_chunks": sum(k7.values())}
        for name, n in save_plan.items():
            if save_launches[name] != n:
                raise AssertionError(f"zamba2 save: {name} {save_launches[name]} launches, "
                                     f"plan {n}")
        out["save_launches"] = save_plan
        add_launches(out["launches"], save_launches)
        disk = os.path.getsize(data)
        log(f"zamba2 card save of {n_bytes} B in {out['save_s']:.3f} s "
            f"({n_bytes / 1e6 / out['save_s']:.1f} MB/s), {disk} B data.bin "
            f"({100 * disk / n_bytes:.3f}%), launches equal the plan {save_plan} (the in_proj "
            f"stack: {huff[ZAMBA_BIG]} Huffman chunks, {k7[ZAMBA_BIG]} K7 "
            f"launches); card memory at peak {out['save_peak_card_bytes']} B")

        # the host's save of the tail's leaves writes the card's blobs
        tail = {"params": {"mamba_tail": _util.tree_map(lambda t: t.cpu(),
                                                        params["mamba_tail"])}}
        t0 = time.perf_counter()
        CheckpointManager(CheckpointConfig(host_dir, zipnn=zcfg, threads=-1,
                                           device="cpu")).save(0, tail, blocking=True)
        out["host_tail_save_s"] = time.perf_counter() - t0
        host_entries, host_data = checkpoint_entries(host_dir, 0)
        fields = ("kind", "dtype", "shape", "size", "crc", "raw")
        for key, e in host_entries.items():
            c = entries[key]
            if ([c[f] for f in fields] != [e[f] for f in fields]
                    or read_blob(data, c) != read_blob(host_data, e)):
                raise AssertionError(f"zamba2 checkpoint {key}: the card's blob differs from the "
                                     "host's")
        tail_raw = sum(e["raw"] for e in host_entries.values())
        log(f"zamba2 mamba_tail ({len(host_entries)} leaves, {tail_raw} B): the card's checkpoint "
            f"blobs equal the host's save ({out['host_tail_save_s']:.3f} s on the host)")
        del tail

        # the serving entry point restores on the card and decodes
        served: dict = {}
        free_card()
        reset_launch_counts()
        t0 = time.perf_counter()
        tokens = launch_serve.main(["--arch", "zamba2_7b", "--ckpt-dir", card_dir,
                                    "--batch", str(BATCH), "--prompt-len", str(PROMPT),
                                    "--gen", str(STEPS)], params_out=served)
        torch.cuda.synchronize()
        out["serve_s"] = time.perf_counter() - t0
        restore_launches = launch_counts()
        out["serve_peak_card_bytes"] = torch.cuda.max_memory_allocated(dev)
        got = _util.tree_flatten_with_keys({"params": served})
        if [k for k, _ in got] != [k for k, _ in flat]:
            raise AssertionError("zamba2 restore: keys differ from the saved params'")
        for (k, a), (_, b) in zip(got, flat):
            if not (a.device == dev and a.dtype == b.dtype and a.shape == b.shape
                    and torch.equal(bits(a), bits(b))):
                raise AssertionError(f"zamba2 restore: {k} differs from the saved leaf")
        if not torch.equal(tokens, plain_tokens):
            raise AssertionError("zamba2: launch.serve's tokens differ from the plain step's")
        del served, got
        # the restore's plan: K1's one-shot decode a Huffman leaf, K2 a
        # window of same-dtype leaves in key order
        sizes: dict = {}
        for key in sorted(entries):
            sizes.setdefault(entries[key]["dtype"], []).append(entries[key]["raw"])
        restore_plan = {"huffdecode_serial": sum(n > 0 for n in huff.values()),
                        "plane_consumer": sum(k3_windows(g, MAX_BATCH_BYTES)
                                              for g in sizes.values()),
                        "huffdecode_chain": 0}
        for name, n in restore_plan.items():
            if restore_launches[name] != n:
                raise AssertionError(f"zamba2 restore: {name} {restore_launches[name]} "
                                     f"launches, plan {n}")
        if restore_launches["huffdecode_chunks"] or restore_launches["huffdecode_index"]:
            raise AssertionError(f"zamba2 restore: sync K1 launched {restore_launches}")
        out["restore_launches"] = restore_plan
        add_launches(out["launches"], restore_launches)
        log(f"zamba2 launch.serve --ckpt-dir: restore and {BATCH} x {STEPS} greedy tokens in "
            f"{out['serve_s']:.3f} s; every restored leaf (the {big.numel() * 2}-byte in_proj "
            f"stack included) equals the saved one bit for bit; tokens equal the plain step's; "
            f"launches equal the plan {restore_plan}; card memory at peak "
            f"{out['serve_peak_card_bytes']} B")

        # the kernels at the 8.15 GB leaf
        e = entries[ZAMBA_BIG]
        ct = zipnn.CompressedTensor(read_blob(data, e), e["dtype"], tuple(e["shape"]))
        del params, flat
        free_card()
        feed = zipnn.build_array_feed(ct, zcfg, device=dev)
        del ct
        out["kernels"] = {"in_proj": measure_leaf_kernels(
            dev, feed, big, "zamba2 in_proj", plain_prefix=DS_PLAIN_PREFIX, reps=3)}
        del feed, big
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["peak_card_bytes"] = max(out.get("save_peak_card_bytes", 0),
                                 out.get("serve_peak_card_bytes", 0), prefill_peak,
                                 out["prefill"]["timed"]["peak_card_bytes"],
                                 torch.cuda.max_memory_allocated(dev))
    out["phase_s"] = time.perf_counter() - t_start
    log(f"zamba2 phase: {out['phase_s']:.1f} s, peak card memory {out['peak_card_bytes']} B")
    return out


# The vlm and audio phases: (timed B, timed S) of the prefill from
# ``data.make_batch``, (hold B, hold S) of the card-vs-CPU hold, and the
# depth the hold cuts the model to (every width as published)
FRONT_TIMED = (4, 2048)          # qwen2_vl: 512 patches + 1,536 text tokens
FRONT_HOLD = {"qwen2_vl": (1, 256), "hubert": (1, 512)}   # qwen2_vl: 64 patches, an 8 x 8 grid
FRONT_HOLD_LAYERS = 2
# The card against the CPU on one prefill at full width, the largest gap
# over the largest logit; each phase's control must go over it.  The
# reduced models' limit (``tests/test_torch_prefill.py``'s
# ``CARD_REL_TOL``, 5e-3; readings 1.8e-3 to 4.9e-3) does not hold at
# full width: on an H100 the card's bf16 products round 0.07-0.29% of
# their entries to the other neighbour of the exact product (K = 1,280 to
# 8,960), the CPU's 0.02-0.03%, and one flipped entry of an 8,960-wide
# hidden row moves all 1,536 sums of its row, so that, given the same
# inputs, qwen2_vl's SwiGLU output differs on 5.3% of its entries between
# the two (``python3 -m repro_torch.models.card_cpu_compare``).  Two layers
# at gains 1 then read 8.76e-3 (qwen2_vl) and 5.48e-3 (hubert) against
# controls of 0.52 and 0.72.
CARD_REL_TOL_FULL = 2e-2
HUBERT_BIG = "params/layers/mlp/w_in"   # (48, 1280, 5120) f32, 1,258,291,200 B
# (parameters, bytes) of the two models at their published sizes, and the
# shape of hubert's widest leaf
PUBLISHED = {"qwen2_vl_2b": (1_778_894_336, 3_557_788_672),
             "hubert_xlarge": (988_346_880, 3_953_387_520)}
HUBERT_W_IN = (48, 1280, 5120)


def front_batch(cfg, B, S, step, device):
    """``data.make_batch``'s vlm or audio batch (B x S) on ``device``."""
    from repro_torch.data import DataConfig, make_batch

    return make_batch(cfg, DataConfig(S, B), step, device=device)


def hold_front_prefill(dev, cfg, params, label, control):
    """``make_prefill`` on the card against the port's prefill on the CPU,
    both on ``reference_norms`` of ``params`` cut in depth to
    FRONT_HOLD_LAYERS layers (every width as published), at FRONT_HOLD's
    ``make_batch`` batch: the largest gap within CARD_REL_TOL_FULL of the
    largest CPU logit.  The same card run under ``control`` (a copy of the config
    that computes another function: no M-RoPE, or causal) must go over it."""
    import dataclasses

    import torch

    from repro_torch import _util
    from repro_torch.models.model import reference_norms
    from repro_torch.serve import make_prefill

    B, S = FRONT_HOLD[label]
    n = FRONT_HOLD_LAYERS
    cut = {k: (_util.tree_map(lambda t: t[:n], v) if k == "layers" else v)
           for k, v in params.items()}
    card = reference_norms(cut)
    host = _util.tree_map(lambda t: t.cpu(), card)
    small, small_ctl = (dataclasses.replace(c, n_layers=n) for c in (cfg, control))
    batch = front_batch(cfg, B, S, 1, "cpu")
    cbatch = {k: v.to(dev) for k, v in batch.items()}
    t0 = time.perf_counter()
    want = make_prefill(small)(host, batch)
    t_cpu = time.perf_counter() - t0
    got = make_prefill(small)(card, cbatch).cpu()
    ctl = make_prefill(small_ctl)(card, cbatch).cpu()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{label} prefill on the card: {tuple(got.shape)} against the "
                             f"CPU's {tuple(want.shape)}, or not finite")
    top = float(want.abs().max())
    row = {"B": B, "S": S, "layers": n, "top_logit": top,
           "max_gap_rel": float((got - want).abs().max()) / top,
           "control_max_gap_rel": float((ctl - want).abs().max()) / top,
           "argmax_equal_share": float((got.argmax(-1) == want.argmax(-1)).float().mean()),
           "cpu_s": t_cpu}
    del got, ctl, want, host, card
    log(f"{label} prefill, card against the CPU ({n} of {cfg.n_layers} layers at full width, "
        f"reference norms; largest gap < {CARD_REL_TOL_FULL} of the largest logit; the control must "
        f"go over): " + json.dumps(row))
    if row["control_max_gap_rel"] <= CARD_REL_TOL_FULL:
        raise AssertionError(f"{label}: the control passes the card-vs-CPU hold: {row}")
    if row["max_gap_rel"] > CARD_REL_TOL_FULL:
        raise AssertionError(f"{label} prefill on the card differs from the CPU's: {row}")
    return row


def phase_qwen2_vl(dev, zcfg):
    """qwen2_vl_2b whole at its published size (28 layers, d_model 1536, 12
    heads of 128, 2 KV heads, d_ff 8960, vocab 151,936, QKV bias, M-RoPE
    (16, 24, 24), untied head; 3,557,788,672 B of bf16): the store built on
    the card against the host's encode of layer 0 (``frontend_proj`` stays
    static), every leaf of layers 0 and 27 decoded against its param, the
    ring at each of TILES against the plain step with traces, the prefill
    of ``make_batch``'s patches and text timed and profiled, held against
    the CPU at 2 layers with a control (plain RoPE) that must fail, and
    K1/K2/K3/K7 at layer 0's ``w_gate`` (1536x8960, 105 exponent chunks)."""
    import dataclasses

    import torch

    from repro_torch import _util
    from repro_torch.configs import get_config

    free_card()
    cfg = get_config("qwen2_vl_2b")
    t_start = time.perf_counter()
    params, n_bytes = served_params(dev, cfg, "qwen2_vl_2b")
    n_params = sum(t.numel() for t in _util.tree_leaves(params))
    if (n_params, n_bytes) != PUBLISHED["qwen2_vl_2b"] or n_params != cfg.param_count():
        raise AssertionError(f"qwen2_vl_2b holds {n_params} parameters, {n_bytes} B")
    store, out = build_served_store(
        dev, zcfg, cfg, params, "qwen2_vl", lambda key, i, path: i == 0,
        [("layers", 0), ("layers", cfg.n_layers - 1)])
    if store.stack_keys != ("layers",) or "frontend_proj" not in store.static:
        raise AssertionError(f"qwen2_vl store: stacks {store.stack_keys}, static "
                             f"{sorted(store.static)}")
    out["plain_bytes_on_card"] = n_bytes
    run_rings(dev, cfg, store, params, "qwen2_vl", out, SEED + 70)
    B, S = FRONT_TIMED
    batch = front_batch(cfg, B, S, 0, dev)
    if tuple(batch["patches"].shape) != (B, S // 4, cfg.frontend_dim) or tuple(
            batch["tokens"].shape) != (B, S - S // 4):
        raise AssertionError(f"qwen2_vl batch {[tuple(v.shape) for v in batch.values()]}")
    timed, peak = time_prefill(dev, cfg, params, B, S, SEED + 71, "qwen2_vl", batch=batch)
    del batch
    control = dataclasses.replace(cfg, mrope=False)
    out["prefill"] = {"timed": timed, "hold": hold_front_prefill(dev, cfg, params, "qwen2_vl",
                                                                 control)}
    out["kernels"] = {"w_gate": measure_leaf_kernels(
        dev, leaf_feed(store, "layers", 0, "mlp/w_gate"),
        leaf_of(params, "layers", 0, "mlp/w_gate"), "qwen2_vl w_gate", reps=20)}
    out["peak_card_bytes"] = max(peak, timed["peak_card_bytes"],
                                 torch.cuda.max_memory_allocated(dev))
    out["phase_s"] = time.perf_counter() - t_start
    log(f"qwen2_vl phase: {out['phase_s']:.1f} s, peak card memory {out['peak_card_bytes']} B")
    return out


def phase_hubert(dev, zcfg):
    """hubert_xlarge whole at its published size (48 layers, d_model 1280,
    16 heads of 80, d_ff 5120, layernorm, GELU, QKV bias, 32,768 learned
    positions, a 512-wide audio front end, vocab 504; 3,953,387,520 B of
    f32), from a ZipNN checkpoint of its f32 params saved and restored on
    the card: one ``CheckpointManager`` base saved on the card (K3's fp32
    variant a leaf, K7 as its chunk cap splits each leaf: 2,048 f32 plane
    chunks a launch, so 3 for each Huffman plane of the 4,800-chunk
    ``w_in`` stack), layers 0-1 of the
    stacks saved on the card and on the host writing equal bytes;
    ``restore(device_resident=True)`` (K1's one-shot decode, K2's 4-byte
    path) bit for bit; the prefill of ``make_batch``'s frames from the
    restored params timed and profiled, held against the CPU at 2 layers
    with a control (causal attention) that must fail; K1/K2/K3/K7 at the
    1.26 GB ``w_in`` stack.  The checkpoint directory is removed at the
    end."""
    import dataclasses
    import shutil

    import torch

    from repro_torch import _util
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import zipnn
    from repro_torch.core.device_plane import MAX_BATCH_BYTES
    from repro_torch.core.options import CodecOptions
    from repro_torch.kernels import launch_counts, reset_launch_counts

    free_card()
    cfg = get_config("hubert_xlarge")
    t_start = time.perf_counter()
    params, n_bytes = served_params(dev, cfg, "hubert_xlarge")
    leaves = _util.tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    if (n_params, n_bytes) != PUBLISHED["hubert_xlarge"] or any(
            t.dtype != torch.float32 for t in leaves):
        raise AssertionError(f"hubert_xlarge holds {n_params} parameters, {n_bytes} B, dtypes "
                             f"{sorted({str(t.dtype) for t in leaves})}")
    big = params["layers"]["mlp"]["w_in"]
    if tuple(big.shape) != HUBERT_W_IN:
        raise AssertionError(f"hubert w_in stack {tuple(big.shape)}")
    out = {"plain_bytes_on_card": n_bytes, "launches": {}}
    card_opts = CodecOptions(threads=-1, backend="device")
    work = os.path.join(ROOT, "build", "chip_hubert_ckpt")
    shutil.rmtree(work, ignore_errors=True)
    card_dir = os.path.join(work, "card")
    try:
        mgr = CheckpointManager(CheckpointConfig(card_dir, zipnn=zcfg, options=card_opts,
                                                 device=dev))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        mgr.save(0, {"params": params}, blocking=True)
        torch.cuda.synchronize()
        out["save_s"] = time.perf_counter() - t0
        save_launches = launch_counts()
        out["save_peak_card_bytes"] = torch.cuda.max_memory_allocated(dev)
        del mgr
        free_card()
        entries, data = checkpoint_entries(card_dir, 0)
        flat = _util.tree_flatten_with_keys({"params": params})
        if sorted(entries) != sorted(k for k, _ in flat):
            raise AssertionError("hubert checkpoint keys differ from the params'")
        huff, k7 = {}, {}
        for key, e in entries.items():
            blob = read_blob(data, e)
            huff[key], k7[key] = huff_chunks(blob), k7_launches(blob)
            del blob
        save_plan = {"plane_producer": len(entries), "bitpack_encode_chunks": sum(k7.values())}
        for name, n in save_plan.items():
            if save_launches[name] != n:
                raise AssertionError(f"hubert save: {name} {save_launches[name]} launches, "
                                     f"plan {n}")
        out["save_launches"] = save_plan
        add_launches(out["launches"], save_launches)
        disk = os.path.getsize(data)
        out["save"] = {"seconds": out["save_s"], "mb_per_s": n_bytes / 1e6 / out["save_s"],
                       "data_bytes": disk, "ratio_pct": 100 * disk / n_bytes,
                       "chunks_by_method": chunk_methods(card_dir, 0),
                       "w_in_huff_chunks": huff[HUBERT_BIG], "w_in_k7_launches": k7[HUBERT_BIG]}
        log(f"hubert card save of {n_bytes} B of f32 in {out['save_s']:.3f} s "
            f"({out['save']['mb_per_s']:.1f} MB/s), {disk} B data.bin "
            f"({out['save']['ratio_pct']:.3f}%), chunks by method "
            f"{out['save']['chunks_by_method']}; launches equal the plan {save_plan} (the w_in "
            f"stack: {huff[HUBERT_BIG]} Huffman chunks, {k7[HUBERT_BIG]} K7 launches); card "
            f"memory at peak {out['save_peak_card_bytes']} B")

        # layers 0-1 of the stacks: the card's save writes the host's bytes
        small = {"params": {"layers": _util.tree_map(lambda t: t[:2].clone(),
                                                     params["layers"])}}
        t0 = time.perf_counter()
        CheckpointManager(CheckpointConfig(os.path.join(work, "small_card"), zipnn=zcfg,
                                           options=card_opts, device=dev)).save(
            0, small, blocking=True)
        t_small_card = time.perf_counter() - t0
        small_host = _util.tree_map(lambda t: t.cpu(), small)
        t0 = time.perf_counter()
        CheckpointManager(CheckpointConfig(os.path.join(work, "small_host"), zipnn=zcfg,
                                           threads=-1, backend="host", device="cpu")).save(
            0, small_host, blocking=True)
        t_small_host = time.perf_counter() - t0
        for name in ("manifest.json", "data.bin"):
            a, b = (os.path.join(work, d, "step_0", name) for d in ("small_card", "small_host"))
            if not _same_file(a, b):
                raise AssertionError(f"hubert layers 0-1 {name}: the card's bytes differ from "
                                     "the host's")
        small_raw = sum(t.numel() * 4 for t in _util.tree_leaves(small_host))
        out["small_check"] = {"raw_bytes": small_raw, "card_s": t_small_card,
                              "host_s": t_small_host}
        log(f"hubert layers 0-1 of the stacks ({small_raw} B of f32; cut to bound the host's "
            f"time): the card's save writes the host's bytes ({t_small_card:.3f} s on the card, "
            f"{t_small_host:.3f} s on the host)")
        del small, small_host

        # restore on the card, bit for bit
        mgr = CheckpointManager(CheckpointConfig(card_dir, zipnn=zcfg, device=dev))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        step, tree = mgr.restore(device_resident=True)
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        restore_launches = launch_counts()
        out["restore_peak_card_bytes"] = torch.cuda.max_memory_allocated(dev)
        restored = tree["params"]
        got = _util.tree_flatten_with_keys({"params": restored})
        if step != 0 or [k for k, _ in got] != [k for k, _ in flat]:
            raise AssertionError("hubert restore: keys differ from the saved params'")
        for (k, a), (_, b) in zip(got, flat):
            if not (a.device == dev and a.dtype == b.dtype and a.shape == b.shape
                    and torch.equal(bits(a), bits(b))):
                raise AssertionError(f"hubert restore: {k} differs from the saved leaf")
        del got, tree, flat
        sizes: dict = {}
        for key in sorted(entries):
            sizes.setdefault(entries[key]["dtype"], []).append(entries[key]["raw"])
        restore_plan = {"huffdecode_serial": sum(n > 0 for n in huff.values()),
                        "plane_consumer": sum(k3_windows(g, MAX_BATCH_BYTES)
                                              for g in sizes.values()),
                        "huffdecode_chain": 0}
        for name, n in restore_plan.items():
            if restore_launches[name] != n:
                raise AssertionError(f"hubert restore: {name} {restore_launches[name]} "
                                     f"launches, plan {n}")
        if restore_launches["huffdecode_chunks"] or restore_launches["huffdecode_index"]:
            raise AssertionError(f"hubert restore: sync K1 launched {restore_launches}")
        out["restore_launches"] = restore_plan
        add_launches(out["launches"], restore_launches)
        log(f"hubert restore(device_resident=True) in {out['restore_s']:.3f} s "
            f"({n_bytes / 1e6 / out['restore_s']:.1f} MB/s): every leaf (the "
            f"{big.numel() * 4}-byte w_in stack included) equals the saved one bit for bit; "
            f"launches equal the plan {restore_plan}; card memory at peak "
            f"{out['restore_peak_card_bytes']} B")

        # the prefill from the restored params
        del params, big
        free_card()
        B, S = FRONT_TIMED
        batch = front_batch(cfg, B, S, 0, dev)
        timed, peak = time_prefill(dev, cfg, restored, B, S, SEED + 81, "hubert", batch=batch)
        del batch
        control = dataclasses.replace(cfg, encoder_only=False)
        out["prefill"] = {"timed": timed,
                          "hold": hold_front_prefill(dev, cfg, restored, "hubert", control)}

        # the kernels at the 1.26 GB leaf
        e = entries[HUBERT_BIG]
        ct = zipnn.CompressedTensor(read_blob(data, e), e["dtype"], tuple(e["shape"]))
        feed = zipnn.build_array_feed(ct, zcfg, device=dev)
        del ct
        out["kernels"] = {"w_in": measure_leaf_kernels(
            dev, feed, restored["layers"]["mlp"]["w_in"], "hubert w_in",
            plain_prefix=DS_PLAIN_PREFIX, reps=3)}
        del feed, restored, mgr
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["peak_card_bytes"] = max(out.get("save_peak_card_bytes", 0),
                                 out.get("restore_peak_card_bytes", 0), peak,
                                 out["prefill"]["timed"]["peak_card_bytes"],
                                 torch.cuda.max_memory_allocated(dev))
    out["phase_s"] = time.perf_counter() - t_start
    log(f"hubert phase: {out['phase_s']:.1f} s, peak card memory {out['peak_card_bytes']} B")
    return out


def measure_leaf_kernels(dev, feed, x, label, plain_prefix=None, reps=10):
    """K1 (sync decode; the self-synchronising kernel's index pass and
    one-shot decode beside the chain baseline, ``k1_serial_forms``), K2, K3
    and K7 at one stored leaf: ``feed`` its payload feed, ``x`` its param
    on the card.  Each kernel is timed beside its bound and its plain
    version and held against it: K1 over the whole leaf, K2 by the round
    trip of K3's planes to ``x``, K3 and K7 over the whole leaf, or over its
    first ``plain_prefix`` elements where the plain versions' int64 keys
    would not fit beside the model.  At a leaf of ``PROFILER_MAX_BYTES`` or
    more only the events time is read."""
    import torch

    from repro_torch.core import huffman
    from repro_torch.kernels import (
        bitpack_encode_chunks, bitpack_encode_chunks_plain, huffdecode_chunks,
        huffdecode_chunks_plain, plane_consumer, plane_consumer_plain, plane_producer,
        plane_producer_plain,
    )
    from repro_torch.kernels.fused_plane import ELEM_DTYPES

    itemsize = x.element_size()
    leaf_bytes = x.numel() * itemsize
    chunk = (256 << 10) // itemsize              # plane chunk of the default 256 KiB chunks
    args = feed.launch_args()
    if args is None:
        raise AssertionError(f"the {label} leaf has no Huffman-coded chunk")
    n_out = args.pop("out_bytes")
    sync, sync_off = args.pop("sync"), args.pop("sync_off")
    out, out_p = (torch.zeros(n_out, dtype=torch.uint8, device=dev) for _ in range(2))
    run = lambda: huffdecode_chunks(**args, out=out, sync=sync, sync_off=sync_off)  # noqa: E731
    ms = device_ms(run, reps)
    kernel_ms = profiled_ms(run, r"huffdecode_sync_kernel", 5, leaf_bytes)
    plain = []
    plain_ms = device_ms(lambda: plain.append(huffdecode_chunks_plain(
        **args, out=out_p, sync=sync, sync_off=sync_off)), 1)
    cur = run()
    torch.cuda.synchronize()
    if not (torch.equal(out, out_p) and torch.equal(cur, plain[0])):
        raise AssertionError(f"K1's sync decode disagrees with its plain version at the "
                             f"{label} leaf")
    del out_p, plain, out
    symbols = int(args["counts"].sum())
    inputs = sum(t.numel() * t.element_size() for t in args.values())
    sync_bytes = sync.numel() * 4 + sync_off.numel() * 8
    k1_bytes = inputs + sync_bytes + symbols + 4 * cur.numel()
    b, by = bound_ms(k1_bytes, K1_OPS_PER_SYMBOL * symbols)
    forms = k1_serial_forms(args, sync_off, n_out, dev, reps=3, leaf_bytes=leaf_bytes)
    rows = {"K1": {"ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                   "kernel_ms_profiler": kernel_ms, "chunks": int(args["counts"].numel()),
                   "symbols": symbols, "bytes": k1_bytes, "seg_bits": forms["seg_bits"],
                   "rounds": forms["rounds"], "index_pass": forms["index_pass"],
                   "one_shot": forms["one_shot"]}}
    log(f"K1 at {label} {tuple(x.shape)}: {rows['K1']['chunks']} chunks, {symbols} symbols; "
        f"sync decode {ms:.5f} ms (device time alone {kernel_ms}), plain {plain_ms:.2f} ms, "
        f"bound {b:.6f} ms ({by}, {k1_bytes} B)")
    log_serial_forms(f"{label} {tuple(x.shape)}", forms)

    x = x.reshape(-1).view(ELEM_DTYPES[itemsize])
    if x.numel() % chunk:                        # zero-padded to whole chunks, as the store pads
        x = torch.cat([x, x.new_zeros(-x.numel() % chunk)])
    n = x.numel()
    xp = x if plain_prefix is None else x[:plain_prefix]
    k3 = lambda: plane_producer(x, itemsize=itemsize, chunk_elems=chunk)  # noqa: E731
    k3_ms = device_ms(k3, reps)
    k3_kernel_ms = profiled_ms(k3, r"(?<!un)plane_kernel", 5, leaf_bytes)
    k3_plain_ms = device_ms(lambda: plane_producer_plain(xp, itemsize=itemsize,
                                                         chunk_elems=chunk), 1)
    planes, hists = k3()
    pp, hp = plane_producer_plain(xp, itemsize=itemsize, chunk_elems=chunk)
    m = xp.numel()
    if not (torch.equal(planes[:, :m], pp) and torch.equal(hists[:m // chunk], hp)):
        raise AssertionError(f"K3 disagrees at the {label} leaf")
    del pp, hp
    k3_bytes = itemsize * n * 2 + (n // chunk) * itemsize * 256 * 4
    b, by = bound_ms(k3_bytes, K3_OPS_PER_ELEMENT[itemsize] * n)
    rows["K3"] = {"ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": b, "bound_by": by,
                  "kernel_ms_profiler": k3_kernel_ms, "bytes": k3_bytes, "plain_elems": m}

    pl = [planes[p].contiguous() for p in range(itemsize)]
    del planes
    k2 = lambda: plane_consumer(pl, itemsize=itemsize)  # noqa: E731
    k2_path_taken = k2_path(plane_consumer, k2, pl, None, itemsize, dev)
    k2_ms = device_ms(k2, reps)
    k2_kernel_ms = profiled_ms(k2, r"unplane_kernel", 5, leaf_bytes)
    pl_p = [q[:m] for q in pl]
    k2_plain_ms = device_ms(lambda: plane_consumer_plain(pl_p, itemsize=itemsize), 1)
    if not (torch.equal(k2(), x) and torch.equal(plane_consumer_plain(pl_p, itemsize=itemsize),
                                                 xp)):
        raise AssertionError(f"K2 disagrees at the {label} leaf")
    b, by = bound_ms(2 * itemsize * n, K2_OPS_PER_ELEMENT * n)
    rows["K2"] = {"ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": b, "bound_by": by,
                  "kernel_ms_profiler": k2_kernel_ms, "bytes": 2 * itemsize * n,
                  "plain_elems": m, "path": k2_path_taken}

    exp = pl[0]
    del pl, pl_p
    lens = huffman.code_lengths(torch.bincount(exp, minlength=256).cpu().numpy() + 1)
    tabs = [torch.from_numpy(np.asarray(t, dtype=np.int32)[None]).to(dev)
            for t in (lens, huffman.canonical_codes(lens))]
    c = n // chunk
    cp = m // chunk
    pids = torch.zeros(c, dtype=torch.int32, device=dev)
    k7 = lambda: bitpack_encode_chunks(exp, pids, *tabs, chunk_syms=chunk)  # noqa: E731
    k7_ms = device_ms(k7, reps)
    k7_kernel_ms = profiled_ms(k7, r"bitpack_kernel", 5, leaf_bytes)
    k7_plain_ms = device_ms(lambda: bitpack_encode_chunks_plain(
        exp[:m], pids[:cp], *tabs, chunk_syms=chunk), 1)
    words, nbits = k7()
    wp, np_ = bitpack_encode_chunks_plain(exp[:m], pids[:cp], *tabs, chunk_syms=chunk)
    if (not (torch.equal(words[:cp], wp) and torch.equal(nbits[:cp], np_))
            or int(nbits.min()) <= 0):
        raise AssertionError(f"K7 disagrees at the {label} leaf")
    del wp, np_
    k7_bytes = n + words.numel() * 4 + 4 * c + 4 * c + 2 * 4 * 256
    b, by = bound_ms(k7_bytes, K7_OPS_PER_SYMBOL * n)
    rows["K7"] = {"ms": k7_ms, "plain_ms": k7_plain_ms, "bound_ms": b, "bound_by": by,
                  "kernel_ms_profiler": k7_kernel_ms, "bytes": k7_bytes, "chunks": c,
                  "segments": c * (-(-chunk // 8192)), "bits": int(nbits.sum()),
                  "plain_chunks": cp}
    log(f"K2 at {label} {tuple(feed.shape)} took the {k2_path_taken} path")
    for k in ("K2", "K3", "K7"):
        r = rows[k]
        log(f"{k} at {label} {tuple(feed.shape)}: kernel {r['ms']:.5f} ms (device time alone "
            f"{r['kernel_ms_profiler']}), plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']}, {r['bytes']} B)")
    return rows


TRAIN_STEPS = 12                 # the first run; the resumed run goes 4 steps further
TRAIN_MORE = 4
TRAIN_B, TRAIN_S = 8, 2048       # crosses q_block 512 and kv_block 1,024 several times
TRAIN_LR = 1e-3
TRAIN_HOLD = (1, 256)            # the card-against-CPU gradient hold: B x S, 2 layers
TRAIN_HOLD_LAYERS = 2
# The card against the CPU on one step's gradients at full width (2 layers,
# gains 1): each leaf's largest gap over its largest CPU entry, floored at
# 1% of the largest entry of any leaf.  The card's bf16 products round
# other entries to the other neighbour than the CPU's (CARD_REL_TOL_FULL's
# note), and every gradient reads them; the reduced configs read up to
# 2.4% against the reference (tests/test_torch_train_grads*.py).  The
# control (attention without its causal mask) must go over it.
CARD_GRAD_REL = 1e-1
CARD_GRAD_FLOOR = 1e-2
TRAIN_KINDS = ("matmuls", "flash_fwd", "flash_bwd", "fused_ce", "optimizer", "rest")
OLMOE_TRAIN_LAYERS = 2           # olmoe_1b_7b cut in depth from 16; every width as published
OLMOE_TRAIN = (4, 2048)


class train_ranges:
    """Within the block the flash loop's forward and backward, the fused
    cross-entropy's forward and backward and the AdamW update each run
    inside a ``record_function`` range named for their kind, so a trace
    can attribute the kernels each launches (the backward ones from the
    autograd thread)."""

    def __enter__(self):
        from torch.profiler import record_function

        from repro_torch.models import attention, layers
        from repro_torch.train import step as train_step_mod

        def wrap(fn, kind):
            def ranged(*a, **k):
                with record_function(kind):
                    return fn(*a, **k)
            return ranged

        self.sites = [(attention, "_flash_fwd", "flash_fwd"), (attention, "_flash_bwd", "flash_bwd"),
                      (train_step_mod, "apply_updates", "optimizer")]
        self.saved = [getattr(m, n) for m, n, _ in self.sites]
        for (m, n, kind), fn in zip(self.sites, self.saved):
            setattr(m, n, wrap(fn, kind))
        self.ce = layers._FusedCE
        self.ce_saved = (self.ce.forward, self.ce.backward)
        self.ce.forward = staticmethod(wrap(self.ce_saved[0], "fused_ce"))
        self.ce.backward = staticmethod(wrap(self.ce_saved[1], "fused_ce"))
        return self

    def __exit__(self, *exc):
        for (m, n, _), fn in zip(self.sites, self.saved):
            setattr(m, n, fn)
        self.ce.forward = staticmethod(self.ce_saved[0])
        self.ce.backward = staticmethod(self.ce_saved[1])


class save_log:
    """Within the block, each ``CheckpointManager`` save's seconds until
    ``save`` returned and until its ``_write`` (on the save thread) ended,
    and the codec kernels launched inside that ``_write`` (the training
    thread launches none of them), by step."""

    def __enter__(self):
        from repro_torch.checkpoint.manager import CheckpointManager

        self.cls, self.rows = CheckpointManager, {}
        self.save, self.write = CheckpointManager.save, CheckpointManager._write
        log_ = self

        def save(mgr, step, state, *, blocking=False):
            log_.rows[step] = {"t0": time.perf_counter()}
            log_.save(mgr, step, state, blocking=blocking)
            log_.rows[step]["return_s"] = time.perf_counter() - log_.rows[step]["t0"]

        def write(mgr, step, *a, **k):
            before = _path_launches()
            log_.write(mgr, step, *a, **k)
            after = _path_launches()
            row = log_.rows[step]
            row["disk_s"] = time.perf_counter() - row["t0"]
            row["launches"] = {n: after[n] - before[n] for n in after}

        CheckpointManager.save, CheckpointManager._write = save, write
        return self

    def __exit__(self, *exc):
        self.cls.save, self.cls._write = self.save, self.write


def _plane_entries(entries):
    """The entries the card's stages code (bf16 and f32 leaves)."""
    return {k: e for k, e in entries.items() if e["dtype"] in ("bfloat16", "float32")}


def save_plan(directory, step):
    """K3 and K7 launches of one save of the train state, from its blobs:
    one K3 launch a full leaf, one a window of each dtype's batched deltas
    (weights against the base, moments against the previous save), one K7
    launch a chunk cap of each leaf's Huffman chunks; and each kind's
    ratio (params and moments apart)."""
    from repro_torch.core.device_plane import MAX_BATCH_BYTES

    entries, data = checkpoint_entries(directory, step)
    plane = _plane_entries(entries)
    k3 = sum(e["kind"] == "full" for e in plane.values())
    for kind in ("delta", "delta_prev"):
        sizes: dict = {}
        for key in sorted(plane):
            if plane[key]["kind"] == kind:
                sizes.setdefault(plane[key]["dtype"], []).append(plane[key]["raw"])
        k3 += sum(k3_windows(g, MAX_BATCH_BYTES) for g in sizes.values())
    k7 = sum(k7_launches(read_blob(data, e)) for e in plane.values())
    ratio: dict = {}
    for key, e in entries.items():
        part = "moments" if key.startswith("opt/") else "params"
        r = ratio.setdefault(f"{part} {e['kind']}", [0, 0])
        r[0] += e["size"]
        r[1] += e["raw"]
    return ({"plane_producer": k3, "bitpack_encode_chunks": k7, "huffdecode_serial": 0,
             "plane_consumer": 0, "huffdecode_chain": 0},
            {k: round(100 * a / b, 4) for k, (a, b) in ratio.items()})


def decode_plan(cts):
    """K1 one-shot and K2 launches that decoding ``cts`` (a base's full
    blobs, or a manifest's leaves) in one batched call takes: one K1
    launch a leaf with Huffman chunks, one K2 launch a window of each
    layout's leaves."""
    from repro_torch.core.device_plane import MAX_BATCH_BYTES

    sizes: dict = {}
    for dtype, raw, _ in cts:
        sizes.setdefault(dtype, []).append(raw)
    return {"huffdecode_serial": sum(has_huff(blob) for _, _, blob in cts),
            "plane_consumer": sum(k3_windows(g, MAX_BATCH_BYTES) for g in sizes.values()),
            "huffdecode_chain": 0}


def check_plan(label, got, plan):
    bad = {k: (got.get(k, 0), n) for k, n in plan.items() if got.get(k, 0) != n}
    if bad:
        raise AssertionError(f"{label}: launches (got, plan) {bad}")


def same_tree(label, a, b, dev=None):
    """Raise unless two trees hold the same keys and bits (``a`` on ``dev``)."""
    import torch

    from repro_torch import _util

    ka, kb = _util.tree_flatten_with_keys(a), _util.tree_flatten_with_keys(b)
    if [k for k, _ in ka] != [k for k, _ in kb]:
        raise AssertionError(f"{label}: keys differ")
    for (k, x), (_, y) in zip(ka, kb):
        if not (x.dtype == y.dtype and x.shape == y.shape
                and (dev is None or x.device == dev)
                and torch.equal(bits(x.reshape(-1)), bits(y.reshape(-1).to(x.device)))):
            raise AssertionError(f"{label}: {k} differs")


def grad_gap(want, got):
    """Each leaf's largest gap over its largest ``want`` entry, floored at
    CARD_GRAD_FLOOR of the largest entry of any leaf; the largest and its
    leaf index."""
    want = [w.float() for w in want]
    top = max(float(w.abs().max()) for w in want)
    gaps = [float((w - g.float().cpu()).abs().max()) / max(float(w.abs().max()),
                                                           CARD_GRAD_FLOOR * top)
            for w, g in zip(want, got)]
    i = max(range(len(gaps)), key=gaps.__getitem__)
    return gaps[i], i


def hold_train_grads(dev, cfg):
    """One step's loss and gradients of ``cfg`` cut to TRAIN_HOLD_LAYERS
    layers (every width as published; ``init_train_state``'s params, gains
    1) on the card against the CPU at TRAIN_HOLD's ``make_batch`` batch:
    every leaf within CARD_GRAD_REL (``grad_gap``).  The same card step
    with attention not causal (another function) must go over it."""
    import dataclasses

    import torch

    from repro_torch import _util
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.models import attention
    from repro_torch.train import init_train_state, loss_and_grads

    small = dataclasses.replace(cfg, n_layers=TRAIN_HOLD_LAYERS)
    B, S = TRAIN_HOLD
    host = init_train_state(small, SEED + 90, device="cpu")["params"]
    card = _util.tree_map(lambda t: t.to(dev), host)
    hb = make_batch(small, DataConfig(S, B), 0, device="cpu")
    cb = {k: v.to(dev) for k, v in hb.items()}
    t0 = time.perf_counter()
    lh, _, gh = loss_and_grads(small, host, hb)
    t_cpu = time.perf_counter() - t0
    lc, _, gc = loss_and_grads(small, card, cb)
    real = attention._attend
    attention._attend = lambda q, k, v, c, *, causal: real(q, k, v, c, causal=not causal)
    try:
        lx, _, gx = loss_and_grads(small, card, cb)
    finally:
        attention._attend = real
    keys = [k for k, _ in _util.tree_flatten_with_keys(host)]
    want = _util.tree_leaves(gh)
    if not all(torch.isfinite(g).all() for g in _util.tree_leaves(gc)):
        raise AssertionError("train hold: a card gradient is not finite")
    gap, i = grad_gap(want, _util.tree_leaves(gc))
    ctl, j = grad_gap(want, _util.tree_leaves(gx))
    row = {"B": B, "S": S, "layers": TRAIN_HOLD_LAYERS, "loss_cpu": float(lh),
           "loss_card": float(lc), "loss_gap_rel": abs(float(lc) - float(lh)) / float(lh),
           "max_grad_gap_rel": gap, "worst_leaf": keys[i], "control_loss": float(lx),
           "control_max_grad_gap_rel": ctl, "control_worst_leaf": keys[j], "cpu_s": t_cpu}
    log(f"train, card against the CPU ({TRAIN_HOLD_LAYERS} of {cfg.n_layers} layers at full "
        f"width; each leaf's gradient within {CARD_GRAD_REL} of its largest CPU entry, floored "
        f"at {CARD_GRAD_FLOOR} of the largest; the non-causal control must go over): "
        + json.dumps(row))
    if ctl <= CARD_GRAD_REL:
        raise AssertionError(f"train hold: the control passes: {row}")
    if gap > CARD_GRAD_REL:
        raise AssertionError(f"train hold: the card's gradients differ from the CPU's: {row}")
    return row


def profile_train_step(dev, cfg, step_fn, state, batch):
    """One ``torch.profiler`` run over one train step (ended by a
    synchronize): device ms by kind (TRAIN_KINDS; matmuls are the GEMM
    kernels outside the named ranges) and the idle share.  Raises where a
    range holds no device time.  Trace: build/train_step_trace.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with train_ranges(), profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
        with record_function("train_step"):
            state, _ = step_fn(state, batch)
            torch.cuda.synchronize()
    out = trace_split(prof, "train_step_trace.json", TRAIN_KINDS, "train_step", "train step")
    empty = [k for k in TRAIN_KINDS if k != "rest" and not out["device_ms"][k]]
    if empty:
        raise AssertionError(f"train step trace: no device time under {empty}")
    log("train step under the profiler: " + json.dumps(out))
    return out, state


def phase_grad_sync(dev, zcfg, cfg, params, batch):
    """``GradSync`` on one real step's gradients at full width: ``pack`` on
    the card (K3 a window, K7 a chunk cap a leaf, against the plan from the
    blobs) and ``unpack`` back onto the card (K1's one-shot decode, K2)
    bit for bit; layers 0-1 of the stacks (cut to bound the host's time)
    packed on the card and on the host give equal blobs."""
    import torch

    from repro_torch import _util
    from repro_torch.core.device_plane import MAX_BATCH_BYTES
    from repro_torch.core.options import CodecOptions
    from repro_torch.distributed import GradSync
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.train import loss_and_grads

    _, _, grads = loss_and_grads(cfg, params, batch)
    opts = CodecOptions(threads=-1, backend="device", device_resident=True)
    gs = GradSync(zcfg, options=opts, device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    manifest, st = gs.pack(grads)
    pack_launches = _path_launches()
    reset_launch_counts()
    t0 = time.perf_counter()
    back = gs.unpack(manifest)
    torch.cuda.synchronize()
    t_unpack = time.perf_counter() - t0
    unpack_launches = _path_launches()
    same_tree("GradSync round trip", back, grads, dev)
    cts = manifest["leaves"]
    sizes: dict = {}
    for ct, g in zip(cts, _util.tree_leaves(grads)):
        sizes.setdefault(ct.dtype, []).append(g.numel() * g.element_size())
    check_plan("GradSync.pack", pack_launches, {
        "plane_producer": sum(k3_windows(v, MAX_BATCH_BYTES) for v in sizes.values()),
        "bitpack_encode_chunks": sum(k7_launches(ct.blob) for ct in cts),
        "huffdecode_serial": 0, "plane_consumer": 0, "huffdecode_chain": 0})
    check_plan("GradSync.unpack", unpack_launches, decode_plan(
        [(ct.dtype, g.numel() * g.element_size(), ct.blob)
         for ct, g in zip(cts, _util.tree_leaves(grads))]))
    cut = {"layers": _util.tree_map(lambda t: t[:2].clone(), grads["layers"])}
    card_blobs = [c.blob for c in GradSync(zcfg, options=opts, device=dev).pack(cut)[0]["leaves"]]
    t0 = time.perf_counter()
    host_m, _ = GradSync(zcfg, options=CodecOptions(threads=-1, backend="host"),
                         device="cpu").pack(_util.tree_map(lambda t: t.cpu(), cut))
    t_host = time.perf_counter() - t0
    if card_blobs != [c.blob for c in host_m["leaves"]]:
        raise AssertionError("GradSync: layers 0-1 packed on the card differ from the host's")
    out = {"raw_bytes": st.raw_bytes, "comp_bytes": st.comp_bytes, "ratio_pct": st.ratio_pct,
           "pack_s": st.seconds_compress, "unpack_s": t_unpack, "pack_launches": pack_launches,
           "unpack_launches": unpack_launches, "host_pack_layers_0_1_s": t_host}
    log("GradSync of one step's gradients on the card (bit-exact round trip; layers 0-1 "
        "equal to the host's blobs): " + json.dumps(out))
    return out


def olmoe_train_step(dev):
    """olmoe_1b_7b at its published widths cut in depth to
    OLMOE_TRAIN_LAYERS of its 16 layers (the whole model's bf16 params, f32
    moments and gradients, ~83 GB, do not fit one card): one step at
    OLMOE_TRAIN's batch with the fused CE at vocab 50,304 and the capacity
    factor 1.25, so the dispatch and combine backward run at full width.
    Two runs of the step's gradients must be equal bit for bit and finite;
    then the AdamW update."""
    import dataclasses

    import torch

    from repro_torch import _util
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.models import moe
    from repro_torch.optim import AdamWConfig, apply_updates
    from repro_torch.train import init_train_state, loss_and_grads

    free_card()
    cfg = dataclasses.replace(get_config("olmoe_1b_7b"), n_layers=OLMOE_TRAIN_LAYERS)
    state = init_train_state(cfg, SEED + 91, device=dev)
    n_params = sum(t.numel() for t in _util.tree_leaves(state["params"]))
    state_bytes = sum(t.numel() * t.element_size() for t in _util.tree_leaves(state))
    B, S = OLMOE_TRAIN
    batch = make_batch(cfg, DataConfig(S, B), 0, device=dev)
    calls = {"dispatch": 0, "combine": 0}
    saved = (moe._Dispatch.backward, moe._Combine.backward)

    def counted(fn, name):
        def run(ctx, g):
            calls[name] += 1
            return fn(ctx, g)
        return staticmethod(run)

    moe._Dispatch.backward = counted(saved[0], "dispatch")
    moe._Combine.backward = counted(saved[1], "combine")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        loss, metrics, g1 = loss_and_grads(cfg, state["params"], batch)
        torch.cuda.synchronize()
        t_step = time.perf_counter() - t0
        _, _, g2 = loss_and_grads(cfg, state["params"], batch)
    finally:
        moe._Dispatch.backward, moe._Combine.backward = (staticmethod(f) for f in saved)
    if calls["dispatch"] < 2 * cfg.n_layers or calls["combine"] < 2 * cfg.n_layers:
        raise AssertionError(f"olmoe train: the MoE backward passes ran {calls}")
    if not torch.isfinite(loss) or not all(torch.isfinite(g).all()
                                           for g in _util.tree_leaves(g1)):
        raise AssertionError("olmoe train: loss or gradients not finite")
    same_tree("olmoe train: two runs of the step's gradients", g1, g2)
    del g2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    apply_updates(AdamWConfig(), state["params"], g1, state["opt"], state["step"])
    torch.cuda.synchronize()
    out = {"layers": cfg.n_layers, "params": n_params, "train_state_bytes": state_bytes,
           "B": B, "S": S, "loss": float(loss), "aux": float(metrics["aux"]),
           "loss_and_grads_s": t_step, "adamw_s": time.perf_counter() - t0,
           "backward_calls": calls, "peak_card_bytes": torch.cuda.max_memory_allocated(dev)}
    log(f"olmoe_1b_7b train step ({cfg.n_layers} of 16 layers at full width; two runs' "
        "gradients bit-identical and finite): " + json.dumps(out))
    del state, g1
    free_card()
    return out


def phase_train(dev, zcfg):
    """repro_gpt_100m trained whole at its published size through
    ``repro_torch.launch.train.main`` (B=8 x S=2,048, random weights from a
    seed), with ZipNN checkpoints saved on the card (K3, K7) every 4 steps
    (a base, a delta, a base), resumed in a second ``main`` on the card
    (K1's one-shot decode, K2); then the card-against-CPU gradient hold,
    ``GradSync`` on a real step's gradients, and one olmoe_1b_7b step.
    Both ``main`` calls run in this process: ``data.make_batch`` seeds with
    ``hash(cfg.name)``, which Python salts per process, so only one process
    sees the same batches twice."""
    import shutil

    import torch

    from repro_torch import _util
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.options import CodecOptions
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step

    free_card()
    t_start = time.perf_counter()
    cfg = get_config("repro_gpt_100m")
    N, M, B, S = TRAIN_STEPS, TRAIN_MORE, TRAIN_B, TRAIN_S
    opts = CodecOptions(threads=-1, backend="device")
    work = os.path.join(ROOT, "build", "chip_train_ckpt")
    shutil.rmtree(work, ignore_errors=True)
    argv = ["--arch", cfg.name, "--batch", str(B), "--seq", str(S), "--lr", str(TRAIN_LR),
            "--ckpt-dir", work, "--ckpt-every", "4", "--base-every", "2", "--log-every", "1",
            "--device", str(dev)]
    out = {"launches": {}}
    try:
        state: dict = {}
        reset_launch_counts()
        with save_log() as saves:
            first = launch_train.main(argv + ["--steps", str(N)], zipnn_config=zcfg,
                                      options=opts, state_out=state)
            torch.cuda.synchronize()
        add_launches(out["launches"], _path_launches())
        losses = first["losses"]
        lo, hi = 0.5 * math.log(cfg.vocab_size), 2.5 * math.log(cfg.vocab_size)
        if not (lo <= losses[0] <= hi and losses[-1] < losses[0]
                and all(math.isfinite(x) for x in losses)):
            raise AssertionError(f"train: losses {losses} (step 1 must lie in "
                                 f"[{lo:.3f}, {hi:.3f}] and the loss fall)")
        saved_steps = sorted(saves.rows)
        if saved_steps != [4, 8, 12]:
            raise AssertionError(f"train: saves at {saved_steps}")
        out["saves"] = {}
        for st in saved_steps:
            plan, ratio = save_plan(work, st)
            check_plan(f"train save at step {st}", saves.rows[st]["launches"], plan)
            out["saves"][st] = {"kind": checkpoint_kind(work, st), "return_s":
                                saves.rows[st]["return_s"], "disk_s": saves.rows[st]["disk_s"],
                                "launches": plan, "ratio_pct_by_kind": ratio}
        out["first_run"] = {k: first[k] for k in ("losses", "tokens_per_s", "ckpt")}
        log(f"train: {N} steps of repro_gpt_100m at B={B} S={S} through launch.train, losses "
            f"{losses}; saves on the card (seconds to return and to disk, K3/K7 launches equal "
            f"to the plan from the blobs, ratio by kind): " + json.dumps(out["saves"]))

        # the restored state equals the saved one bit for bit
        mgr = CheckpointManager(CheckpointConfig(work, zipnn=zcfg, device=dev))
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        step, tree = mgr.restore(device_resident=True)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        restore_launches = _path_launches()
        add_launches(out["launches"], restore_launches)
        if step != N or int(tree["step"]) != N:
            raise AssertionError(f"train restore: step {step}, state step {int(tree['step'])}")
        same_tree("train restore", tree, state, dev)
        del tree
        entries, data = checkpoint_entries(work, N)
        check_plan("train restore", restore_launches, decode_plan(
            [(e["dtype"], e["raw"], read_blob(data, e)) for e in _plane_entries(entries).values()]))
        out["restore"] = {"seconds": t_restore, "launches": restore_launches}

        # the uninterrupted run: the in-memory state N steps on, 4 more steps
        ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=max((N + M) // 20, 2), total_steps=N + M)
        step_fn = make_train_step(cfg, ocfg)
        dc = DataConfig(seq_len=S, global_batch=B)
        cont, times = [], []
        state_bytes = sum(t.numel() * t.element_size() for t in _util.tree_leaves(state))
        for i in range(N, N + M):
            batch = make_batch(cfg, dc, i, device=dev)
            torch.cuda.synchronize()
            if i == N + 1:
                torch.cuda.reset_peak_memory_stats(dev)
                resident = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if i == N + 1:
                peak = torch.cuda.max_memory_allocated(dev)
            cont.append(float(metrics["loss"]))
        step_s = sorted(times[1:])[len(times[1:]) // 2]
        out["step"] = {"B": B, "S": S, "seconds": times, "median_s": step_s,
                       "tokens_per_s": B * S / step_s, "train_state_bytes": state_bytes,
                       "resident_bytes": resident, "peak_card_bytes": peak}
        log(f"train step B={B} S={S}: median {step_s:.4f} s of steps {N + 2}-{N + M} "
            f"({B * S / step_s:.1f} tokens/s); train state {state_bytes} B, {resident} B "
            f"resident before the step, card peak {peak} B")
        batch = make_batch(cfg, dc, N + M, device=dev)
        out["profile"], state = profile_train_step(dev, cfg, step_fn, state, batch)
        out["grad_sync"] = phase_grad_sync(dev, zcfg, cfg, state["params"], batch)
        add_launches(out["launches"], out["grad_sync"]["pack_launches"])
        add_launches(out["launches"], out["grad_sync"]["unpack_launches"])
        del state, batch
        free_card()

        # the resumed run: a second main on the same directory to N + 4
        reset_launch_counts()
        second = launch_train.main(argv + ["--steps", str(N + M)], zipnn_config=zcfg,
                                   options=opts)
        torch.cuda.synchronize()
        resume_launches = _path_launches()
        add_launches(out["launches"], resume_launches)
        if second["start"] != N or len(second["losses"]) != M:
            raise AssertionError(f"train resume: started at {second['start']}, "
                                 f"{len(second['losses'])} steps")
        res = second["losses"]
        identical = res == cont
        worst = max(abs(a - b) / abs(b) for a, b in zip(res, cont))
        out["resume"] = {"seconds": second["resume_s"], "losses": res, "uninterrupted": cont,
                         "bit_identical": identical, "max_rel_gap": worst,
                         "launches": resume_launches, "ckpt": second["ckpt"]}
        log(f"train resume: main restored step {N} in {second['resume_s']:.3f} s and ran steps "
            f"{N + 1}-{N + M}: losses {res}; the uninterrupted run's {cont}; bit-identical "
            f"{identical}, largest gap {worst:.3e} of the loss")
        if worst > 1e-6:
            raise AssertionError(f"train resume: losses {res} against {cont}")
        for k in ("huffdecode_serial", "plane_consumer", "plane_producer",
                  "bitpack_encode_chunks"):
            if not resume_launches[k]:
                raise AssertionError(f"train resume: {k} never launched")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    free_card()
    out["hold"] = hold_train_grads(dev, cfg)
    out["olmoe"] = olmoe_train_step(dev)
    out["phase_s"] = time.perf_counter() - t_start
    log(f"train phase: {out['phase_s']:.1f} s; launches on its paths {out['launches']}")
    return out


def checkpoint_kind(directory, step):
    with open(os.path.join(directory, f"step_{step}", "manifest.json")) as f:
        return json.load(f)["kind"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # fails outside a checkout of the repository: nothing else is importable
    from repro_torch.configs import get_config
    from repro_torch.core import zipnn
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.huffdecode import SYNC_EVERY

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
    phase_k7_sync_free(dev)
    phase_small_reference(dev)
    zcfg = zipnn.ZipNNConfig(backend="huffman")
    store, params, launches, per_step, n_steps, build_launches, build_plan, k2_paths = phase_main(
        dev, get_config("repro_gpt_100m"), zcfg
    )
    k1_leaves = check_k1_leaves(store, dev)
    ring = profile_ring(dev, get_config("repro_gpt_100m"), store)
    k1 = measure_k1(store, dev)
    k2 = measure_k2(dev)
    del store
    news = phase_delta(dev, zcfg, params)
    ops_errs = phase_ops(dev)
    ops_launches = phase_ops_path(dev, get_config("repro_gpt_100m"), params, news)
    del news
    # this slice's path: the statistics over the 108 leaves, the baselines
    stats_ph = phase_stats(dev, get_config("repro_gpt_100m"), params, zcfg)
    phase_fp32(dev, zcfg, params)
    k3_rows = measure_k3(dev, params)
    k3 = k3_rows["bf16"]
    k7 = measure_k7(dev)
    ops_rows = measure_ops(dev)
    # this slice's paths: the ZNS1 file engine and checkpoints, full width
    files = phase_file(dev, zcfg, params)
    ckpt = phase_checkpoint(dev, zcfg, params)
    del params
    # this slice's path: granite_20b at its published widths, tiles, KV tier
    granite = phase_granite(dev, zcfg)
    gk, gl = granite["kernels"], granite["launches"]
    # this slice's paths: the MoE family, olmoe_1b_7b whole and
    # deepseek_v2_236b at its published widths
    moe = {"olmoe": phase_olmoe(dev, zcfg), "deepseek": phase_deepseek(dev, zcfg)}
    for label, ph in moe.items():
        need = ["plane_producer", "bitpack_encode_chunks", "huffdecode_index",
                "huffdecode_chunks", "plane_consumer"]
        if "kv" in ph:
            need.append("huffdecode_serial")
        idle = [k for k in need if not ph["launches"].get(k)]
        if idle:
            raise AssertionError(f"{label}: kernels of the path never launched: {idle}")
    # this slice's paths: the SSM family (mamba2_130m whole, served by the
    # ring) and the hybrid (zamba2_7b whole, from a checkpoint on the card)
    ssm = {"mamba2": phase_mamba2(dev, zcfg), "zamba2": phase_zamba2(dev, zcfg)}
    for label, need in (("mamba2", ["plane_producer", "bitpack_encode_chunks",
                                    "huffdecode_index", "huffdecode_chunks", "plane_consumer"]),
                        ("zamba2", ["plane_producer", "bitpack_encode_chunks",
                                    "huffdecode_serial", "plane_consumer"])):
        idle = [k for k in need if not ssm[label]["launches"].get(k)]
        if idle:
            raise AssertionError(f"{label}: kernels of the path never launched: {idle}")
    # this slice's paths: the VLM family (qwen2_vl_2b whole, served by the
    # ring) and the audio family (hubert_xlarge whole, f32, from a
    # checkpoint saved and restored on the card)
    front = {"qwen2_vl": phase_qwen2_vl(dev, zcfg), "hubert": phase_hubert(dev, zcfg)}
    for label, need in (("qwen2_vl", ["plane_producer", "bitpack_encode_chunks",
                                      "huffdecode_index", "huffdecode_chunks", "plane_consumer"]),
                        ("hubert", ["plane_producer", "bitpack_encode_chunks",
                                    "huffdecode_serial", "plane_consumer"])):
        idle = [k for k in need if not front[label]["launches"].get(k)]
        if idle:
            raise AssertionError(f"{label}: kernels of the path never launched: {idle}")
        if front[label]["launches"].get("huffdecode_chain"):
            raise AssertionError(f"{label}: the path launched K1's chain baseline")
    # this slice's path: training (repro_gpt_100m whole through launch.train
    # with checkpoints saved and resumed on the card, GradSync; olmoe's step)
    train = phase_train(dev, zcfg)
    tl = train["launches"]
    idle = [k for k in ("plane_producer", "bitpack_encode_chunks", "huffdecode_serial",
                        "plane_consumer") if not tl.get(k)]
    if idle:
        raise AssertionError(f"train: kernels of the path never launched: {idle}")
    if tl.get("huffdecode_chain"):
        raise AssertionError("train: the path launched K1's chain baseline")
    reset_launch_counts()

    def train_rows(counter):
        """A kernel's launches on the train path: each save, the restore,
        the resumed run (its restore and save), GradSync's pack and unpack."""
        return {"launches": tl.get(counter, 0),
                "saves": {st: r["launches"][counter] for st, r in train["saves"].items()},
                "restore": train["restore"]["launches"][counter],
                "resumed_run": train["resume"]["launches"][counter],
                "grad_sync_pack": train["grad_sync"]["pack_launches"][counter],
                "grad_sync_unpack": train["grad_sync"]["unpack_launches"][counter]}

    def moe_rows(k, counter):
        """Kernel ``k``'s readings and launches on the two MoE paths."""
        return {label: {"launches": ph["launches"].get(counter, 0),
                        "expert": ph["kernels"]["expert"][k],
                        "router": ph["kernels"]["router"][k]} for label, ph in moe.items()}

    def ssm_rows(k, counter):
        """Kernel ``k``'s readings and launches on the SSM and hybrid paths
        (readings at ``in_proj``, and K2's at mamba2's f32 ``A_log``)."""
        return {label: dict({leaf: r[k] for leaf, r in ph["kernels"].items() if k in r},
                            launches=ph["launches"].get(counter, 0))
                for label, ph in ssm.items()}

    serial_keys = ("seg_bits", "rounds", "index_pass", "one_shot")

    def k1_sync(r):
        """A leaf's K1 reading without its self-synchronising forms."""
        return {k: v for k, v in r.items() if k not in serial_keys}

    def k1_serial(r, launches):
        """A leaf's self-synchronising readings, with a path's launches."""
        return dict({k: r[k] for k in serial_keys},
                    index_pass_launches=launches.get("huffdecode_index", 0),
                    one_shot_launches=launches.get("huffdecode_serial", 0))

    def front_rows(k, counter):
        """Kernel ``k``'s readings and launches on the vlm and audio paths
        (qwen2_vl's ``w_gate`` layer leaf, bf16; hubert's ``w_in`` stack,
        f32)."""
        return {label: dict({leaf: r[k] for leaf, r in ph["kernels"].items()},
                            launches=ph["launches"].get(counter, 0))
                for label, ph in front.items()}

    k1_moe = moe_rows("K1", "huffdecode_chunks")
    k1_ssm = ssm_rows("K1", "huffdecode_chunks")
    sf = k1["serial_forms"]
    # Every row's ms is device_ms (L2 evicted before each call) and its
    # kernel_ms_profiler the kernel's device time alone.
    no_library = "no single PyTorch call computes it"
    kernels = [
        {"name": "huffdecode_chunks", "route": "cuda",
         "source": "src/repro_torch/csrc/huffdecode.cu",
         "replaces": "src/repro/kernels/huffdecode.py:92",
         "launches": launches["huffdecode_chunks"],
         "launches_per_step": per_step["huffdecode_chunks"], "max_abs_err": k1_err,
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": None, "library": no_library,
         "kernel_ms_profiler": k1["kernel_ms_profiler"], "sync_every": SYNC_EVERY,
         "leaves_checked": k1_leaves, "sync_every_sweep": k1["sweep"], "ring_trace": ring,
         "granite": dict(k1_sync(gk["K1"]), launches=gl["huffdecode_chunks"], shape=W_IN),
         "moe": {label: dict(r, expert=k1_sync(r["expert"]), router=k1_sync(r["router"]))
                 for label, r in k1_moe.items()},
         "ssm": {label: {k: (k1_sync(v) if isinstance(v, dict) else v) for k, v in r.items()}
                 for label, r in k1_ssm.items()},
         "vlm_audio": {label: {k: (k1_sync(v) if isinstance(v, dict) else v)
                               for k, v in r.items()}
                       for label, r in front_rows("K1", "huffdecode_chunks").items()}},
        # The same source's self-synchronising kernel: the main path runs it
        # once a Huffman leaf at the store build (the index pass); the file
        # and checkpoint paths, deltas and the KV tier run its one-shot form.
        # Its readings are the index pass's, with the one-shot form and the
        # chain baseline (one thread a chunk, no path launches it) beside.
        {"name": "huffdecode_selfsync", "route": "cuda",
         "source": "src/repro_torch/csrc/huffdecode.cu",
         "replaces": "src/repro/kernels/huffdecode.py:92",
         "launches": build_launches["huffdecode_index"],
         "launches_per_build": build_plan["huffdecode_index"], "max_abs_err": k1_err,
         "ms": sf["index_pass"]["ms"], "plain_ms": sf["index_pass"]["plain_ms"],
         "bound_ms": sf["index_pass"]["bound_ms"], "bound_by": sf["index_pass"]["bound_by"],
         "library_ms": None, "library": no_library,
         "kernel_ms_profiler": sf["index_pass"]["kernel_ms_profiler"],
         "seg_bits": sf["seg_bits"], "rounds": sf["rounds"],
         "index_pass": sf["index_pass"],
         "one_shot": dict(sf["one_shot"], launches_file=files["launches"]["huffdecode_serial"],
                          launches_checkpoint_restore=ckpt["restore_launches"][
                              "huffdecode_serial"],
                          launches_restore_then_prefill=ckpt["prefill_launches"][
                              "huffdecode_serial"],
                          launches_shard_restore=ckpt["shard_restore"]["launches"][
                              "huffdecode_serial"]),
         "seg_bits_sweep": k1["seg_sweep"], "seg_bits_fastest": k1["seg_fastest"],
         "granite": dict(k1_serial(gk["K1"], gl), shape=W_IN),
         "moe": {label: {leaf: k1_serial(moe[label]["kernels"][leaf]["K1"],
                                         moe[label]["launches"])
                         for leaf in ("expert", "router")} for label in moe},
         "ssm": {label: {leaf: k1_serial(r["K1"], ssm[label]["launches"])
                         for leaf, r in ssm[label]["kernels"].items() if "K1" in r}
                 for label in ssm},
         "vlm_audio": {label: {leaf: k1_serial(r["K1"], front[label]["launches"])
                               for leaf, r in front[label]["kernels"].items()}
                       for label in front},
         "train": train_rows("huffdecode_serial")},
        {"name": "plane_consumer", "route": "cuda",
         "source": "src/repro_torch/csrc/unplane.cu",
         "replaces": "src/repro/kernels/fused_unplane.py:83",
         "launches": launches["plane_consumer"],
         "launches_per_step": per_step["plane_consumer"], "max_abs_err": k2_err,
         "ms": k2[0], "plain_ms": k2[1], "bound_ms": k2[2], "bound_by": k2[3],
         "library_ms": None, "library": no_library, "kernel_ms_profiler": k2[4], "path": k2[5],
         "launches_by_path": k2_paths,
         "launches_file": files["launches"]["plane_consumer"],
         "launches_checkpoint_restore": ckpt["restore_launches"]["plane_consumer"],
         "launches_restore_then_prefill": ckpt["prefill_launches"]["plane_consumer"],
         "launches_shard_restore": ckpt["shard_restore"]["launches"]["plane_consumer"],
         "granite": dict(gk["K2"], launches=gl["plane_consumer"], shape=W_IN),
         "moe": moe_rows("K2", "plane_consumer"), "ssm": ssm_rows("K2", "plane_consumer"),
         "vlm_audio": front_rows("K2", "plane_consumer"), "train": train_rows("plane_consumer")},
        {"name": "plane_producer", "route": "cuda",
         "source": "src/repro_torch/csrc/plane.cu",
         "replaces": "src/repro/kernels/fused_plane.py:52",
         "launches": build_launches["plane_producer"],
         "launches_per_build": build_plan["plane_producer"], "max_abs_err": k3_err,
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None, "library": no_library,
         "kernel_ms_profiler": k3["kernel_ms_profiler"], "variants": k3_rows,
         "launches_file": files["launches"]["plane_producer"],
         "launches_checkpoint_save": ckpt["save_launches"]["plane_producer"],
         "granite": dict(gk["K3"], launches=gl["plane_producer"], shape=W_IN),
         "moe": moe_rows("K3", "plane_producer"), "ssm": ssm_rows("K3", "plane_producer"),
         "vlm_audio": front_rows("K3", "plane_producer"), "train": train_rows("plane_producer")},
        {"name": "bitpack_encode_chunks", "route": "cuda",
         "source": "src/repro_torch/csrc/bitpack.cu",
         "replaces": "src/repro/kernels/bitpack.py:116",
         "launches": build_launches["bitpack_encode_chunks"],
         "launches_per_build": build_plan["bitpack_encode_chunks"], "max_abs_err": k7_err,
         "ms": k7[0], "plain_ms": k7[1], "bound_ms": k7[2], "bound_by": k7[3],
         "library_ms": None, "library": no_library, "kernel_ms_profiler": k7[4],
         "launches_file": files["launches"]["bitpack_encode_chunks"],
         "launches_checkpoint_save": ckpt["save_launches"]["bitpack_encode_chunks"],
         "granite": dict(gk["K7"], launches=gl["bitpack_encode_chunks"], shape=W_IN),
         "moe": moe_rows("K7", "bitpack_encode_chunks"),
         "ssm": ssm_rows("K7", "bitpack_encode_chunks"),
         "vlm_audio": front_rows("K7", "bitpack_encode_chunks"),
         "train": train_rows("bitpack_encode_chunks")},
    ]
    # The ops kernels: launches are those of the ops path over the 108
    # leaves; times from measure_ops (K4/K11 list both widths, K5 both
    # operand widths; the top-level numbers are the first variant's).
    for name, source, replaces, variants, library in (
        ("bytegroup", "bytegroup.cu", ("bytegroup.py:63", "bytegroup.py:90"),
         ("K4 bf16", "K4 fp32"), None),
        ("xor_elems", "xor_delta.cu", ("xor_delta.py:39",), ("K5 u16", "K5 u32"),
         "torch.bitwise_xor"),
        ("chunk_histogram", "histogram.cu", ("histogram.py:74",), ("K6",), None),
        ("bitpack_encode_chunks_single", "bitpack.cu", ("bitpack.py:78",), ("K8",), None),
        ("byte_histogram", "histogram.cu", ("histogram.py:41",), ("K9",),
         "torch.bincount(x, minlength=256)"),
        ("xor_delta_u32", "xor_delta.cu", ("xor_delta.py:59",), ("K10",), None),
        ("ungroup", "unplane.cu", ("bytegroup.py:77", "bytegroup.py:104"),
         ("K11 bf16", "K11 fp32"), None),
    ):
        first = ops_rows[variants[0]]
        counters = {"bytegroup": ("bytegroup_bf16", "bytegroup_fp32"),
                    "ungroup": ("ungroup_bf16", "ungroup_fp32")}.get(name, (name,))
        entry = {
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces[0]}",
            "launches": sum(ops_launches.get(k, 0) for k in counters),
            "max_abs_err": ops_errs[name],
            "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"],
            "library": library or no_library,
            "kernel_ms_profiler": first["kernel_ms_profiler"],
            "library_kernel_ms_profiler": first["library_kernel_ms_profiler"],
        }
        if name in ("bytegroup", "byte_histogram"):     # the stats path's launches
            entry["launches_stats"] = sum(stats_ph["launches"].get(k, 0) for k in counters)
            entry["launches_stats_plan"] = sum(stats_ph["plan"].get(k, 0) for k in counters)
        if len(variants) > 1:
            entry["variants"] = {v: ops_rows[v] for v in variants}
        if len(replaces) > 1:
            entry["replaces_also"] = [f"src/repro/kernels/{r}" for r in replaces[1:]]
        kernels.append(entry)
    for label, ph in list(moe.items()) + list(ssm.items()) + list(front.items()):
        log(f"{label} summary: " + json.dumps({k: v for k, v in ph.items()
                                               if k not in ("kernels", "trace", "prefill")}))
    prefills = dict({"repro_gpt_100m": ckpt["prefill"], "granite": granite["prefill"]},
                    **{label: ph["prefill"] for label, ph in list(moe.items())
                       + list(ssm.items()) + list(front.items())})
    log("prefill summary (tokens/s, card peak bytes, device ms by kind, idle share): "
        + json.dumps({label: {"B": p["timed"]["B"], "S": p["timed"]["S"],
                              "tokens_per_s": p["timed"]["tokens_per_s"],
                              "peak_card_bytes": p["timed"]["peak_card_bytes"],
                              "device_ms": p["timed"]["profile"]["device_ms"],
                              "idle": p["timed"]["profile"]["idle"],
                              "hold_max_gap_rel": p["hold"]["max_gap_rel"],
                              "control_max_gap_rel": (p["hold"]["control"]["max_gap_rel"]
                                                      if "control" in p["hold"] else
                                                      p["hold"]["control_max_gap_rel"])}
                      for label, p in prefills.items()}))
    log("train summary: " + json.dumps({
        "tokens_per_s": train["step"]["tokens_per_s"], "step": train["step"],
        "device_ms": train["profile"]["device_ms"], "idle": train["profile"]["idle"],
        "saves": train["saves"], "restore_s": train["restore"]["seconds"],
        "resume": {k: train["resume"][k] for k in ("seconds", "bit_identical", "max_rel_gap")},
        "first_losses": train["first_run"]["losses"], "grad_sync": train["grad_sync"],
        "hold": train["hold"], "olmoe": train["olmoe"], "phase_s": train["phase_s"]}))
    log("stats and shard_restore summary: " + json.dumps({
        "stats": {k: v for k, v in stats_ph.items() if k != "baselines"},
        "baselines_ratio_compress_decompress_mb_s": stats_ph["baselines"],
        "shard_restore": ckpt["shard_restore"]}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
