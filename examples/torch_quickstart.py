"""Quickstart on the PyTorch port: compress a model with ZipNN on the card,
check that it is lossless, see where the savings come from, then serve it
compressed-resident.

    PYTHONPATH=src python examples/torch_quickstart.py            # on a card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The card runs the paper's four device kernels here: the plane producer
(K3) and the Huffman bit-pack (K7) when it encodes, the Huffman decoder
(K1) and the plane consumer (K2) when it decodes.  On the CPU the same
calls run each kernel's plain PyTorch version.  ``main`` returns each
section's kernel launches beside the plan it expects for them.
"""

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import device_entropy, stats, zipnn
from repro_torch.core.options import CodecOptions, ZipNNSession
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import model
from repro_torch.serve import (CompressedParamStore, KVCacheStore, make_compressed_serve_step,
                               make_kv_tiered_serve_step)

ENCODE = ("plane_producer", "bitpack_encode_chunks")      # K3, K7
DECODE = ("huffdecode_serial", "plane_consumer")          # K1 one-shot, K2
RING = ("huffdecode_chunks", "plane_consumer")            # K1 from the feed, K2


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-exact: the same bytes."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8).cpu(), b.reshape(-1).view(torch.uint8).cpu())


def _k7_plan(blob: bytes) -> int:
    """K7 launches of encoding ``blob``'s leaf on the card: its Huffman
    chunks, at most ``MAX_BATCH_BYTES // (2 * chunk bytes)`` a launch."""
    from repro_torch.core import codec, container
    from repro_torch.core.device_plane import MAX_BATCH_BYTES

    meta, _ = container.unpack_stream(blob)
    huff = sum(e.method == codec.Method.HUFF for pe in meta.entries for e in pe)
    per_launch = max(1, MAX_BATCH_BYTES // (2 * meta.chunk_bytes))
    return -(-huff // per_launch)


def _section(launches, name, kernels):
    counts = launch_counts()
    launches[name] = {k: counts[k] for k in kernels}
    reset_launch_counts()


def main(device: str = "cuda") -> dict:
    dev = torch.device(device)
    launches, plan = {}, {}
    reset_launch_counts()

    # 1. A real (reduced) model from the zoo, on the device
    cfg = get_config("yi_6b").reduced()
    params = model.init_params(cfg, seed=0, device=dev)

    # 2. Compress the whole tree (the host codec) and check it is lossless
    manifest = zipnn.compress_pytree(params, device=dev)
    print(f"raw   : {manifest['raw_bytes'] / 1e6:8.2f} MB")
    print(f"zipnn : {manifest['comp_bytes'] / 1e6:8.2f} MB "
          f"({100 * manifest['comp_bytes'] / manifest['raw_bytes']:.1f}% — "
          "paper BF16 models: ~66%)")
    back = zipnn.decompress_pytree(manifest, device=dev)
    from repro_torch import _util

    for a, b in zip(_util.tree_leaves(params), _util.tree_leaves(back)):
        assert _same(a, b)
    print("round-trip: bit-exact ✓")
    reset_launch_counts()

    # 3. Why it compresses: the exponent byte is skewed (paper Fig. 2)
    w = params["layers"]["mlp"]["w_gate"]
    h = stats.exponent_histogram(w, device=dev)
    print(f"exponent: {h['distinct_values']} distinct values, "
          f"top-12 cover {100 * h['top12_mass']:.2f}% of weights")
    rep = stats.plane_report(w, device=dev)
    print(f"plane entropies (bits/byte): exponent={rep[0]['entropy_bits']:.2f} "
          f"fraction={rep[1]['entropy_bits']:.2f}  → only the exponent compresses")
    reset_launch_counts()

    # 4. Delta compression (paper §4.2): a fine-tuning step away
    w2 = w.to(torch.float32).reshape(-1).clone()
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, w2.numel(), w2.numel() // 50))
    w2[idx.to(dev)] *= 1.01
    w2 = w2.to(torch.bfloat16).reshape(w.shape)
    d = zipnn.delta_compress(w2, w, device=dev)
    print(f"delta of a 2%-changed tensor: {100 * d.nbytes / (w.numel() * 2):.1f}% "
          "(vs ~66% standalone)")
    assert _same(zipnn.delta_decompress(d, w, device=dev), w2)
    reset_launch_counts()

    # 5. The parallel streaming engine: threads=-1 fans (plane, chunk) work
    # across every core with the serial path's bytes; compress_file streams
    # checkpoints larger than memory through a bounded window
    all_cores = CodecOptions(threads=-1, backend="host")
    raw = w.reshape(-1).view(torch.uint8).cpu().numpy().tobytes()
    t0 = time.perf_counter()
    blob = zipnn.compress_bytes(raw, "bfloat16", options=all_cores, device=dev)
    t_par = time.perf_counter() - t0
    assert blob == zipnn.compress_bytes(raw, "bfloat16", options=CodecOptions(backend="host"),
                                        device=dev)
    with tempfile.TemporaryDirectory() as td:
        src, dst = os.path.join(td, "ckpt.bin"), os.path.join(td, "ckpt.znns")
        with open(src, "wb") as f:
            f.write(raw)
        raw_b, comp_b = zipnn.compress_file(src, dst, "bfloat16", window_bytes=1 << 20,
                                            options=all_cores, device=dev)
    print(f"engine: {raw_b / 1e6:.1f} MB streamed → {comp_b / 1e6:.1f} MB "
          f"(all-core compress in {t_par * 1e3:.0f} ms, O(window) memory)")
    reset_launch_counts()

    # 6. The full-device compress path: with the canonical Huffman coder,
    # backend="device" plans, rotates and byte-groups on the card (K3) and
    # bit-packs the Huffman chunks there (K7); the host builds the tables
    # and frames the container.  Blobs are byte-identical on every path.
    cfg_h = zipnn.ZipNNConfig(backend="huffman")
    ref = zipnn.compress_bytes(raw, "bfloat16", cfg_h, options=CodecOptions(backend="host"),
                               device=dev)
    reset_launch_counts()
    device_entropy.reset_transfer_stats()
    full_dev = zipnn.compress_bytes(raw, "bfloat16", cfg_h,
                                    options=CodecOptions(backend="device"), device=dev)
    symbol_uploads = device_entropy.transfer_stats()["symbol_uploads"]
    assert symbol_uploads == 0          # the planes never left the device
    _section(launches, "encode", ENCODE)
    plan["encode"] = {"plane_producer": 1, "bitpack_encode_chunks": _k7_plan(full_dev)}
    mixed = zipnn.compress_bytes(raw, "bfloat16", cfg_h,
                                 options=CodecOptions(backend="host", entropy_backend="device"),
                                 device=dev)
    assert ref == full_dev == mixed
    reset_launch_counts()
    print("full-device compress (K3 planes + K7 Huffman bit-pack): "
          f"{len(ref) / 1e6:.2f} MB, byte-identical across backends ✓")

    # 7. Full-device decode: K1 decodes every Huffman chunk, K2 joins the
    # planes into elements; a restored leaf stays on the device
    full_device = CodecOptions(backend="device", entropy_backend="device")
    assert zipnn.decompress_bytes(ref, cfg_h, options=full_device, device=dev) == raw
    ct = zipnn.compress_array(w, cfg_h, options=CodecOptions(backend="host"), device=dev)
    reset_launch_counts()
    leaf = zipnn.decompress_array(ct, cfg_h, options=full_device, device_resident=True,
                                  device=dev)
    assert leaf.device.type == dev.type and _same(leaf, w)
    _section(launches, "decode", DECODE)
    plan["decode"] = {"huffdecode_serial": ">=1", "plane_consumer": 1}
    print("device decode: the compressed payload is the only upload; the restored leaf "
          "stays on the device ✓")

    # 8. Compressed-resident serving from a device-resident payload feed:
    # each layer's payloads are parsed and uploaded once at build, and each
    # step decodes layer i + 1 (K1, K2) while layer i computes; logits are
    # bit-identical to the plain step's, with no payload upload a token
    feed_store = CompressedParamStore.from_params(params, cfg_h, payload_feed=True, device=dev)
    fstep = make_compressed_serve_step(cfg, feed_store, ring=2, tiles=2)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 1)).astype(np.int32)).to(dev)
    sc = model.init_decode_state(cfg, 2, 4, start_pos=0, device=dev)
    sd = model.init_decode_state(cfg, 2, 4, start_pos=0, device=dev)
    _, sc = fstep(sc, toks)                                 # warm-up
    _, sd = model.decode_step(cfg, params, sd, toks)
    device_entropy.reset_transfer_stats()
    reset_launch_counts()
    steps = 3
    for _ in range(steps):
        lc, sc = fstep(sc, toks)
        ld, sd = model.decode_step(cfg, params, sd, toks)
        assert _same(lc, ld)
    uploads = device_entropy.transfer_stats()["payload_uploads"]
    assert uploads == 0
    assert feed_store.peak_resident <= 2 * 2
    _section(launches, "ring", RING)
    feeds = [f for key in feed_store.stack_keys for layer in feed_store.feeds(key) for f in layer]
    plan["ring"] = {k: steps * sum(f.n_launches[k] for f in feeds) for k in RING}
    print(f"payload feed: {feed_store.device_payload_bytes / 1e3:.0f} kB resident payloads, "
          f"{uploads} per-token uploads, ring logits bit-identical ✓")

    # 9. One options bag and a session for the whole surface; the KV-cache
    # tier keeps a hot window and compresses older blocks
    session = ZipNNSession(options=CodecOptions(threads=-1, backend="host"), device=dev)
    assert session.decompress_bytes(session.compress_bytes(raw, "bfloat16")) == raw
    assert session.compress_bytes(raw, "bfloat16") == blob
    print("ZipNNSession: one options bag, whole surface, bytes identical ✓")
    kv_steps = 8
    kv = KVCacheStore(model.init_decode_state(cfg, 2, kv_steps, start_pos=0, device=dev),
                      hot_window=3, block_len=2, config=cfg_h)
    tstep = make_kv_tiered_serve_step(cfg, params, kv)
    su = model.init_decode_state(cfg, 2, kv_steps, start_pos=0, device=dev)
    for _ in range(kv_steps):
        lu, su = model.decode_step(cfg, params, su, toks)
        assert _same(tstep(toks), lu)
    assert kv.peak_hot_positions <= kv.hot_window + kv.block_len
    print(f"KV-cache tier: {kv.n_cold_blocks} cold blocks/layer at "
          f"{100 * kv.cold_comp_bytes / max(kv.cold_raw_bytes, 1):.1f}% of raw, "
          "logits bit-identical ✓")
    reset_launch_counts()

    # The byte-identity contract is also checked statically:
    # `python -m repro_torch.analysis --strict` (zipnn-lint).
    return {"launches": launches, "plan": plan, "payload_uploads": uploads,
            "symbol_uploads": symbol_uploads,
            "ratio_pct": 100 * manifest["comp_bytes"] / manifest["raw_bytes"]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
