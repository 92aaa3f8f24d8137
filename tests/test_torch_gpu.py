"""The port's CUDA kernels and ring on the card (``gpu`` marker).

Every test here needs a CUDA card: the ``cuda`` fixture skips inside the
test when there is none, so every worker collects the same tests.  Run
them on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Contract: each kernel (K1–K11) equals its plain PyTorch version on the
same card tensors bit for bit (integer bit work: no tolerance), each wrapper counts
its launches, blobs encoded on the card equal the host's byte for byte
(tensors and delta streams, which also round-trip), and the compressed
ring's logits equal the plain step's bit for bit on the card.
"""

import io
import json
import os
import zlib

import numpy as np
import pytest
import torch

from repro_torch import _util
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import codec, container, device_entropy, engine, huffman, zipnn
from repro_torch.core.options import CodecOptions
from repro_torch.kernels import (
    bitpack_encode_chunks,
    bitpack_encode_chunks_plain,
    bitpack_encode_chunks_single,
    bitpack_encode_chunks_single_plain,
    byte_histogram,
    byte_histogram_plain,
    bytegroup_bf16,
    bytegroup_bf16_plain,
    bytegroup_fp32,
    bytegroup_fp32_plain,
    chunk_histogram,
    chunk_histogram_plain,
    huffdecode_chain,
    huffdecode_chunks,
    huffdecode_chunks_plain,
    huffdecode_index,
    huffdecode_index_plain,
    huffdecode_selfsync_plain,
    huffdecode_serial,
    launch_counts,
    plane_consumer,
    plane_consumer_plain,
    plane_producer,
    plane_producer_plain,
    reset_launch_counts,
    ungroup_bf16,
    ungroup_bf16_plain,
    ungroup_fp32,
    ungroup_fp32_plain,
    xor_delta_u32,
    xor_delta_u32_plain,
    xor_elems,
    xor_elems_plain,
)
from repro_torch.kernels import _build
from repro_torch.kernels import bitpack as bitpack_mod
from repro_torch.kernels import histogram as histogram_mod
from repro_torch.kernels import ops
from repro_torch.kernels.huffdecode import (
    SEG_BITS, fuse_lut, pack_words, sync_offsets, sync_word_cap,
)
from repro_torch.models import decode_step, init_decode_state
from repro_torch.models.model import param_shapes
from repro_torch.serve import CompressedParamStore, make_compressed_serve_step

pytestmark = pytest.mark.gpu

HUFF = zipnn.ZipNNConfig(chunk_param_bytes=1 << 12, backend="huffman")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _bf16(shape, seed, device):
    a = (np.random.default_rng(seed).standard_normal(shape) * 0.02).astype(np.float32)
    return torch.from_numpy(a).to(torch.bfloat16).to(device)


def test_k1_kernel_matches_plain(cuda):
    leaf = _bf16((256, 384), 1, "cpu")
    ct = zipnn.compress_array(leaf, HUFF)
    reset_launch_counts()
    feed = zipnn.build_array_feed(ct, HUFF, device=cuda)
    assert launch_counts()["huffdecode_index"] == 1          # the feed's index pass
    assert launch_counts()["huffdecode_serial"] == launch_counts()["huffdecode_chain"] == 0
    args = feed.launch_args()
    n = args.pop("out_bytes")
    out_k, out_p, out_s = (torch.zeros(n, dtype=torch.uint8, device=cuda) for _ in range(3))
    reset_launch_counts()
    cur_k = huffdecode_chunks(**args, out=out_k)             # the sync decode
    cur_p = huffdecode_chunks_plain(**args, out=out_p)
    sync, sync_off = args.pop("sync"), args.pop("sync_off")
    cur_s = huffdecode_serial(**args, out=out_s)
    torch.cuda.synchronize()
    assert launch_counts()["huffdecode_chunks"] == 1
    assert launch_counts()["huffdecode_serial"] == 1
    assert launch_counts()["huffdecode_chain"] == 0
    assert torch.equal(cur_k, cur_p) and torch.equal(out_k, out_p)
    assert torch.equal(cur_k, cur_s) and torch.equal(out_k, out_s)
    cur_i, sync_i = huffdecode_index(**args, out=out_s, sync_off=sync_off)
    cur_ip, sync_ip = huffdecode_index_plain(**args, out=out_p, sync_off=sync_off)
    cur_c, sync_c = huffdecode_chain(**args, out=out_p, sync_off=sync_off)
    assert torch.equal(sync_i, sync) and torch.equal(sync_ip, sync) and torch.equal(sync_c, sync)
    assert torch.equal(cur_i, cur_k) and torch.equal(cur_ip, cur_k) and torch.equal(cur_c, cur_k)
    assert torch.equal(out_p, out_k)
    assert torch.equal(feed.decode().cpu().view(torch.int16), leaf.view(torch.int16))


def _k1_case(chunk, n_chunks, seed, pad, top=0.05):
    """K1 inputs over two tables at ``chunk`` symbols a chunk: a plane of
    ``n_chunks`` chunks (a short final one) whose 16 most frequent bytes
    each have probability ``top``, and a 1-symbol chunk;
    each chunk's output starts ``pad`` bytes after the previous one ends,
    so its sub-streams start off 16-byte boundaries.  Also returns every
    symbol's code length (``bits``)."""
    rng = np.random.default_rng(seed)
    p = np.r_[np.full(16, top), np.full(240, (1 - 16 * top) / 240)]
    plane = rng.choice(256, p=p, size=(n_chunks - 1) * chunk + chunk // 3).astype(np.uint8)
    small = (np.arange(chunk) % 7).astype(np.uint8)
    tables, payloads, counts, pids, syms, bits = [], [], [], [], [], []
    for pid, sample in enumerate((plane, small)):
        lens = huffman.code_lengths(np.bincount(sample, minlength=256) + 1)
        codes = huffman.canonical_codes(lens)
        tables.append((lens, codes))
        cnt = [min(chunk, sample.size - o) for o in range(0, sample.size, chunk)]
        if pid == 1:
            cnt, sample = [1], sample[:1]
        payloads += huffman.encode_chunks(sample, np.asarray(cnt), lens, codes)
        counts += cnt
        pids += [pid] * len(cnt)
        syms.append(sample)
        bits.append(lens[sample].astype(np.int64))
    width = max(int(t[0].max()) for t in tables)
    luts = np.stack([fuse_lut(*huffman._build_lut(l, c, width)) for l, c in tables])
    words, word_off = pack_words(payloads)
    out_off = np.cumsum([0] + [c + pad for c in counts[:-1]]).astype(np.int64) + pad
    return words, word_off, np.asarray(pids, np.int32), np.asarray(counts, np.int32), \
        out_off, luts, np.concatenate(syms), np.concatenate(bits), payloads


@pytest.mark.parametrize("chunk, pad, top", [
    (1 << 17, 0, 0.05), (1 << 17, 3, 0.05), (1 << 18, 5, 0.02)])
@pytest.mark.parametrize("sync_every", [512, 300])
def test_k1_sync_decode_staged_and_global_words(cuda, chunk, pad, top, sync_every):
    """The sync decode against its plain version and the serial kernel, with
    every chunk's words staged in shared memory (131,072-symbol chunks of a
    ~5.5-bit plane) and with the big chunks' words read from global memory
    (262,144 symbols of a ~7.6-bit plane, ~250 KB, do not fit in a block's
    227 KB)."""
    words, word_off, pids, counts, out_off, luts, syms, bits, payloads = _k1_case(
        chunk, 3, chunk + pad, pad, top)
    cap = sync_word_cap(luts.shape[1].bit_length() - 1, cuda)
    staged = [len(p) <= 4 * cap for p in payloads]
    assert all(staged) if chunk == 1 << 17 else not all(staged)
    args = [torch.from_numpy(a).to(cuda) for a in (words, word_off, pids, counts, out_off, luts)]
    sync_off = torch.from_numpy(sync_offsets(counts, sync_every)).to(cuda)
    n = int(out_off[-1] + counts[-1])
    out_i, out_k, out_p, out_s = (torch.zeros(n, dtype=torch.uint8, device=cuda)
                                  for _ in range(4))
    reset_launch_counts()
    cur_i, sync = huffdecode_index(*args, out_i, sync_off, sync_every)
    # the index: code lengths summed over each chunk's symbols before every
    # sync point (the plain index pass walks every symbol serially, too slow
    # at these sizes; chip_smoke.py holds it against the kernel)
    want, start = [], 0
    for c in counts:
        want.append(np.cumsum(np.r_[0, bits[start : start + c]])[0:c:sync_every])
        start += c
    assert np.array_equal(sync.cpu().numpy(), np.concatenate(want))
    cur_k = huffdecode_chunks(*args, out_k, sync, sync_off, sync_every)
    cur_p = huffdecode_chunks_plain(*args, out_p, sync, sync_off, sync_every)
    cur_s = huffdecode_serial(*args, out_s)
    torch.cuda.synchronize()
    assert {k: v for k, v in launch_counts().items() if k.startswith("huff")} == {
        "huffdecode_chunks": 1, "huffdecode_serial": 1, "huffdecode_index": 1,
        "huffdecode_chain": 0}
    for out in (out_i, out_p, out_s):
        assert torch.equal(out_k, out)
    for cur in (cur_i, cur_p, cur_s):
        assert torch.equal(cur_k, cur)
    got = np.concatenate([out_k[o : o + c].cpu().numpy() for o, c in zip(out_off, counts)])
    assert np.array_equal(got, syms)
    assert all(0 <= len(p) * 8 - c < 8 for p, c in zip(payloads, cur_k.tolist()))


def _selfsync_inputs(kind):
    """CPU inputs (words, word_off, pids, counts, out_off, luts) for the
    self-synchronising decode, by kind: a valid stream, its payloads
    truncated or extended with random bytes, an incomplete code (length-0
    LUT entries), counts zero and above the words, a code whose lengths
    are all 3 or 6 (no resynchronisation, a round a segment), a chunk whose
    words a block cannot stage, and random words under random LUT rows."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "shared_factor":
        lens = np.zeros(256, np.int64)
        lens[:7], lens[7:15] = 3, 6
        codes = huffman.canonical_codes(lens)
        plane = rng.integers(0, 15, 2 * 20_000).astype(np.uint8)
        cnt = np.asarray([20_000, 20_000])              # ~1,400 segments of 64 bits a chunk
        payloads = huffman.encode_chunks(plane, cnt, lens, codes)
        luts = fuse_lut(*huffman._build_lut(lens, codes, 6))[None]
        pids, counts = np.zeros(2, np.int32), cnt.astype(np.int32)
    else:
        chunk = 1 << 18 if kind == "global_words" else 1 << 17
        top = 0.02 if kind == "global_words" else 0.05
        words, word_off, pids, counts, out_off, luts, _, _, payloads = _k1_case(
            chunk, 3, 7, 0, top)
        if kind == "truncated":
            payloads = [p[: len(p) // 2] for p in payloads]
        elif kind == "extended":
            payloads = [p + rng.integers(0, 256, 37, dtype=np.uint8).tobytes() for p in payloads]
        elif kind == "incomplete":
            luts = luts.copy()
            luts[:, 3::11] &= ~0xF
        elif kind == "counts":
            counts = np.asarray([0, counts[1] * 3 + 5, counts[2] // 2, 2], np.int32)
        elif kind == "random":
            payloads = [rng.integers(0, 256, len(p), dtype=np.uint8).tobytes() for p in payloads]
            luts = rng.integers(-(1 << 15), 1 << 15, luts.shape).astype(np.int16)
    words, word_off = pack_words(payloads)
    out_off = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64) + 3
    return words, word_off, pids, counts, out_off, luts


@pytest.mark.parametrize("seg_bits", [SEG_BITS, 64])
@pytest.mark.parametrize("kind", ["valid", "truncated", "extended", "incomplete", "counts",
                                  "shared_factor", "global_words", "random"])
def test_k1_selfsync_matches_plain_and_chain(cuda, kind, seg_bits):
    """The self-synchronising kernel (both forms: symbols, and index without
    symbols) against its plain version and the chain kernel, bit for bit,
    on valid, truncated, extended, incomplete-code and random inputs; at
    64-bit segments the 131,072-symbol chunks have more segments than a
    block has threads, and more than the state it keeps (it lengthens
    them)."""
    arrays = _selfsync_inputs(kind)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    counts = arrays[3]
    n = int(arrays[4][-1] + counts[-1]) + 5
    every = 300
    sync_off = torch.from_numpy(sync_offsets(counts, every)).to(cuda)
    out_s, out_c, out_p = (torch.zeros(n, dtype=torch.uint8, device=cuda) for _ in range(3))
    rounds = torch.full((counts.size,), -1, dtype=torch.int32, device=cuda)
    reset_launch_counts()
    cur_s = huffdecode_serial(*args, out_s, seg_bits=seg_bits, rounds=rounds)
    cur_i, sync_i = huffdecode_index(*args, None, sync_off, every, seg_bits=seg_bits)
    cur_c, sync_c = huffdecode_chain(*args, out_c, sync_off, every)
    torch.cuda.synchronize()
    assert {k: v for k, v in launch_counts().items() if k.startswith("huff")} == {
        "huffdecode_chunks": 0, "huffdecode_serial": 1, "huffdecode_index": 1,
        "huffdecode_chain": 1}
    cur_p, sync_p = huffdecode_selfsync_plain(*args, out_p, sync_off, every, seg_bits)
    assert torch.equal(out_s, out_c) and torch.equal(out_p, out_c)
    assert torch.equal(cur_s, cur_c) and torch.equal(cur_i, cur_c) and torch.equal(cur_p, cur_c)
    assert torch.equal(sync_i, sync_c) and torch.equal(sync_p, sync_c)
    assert bool((rounds >= 0).all())
    if kind == "shared_factor":                      # segment starts off the grid of 3
        assert int(rounds.max()) > 2                 # the fixpoint took many rounds
    if kind == "global_words":
        cap = sync_word_cap(arrays[5].shape[1].bit_length() - 1, cuda)
        assert max(np.diff(arrays[1])) > cap         # a block read its words from global memory


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("with_base", [False, True])
def test_k2_kernel_matches_plain(cuda, itemsize, with_base):
    n = 100_003
    g = torch.Generator().manual_seed(itemsize + 10 * with_base)
    planes = [torch.randint(0, 256, (n,), dtype=torch.uint8, generator=g).to(cuda)
              for _ in range(itemsize)]
    dt = torch.int16 if itemsize == 2 else torch.int32
    base = torch.randint(torch.iinfo(dt).min, torch.iinfo(dt).max, (n,), dtype=dt,
                         generator=g).to(cuda) if with_base else None
    reset_launch_counts()
    k = plane_consumer(planes, base, itemsize=itemsize)
    p = plane_consumer_plain(planes, base, itemsize=itemsize)
    assert launch_counts()["plane_consumer"] == 1
    assert torch.equal(k, p)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_k2_k11_vector_and_element_paths(cuda, itemsize, offset):
    # offset 0: 16-byte aligned operands, 16 elements a thread and a ragged
    # end; offset 1: no aligned plane, element by element.  K11 is the same
    # kernel without a base and counts its own launches.
    n = 100_003
    dt = torch.int16 if itemsize == 2 else torch.int32
    g = torch.Generator().manual_seed(20 + 2 * itemsize + offset)
    planes = [torch.randint(0, 256, (n + offset,), dtype=torch.uint8, generator=g)
              .to(cuda)[offset:] for _ in range(itemsize)]
    base = torch.randint(torch.iinfo(dt).min, torch.iinfo(dt).max, (n + offset,), dtype=dt,
                         generator=g).to(cuda)[offset:]
    ungroup = ungroup_bf16 if itemsize == 2 else ungroup_fp32
    reset_launch_counts()
    k = plane_consumer(planes, base, itemsize=itemsize)
    assert torch.equal(k, plane_consumer_plain(planes, base, itemsize=itemsize))
    assert torch.equal(ungroup(*planes), plane_consumer_plain(planes, itemsize=itemsize))
    counts = launch_counts()
    assert counts["plane_consumer"] == 1 and counts[ungroup.__name__] == 1


def test_corrupt_payload_raises_on_card(cuda):
    leaf = _bf16((128, 128), 2, "cpu")
    ct = zipnn.compress_array(leaf, HUFF)
    meta, mv = container.unpack_stream(ct.blob)
    payloads = [[container.payload_view(meta, mv, p, c) for c in range(len(meta.entries[p]))]
                for p in range(meta.n_planes)]
    cut = payloads[0][0][: len(payloads[0][0]) // 2]
    entries = [list(pe) for pe in meta.entries]
    e = entries[0][0]
    assert e.method == codec.Method.HUFF
    entries[0][0] = codec.ChunkEntry(e.method, len(cut), e.raw_len, zlib.crc32(cut))
    payloads[0][0] = cut
    params = codec.CodecParams(chunk_bytes=meta.chunk_bytes, backend="huffman")
    with pytest.raises(ValueError, match="cursor|pad"):
        device_entropy.decode_planes(entries, payloads, meta.tables, params, device=cuda)
    with pytest.raises(ValueError, match="cursor|pad"):               # at the index pass
        device_entropy.PayloadFeed(entries, payloads, meta.tables, params, device=cuda)


def test_ring_bit_identical_on_card(cuda):
    cfg = get_config("repro_gpt_100m").reduced()
    rng = np.random.default_rng(0)

    def fill(node):                   # shape tuples are leaves here
        if isinstance(node, dict):
            return {k: fill(node[k]) for k in sorted(node)}
        a = (rng.standard_normal(node) * 0.02).astype(np.float32)
        return torch.from_numpy(a).to(torch.bfloat16).to(cuda)

    params = fill(param_shapes(cfg))
    store = CompressedParamStore.from_params(params, HUFF, payload_feed=True, device=cuda)
    cstep = make_compressed_serve_step(cfg, store, ring=2)
    sa = init_decode_state(cfg, 2, 4, start_pos=0, device=cuda)
    sb = init_decode_state(cfg, 2, 4, start_pos=0, device=cuda)
    device_entropy.reset_transfer_stats()
    reset_launch_counts()
    for t in range(4):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)).to(cuda)
        la, sa = decode_step(cfg, params, sa, toks)
        lb, sb = cstep(sb, toks)
        assert torch.equal(la.view(torch.int32), lb.view(torch.int32)), t
    n_feeds = sum(len(l) for l in store.feeds("layers"))
    assert launch_counts()["huffdecode_chunks"] == 4 * sum(
        f.n_launches["huffdecode_chunks"] for l in store.feeds("layers") for f in l) > 0
    assert launch_counts()["huffdecode_serial"] == launch_counts()["huffdecode_index"] == 0
    assert launch_counts()["huffdecode_chain"] == 0
    assert launch_counts()["plane_consumer"] == 4 * n_feeds
    assert device_entropy.transfer_stats()["payload_uploads"] == 0
    assert store.peak_resident <= 2


@pytest.mark.parametrize("chunk", [16384, 3000])     # 3000: tiles end off 16-byte lines
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("with_base", [False, True])
def test_k3_kernel_matches_plain(cuda, itemsize, with_base, chunk):
    n = 5 * chunk
    dt = torch.int16 if itemsize == 2 else torch.int32
    g = torch.Generator().manual_seed(itemsize + 10 * with_base)
    w = torch.randn(n, generator=g) * 0.02
    x = (w.to(torch.bfloat16) if itemsize == 2 else w).view(dt).to(cuda)
    base = torch.randint(torch.iinfo(dt).min, torch.iinfo(dt).max, (n,), dtype=dt,
                         generator=g).to(cuda) if with_base else None
    reset_launch_counts()
    pk, hk = plane_producer(x, base, itemsize=itemsize, chunk_elems=chunk)
    pp, hp = plane_producer_plain(x, base, itemsize=itemsize, chunk_elems=chunk)
    torch.cuda.synchronize()
    assert launch_counts()["plane_producer"] == 1
    assert torch.equal(pk, pp) and torch.equal(hk, hp)
    assert int(hk.sum()) == n * itemsize


@pytest.mark.parametrize("chunk", [8192, 6004])      # 6004: a partial last tile of 4096
def test_k7_kernel_matches_plain(cuda, chunk):
    rng = np.random.default_rng(3)
    skewed = np.clip(rng.normal(120, 3, 3 * chunk), 0, 255).astype(np.uint8)
    tables = []
    for sample in (skewed, (np.arange(5000) % 7).astype(np.uint8)):
        lens = huffman.code_lengths(np.bincount(sample, minlength=256) + 1)
        tables.append((lens, huffman.canonical_codes(lens)))
    skewed[-1000:] = 0                                  # zero-padded final chunk
    syms = np.concatenate([skewed[: 2 * chunk], rng.integers(0, 256, chunk).astype(np.uint8),
                           skewed[2 * chunk :]])
    args = [torch.from_numpy(a).to(cuda) for a in (
        syms, np.asarray([0, 0, 1, 0], np.int32),
        np.stack([t[0] for t in tables]).astype(np.int32),
        np.stack([t[1] for t in tables]).astype(np.int32),
    )]
    reset_launch_counts()
    wk, nk = bitpack_encode_chunks(*args, chunk_syms=chunk)
    wp, np_ = bitpack_encode_chunks_plain(*args, chunk_syms=chunk)
    torch.cuda.synchronize()
    assert launch_counts()["bitpack_encode_chunks"] == 1
    assert int(nk[2]) > 8 * chunk                        # expanded past capacity
    assert torch.equal(nk, np_) and torch.equal(wk, wp)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_device_blobs_equal_host_blobs_on_card(cuda, dtype):
    cfg = zipnn.ZipNNConfig(chunk_param_bytes=1 << 18, backend="huffman")
    leaf = (torch.randn((700, 300), generator=torch.Generator().manual_seed(5)) * 0.02).to(dtype)
    host = zipnn.compress_array(leaf, cfg, options=CodecOptions(backend="host"))
    reset_launch_counts()
    device_entropy.reset_transfer_stats()
    dev = zipnn.compress_array(leaf.to(cuda), cfg, options=CodecOptions(backend="device"),
                               device=cuda)
    assert dev.blob == host.blob
    assert launch_counts()["plane_producer"] == 1
    assert launch_counts()["bitpack_encode_chunks"] == 1
    assert device_entropy.transfer_stats()["symbol_uploads"] == 0


def test_default_device_gathers_symbols_on_card(cuda):
    """With ``device`` left at its default ``"cuda"`` the HUFF symbols are
    gathered from K3's twins on the card, as with an explicit index."""
    cfg = zipnn.ZipNNConfig(chunk_param_bytes=1 << 18, backend="huffman")
    leaf = (torch.randn((700, 300), generator=torch.Generator().manual_seed(7)) * 0.02).to(
        torch.bfloat16
    )
    host = zipnn.compress_array(leaf, cfg, options=CodecOptions(backend="host"))
    opts = CodecOptions(backend="device")
    device_entropy.reset_transfer_stats()
    dev = zipnn.compress_array(leaf.to(cuda), cfg, options=opts)
    store = CompressedParamStore.from_params({"layers": {"w": leaf[None].to(cuda)}}, cfg,
                                             options=opts)
    assert dev.blob == host.blob
    assert store.manifest("layers", 0)["leaves"][0].blob == host.blob
    assert store.device == cuda
    assert device_entropy.transfer_stats()["symbol_uploads"] == 0


def test_delta_round_trip_on_card(cuda):
    cfg = zipnn.ZipNNConfig(chunk_param_bytes=1 << 18, backend="huffman")
    g = torch.Generator().manual_seed(6)
    base = (torch.randn((600, 512), generator=g) * 0.02).to(torch.bfloat16)
    new = (base.float() + 1e-4 * torch.randn((600, 512), generator=g)).to(torch.bfloat16)
    host = zipnn.delta_compress(new, base, cfg, options=CodecOptions(backend="host"))
    dev = zipnn.delta_compress_batched([new.to(cuda)], [base.to(cuda)], cfg,
                                       options=CodecOptions(backend="device"), device=cuda)[0]
    assert dev.blob == host.blob
    out = zipnn.delta_decompress(dev, base.to(cuda), cfg, device_resident=True, device=cuda)
    assert out.is_cuda and torch.equal(out.cpu().view(torch.int16), new.view(torch.int16))


# K4-K6 and K8-K11.  ``offset`` starts the operands one element into a
# buffer, so no pointer is 16-byte aligned and the kernels take their
# element-by-element path; n = 100,003 leaves a ragged end on the aligned
# path.
def _card_bits(n, itemsize, seed, cuda, offset=0):
    dt = torch.int16 if itemsize == 2 else torch.int32
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(n + offset, generator=g) * 0.02
    x = (w.to(torch.bfloat16) if itemsize == 2 else w).view(dt)
    return x.to(cuda)[offset:]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 100_003, 1 << 20])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_k4_k11_kernels_match_plain(cuda, itemsize, n, offset):
    x = _card_bits(n, itemsize, n + itemsize, cuda, offset)
    group, group_plain, ungroup, ungroup_plain = (
        (bytegroup_bf16, bytegroup_bf16_plain, ungroup_bf16, ungroup_bf16_plain) if itemsize == 2
        else (bytegroup_fp32, bytegroup_fp32_plain, ungroup_fp32, ungroup_fp32_plain)
    )
    reset_launch_counts()
    pk = group(x)
    pp = group_plain(x)
    assert len(pk) == itemsize and all(torch.equal(a, b) for a, b in zip(pk, pp))
    planes = [torch.cat([p.new_zeros(offset), p])[offset:] for p in pk]     # misaligned too
    back = ungroup(*planes)
    assert torch.equal(back, ungroup_plain(*planes)) and torch.equal(back, x)
    counts = launch_counts()
    assert counts[group.__name__] == 1 and counts[ungroup.__name__] == 1


# K5/K10: 3072 * 768 is the main path's leaf (a partial group of 4 vectors
# a thread); 3,000,017 a ragged end; 9,000,001 u32 elements take more than
# one pass of the grid-stride loop.
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 100_003, 1 << 20, 3072 * 768, 3_000_017, 9_000_001])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_k5_k10_kernels_match_plain(cuda, itemsize, n, offset):
    a = _card_bits(n, itemsize, n, cuda, offset)
    b = a.clone()
    b[::3] = _card_bits(n, itemsize, n + 1, cuda)[::3]           # some elements change
    reset_launch_counts()
    d = xor_elems(a, b)
    assert torch.equal(d, xor_elems_plain(a, b))
    assert launch_counts()["xor_elems"] == 1
    if itemsize == 4:
        dk, ck = xor_delta_u32(a, b)
        dp, cp = xor_delta_u32_plain(a, b)
        torch.cuda.synchronize()
        assert torch.equal(dk, dp) and int(ck) == int(cp) > 0
        assert int(ck) == int((d.cpu().view(torch.uint8) != 0).sum())
        assert launch_counts()["xor_delta_u32"] == 1


@pytest.mark.parametrize("n, chunk, offset", [
    (1, 7, 0), (100_003, 3000, 0), (100_003, 3000, 5), (1 << 20, 131_072, 0),
    (1 << 20, 50_000, 3),
])
def test_k6_k9_kernels_match_plain(cuda, n, chunk, offset):
    rng = np.random.default_rng(n + chunk)
    skewed = np.clip(rng.normal(120, 3, n + offset), 0, 255).astype(np.uint8)
    x = torch.from_numpy(skewed).to(cuda)[offset:]
    reset_launch_counts()
    hk, hp = chunk_histogram(x, chunk), chunk_histogram_plain(x, chunk)
    bk, bp = byte_histogram(x), byte_histogram_plain(x)
    torch.cuda.synchronize()
    assert hk.shape == (-(-n // chunk), 256) and torch.equal(hk, hp)
    assert torch.equal(bk, bp) and int(bk.sum()) == n
    assert launch_counts()["chunk_histogram"] == 1 and launch_counts()["byte_histogram"] == 1


def test_k8_kernel_matches_plain(cuda):
    chunk = 8192
    rng = np.random.default_rng(4)
    skewed = np.clip(rng.normal(120, 3, 3 * chunk), 0, 255).astype(np.uint8)
    lens = huffman.code_lengths(np.bincount(skewed, minlength=256) + 1)
    codes = huffman.canonical_codes(lens)
    syms = np.concatenate([skewed[: 2 * chunk], rng.integers(0, 256, chunk).astype(np.uint8)])
    args = [torch.from_numpy(a).to(cuda) for a in (
        syms, lens.astype(np.int32), codes.astype(np.int32))]
    reset_launch_counts()
    wk, nk = bitpack_encode_chunks_single(*args, chunk_syms=chunk)
    wp, np_ = bitpack_encode_chunks_single_plain(*args, chunk_syms=chunk)
    torch.cuda.synchronize()
    assert int(nk[2]) > 8 * chunk                         # expanded past capacity
    assert torch.equal(nk, np_) and torch.equal(wk, wp)
    counts = launch_counts()
    assert counts["bitpack_encode_chunks_single"] == 1 and counts["bitpack_encode_chunks"] == 0


def test_ops_on_card_match_ops_on_cpu(cuda):
    """The public ops on card tensors give the CPU's results, and a numpy
    encode goes to the card by default."""
    x = _card_bits(50_001, 2, 9, cuda)
    exp, frac = ops.bytegroup_bf16(x.view(torch.uint16))
    cexp, cfrac = ops.bytegroup_bf16(x.cpu())
    assert exp.is_cuda and torch.equal(exp.cpu(), cexp) and torch.equal(frac.cpu(), cfrac)
    assert torch.equal(ops.byte_histogram(exp).cpu(), ops.byte_histogram(cexp))
    lens = huffman.code_lengths(np.bincount(cexp.numpy(), minlength=256))
    codes = huffman.canonical_codes(lens)
    reset_launch_counts()
    on_card = ops.huffman_encode_chunks(cexp.numpy(), lens, codes)
    assert launch_counts()["bitpack_encode_chunks_single"] == 1
    assert on_card == ops.huffman_encode_chunks(cexp.numpy(), lens, codes, device="cpu")
    assert on_card == ops.huffman_encode_chunks(exp, lens, codes)


# ---------------------------------------------------------------------------
# The redesigned K7 (segments of 8,192 symbols over many blocks, placed by a
# look-back, the table checked on the card) and K3 (16-byte traffic,
# per-warp histograms, tiles sized to one wave)
# ---------------------------------------------------------------------------

def _k7_tables_and_syms(chunk, seed):
    """Five table rows and eight chunks: skewed chunks under row 0, a
    7-symbol row (1), all length-1 codes (2), all length-15 codes that
    expand past capacity (3), a row with one length-16 code (4), and a
    chunk whose plane id (7) names no row."""
    rng = np.random.default_rng(seed)
    skewed = np.clip(rng.normal(120, 3, 3 * chunk), 0, 255).astype(np.uint8)
    rows = []
    for sample in (skewed, (np.arange(5000) % 7).astype(np.uint8)):
        lens = huffman.code_lengths(np.bincount(sample, minlength=256) + 1)
        rows.append((lens, huffman.canonical_codes(lens)))
    ones = np.zeros(256, np.int64)
    ones[[3, 200]] = 1
    rows.append((ones, huffman.canonical_codes(ones)))
    rows.append((np.full(256, 15, np.int64), np.arange(256, dtype=np.int64) * 37 % (1 << 15)))
    rows.append((np.where(np.arange(256) == 5, 16, rows[0][0]), rows[0][1]))
    tail = skewed[2 * chunk :].copy()
    tail[chunk - 1000 :] = 0                                # zero-padded final chunk
    syms = np.concatenate([
        skewed[: 2 * chunk], rng.integers(0, 256, chunk).astype(np.uint8), tail,
        rng.choice([3, 200], chunk).astype(np.uint8), rng.integers(0, 256, chunk).astype(np.uint8),
        skewed[:chunk], skewed[chunk : 2 * chunk],
    ])
    pids = np.asarray([0, 0, 1, 0, 2, 3, 4, 7], np.int32)
    lens = np.stack([r[0] for r in rows]).astype(np.int32)
    codes = np.stack([r[1] for r in rows]).astype(np.int32)
    return syms, pids, lens, codes


# 6,004 and 262,144: segments end off word boundaries and a chunk is not a
# whole number of segments, or is 32 of them
@pytest.mark.parametrize("chunk", [6004, 8192, 131_072, 262_144])
def test_k7_segments_match_plain(cuda, chunk):
    syms, pids, lens, codes = _k7_tables_and_syms(chunk, chunk % 97)
    args = [torch.from_numpy(a).to(cuda) for a in (syms, pids, lens, codes)]
    reset_launch_counts()
    wk, nk = bitpack_encode_chunks(*args, chunk_syms=chunk)
    good = torch.arange(6, device=cuda)                  # the plain version raises on row 4
    wp, np_ = bitpack_encode_chunks_plain(
        args[0].view(-1, chunk)[good].reshape(-1), args[1][good], args[2][:4].contiguous(),
        args[3][:4].contiguous(), chunk_syms=chunk)
    torch.cuda.synchronize()
    assert launch_counts()["bitpack_encode_chunks"] == 1
    assert nk[6:].tolist() == [-1, -1] and not wk[6:].any()
    assert int(nk[4]) == chunk                           # one bit a symbol
    assert int(nk[2]) > 8 * chunk and int(nk[5]) == 15 * chunk     # expanded past capacity
    assert torch.equal(nk[:6], np_) and torch.equal(wk[:6], wp)


@pytest.mark.parametrize("single", [False, True])
def test_k7_k8_wrappers_do_not_sync(cuda, single):
    """The CUDA path reads nothing back to the host: with the sync debug
    mode at "error" a synchronising call would raise."""
    syms, pids, lens, codes = _k7_tables_and_syms(8192, 1)
    s, p, l, c = (torch.from_numpy(a).to(cuda) for a in (syms, pids, lens, codes))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):              # control: a host read is caught
            int(l.max())
        if single:
            words, nbits = bitpack_encode_chunks_single(s, l[0], c[0], chunk_syms=8192)
        else:
            words, nbits = bitpack_encode_chunks(s, p, l, c, chunk_syms=8192)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if single:
        assert torch.equal(nbits, bitpack_encode_chunks_single_plain(
            s, l[0], c[0], chunk_syms=8192)[1])
    else:
        assert nbits[6:].tolist() == [-1, -1]


def test_bad_table_raises_on_card(cuda):
    """A length-16 table: K7 flags it on the card and both callers raise."""
    syms, _, lens, codes = _k7_tables_and_syms(8192, 2)
    plane = syms[: 2 * 8192]
    with pytest.raises(ValueError, match="0..15"):
        device_entropy._pack_jobs([plane], [(0, 0, 8192), (0, 1, 8192)], lens[4:5].copy(),
                                  codes[4:5].copy(), 8192, cuda)
    with pytest.raises(ValueError, match="0..15"):
        ops.huffman_encode_chunks(plane, lens[4], codes[4], chunk_syms=8192, device=cuda)


def _k3_case(kind, itemsize, n, seed):
    dt = torch.int16 if itemsize == 2 else torch.int32
    g = torch.Generator().manual_seed(seed)
    if kind == "random_bits":
        return torch.randint(torch.iinfo(dt).min, torch.iinfo(dt).max, (n,), dtype=dt, generator=g)
    w = torch.randn(n, generator=g) * 0.02
    x = (w.to(torch.bfloat16) if itemsize == 2 else w).view(dt)
    if kind == "same_exponent":                  # one exponent byte after the rotate
        keep = 0x007F if itemsize == 2 else 0x007FFFFF
        x = (x & keep) | (0x3C00 if itemsize == 2 else 0x3C000000)
    return x


# offset_view: a view that starts one element in; odd_n: n not a multiple
# of 8 (planes 1.. start off 8-byte lines); same_exponent: every exponent
# byte one value; random_bits: uniform bits in every plane
@pytest.mark.parametrize("kind", ["offset_view", "odd_n", "same_exponent", "random_bits"])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("with_base", [False, True])
def test_k3_vectors_and_histograms_match_plain(cuda, kind, itemsize, with_base):
    chunk = 131_072 // itemsize if kind != "odd_n" else 50_001
    n = 3 * chunk
    x = _k3_case(kind, itemsize, n + 1, itemsize + 3 * with_base).to(cuda)
    x = x[1:] if kind == "offset_view" else x[:n]
    base = None
    if with_base:
        base = _k3_case("random_bits", itemsize, n, 7 + itemsize).to(cuda)
    reset_launch_counts()
    pk, hk = plane_producer(x, base, itemsize=itemsize, chunk_elems=chunk)
    pp, hp = plane_producer_plain(x, base, itemsize=itemsize, chunk_elems=chunk)
    torch.cuda.synchronize()
    assert launch_counts()["plane_producer"] == 1
    assert torch.equal(pk, pp) and torch.equal(hk, hp)
    if kind == "same_exponent" and not with_base:
        assert int(hk[:, 0].count_nonzero()) == hk.shape[0]        # one bin a chunk


def test_k7_more_segments_than_the_card_holds(cuda):
    """3,200 segments (200 chunks of 131,072 symbols): more blocks than are
    resident at once, so later segments start only as earlier ones end and
    the look-back meets predecessors that have finished long before."""
    rng = np.random.default_rng(11)
    syms = np.clip(rng.normal(120, 3, 200 * 131_072), 0, 255).astype(np.uint8)
    lens = huffman.code_lengths(np.bincount(syms[:131_072], minlength=256) + 1)
    codes = huffman.canonical_codes(lens)
    args = [torch.from_numpy(a).to(cuda) for a in (
        syms, (np.arange(200) % 2).astype(np.int32),
        np.stack([lens, lens]).astype(np.int32), np.stack([codes, codes]).astype(np.int32))]
    wk, nk = bitpack_encode_chunks(*args, chunk_syms=131_072)
    wp, np_ = bitpack_encode_chunks_plain(*args, chunk_syms=131_072)
    torch.cuda.synchronize()
    assert torch.equal(nk, np_) and torch.equal(wk, wp)


# n past one wave of tiles at the longest tile: each block walks several
@pytest.mark.parametrize("itemsize, n", [(2, 36_000_000), (4, 12_000_000)])
def test_k3_tiles_past_one_wave(cuda, itemsize, n):
    chunk = 131_072 // itemsize
    n = n // chunk * chunk
    x = _k3_case("weights", itemsize, n, 17).to(cuda)
    pk, hk = plane_producer(x, itemsize=itemsize, chunk_elems=chunk)
    pp, hp = plane_producer_plain(x, itemsize=itemsize, chunk_elems=chunk)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp) and torch.equal(hk, hp)


# ---------------------------------------------------------------------------
# The redesigned K9/K6 (one wave of contiguous parts, 16-byte loads, a
# shared histogram a block)
# ---------------------------------------------------------------------------

def _hist_plane(kind, n, seed):
    """n bytes of one kind, as a CPU uint8 tensor."""
    rng = np.random.default_rng(seed)
    if kind == "exponent":                # a bf16 weight's exponent plane
        w = torch.from_numpy((rng.standard_normal(n) * 0.02).astype(np.float32))
        return bytegroup_bf16_plain(w.to(torch.bfloat16).view(torch.int16))[0]
    if kind == "uniform":
        return torch.from_numpy(rng.integers(0, 256, n).astype(np.uint8))
    if kind == "one value":               # every byte on one bin
        return torch.full((n,), 121, dtype=torch.uint8)
    return torch.zeros(n, dtype=torch.uint8)


@pytest.mark.parametrize("kind, n, chunk, offset", [
    ("exponent", 3072 * 768, 3072 * 768, 0),          # the ops path's leaf, K9
    ("exponent", 3072 * 768, 131_072, 0),             # and K6
    ("exponent", 3072 * 768 - 5, 131_072, 1),         # one byte in, a short last chunk
    ("uniform", 3072 * 768, 3072 * 768, 0),
    ("uniform", 3072 * 768, 131_072, 3),
    ("one value", 3_000_000, 3_000_000, 0),           # every lane of a warp on one bin
    ("one value", 3_000_000, 131_072, 0),
    ("zeros", 1_000_003, 1_000_003, 1),
    ("exponent", 10_000, 100, 0),                     # chunks shorter than a part
    ("exponent", 100_003, 7_000, 5),
    ("exponent", 1_000_000, 16, 0),                   # more rows than one wave: each
    ("exponent", 5_000_001, 3_000, 3),                # block walks many chunks
    ("uniform", 1, 1, 0),                             # less than one vector
    ("uniform", 15, 15, 3),
    ("uniform", 17, 5, 1),
    ("exponent", 64_000_007, 64_000_007, 0),          # many vectors a thread
    ("exponent", 64_000_007, 131_072, 2),
])
def test_k6_k9_redesign_matches_plain(cuda, kind, n, chunk, offset):
    x = torch.cat([torch.zeros(offset, dtype=torch.uint8), _hist_plane(kind, n, n)])
    x = x.to(cuda)[offset:]
    rows = -(-n // chunk)
    # the caching allocator hands the wrappers these blocks back, so a count
    # left unzeroed would show
    stale = [torch.full((rows, 256), 7, dtype=torch.int32, device=cuda),
             torch.full((256,), 7, dtype=torch.int32, device=cuda)]
    del stale
    reset_launch_counts()
    hk, bk = chunk_histogram(x, chunk), byte_histogram(x)
    hp, bp = chunk_histogram_plain(x, chunk), byte_histogram_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(hk, hp) and torch.equal(bk, bp) and int(bk.sum()) == n
    assert launch_counts()["chunk_histogram"] == 1 and launch_counts()["byte_histogram"] == 1


def test_k6_k9_launch_failure_raises(cuda, monkeypatch):
    """A launch the C entry refuses (here a chunk length of 0) raises
    through the wrappers and is not counted."""
    x = _hist_plane("exponent", 300_000, 22).to(cuda)
    launch = histogram_mod._launcher()
    monkeypatch.setattr(histogram_mod, "_launcher",
                        lambda: lambda x, out, n, chunk, s: launch(x, out, n, 0, s))
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="histogram launch"):
        chunk_histogram(x, 100_000)
    with pytest.raises(RuntimeError, match="histogram launch"):
        byte_histogram(x)
    assert launch_counts()["chunk_histogram"] == 0 and launch_counts()["byte_histogram"] == 0
    monkeypatch.undo()
    assert torch.equal(chunk_histogram(x, 100_000), chunk_histogram_plain(x, 100_000))


def test_k6_k9_on_two_streams_at_once(cuda):
    """Launches on two streams at once each count their own input."""
    xs = [_hist_plane(k, 2_000_000, 23 + i).to(cuda) for i, k in enumerate(("exponent", "uniform"))]
    want = [chunk_histogram_plain(x, 65_536) for x in xs]
    streams = [torch.cuda.Stream(cuda) for _ in xs]
    got = [[], []]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda))
    for _ in range(10):
        for i, (s, x) in enumerate(zip(streams, xs)):
            with torch.cuda.stream(s):
                got[i].append(chunk_histogram(x, 65_536))
    torch.cuda.synchronize()
    assert all(torch.equal(h, w) for hs, w in zip(got, want) for h in hs)


def test_k6_k9_in_a_cuda_graph(cuda):
    """A launch captured in a CUDA graph zeroes and counts anew at each replay."""
    x = _hist_plane("exponent", 300_000, 26).to(cuda)
    chunk_histogram(x, 65_536), byte_histogram(x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        h, b = chunk_histogram(x, 65_536), byte_histogram(x)
    for seed in (27, 28):
        x.copy_(_hist_plane("uniform", 300_000, seed).to(cuda))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(h, chunk_histogram_plain(x, 65_536))
        assert torch.equal(b, byte_histogram_plain(x))


# ---------------------------------------------------------------------------
# the file engine, the "auto" default and checkpoints on the card
# ---------------------------------------------------------------------------

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
HOST = CodecOptions(backend="host")


def _raw_stream(n, seed):
    return _bf16((n,), seed, "cpu").view(torch.uint8).numpy().tobytes() + b"\x07"


def test_compress_array_of_a_card_tensor_runs_k3_by_default(cuda):
    cfg = zipnn.ZipNNConfig(chunk_param_bytes=1 << 18, backend="huffman")
    leaf = _bf16((600, 400), 31, "cpu")
    reset_launch_counts()
    ct = zipnn.compress_array(leaf.to(cuda), cfg)            # no backend: "auto"
    assert launch_counts()["plane_producer"] == 1
    assert launch_counts()["bitpack_encode_chunks"] == 1
    assert ct.blob == zipnn.compress_array(leaf, cfg, options=HOST).blob
    reset_launch_counts()
    zipnn.compress_array(leaf, cfg)                          # a CPU tensor stays on the host
    assert launch_counts()["plane_producer"] == 0


def test_decompress_bytes_decodes_on_the_card_by_default(cuda):
    cfg = zipnn.ZipNNConfig(chunk_param_bytes=1 << 18, backend="huffman")
    raw = _raw_stream(400_000, 32)
    reset_launch_counts()
    blob = zipnn.compress_bytes(raw, "bfloat16", cfg)        # host bytes, "auto": the card
    assert launch_counts()["plane_producer"] == launch_counts()["bitpack_encode_chunks"] == 1
    assert blob == zipnn.compress_bytes(raw, "bfloat16", cfg, options=HOST)
    reset_launch_counts()
    assert zipnn.decompress_bytes(blob, cfg) == raw          # no backend: "auto"
    assert launch_counts()["huffdecode_serial"] == 1         # the self-synchronising decode
    assert launch_counts()["huffdecode_chain"] == 0
    assert launch_counts()["plane_consumer"] == 1
    reset_launch_counts()
    assert zipnn.decompress_bytes(blob, cfg, options=HOST) == raw
    assert sum(launch_counts().values()) == 0


@pytest.mark.parametrize("threads,depth", [(0, 1), (4, 3)])
def test_file_on_card_equals_host_file(cuda, tmp_path, threads, depth):
    cfg = zipnn.ZipNNConfig(chunk_param_bytes=1 << 16, backend="huffman")
    raw = _raw_stream(1_500_000, 33)
    src = tmp_path / "w.raw"
    src.write_bytes(raw)
    engine.compress_file(str(src), str(tmp_path / "host.znns"), "bfloat16", cfg,
                         window_bytes=1 << 20, options=CodecOptions(threads=threads, backend="host"))
    reset_launch_counts()
    opts = CodecOptions(threads=threads, backend="device")
    engine.compress_file(str(src), str(tmp_path / "card.znns"), "bfloat16", cfg,
                         window_bytes=1 << 20, options=opts, pipeline_depth=depth)
    frames = len(list(engine.frame_records(str(tmp_path / "card.znns"))))
    assert frames == 3
    assert launch_counts()["plane_producer"] == launch_counts()["bitpack_encode_chunks"] == frames
    assert (tmp_path / "card.znns").read_bytes() == (tmp_path / "host.znns").read_bytes()
    reset_launch_counts()
    out = io.BytesIO()
    n = engine.decompress_file(str(tmp_path / "card.znns"), out, cfg,
                               options=CodecOptions(threads=threads), pipeline_depth=depth)
    assert n == len(raw) and out.getvalue() == raw
    assert launch_counts()["huffdecode_serial"] == launch_counts()["plane_consumer"] == frames
    assert launch_counts()["huffdecode_chain"] == 0


def test_file_on_card_by_default(cuda, tmp_path):
    """No backend given: every frame is host bytes, so "auto" encodes it
    with K3 and K7 on the present card, and the file is the host's."""
    cfg = zipnn.ZipNNConfig(chunk_param_bytes=1 << 16, backend="huffman")
    raw = _raw_stream(1_500_000, 34)
    src = tmp_path / "w.raw"
    src.write_bytes(raw)
    engine.compress_file(str(src), str(tmp_path / "host.znns"), "bfloat16", cfg,
                         window_bytes=1 << 20, options=HOST)
    reset_launch_counts()
    engine.compress_file(str(src), str(tmp_path / "auto.znns"), "bfloat16", cfg,
                         window_bytes=1 << 20)
    frames = len(list(engine.frame_records(str(tmp_path / "auto.znns"))))
    assert frames == 3
    assert launch_counts()["plane_producer"] == launch_counts()["bitpack_encode_chunks"] == frames
    assert (tmp_path / "auto.znns").read_bytes() == (tmp_path / "host.znns").read_bytes()


def test_stream_fixture_decodes_on_card(cuda):
    with open(os.path.join(FIXTURES, "meta.json")) as f:
        fx = next(x for x in json.load(f)["fixtures"] if x["kind"] == "stream")
    with open(os.path.join(FIXTURES, fx["raw"]), "rb") as f:
        raw = f.read()
    reset_launch_counts()
    out = io.BytesIO()
    engine.decompress_file(os.path.join(FIXTURES, fx["blob"]), out,
                           zipnn.ZipNNConfig(**fx["config"]), options=CodecOptions(backend="device"))
    assert out.getvalue() == raw
    assert launch_counts()["plane_consumer"] > 0             # zlib chunks: no K1


def _card_state(step, cuda):
    g = torch.Generator().manual_seed(40)
    params = {"w": (torch.randn((3, 256, 192), generator=g) * 0.02).to(torch.bfloat16),
              "b": (torch.randn(192, generator=g) * 0.02).to(torch.bfloat16)}
    m = {k: torch.zeros(v.shape) for k, v in params.items()}
    v = {k: torch.zeros(p.shape) for k, p in params.items()}
    for t in range(step):
        g = torch.Generator().manual_seed(50 + t)
        for k in sorted(params):
            grad = torch.randn(params[k].shape, generator=g) * 1e-2
            m[k] = 0.9 * m[k] + 0.1 * grad
            v[k] = 0.95 * v[k] + 0.05 * grad * grad
            params[k] = (params[k].float() - 1e-4 * torch.randn(
                params[k].shape, generator=g)).to(torch.bfloat16)
    state = {"params": params, "opt": {"m": m, "v": v, "step": torch.tensor(step)}}
    return _util.tree_map(lambda t: t.to(cuda), state)


def _ckpt(path, backend, **kw):
    return CheckpointManager(CheckpointConfig(
        str(path), base_every=3, backend=backend,
        zipnn=zipnn.ZipNNConfig(chunk_param_bytes=1 << 16, backend="huffman"), **kw))


def test_checkpoint_on_card_equals_host_and_restores_on_card(cuda, tmp_path):
    card, host = _ckpt(tmp_path / "card", "device"), _ckpt(tmp_path / "host", "host")
    reset_launch_counts()
    for s in range(4):
        state = _card_state(s, cuda)
        card.save(s, state)
        host.save(s, state)
        card.wait()
        host.wait()
    assert launch_counts()["plane_producer"] > 0 and launch_counts()["bitpack_encode_chunks"] > 0
    held = card.held_bytes()
    assert held["base_card"] > 0 and held["moments_card"] > 0
    assert held["base_host"] == held["moments_host"] == 0
    for s in range(4):
        for name in ("manifest.json", "data.bin"):
            assert (tmp_path / "card" / f"step_{s}" / name).read_bytes() == (
                tmp_path / "host" / f"step_{s}" / name).read_bytes(), (s, name)
    want = _card_state(2, cuda)
    reset_launch_counts()
    step, tree = card.restore(2, device_resident=True)
    assert step == 2
    assert launch_counts()["huffdecode_serial"] > 0 and launch_counts()["plane_consumer"] > 0
    assert launch_counts()["huffdecode_chain"] == 0
    got, ref = _util.tree_flatten_with_keys(tree), _util.tree_flatten_with_keys(want)
    assert [k for k, _ in got] == [k for k, _ in ref]
    for (k, a), (_, b) in zip(got, ref):
        assert a.is_cuda and a.dtype == b.dtype and a.shape == b.shape, k
        assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)), k


def test_card_save_is_a_snapshot(cuda, tmp_path):
    """The state updated in place on the caller's stream right after save()
    does not reach what the save thread writes."""
    mgr = _ckpt(tmp_path, "device")
    state = _card_state(1, cuda)
    want = {k: t.clone() for k, t in state["params"].items()}
    torch.cuda._sleep(50_000_000)                  # the caller's stream is still busy
    mgr.save(1, state)
    for t in state["params"].values():
        t.add_(1)
    mgr.wait()
    _, tree = mgr.restore(device_resident=True)
    for k, t in want.items():
        assert torch.equal(tree["params"][k].view(torch.int16), t.view(torch.int16))


def test_card_save_whose_k7_fails_raises_and_publishes_nothing(cuda, tmp_path, monkeypatch):
    _build.load("bitpack")
    monkeypatch.setattr(bitpack_mod, "_launcher", lambda: (lambda *a: 1))
    mgr = _ckpt(tmp_path, "device")
    mgr.save(0, _card_state(0, cuda))
    with pytest.raises(RuntimeError, match="bitpack_encode_chunks launch"):
        mgr.wait()
    assert mgr.latest_step() is None
    assert not any(n.startswith("step_") for n in os.listdir(tmp_path))


# ---------------------------------------------------------------------------
# granite_20b's widths: one 6144x24576 MLP weight (1,152 plane chunks,
# 18,432 K7 segments, a single leaf over MAX_BATCH_BYTES), and the tiered
# ring on the card
# ---------------------------------------------------------------------------

W_IN = (6144, 24576)
PLANE_CHUNK = 131_072


def _card_bf16(shape, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=device) * 0.02).to(torch.bfloat16)


def _chunk_slice(args, a, b):
    """K1's per-chunk arrays cut to chunks ``a:b`` (offsets stay absolute)."""
    out = dict(args)
    for k in ("plane_ids", "counts", "out_off"):
        out[k] = args[k][a:b].contiguous()
    for k in ("word_off", "sync_off"):
        out[k] = args[k][a : b + 1].contiguous()
    return out


def test_full_width_leaf_k7_k1_on_card(cuda):
    """The w_in leaf of granite_20b encoded on the card (K3, K7) equals the
    host's blob; its feed's index pass (K1 serial) and sync decode restore
    it bit for bit; K1's sync decode and index pass equal their plain
    versions on the first and last chunks."""
    from repro_torch.core.device_plane import MAX_BATCH_BYTES

    cfg = zipnn.ZipNNConfig(backend="huffman")           # 256 KiB: 131,072-symbol planes
    leaf = _card_bf16(W_IN, 0, cuda)
    reset_launch_counts()
    ct = zipnn.compress_array(leaf, cfg, options=CodecOptions(backend="device", threads=-1))
    meta, _ = container.unpack_stream(ct.blob)
    n_huff = sum(e.method == codec.Method.HUFF for pe in meta.entries for e in pe)
    assert n_huff >= W_IN[0] * W_IN[1] // PLANE_CHUNK
    assert launch_counts()["plane_producer"] == 1        # one leaf over the cap: its own launch
    # K7 packs at most MAX_BATCH_BYTES / (2 * chunk bytes) = 1,024 chunks a launch
    assert launch_counts()["bitpack_encode_chunks"] == -(-n_huff // (MAX_BATCH_BYTES // (2 * PLANE_CHUNK)))
    host = zipnn.compress_array(leaf.cpu(), cfg, options=CodecOptions(backend="host", threads=-1))
    assert ct.blob == host.blob
    feed = zipnn.build_array_feed(ct, cfg, device=cuda)
    assert launch_counts()["huffdecode_index"] == 1
    assert launch_counts()["huffdecode_chain"] == 0
    assert torch.equal(feed.decode().view(torch.int16), leaf.view(torch.int16))
    args = feed.launch_args()
    n_out = args.pop("out_bytes")
    n = args["counts"].numel()
    assert n >= W_IN[0] * W_IN[1] // PLANE_CHUNK          # the exponent plane's 1,152
    full = torch.zeros(n_out, dtype=torch.uint8, device=cuda)
    cur = huffdecode_chunks(**args, out=full)
    for a, b in ((0, 6), (n - 6, n)):
        part = _chunk_slice(args, a, b)
        out_p = torch.zeros(n_out, dtype=torch.uint8, device=cuda)
        cur_p = huffdecode_chunks_plain(**part, out=out_p)
        sync, sync_off = part.pop("sync"), part.pop("sync_off")
        out_i = torch.zeros(n_out, dtype=torch.uint8, device=cuda)
        cur_i, sync_i = huffdecode_index(**part, out=out_i, sync_off=sync_off)
        lo = int(part["out_off"][0])
        hi = int(part["out_off"][-1]) + int(part["counts"][-1])
        assert torch.equal(cur_p, cur[a:b]) and torch.equal(cur_i, cur[a:b])
        assert torch.equal(out_p[lo:hi], full[lo:hi]) and torch.equal(out_i[lo:hi], full[lo:hi])
        lo_s, hi_s = int(sync_off[0]), int(sync_off[-1])   # the slice's entries, absolute
        assert torch.equal(sync_i[lo_s:hi_s], sync[lo_s:hi_s])


def test_full_width_k7_segments_match_plain(cuda):
    """K7 over the 1,152 exponent-plane chunks of a 6144x24576 leaf (18,432
    segments, over five times the 3,200 of the test above) against its
    plain version on the first and last chunks."""
    leaf = _card_bf16(W_IN, 1, cuda)
    planes, _ = plane_producer(leaf.view(torch.int16).reshape(-1), itemsize=2,
                               chunk_elems=PLANE_CHUNK)
    exp = planes[0].contiguous()               # the exponent plane
    counts = torch.bincount(exp, minlength=256).cpu().numpy()
    lens = huffman.code_lengths(counts + 1)
    codes = huffman.canonical_codes(lens)
    c = exp.numel() // PLANE_CHUNK
    assert c * (PLANE_CHUNK // bitpack_mod.SEGMENT_SYMS) == 18_432
    tabs = [torch.from_numpy(np.asarray(t, dtype=np.int32)[None]).to(cuda) for t in (lens, codes)]
    pids = torch.zeros(c, dtype=torch.int32, device=cuda)
    wk, nk = bitpack_encode_chunks(exp, pids, *tabs, chunk_syms=PLANE_CHUNK)
    assert int(nk.min()) > 0                   # no -1 (table) or -2 (look-back gave up)
    for a, b in ((0, 4), (c - 4, c)):
        wp, np_ = bitpack_encode_chunks_plain(
            exp[a * PLANE_CHUNK : b * PLANE_CHUNK].contiguous(), pids[a:b].contiguous(), *tabs,
            chunk_syms=PLANE_CHUNK)
        assert torch.equal(nk[a:b], np_) and torch.equal(wk[a:b], wp)


def test_k3_single_leaf_over_the_batch_cap(cuda):
    """A 6144x24576 bf16 leaf (302 MB) is over MAX_BATCH_BYTES: it planes
    in one launch of its own, and the next leaf in another."""
    from repro_torch.core import bitlayout, device_plane

    leaf = _card_bf16(W_IN, 2, cuda)
    assert leaf.numel() * 2 > device_plane.MAX_BATCH_BYTES
    x = leaf.view(torch.int16).reshape(-1)
    pk, hk = plane_producer(x, itemsize=2, chunk_elems=PLANE_CHUNK)
    pp, hp = plane_producer_plain(x, itemsize=2, chunk_elems=PLANE_CHUNK)
    assert torch.equal(pk, pp) and torch.equal(hk, hp)
    small = _card_bf16((1000,), 3, cuda)
    layout = bitlayout.layout_for("bfloat16")
    params = zipnn.ZipNNConfig().plane_params(2)
    reset_launch_counts()
    out = device_plane.produce_planes_batched([leaf, small], layout, params, device=cuda)
    assert launch_counts()["plane_producer"] == 2
    for p in range(2):
        assert np.array_equal(np.asarray(out[0][0][p]), pp[p].cpu().numpy())
    want_small, _ = plane_producer_plain(small.view(torch.int16), itemsize=2, chunk_elems=1000)
    for p in range(2):
        assert np.array_equal(np.asarray(out[1][0][p]), want_small[p].cpu().numpy())


def test_tiered_ring_on_card(cuda):
    """granite_20b reduced on the card: the ring at tiles=2 with a KV store
    is bit-identical to the plain step over the untiered cache; evicted
    blocks encode on the card (K3, K7) to the host's bytes and decode
    there (K1's one-shot decode, K2)."""
    from repro_torch.models.model import init_params
    from repro_torch.serve import KVCacheStore

    cfg = get_config("granite_20b").reduced()
    params = init_params(cfg, 0, device=cuda)
    steps, B = 12, 2
    toks = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab_size, (steps, B, 1)).astype(np.int32)
    ).to(cuda)
    state = init_decode_state(cfg, B, steps, start_pos=0, device=cuda)
    want = []
    for t in toks:
        logits, state = decode_step(cfg, params, state, t)
        want.append(logits)
    zcfg = zipnn.ZipNNConfig(chunk_param_bytes=1 << 15, backend="huffman")   # K3's least chunk
    kv = KVCacheStore(init_decode_state(cfg, B, steps, start_pos=0, device=cuda),
                      hot_window=3, block_len=2, config=zcfg)
    store = CompressedParamStore.from_params(
        params, zcfg, options=CodecOptions(backend="device"), payload_feed=True)
    cstep = make_compressed_serve_step(cfg, store, ring=2, tiles=2, kv_store=kv)
    reset_launch_counts()
    s = {"pos": torch.tensor(0, dtype=torch.int32, device=cuda)}
    for i, t in enumerate(toks):
        logits, s = cstep(s, t)
        assert torch.equal(logits.view(torch.int32), want[i].view(torch.int32)), i
    counts = launch_counts()
    assert kv.n_cold_blocks == (steps - 3) // 2
    assert counts["plane_producer"] == 2 * cfg.n_layers * kv.n_cold_blocks
    assert counts["huffdecode_serial"] > 0 and counts["plane_consumer"] > 0
    assert counts["huffdecode_chain"] == 0
    assert store.peak_resident <= 2 * 2
    for key in kv.keys:
        for j in range(cfg.n_layers):
            for b, ct in enumerate(kv.cold_blocks(key, j)):
                block = state[key][j][:, 2 * b : 2 * b + 2].contiguous().cpu()
                assert ct.blob == zipnn.compress_array(block, zcfg, options=HOST).blob


# -- the MoE family (olmoe_1b_7b, deepseek_v2_236b) -----------------------------

@pytest.mark.parametrize("name", ["olmoe_1b_7b", "deepseek_v2_236b"])
def test_moe_decode_on_card_matches_the_cpu(cuda, name):
    """The MoE decode step on the card against its CPU run on the same
    params: the same experts chosen (the router a full f32 product, TF32
    off), logits within 1e-4 of the largest."""
    from repro_torch.models import moe
    from repro_torch.models.model import init_params

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config(name).reduced()
    params = init_params(cfg, 0, device="cpu")
    card = _util.tree_map(lambda a: a.to(cuda), params)
    layer = _util.tree_map(lambda a: a[0], params["moe_layers"]["moe"])
    xt = (torch.randn(16, cfg.d_model, generator=torch.Generator().manual_seed(1))
          ).to(torch.bfloat16)
    _, g0, i0 = moe.route(layer, xt, cfg)
    _, g1, i1 = moe.route(_util.tree_map(lambda a: a.to(cuda), layer), xt.to(cuda), cfg)
    assert torch.equal(i0, i1.cpu()) and torch.allclose(g0, g1.cpu(), rtol=1e-6, atol=0)
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 2, 1)).astype(np.int32))
    sa = init_decode_state(cfg, 2, 4, start_pos=0, device="cpu")
    sb = init_decode_state(cfg, 2, 4, start_pos=0, device=cuda)
    for t in toks:
        la, sa = decode_step(cfg, params, sa, t)
        lb, sb = decode_step(cfg, card, sb, t.to(cuda))
        assert (la - lb.cpu()).abs().max() <= 1e-4 * la.abs().max()


@pytest.mark.parametrize("name", ["olmoe_1b_7b", "deepseek_v2_236b"])
def test_moe_ring_on_card_with_the_f32_router(cuda, name):
    """The MoE store built on the card (both stacks for deepseek), its f32
    router leaves decoded every ring step through K2's 4-byte path: the
    ring at tiles 1 and 2 bit-identical to the plain step, and each
    decoded router equal to its param."""
    from repro_torch.models.model import init_params

    cfg = get_config(name).reduced()
    params = init_params(cfg, 0, device=cuda)
    zcfg = zipnn.ZipNNConfig(chunk_param_bytes=1 << 15, backend="huffman")   # K3's least chunk
    store = CompressedParamStore.from_params(
        params, zcfg, options=CodecOptions(backend="device"), payload_feed=True)
    assert store.stack_keys == tuple(k for k in ("dense_layers", "moe_layers") if k in params)
    router = store.decode_layer("moe_layers", 0)["moe"]["router"]["w"]
    store.release("moe_layers", 0)
    assert router.dtype == torch.float32 and router.is_cuda
    assert torch.equal(router.view(torch.int32),
                       params["moe_layers"]["moe"]["router"]["w"][0].view(torch.int32))
    steps = 6
    toks = torch.from_numpy(
        np.random.default_rng(5).integers(0, cfg.vocab_size, (steps, 2, 1)).astype(np.int32)
    ).to(cuda)
    state = init_decode_state(cfg, 2, steps, start_pos=0, device=cuda)
    want = []
    for t in toks:
        logits, state = decode_step(cfg, params, state, t)
        want.append(logits)
    for tiles in (1, 2):
        cstep = make_compressed_serve_step(cfg, store, ring=2, tiles=tiles)
        reset_launch_counts()
        s = init_decode_state(cfg, 2, steps, start_pos=0, device=cuda)
        for i, t in enumerate(toks):
            logits, s = cstep(s, t)
            assert torch.equal(logits.view(torch.int32), want[i].view(torch.int32)), (tiles, i)
        counts = launch_counts()
        feeds = [f for k in store.stack_keys for layer in store.feeds(k) for f in layer]
        assert all(f is not None for f in feeds)
        assert counts["plane_consumer"] == steps * sum(
            f.n_launches["plane_consumer"] for f in feeds)
        assert counts["huffdecode_serial"] == counts["huffdecode_index"] == 0
        assert counts["huffdecode_chain"] == 0


def test_mla_kv_tier_on_card(cuda):
    """deepseek reduced on the card: the ring with the MLA KV tier is
    bit-identical to the plain step, and its evicted latent blocks encode
    on the card to the host's bytes."""
    from repro_torch.models.model import init_params
    from repro_torch.serve import KVCacheStore

    cfg = get_config("deepseek_v2_236b").reduced()
    params = init_params(cfg, 0, device=cuda)
    steps, B = 12, 2
    toks = torch.from_numpy(
        np.random.default_rng(6).integers(0, cfg.vocab_size, (steps, B, 1)).astype(np.int32)
    ).to(cuda)
    state = init_decode_state(cfg, B, steps, start_pos=0, device=cuda)
    want = []
    for t in toks:
        logits, state = decode_step(cfg, params, state, t)
        want.append(logits)
    zcfg = zipnn.ZipNNConfig(chunk_param_bytes=1 << 15, backend="huffman")
    kv = KVCacheStore(init_decode_state(cfg, B, steps, start_pos=0, device=cuda),
                      hot_window=3, block_len=2, config=zcfg)
    assert kv.keys == ("mla_ckv", "mla_kr")
    store = CompressedParamStore.from_params(
        params, zcfg, options=CodecOptions(backend="device"), payload_feed=True)
    cstep = make_compressed_serve_step(cfg, store, ring=2, tiles=1, kv_store=kv)
    s = {"pos": torch.tensor(0, dtype=torch.int32, device=cuda)}
    for i, t in enumerate(toks):
        logits, s = cstep(s, t)
        assert torch.equal(logits.view(torch.int32), want[i].view(torch.int32)), i
    assert kv.n_cold_blocks == (steps - 3) // 2
    for key in kv.keys:
        for j in range(cfg.n_layers):
            for b, ct in enumerate(kv.cold_blocks(key, j)):
                block = state[key][j][:, 2 * b : 2 * b + 2].contiguous().cpu()
                assert ct.blob == zipnn.compress_array(block, zcfg, options=HOST).blob


def test_256_mib_expert_leaf_launch_counts(cuda):
    """olmoe's expert leaf, (64, 2048, 1024) bf16, is exactly
    MAX_BATCH_BYTES and its exponent plane exactly K7's 1,024-chunk cap: it
    takes one K3 window of its own (the leaf after it another) and one K7
    launch, and its blob equals the host's."""
    from repro_torch.core import device_plane

    leaf = _card_bf16((64, 2048, 1024), 7, cuda)
    assert leaf.numel() * 2 == device_plane.MAX_BATCH_BYTES
    small = _card_bf16((2048, 64), 8, cuda)
    reset_launch_counts()
    manifest = zipnn.compress_pytree({"a": leaf, "b": small}, zipnn.ZipNNConfig(
        backend="huffman"), options=CodecOptions(backend="device"))
    counts = launch_counts()
    assert counts["plane_producer"] == 2
    ct = manifest["leaves"][0]
    meta, _ = container.unpack_stream(ct.blob)
    huff = sum(e.method == codec.Method.HUFF for pe in meta.entries for e in pe)
    assert huff == 1024 and meta.chunk_bytes == PLANE_CHUNK
    small_huff = sum(e.method == codec.Method.HUFF for pe in container.unpack_stream(
        manifest["leaves"][1].blob)[0].entries for e in pe)
    assert counts["bitpack_encode_chunks"] == 1 + (small_huff > 0)
    host = zipnn.compress_array(leaf.cpu(), zipnn.ZipNNConfig(backend="huffman"), options=HOST)
    assert ct.blob == host.blob
