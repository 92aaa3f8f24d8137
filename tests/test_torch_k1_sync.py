"""K1's sync-point index and sync decode, on the CPU (plain versions).

A resident payload feed runs K1's serial decode once at build as the
index pass, which records the bit cursor before every ``sync_every``-th
symbol of each chunk; every later decode cuts each chunk there into
sub-streams that decode in parallel.  Here the plain versions, which the
wrappers run for CPU tensors, are held against independent references on
inputs made from numpy seeds: the index against the code lengths summed
over each chunk's symbols and against the cursors of the reference's
Pallas kernel (``repro.kernels.huffdecode.huffdecode_chunks_multi``, in
interpret mode) on prefixes of the chunks; the sync decode against the
serial plain decode and the reference kernel.  The CUDA kernels run only on
the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).  Tolerance:
none — symbols, cursors and index entries are integers and must be equal.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import huffdecode as ref_huffdecode
from repro_torch.core import codec, container, device_entropy, huffman, zipnn
from repro_torch.kernels import (
    huffdecode_chunks,
    huffdecode_chunks_plain,
    huffdecode_index,
    huffdecode_index_plain,
    huffdecode_serial,
    launch_counts,
)
from repro_torch.kernels.huffdecode import SYNC_EVERY, fuse_lut, pack_words, sync_offsets

HUFF = zipnn.ZipNNConfig(chunk_param_bytes=1 << 11, backend="huffman")


def _skewed(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = np.r_[np.full(16, 0.05), np.full(240, 0.2 / 240)]
    return rng.choice(256, p=p, size=n).astype(np.uint8)


def _case(planes, cb):
    """K1 inputs for ``planes`` (one table each) cut into ``cb``-symbol
    chunks, plus every symbol's code length and the chunks' payloads."""
    encs = []
    for plane in planes:
        lens = huffman.code_lengths(np.bincount(plane, minlength=256) + 1)
        encs.append((lens, huffman.canonical_codes(lens)))
    width = max(int(lens.max()) for lens, _ in encs)
    payloads, counts, pids, bits = [], [], [], []
    for pid, (plane, (lens, codes)) in enumerate(zip(planes, encs)):
        cnt = [min(cb, plane.size - o) for o in range(0, plane.size, cb)]
        payloads += huffman.encode_chunks(plane, np.asarray(cnt), lens, codes)
        counts += cnt
        pids += [pid] * len(cnt)
        bits.append(lens[plane].astype(np.int64))
    luts = np.stack([fuse_lut(*huffman._build_lut(l, c, width)) for l, c in encs])
    words, word_off = pack_words(payloads)
    counts = np.asarray(counts, np.int32)
    out_off = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        words, word_off, np.asarray(pids, np.int32), counts, out_off, luts)]
    return args, counts, np.concatenate(bits), payloads, encs, width


def _want_index(counts, bits, every):
    """Cursor before every ``every``-th symbol: the code lengths summed."""
    want, start = [], 0
    for c in counts:
        want.append(np.cumsum(np.r_[0, bits[start : start + c]])[0:c:every])
        start += int(c)
    return np.concatenate(want).astype(np.int32)


# (planes, chunk symbols, symbols per sub-stream): a short final chunk that
# 512 does not divide; 2,048-symbol chunks that 300 does not divide; a
# 1-symbol chunk; two tables of different widths selected per chunk; a
# sub-stream longer than every chunk.
CASES = {
    "short_final_chunk": ([_skewed(3 * 2048 + 700, 1)], 2048, SYNC_EVERY),
    "every_not_dividing": ([_skewed(2 * 2048, 2)], 2048, 300),
    "one_symbol_chunk": ([_skewed(2048 + 1, 3)], 2048, 300),
    "multi_table": ([_skewed(2048 + 999, 4), (np.arange(3000) % 7).astype(np.uint8)], 2048, 256),
    "every_above_count": ([_skewed(1500, 5)], 2048, 4096),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_index_plain_sums_code_lengths(name):
    planes, cb, every = CASES[name]
    args, counts, bits, payloads, _, _ = _case(planes, cb)
    sync_off = torch.from_numpy(sync_offsets(counts, every))
    out = torch.zeros(int(counts.sum()), dtype=torch.uint8)
    cursors, sync = huffdecode_index_plain(*args, out, sync_off, every)
    assert np.array_equal(sync.numpy(), _want_index(counts, bits, every))
    assert sync.numel() == int(sync_off[-1]) == sum(-(-int(c) // every) for c in counts)
    assert np.array_equal(out.numpy(), np.concatenate(planes))
    sizes = np.asarray([len(p) for p in payloads])
    assert np.all((sizes * 8 - cursors.numpy() >= 0) & (sizes * 8 - cursors.numpy() < 8))


def test_index_matches_reference_kernel_prefix_cursors():
    """Entry k of a chunk is the reference kernel's final cursor when it
    decodes only the chunk's first k * every symbols."""
    cb, every = 2048, 512
    planes = [_skewed(2 * cb + 333, 6)]
    args, counts, _, payloads, encs, width = _case(planes, cb)
    sync_off = torch.from_numpy(sync_offsets(counts, every))
    _, sync = huffdecode_index_plain(
        *args, torch.zeros(int(counts.sum()), dtype=torch.uint8), sync_off, every)
    lut_sym, lut_len = huffman._build_lut(*encs[0], width)
    ref_lut = ((lut_sym.astype(np.int32) << 8) | lut_len.astype(np.int32))[None]
    jobs = [(c, k * every) for c in range(len(counts)) for k in range(-(-int(counts[c]) // every))]
    words = np.zeros(len(jobs) * (cb // 4), np.uint32)
    for j, (c, _) in enumerate(jobs):
        w = np.frombuffer(payloads[c] + b"\x00" * (-len(payloads[c]) % 4), dtype=">u4")
        words[j * (cb // 4) : j * (cb // 4) + w.size] = w
    _, cur_r = ref_huffdecode.huffdecode_chunks_multi(
        jnp.asarray(words), jnp.zeros(len(jobs), jnp.int32),
        jnp.asarray([n for _, n in jobs], jnp.int32), jnp.asarray(ref_lut),
        chunk_bytes=cb, interpret=True,
    )
    assert np.array_equal(np.asarray(cur_r), sync.numpy())


@pytest.mark.parametrize("name", sorted(CASES))
def test_sync_plain_equals_serial_plain(name):
    planes, cb, every = CASES[name]
    args, counts, _, _, _, _ = _case(planes, cb)
    sync_off = torch.from_numpy(sync_offsets(counts, every))
    n = int(counts.sum())
    out_s, out_i, out_k = (torch.zeros(n, dtype=torch.uint8) for _ in range(3))
    cur_s = huffdecode_chunks_plain(*args, out_s)
    cur_i, sync = huffdecode_index_plain(*args, out_i, sync_off, every)
    cur_k = huffdecode_chunks_plain(*args, out_k, sync, sync_off, every)
    assert torch.equal(cur_k, cur_s) and torch.equal(cur_i, cur_s)
    assert torch.equal(out_k, out_s) and torch.equal(out_i, out_s)
    assert np.array_equal(out_k.numpy(), np.concatenate(planes))


def test_sync_plain_matches_reference_kernel():
    cb, every = 2048, 300
    planes = [_skewed(cb + 900, 7), (np.arange(2500) % 5).astype(np.uint8)]
    args, counts, _, payloads, encs, width = _case(planes, cb)
    sync_off = torch.from_numpy(sync_offsets(counts, every))
    n = int(counts.sum())
    _, sync = huffdecode_index_plain(*args, torch.zeros(n, dtype=torch.uint8), sync_off, every)
    out = torch.zeros(n, dtype=torch.uint8)
    cur = huffdecode_chunks_plain(*args, out, sync, sync_off, every)
    rows = [huffman._build_lut(*e, width) for e in encs]
    ref_lut = np.stack([(s.astype(np.int32) << 8) | l.astype(np.int32) for s, l in rows])
    words = np.zeros(len(counts) * (cb // 4), np.uint32)
    for c, p in enumerate(payloads):
        w = np.frombuffer(p + b"\x00" * (-len(p) % 4), dtype=">u4")
        words[c * (cb // 4) : c * (cb // 4) + w.size] = w
    syms_r, cur_r = ref_huffdecode.huffdecode_chunks_multi(
        jnp.asarray(words), jnp.asarray(args[2].numpy()), jnp.asarray(counts),
        jnp.asarray(ref_lut), chunk_bytes=cb, interpret=True,
    )
    assert np.array_equal(cur.numpy(), np.asarray(cur_r))
    syms_r = np.asarray(syms_r).reshape(len(counts), cb)
    got = np.concatenate([syms_r[c, : counts[c]] for c in range(len(counts))])
    assert np.array_equal(out.numpy(), got)


def test_sync_plain_runaway_cursor_is_past_the_payload():
    """A truncated payload, indexed as it is: the sync decode's final
    cursor lands past the payload, as the serial one does."""
    cb, every = 2048, 512
    args, counts, _, payloads, _, _ = _case([_skewed(cb, 8)], cb)
    cut = payloads[0][: len(payloads[0]) // 2]
    words, word_off = pack_words([cut])
    args[0], args[1] = torch.from_numpy(words), torch.from_numpy(word_off)
    sync_off = torch.from_numpy(sync_offsets(counts, every))
    n = int(counts.sum())
    out_s, out_k = torch.zeros(n, dtype=torch.uint8), torch.zeros(n, dtype=torch.uint8)
    cur_s, sync = huffdecode_index_plain(*args, out_s, sync_off, every)
    cur_k = huffdecode_chunks_plain(*args, out_k, sync, sync_off, every)
    assert torch.equal(cur_k, cur_s) and int(cur_k[0]) > 8 * len(cut)


def test_wrappers_run_plain_on_cpu_uncounted_and_refuse_other_devices():
    cb, every = 2048, 512
    args, counts, _, _, _, _ = _case([_skewed(cb + 10, 9)], cb)
    sync_off = torch.from_numpy(sync_offsets(counts, every))
    n = int(counts.sum())
    before = launch_counts()
    cur_i, sync = huffdecode_index(*args, torch.zeros(n, dtype=torch.uint8), sync_off)
    out = torch.zeros(n, dtype=torch.uint8)
    assert torch.equal(huffdecode_chunks(*args, out, sync, sync_off), cur_i)
    assert torch.equal(huffdecode_serial(*args, torch.zeros(n, dtype=torch.uint8)), cur_i)
    assert launch_counts() == before                 # CPU: plain versions, uncounted
    meta = [a.to("meta") for a in args]
    for call in (
        lambda: huffdecode_chunks(*meta, out.to("meta"), sync.to("meta"), sync_off.to("meta")),
        lambda: huffdecode_serial(*meta, out.to("meta")),
        lambda: huffdecode_index(*meta, out.to("meta"), sync_off.to("meta")),
    ):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    with pytest.raises(ValueError, match="together"):
        huffdecode_chunks(*args, out, sync)
    with pytest.raises(ValueError, match="sync_off"):
        huffdecode_chunks(*args, out, sync, sync_off[:-1])
    with pytest.raises(ValueError, match="sync"):
        huffdecode_chunks(*args, out, sync.to(torch.int64), sync_off)


def test_sync_offsets():
    assert sync_offsets(np.asarray([0, 1, 512, 513, 1024]), 512).tolist() == [0, 0, 1, 2, 4, 6]
    assert sync_offsets(np.zeros(0, np.int32)).tolist() == [0]


# ---------------------------------------------------------------------------
# the feed keeps the index resident
# ---------------------------------------------------------------------------

def _bf16(shape, seed):
    a = (np.random.default_rng(seed).standard_normal(shape) * 0.02).astype(np.float32)
    return torch.from_numpy(a).to(torch.bfloat16)


def test_array_feed_carries_the_index_and_decodes_bit_exactly():
    leaf = _bf16((300, 200), 10)
    ct = zipnn.compress_array(leaf, HUFF)
    feed = zipnn.build_array_feed(ct, HUFF, device="cpu")
    args = feed.launch_args()
    counts = args["counts"].numpy()
    assert args["sync"].dtype == torch.int32 and args["sync_off"].dtype == torch.int64
    assert np.array_equal(args["sync_off"].numpy(), sync_offsets(counts))
    assert args["sync"].numel() == int(args["sync_off"][-1])
    for _ in range(2):
        assert torch.equal(feed.decode().view(torch.int16), leaf.view(torch.int16))
    n = args.pop("out_bytes")
    out_k, out_s = torch.zeros(n, dtype=torch.uint8), torch.zeros(n, dtype=torch.uint8)
    cur_k = huffdecode_chunks(**args, out=out_k)
    args.pop("sync"), args.pop("sync_off")
    assert torch.equal(cur_k, huffdecode_serial(**args, out=out_s)) and torch.equal(out_k, out_s)


def test_mixed_store_huff_stream_feed_decodes_and_indexes_huff_only():
    cb = 1024
    params = codec.CodecParams(chunk_bytes=cb, backend="huffman")
    rng = np.random.default_rng(11)
    planes = [
        np.concatenate([
            rng.integers(0, 256, cb, dtype=np.uint8),     # STORE
            np.zeros(cb, dtype=np.uint8),                 # ZERO
            _skewed(cb + cb // 3, seed=12),               # HUFF + partial chunk
        ]),
        _skewed(2 * cb + 1, seed=13),                     # HUFF, then a 1-symbol chunk
    ]
    outs = [codec.compress_plane(p, params) for p in planes]
    entries = [o[0] for o in outs]
    methods = {e.method for pe in entries for e in pe}
    assert {codec.Method.HUFF, codec.Method.STORE, codec.Method.ZERO} <= methods
    feed = device_entropy.PayloadFeed(
        entries, [o[1] for o in outs], [o[2] for o in outs], params, device="cpu")
    for got, want in zip(feed.decode(), planes):
        assert np.array_equal(got.numpy(), want)
    args = feed.launch_args()
    huff = [e.raw_len for pe in entries for e in pe if e.method == codec.Method.HUFF]
    assert args["counts"].tolist() == huff
    assert args["sync"].numel() == sum(-(-n // SYNC_EVERY) for n in huff)


def test_feed_build_rejects_a_truncated_payload_at_the_index_pass():
    leaf = _bf16((128, 128), 14)
    ct = zipnn.compress_array(leaf, HUFF)
    meta, mv = container.unpack_stream(ct.blob)
    payloads = [[container.payload_view(meta, mv, p, c) for c in range(len(meta.entries[p]))]
                for p in range(meta.n_planes)]
    entries = [list(pe) for pe in meta.entries]
    e = entries[0][0]
    assert e.method == codec.Method.HUFF
    cut = bytes(payloads[0][0][: len(payloads[0][0]) // 2])
    entries[0][0] = codec.ChunkEntry(e.method, len(cut), e.raw_len, zlib.crc32(cut))
    payloads[0][0] = cut
    params = codec.CodecParams(chunk_bytes=meta.chunk_bytes, backend="huffman")
    before = launch_counts()
    with pytest.raises(ValueError, match="cursor|pad"):
        device_entropy.PayloadFeed(entries, payloads, meta.tables, params, device="cpu")
    assert launch_counts() == before


def test_sync_index_costs_under_one_percent_of_a_bf16_feed():
    """At the default chunking the index is 4 B per SYNC_EVERY symbols of
    HUFF chunks plus 8 B per chunk: under 1% of the feed's resident bytes."""
    leaf = _bf16((1024, 768), 15)
    cfg = zipnn.ZipNNConfig(backend="huffman")
    feed = zipnn.build_array_feed(zipnn.compress_array(leaf, cfg), cfg, device="cpu")
    args = feed.launch_args()
    index = args["sync"].numel() * 4 + args["sync_off"].numel() * 8
    assert index == 4 * sum(-(-int(c) // SYNC_EVERY) for c in args["counts"]) + \
        8 * (args["counts"].numel() + 1)
    assert 0 < index < 0.01 * feed.device_bytes
