"""K1's self-synchronising decode, on the CPU (its plain version).

The one-shot decode and a feed's index pass run K1's self-synchronising
kernel: a chunk's bits are cut into segments that start at guessed
offsets, segments restart from their predecessor's end until nothing
changes, a scan of their symbol counts places them, and they decode again;
what lies past the words or past a length-0 entry is written in closed
form.  Here the plain version, which the wrappers run for CPU tensors and
the card holds the kernel against, is held against the independent serial
oracle ``_serial_plain`` (one symbol of every chunk a step) and against the
reference's Pallas kernel (``repro.kernels.huffdecode.huffdecode_chunks_multi``
in interpret mode) on inputs made from numpy seeds: valid streams,
truncated, extended and bit-flipped payloads, random words under random
LUTs, incomplete codes (LUT entries of length 0, a one-symbol plane), codes
whose lengths share a factor (many synchronisation rounds), ``counts`` of
0 and below and above what the words hold, and segments of 16 to 1,024
bits, sizes that do not divide the words and more segments than a block of
the kernel has threads.  The CUDA kernel runs only on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).  Tolerance: none —
symbols, cursors and index entries are integers and must be equal.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hyp_compat import given, settings, strategies as st
from repro.kernels import huffdecode as ref_huffdecode
from repro_torch.core import codec, container, device_entropy, huffman, zipnn
from repro_torch.kernels import (
    huffdecode_chain,
    huffdecode_chunks,
    huffdecode_index,
    huffdecode_selfsync_plain,
    huffdecode_serial,
    launch_counts,
)
from repro_torch.kernels.huffdecode import (
    SEG_BITS, SYNC_EVERY, _serial_plain, fuse_lut, pack_words, sync_offsets,
)

HUFF = zipnn.ZipNNConfig(chunk_param_bytes=1 << 11, backend="huffman")
KERNEL_THREADS = 1024                     # a self-synchronising block's threads


def _skewed(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = np.r_[np.full(16, 0.05), np.full(240, 0.2 / 240)]
    return rng.choice(256, p=p, size=n).astype(np.uint8)


def _encode(planes, cb, tables=None):
    """Payloads, counts, plane ids and fused LUT rows of ``planes`` (one
    table each, from its counts unless ``tables`` gives ``(lens, codes)``)
    cut into ``cb``-symbol chunks."""
    encs = tables or []
    if not encs:
        for plane in planes:
            lens = huffman.code_lengths(np.bincount(plane, minlength=256) + 1)
            encs.append((lens, huffman.canonical_codes(lens)))
    width = max(int(lens.max()) for lens, _ in encs)
    payloads, counts, pids = [], [], []
    for pid, (plane, (lens, codes)) in enumerate(zip(planes, encs)):
        cnt = [min(cb, plane.size - o) for o in range(0, plane.size, cb)]
        payloads += huffman.encode_chunks(plane, np.asarray(cnt), lens, codes)
        counts += cnt
        pids += [pid] * len(cnt)
    luts = np.stack([fuse_lut(*huffman._build_lut(l, c, width)) for l, c in encs])
    return payloads, np.asarray(counts, np.int32), np.asarray(pids, np.int32), luts, encs


def _args(payloads, counts, pids, luts):
    words, word_off = pack_words(payloads)
    out_off = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        words, word_off, pids, np.asarray(counts, np.int32), out_off, luts)]


def _both(payloads, counts, pids, luts, every=SYNC_EVERY, seg_bits=SEG_BITS):
    """(oracle, self-sync) each as (symbols, cursors, index), plus the
    self-sync decode's rounds per chunk."""
    args = _args(payloads, counts, pids, luts)
    n = int(np.asarray(counts, np.int64).sum())
    sync_off = torch.from_numpy(sync_offsets(counts, every))
    out_o, out_s = torch.zeros(n, dtype=torch.uint8), torch.zeros(n, dtype=torch.uint8)
    cur_o, idx_o = _serial_plain(*args, out_o, sync_off, every)
    rounds = torch.zeros(len(counts), dtype=torch.int32)
    cur_s, idx_s = huffdecode_selfsync_plain(*args, out_s, sync_off, every, seg_bits, rounds)
    return (out_o, cur_o, idx_o), (out_s, cur_s, idx_s), rounds


def _assert_equal(payloads, counts, pids, luts, every=SYNC_EVERY, seg_bits=SEG_BITS):
    want, got, rounds = _both(payloads, counts, pids, luts, every, seg_bits)
    for name, w, g in zip(("symbols", "cursors", "index"), want, got):
        assert torch.equal(w, g), name
    # the two optional outputs alone give the same
    args = _args(payloads, counts, pids, luts)
    sync_off = torch.from_numpy(sync_offsets(counts, every))
    cur_i, idx_i = huffdecode_selfsync_plain(*args, None, sync_off, every, seg_bits)
    out = torch.zeros_like(want[0])
    cur_p, none = huffdecode_selfsync_plain(*args, out, None, every, seg_bits)
    assert none is None and torch.equal(out, want[0])
    assert torch.equal(cur_i, want[1]) and torch.equal(cur_p, want[1])
    assert torch.equal(idx_i, want[2])
    return rounds


# (planes, chunk symbols, symbols per index entry): as in test_torch_k1_sync
CASES = {
    "short_final_chunk": ([_skewed(3 * 2048 + 700, 1)], 2048, SYNC_EVERY),
    "every_not_dividing": ([_skewed(2 * 2048, 2)], 2048, 300),
    "one_symbol_chunk": ([_skewed(2048 + 1, 3)], 2048, 300),
    "multi_table": ([_skewed(2048 + 999, 4), (np.arange(3000) % 7).astype(np.uint8)], 2048, 256),
    "every_above_count": ([_skewed(1500, 5)], 2048, 4096),
}


@pytest.mark.parametrize("seg_bits", [16, 32, 64, 100, 1024])
@pytest.mark.parametrize("name", sorted(CASES))
def test_selfsync_plain_equals_the_serial_oracle(name, seg_bits):
    planes, cb, every = CASES[name]
    payloads, counts, pids, luts, _ = _encode(planes, cb)
    _assert_equal(payloads, counts, pids, luts, every, seg_bits)


def test_selfsync_plain_matches_reference_kernel():
    cb, every = 2048, 300
    planes = [_skewed(cb + 900, 7), (np.arange(2500) % 5).astype(np.uint8)]
    payloads, counts, pids, luts, encs = _encode(planes, cb)
    args = _args(payloads, counts, pids, luts)
    n = int(counts.sum())
    out = torch.zeros(n, dtype=torch.uint8)
    cur = huffdecode_serial(*args, out, seg_bits=64)
    width = luts.shape[1].bit_length() - 1
    rows = [huffman._build_lut(*e, width) for e in encs]
    ref_lut = np.stack([(s.astype(np.int32) << 8) | l.astype(np.int32) for s, l in rows])
    words = np.zeros(len(counts) * (cb // 4), np.uint32)
    for c, p in enumerate(payloads):
        w = np.frombuffer(p + b"\x00" * (-len(p) % 4), dtype=">u4")
        words[c * (cb // 4) : c * (cb // 4) + w.size] = w
    syms_r, cur_r = ref_huffdecode.huffdecode_chunks_multi(
        jnp.asarray(words), jnp.asarray(pids), jnp.asarray(counts),
        jnp.asarray(ref_lut), chunk_bytes=cb, interpret=True,
    )
    assert np.array_equal(cur.numpy(), np.asarray(cur_r))
    syms_r = np.asarray(syms_r).reshape(len(counts), cb)
    assert np.array_equal(out.numpy(), np.concatenate([syms_r[c, : counts[c]]
                                                       for c in range(len(counts))]))


def test_selfsync_index_matches_reference_kernel_prefix_cursors():
    """Entry k of a chunk is the reference kernel's final cursor when it
    decodes only the chunk's first k * every symbols."""
    cb, every = 2048, 512
    payloads, counts, pids, luts, encs = _encode([_skewed(2 * cb + 333, 6)], cb)
    args = _args(payloads, counts, pids, luts)
    _, sync = huffdecode_index(*args, None, torch.from_numpy(sync_offsets(counts, every)),
                               every, seg_bits=48)
    width = luts.shape[1].bit_length() - 1
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


MODES = ["valid", "truncated", "extended", "flipped", "random_words", "random_luts"]


@given(
    st.integers(min_value=0, max_value=10_000),
    st.sampled_from(MODES),
    st.sampled_from([16, 32, 48, 64, 100, 1024]),
    st.sampled_from([1, 7, 64, 512]),
    st.sampled_from([0.0, 0.5, 1.0, 1.5]),
)
@settings(max_examples=40, deadline=None)
def test_selfsync_plain_equals_the_oracle_on_any_input(seed, mode, seg_bits, every, scale):
    """Valid, truncated, extended and bit-flipped payloads, random words and
    random LUT rows; ``counts`` scaled below and above what the words hold
    (``scale`` 1.0 keeps them)."""
    rng = np.random.default_rng(seed)
    planes = [_skewed(int(rng.integers(1, 3000)), seed), _skewed(int(rng.integers(1, 900)),
                                                                 seed + 1)]
    payloads, counts, pids, luts, _ = _encode(planes, int(rng.choice([256, 1024])))
    if mode == "truncated":
        payloads = [p[: int(rng.integers(0, len(p) + 1))] for p in payloads]
    elif mode == "extended":
        payloads = [p + rng.integers(0, 256, int(rng.integers(1, 40)), dtype=np.uint8).tobytes()
                    for p in payloads]
    elif mode == "flipped":
        flipped = []
        for p in payloads:
            b = bytearray(p)
            for i in rng.integers(0, max(len(b), 1), int(rng.integers(1, 5))):
                if b:
                    b[i] ^= 1 << int(rng.integers(0, 8))
            flipped.append(bytes(b))
        payloads = flipped
    elif mode == "random_words":
        payloads = [rng.integers(0, 256, int(rng.integers(0, 400)), dtype=np.uint8).tobytes()
                    for _ in payloads]
    elif mode == "random_luts":
        luts = rng.integers(-(1 << 15), 1 << 15, luts.shape).astype(np.int16)
    if scale != 1.0:
        counts = (counts * scale).astype(np.int32) + rng.integers(0, 3, counts.size).astype(
            np.int32)
    _assert_equal(payloads, counts, pids, luts, every, seg_bits)


def test_incomplete_codes_stall_and_match():
    """LUT entries of length 0: an incomplete code's unmatched windows, and
    a one-symbol plane (only the code 0 exists, a window starting with a 1
    bit matches nothing).  A stall on the decode's path keeps its cursor;
    a mis-started segment landing on one must not derail the rest."""
    planes = [_skewed(4000, 11)]
    payloads, counts, pids, luts, _ = _encode(planes, 1024)
    holes = luts.copy()
    holes[0, 5::9] &= ~0xF                          # length-0 entries amid a valid code
    for seg in (16, 32, 1024):
        _assert_equal(payloads, counts, pids, holes, 64, seg)
    lens = np.zeros(256, np.int64)
    lens[42] = 1                                    # one symbol, code "0"
    one = np.full(3000, 42, np.uint8)
    payloads, counts, pids, luts, _ = _encode([one], 1024,
                                              [(lens, huffman.canonical_codes(lens))])
    assert all(p == b"\x00" * len(p) for p in payloads)
    for bad in (payloads, [b"\x00\x00\x10" + p[3:] for p in payloads]):
        for seg in (16, 64):
            _assert_equal(bad, counts, pids, luts, 100, seg)


def _shared_factor_case(n, seed):
    """A complete code whose lengths are all 3 or 6 (a factor of 3 shared),
    so a segment started off the codeword grid by a bit count that 3 does
    not divide never meets the true path."""
    lens = np.zeros(256, np.int64)
    lens[:7] = 3
    lens[7:15] = 6
    rng = np.random.default_rng(seed)
    plane = rng.integers(0, 15, n).astype(np.uint8)
    return _encode([plane], n, [(lens, huffman.canonical_codes(lens))])


def test_codes_sharing_a_factor_need_a_round_a_segment():
    payloads, counts, pids, luts, _ = _shared_factor_case(3000, 12)
    bits = 8 * len(payloads[0])
    for seg in (32, 64):
        rounds = _assert_equal(payloads, counts, pids, luts, 512, seg)
        nseg = -(-32 * -(-bits // 32) // seg)
        assert int(rounds[0]) >= nseg // 2        # no resynchronisation: about one a segment
    even = np.zeros(256, np.int64)
    even[:4], even[4:8] = 2, 4                      # a complete code of even lengths
    plane = np.random.default_rng(13).integers(0, 8, 5000).astype(np.uint8)
    payloads, counts, pids, luts, _ = _encode([plane], 5000,
                                              [(even, huffman.canonical_codes(even))])
    for seg in (33, 64):                            # an odd segment starts off the even grid
        _assert_equal(payloads, counts, pids, luts, 512, seg)


@pytest.mark.parametrize("counts_of", ["zero", "below", "above", "mixed"])
def test_counts_zero_below_and_above_the_words(counts_of):
    payloads, counts, pids, luts, _ = _encode([_skewed(5000, 14)], 1024)
    counts = {
        "zero": np.zeros_like(counts),
        "below": counts // 3,
        "above": counts * 2 + 17,
        "mixed": np.asarray([0, 1, 5000, 513, 1024][: counts.size], np.int32),
    }[counts_of].astype(np.int32)
    for seg in (32, 1024):
        _assert_equal(payloads, counts, pids, luts, 512, seg)


def test_more_segments_than_a_block_has_threads():
    """A chunk of ~41 kbit at 16- and 32-bit segments: 2,600 and 1,300
    segments, over the kernel block's 1,024 threads (at 16 bits also over
    the 2,048 segments whose state a block keeps, where the kernel
    lengthens its segments)."""
    payloads, counts, pids, luts, _ = _encode([_skewed(16_000, 15)], 16_000)
    bits = 8 * len(payloads[0])
    assert bits // 32 > KERNEL_THREADS and bits // 16 > 2048
    for seg in (16, 32):
        _assert_equal(payloads, counts, pids, luts, 512, seg)


# ---------------------------------------------------------------------------
# the wrappers and their callers
# ---------------------------------------------------------------------------

def test_wrappers_run_the_plain_versions_on_cpu_uncounted():
    payloads, counts, pids, luts, _ = _encode([_skewed(5000, 16)], 2048)
    args = _args(payloads, counts, pids, luts)
    n = int(counts.sum())
    sync_off = torch.from_numpy(sync_offsets(counts))
    before = launch_counts()
    out_c, out_s = torch.zeros(n, dtype=torch.uint8), torch.zeros(n, dtype=torch.uint8)
    cur_c, idx_c = huffdecode_chain(*args, out_c, sync_off)
    rounds = torch.full((len(counts),), -1, dtype=torch.int32)
    cur_s = huffdecode_serial(*args, out_s, seg_bits=64, rounds=rounds)
    cur_i, idx_i = huffdecode_index(*args, None, sync_off)
    out_k = torch.zeros(n, dtype=torch.uint8)
    cur_k = huffdecode_chunks(*args, out_k, idx_i, sync_off)
    assert launch_counts() == before                 # CPU: plain versions, uncounted
    assert torch.equal(out_s, out_c) and torch.equal(out_k, out_c)
    assert all(torch.equal(c, cur_c) for c in (cur_s, cur_i, cur_k))
    assert torch.equal(idx_i, idx_c) and bool((rounds >= 0).all())
    meta = [a.to("meta") for a in args]
    for call in (
        lambda: huffdecode_serial(*meta, out_s.to("meta")),
        lambda: huffdecode_index(*meta, None, sync_off.to("meta")),
        lambda: huffdecode_chain(*meta, out_s.to("meta")),
    ):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    with pytest.raises(ValueError, match="seg_bits"):
        huffdecode_serial(*args, out_s, seg_bits=8)
    with pytest.raises(ValueError, match="rounds"):
        huffdecode_serial(*args, out_s, rounds=rounds[:-1])
    with pytest.raises(ValueError, match="needs out"):
        huffdecode_serial(*args, None)


def _bf16(shape, seed):
    a = (np.random.default_rng(seed).standard_normal(shape) * 0.02).astype(np.float32)
    return torch.from_numpy(a).to(torch.bfloat16)


def _parsed(ct):
    meta, mv = container.unpack_stream(ct.blob)
    payloads = [[container.payload_view(meta, mv, p, c) for c in range(len(meta.entries[p]))]
                for p in range(meta.n_planes)]
    params = codec.CodecParams(chunk_bytes=meta.chunk_bytes, backend="huffman")
    return meta, [list(pe) for pe in meta.entries], payloads, params


def test_feed_index_pass_writes_no_symbols_and_equals_the_chain():
    ct = zipnn.compress_array(_bf16((256, 200), 17), HUFF)
    meta, entries, payloads, params = _parsed(ct)
    feed = device_entropy.PayloadFeed(entries, payloads, meta.tables, params, device="cpu")
    args = feed.launch_args()
    n = args.pop("out_bytes")
    sync, sync_off = args.pop("sync"), args.pop("sync_off")
    out = torch.zeros(n, dtype=torch.uint8)
    _, idx = huffdecode_chain(**args, out=out, sync_off=sync_off)
    assert torch.equal(sync, idx)


@pytest.mark.parametrize("damage", ["truncated", "flipped"])
def test_feed_and_one_shot_decode_reject_a_damaged_payload(damage):
    """A HUFF payload cut in half, or with a flipped bit, its CRC resealed:
    only the cursor check can catch it, at a feed's build (the index pass)
    and at a one-shot decode."""
    ct = zipnn.compress_array(_bf16((128, 128), 18), HUFF)
    meta, entries, payloads, params = _parsed(ct)
    e = entries[0][0]
    assert e.method == codec.Method.HUFF
    p = bytes(payloads[0][0])
    bad = p[: len(p) // 2] if damage == "truncated" else p[:-1] + bytes([p[-1] ^ 0x01])
    entries[0][0] = codec.ChunkEntry(e.method, len(bad), e.raw_len, zlib.crc32(bad))
    payloads[0][0] = bad
    before = launch_counts()
    for build in (device_entropy.PayloadFeed, device_entropy.decode_planes):
        with pytest.raises(ValueError, match="cursor|pad"):
            build(entries, payloads, meta.tables, params, device="cpu")
    assert launch_counts() == before
