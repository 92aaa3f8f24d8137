"""K1 and K2's plain PyTorch versions against the reference's Pallas kernels.

The CUDA kernels run only on the card (``tests/test_torch_gpu.py`` and
``chip_smoke.py`` hold them against these plain versions there).  Here the
plain versions — which the wrappers run for CPU tensors — are held
against ``repro.kernels.huffdecode.huffdecode_chunks_multi`` and
``repro.kernels.fused_unplane.plane_consumer`` in interpret mode, on the
same inputs made from numpy seeds.  Tolerance: none — both are integer
bit manipulations, so symbols, cursors and element bits must be equal.
Chunks are 2–4 KiB because the reference's interpret-mode decode loop is
slow.
"""

import dataclasses
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as ref_codec
from repro.core import device_entropy as ref_entropy
from repro.kernels import fused_unplane as ref_unplane
from repro.kernels import huffdecode as ref_huffdecode
from repro_torch.core import codec, device_entropy, huffman
from repro_torch.kernels import (
    huffdecode_chunks,
    huffdecode_chunks_plain,
    launch_counts,
    plane_consumer,
    plane_consumer_plain,
)
from repro_torch.kernels.huffdecode import fuse_lut, pack_words


def _skewed_plane(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = np.r_[np.full(16, 0.05), np.full(240, 0.2 / 240)]
    return rng.choice(256, p=p, size=n).astype(np.uint8)


def _encode(plane: np.ndarray, cb: int):
    lens = huffman.code_lengths(np.bincount(plane, minlength=256) + 1)
    codes = huffman.canonical_codes(lens)
    counts = np.asarray([min(cb, plane.size - o) for o in range(0, plane.size, cb)])
    payloads = huffman.encode_chunks(plane, counts, lens, codes)
    return lens, codes, counts, payloads


def _luts(encs, width):
    """Stacked LUT rows of ``(lens, codes)`` pairs at one width: the
    reference kernel's int32 ``(sym << 8) | len`` and K1's int16
    ``(sym << 4) | len`` (same symbol and length in every entry)."""
    rows = [huffman._build_lut(lens, codes, width) for lens, codes in encs]
    ref = np.stack([(ls.astype(np.int32) << 8) | ll.astype(np.int32) for ls, ll in rows])
    return ref, np.stack([fuse_lut(ls, ll) for ls, ll in rows])


def _ref_words(payloads, cb):
    """The reference kernel's layout: each chunk padded to cb bytes."""
    cw = cb // 4
    words = np.zeros(len(payloads) * cw, dtype=np.uint32)
    for k, pay in enumerate(payloads):
        w = np.frombuffer(bytes(pay) + b"\x00" * (-len(pay) % 4), dtype=">u4")
        words[k * cw : k * cw + w.size] = w
    return words


def _both(payloads, pids, counts, luts, cb):
    """Run the reference kernel (interpret) and the port's plain K1."""
    ref_luts, port_luts = luts
    syms_r, cur_r = ref_huffdecode.huffdecode_chunks_multi(
        jnp.asarray(_ref_words(payloads, cb)),
        jnp.asarray(pids, jnp.int32),
        jnp.asarray(counts, jnp.int32),
        jnp.asarray(ref_luts),
        chunk_bytes=cb,
        interpret=True,
    )
    words, word_off = pack_words(payloads)
    out_off = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    out = torch.zeros(int(np.sum(counts)), dtype=torch.uint8)
    cur_p = huffdecode_chunks_plain(
        torch.from_numpy(words), torch.from_numpy(word_off),
        torch.from_numpy(np.asarray(pids, np.int32)),
        torch.from_numpy(np.asarray(counts, np.int32)),
        torch.from_numpy(out_off), torch.from_numpy(port_luts), out,
    )
    return np.asarray(syms_r), np.asarray(cur_r), out.numpy(), cur_p.numpy(), out_off


@pytest.mark.parametrize("cb,n", [(2048, 2048 * 3), (4096, 4096 + 1_234)])
def test_plain_k1_matches_reference_kernel(cb, n):
    plane = _skewed_plane(n, seed=cb + n)
    lens, codes, counts, payloads = _encode(plane, cb)
    luts = _luts([(lens, codes)], int(lens.max()))
    syms_r, cur_r, out, cur_p, off = _both(payloads, [0] * len(counts), counts, luts, cb)
    assert np.array_equal(cur_p, cur_r)            # cursors exactly
    for k, c in enumerate(counts):
        assert np.array_equal(out[off[k] : off[k] + c], syms_r[k, :c])
    assert np.array_equal(out, plane)


def test_plain_k1_multi_table_selection():
    """Chunks of two planes gather from their own LUT row at one width."""
    cb = 2048
    planes = [_skewed_plane(cb + 700, seed=1), (np.arange(cb * 2) % 7).astype(np.uint8)]
    encs = [_encode(p, cb) for p in planes]
    width = max(int(e[0].max()) for e in encs)
    luts = _luts([e[:2] for e in encs], width)
    payloads, counts, pids = [], [], []
    for p, e in enumerate(encs):
        payloads += e[3]
        counts += e[2].tolist()
        pids += [p] * len(e[2])
    syms_r, cur_r, out, cur_p, off = _both(payloads, pids, counts, luts, cb)
    assert np.array_equal(cur_p, cur_r)
    assert np.array_equal(out, np.concatenate(planes))


def test_plain_k1_truncated_words_stay_in_bounds():
    """A payload cut short mis-lands the cursor in both; neither reads out
    of bounds, and the port's reads past the chunk yield zeros."""
    cb = 2048
    plane = _skewed_plane(cb, seed=7)
    lens, codes, counts, payloads = _encode(plane, cb)
    cut = [payloads[0][: len(payloads[0]) // 2]]
    luts = _luts([(lens, codes)], int(lens.max()))
    _, cur_r, _, cur_p, _ = _both(cut, [0], counts, luts, cb)
    assert int(cur_p[0]) > 8 * len(cut[0]) - 8
    assert int(cur_r[0]) > 8 * len(cut[0]) - 8


def _streams(cb):
    params = codec.CodecParams(chunk_bytes=cb, backend="huffman")
    plane = _skewed_plane(2 * cb, seed=8)
    e, p, t = codec.compress_plane(plane, params)
    assert e[0].method == codec.Method.HUFF
    return params, plane, e, p, [t]


def _decode_both(entries, payloads, tables, cb):
    """Both decode drivers on the same (possibly corrupt) stream; returns
    the two exceptions (or None)."""
    errs = []
    ref_params = ref_codec.CodecParams(chunk_bytes=cb, backend="huffman")
    ref_entries = [[ref_codec.ChunkEntry(**dataclasses.asdict(x)) for x in entries]]
    for run in (
        lambda: ref_entropy.decode_planes(ref_entries, [payloads], tables, ref_params),
        lambda: device_entropy.decode_planes(
            [entries], [payloads], tables,
            codec.CodecParams(chunk_bytes=cb, backend="huffman"), device="cpu"),
    ):
        try:
            run()
        except (IOError, ValueError) as e:
            errs.append(e)
        else:
            errs.append(None)
    return errs


def test_corrupt_payloads_raise_in_both():
    cb = 2048
    params, plane, entries, payloads, tables = _streams(cb)
    got = device_entropy.decode_planes([entries], [payloads], tables, params, device="cpu")
    assert np.array_equal(got[0].numpy(), plane)

    # flipped byte → CRC error
    flipped = [bytes([payloads[0][0] ^ 0x10]) + payloads[0][1:]] + payloads[1:]
    errs = _decode_both(entries, flipped, tables, cb)
    assert all(isinstance(e, IOError) and "CRC" in str(e) for e in errs), errs

    # truncated payload, CRC resealed → cursor check
    cut = payloads[0][: len(payloads[0]) // 2]
    e0 = dataclasses.replace(entries[0], comp_len=len(cut), crc=zlib.crc32(cut))
    errs = _decode_both([e0] + entries[1:], [cut] + payloads[1:], tables, cb)
    assert all(isinstance(e, ValueError) for e in errs), errs

    # a flipped bit in the final byte's zero padding, CRC resealed → pad check
    for k in range(2):
        p0 = payloads[k]
        slack = -huffman.estimate_encoded_bits(
            np.bincount(plane[k * cb : (k + 1) * cb], minlength=256),
            huffman.unpack_table(tables[0]),
        ) % 8
        if slack:
            dirty = p0[:-1] + bytes([p0[-1] | 1])
            ek = dataclasses.replace(entries[k], crc=zlib.crc32(dirty))
            es = list(entries)
            ps = list(payloads)
            es[k], ps[k] = ek, dirty
            errs = _decode_both(es, ps, tables, cb)
            assert all(isinstance(e, ValueError) and "pad" in str(e) for e in errs), errs
            break


@pytest.mark.parametrize("keep", ["half", "word_aligned"])
def test_truncated_payload_raises_in_both(keep):
    """A payload cut to a whole number of words: the cursor runs past it
    and must not be clamped back into the payload's final byte."""
    cb = 2048
    _, _, entries, payloads, tables = _streams(cb)
    n = len(payloads[0])
    cut = payloads[0][: n // 2 if keep == "half" else (n // 2) // 4 * 4]
    e0 = dataclasses.replace(entries[0], comp_len=len(cut), crc=zlib.crc32(cut))
    errs = _decode_both([e0] + entries[1:], [cut] + payloads[1:], tables, cb)
    assert all(isinstance(e, ValueError) and "cursor" in str(e) for e in errs), errs


def test_k1_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    cb = 1024
    plane = _skewed_plane(cb * 2, seed=9)
    lens, codes, counts, payloads = _encode(plane, cb)
    words, word_off = pack_words(payloads)
    args = dict(
        words=torch.from_numpy(words), word_off=torch.from_numpy(word_off),
        plane_ids=torch.zeros(2, dtype=torch.int32),
        counts=torch.from_numpy(counts.astype(np.int32)),
        out_off=torch.tensor([0, cb], dtype=torch.int64),
        luts=torch.from_numpy(_luts([(lens, codes)], int(lens.max()))[1]),
    )
    before = launch_counts()["huffdecode_chunks"]
    out = torch.zeros(2 * cb, dtype=torch.uint8)
    huffdecode_chunks(**args, out=out)
    assert np.array_equal(out.numpy(), plane)
    assert launch_counts()["huffdecode_chunks"] == before
    with pytest.raises(ValueError, match="counts"):
        huffdecode_chunks(**{**args, "counts": args["counts"].to(torch.int64)}, out=out)
    with pytest.raises(ValueError, match="luts"):       # K1's rows are int16
        huffdecode_chunks(**{**args, "luts": args["luts"].to(torch.int32)}, out=out)
    meta = {k: v.to("meta") for k, v in args.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        huffdecode_chunks(**meta, out=out.to("meta"))


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("with_base", [False, True])
def test_plain_k2_matches_reference_kernel(itemsize, with_base):
    rows = ref_unplane.BF16_ROWS if itemsize == 2 else ref_unplane.FP32_ROWS
    n = rows * ref_unplane.LANES
    rng = np.random.default_rng(itemsize * 10 + with_base)
    planes = [rng.integers(0, 256, n, dtype=np.uint8) for _ in range(itemsize)]
    udt, sdt = (np.uint16, np.int16) if itemsize == 2 else (np.uint32, np.int32)
    base = rng.integers(0, np.iinfo(udt).max, n, dtype=udt, endpoint=True)
    want = np.asarray(ref_unplane.plane_consumer(
        tuple(jnp.asarray(p.reshape(-1, ref_unplane.LANES)) for p in planes),
        jnp.asarray(base.reshape(-1, ref_unplane.LANES)) if with_base else None,
        itemsize=itemsize, interpret=True,
    )).reshape(-1)
    got = plane_consumer_plain(
        [torch.from_numpy(p) for p in planes],
        torch.from_numpy(base.view(sdt)) if with_base else None,
        itemsize=itemsize,
    )
    assert np.array_equal(got.numpy().view(udt), want)
    # the wrapper takes the plain path for CPU tensors, for any length
    tail = n - 77
    part = plane_consumer(
        [torch.from_numpy(p[:tail]) for p in planes],
        torch.from_numpy(base[:tail].view(sdt)) if with_base else None,
        itemsize=itemsize,
    )
    assert np.array_equal(part.numpy().view(udt), want[:tail])


def test_plain_k2_inverts_host_planes():
    """K2 is the exact inverse of the host byte-group for bf16 and fp32."""
    from repro_torch.core import bitlayout

    rng = np.random.default_rng(4)
    for name, dt in (("bfloat16", np.uint16), ("float32", np.uint32)):
        x = rng.integers(0, np.iinfo(dt).max, 3001, dtype=dt, endpoint=True)
        layout = bitlayout.layout_for(name)
        planes = bitlayout.to_planes(x.view(np.uint8), layout)
        got = plane_consumer([torch.from_numpy(p) for p in planes], itemsize=layout.itemsize)
        assert np.array_equal(got.numpy().view(dt), x)


def test_k2_wrapper_validates_inputs():
    p = torch.zeros(16, dtype=torch.uint8)
    with pytest.raises(ValueError, match="itemsize"):
        plane_consumer([p, p, p], itemsize=3)
    with pytest.raises(ValueError, match="expected 2 planes"):
        plane_consumer([p], itemsize=2)
    with pytest.raises(ValueError, match="base"):
        plane_consumer([p, p], torch.zeros(16, dtype=torch.int32), itemsize=2)
    with pytest.raises(ValueError, match="length"):
        plane_consumer([p, p[:8]], itemsize=2)
