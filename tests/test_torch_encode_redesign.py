"""The encode kernels' host-side logic and plain versions on the CPU, for the
K7 and K3 designs that spread a chunk over many thread blocks.

The CUDA kernels run only on the card (``tests/test_torch_gpu.py`` holds
them against their plain versions there).  Here:

* the host logic around them: K7's segment plan (thread blocks per
  chunk);
* a table with a code length outside 0..15 raises ``ValueError`` through
  ``ops.huffman_encode_chunks`` and ``device_entropy._pack_jobs`` (the
  kernel flags such a chunk on the card; these callers turn the flag, or
  the plain version's own check, into the error);
* the plain versions against the reference's Pallas kernels in interpret
  mode on the shapes the new designs cut differently: K7 at chunk sizes
  that end a segment off a word boundary or hold a partial segment, with
  all-length-1 and all-length-15 tables; K8 over several chunks; K3 on an
  input whose every exponent byte is one value, on uniform random bits and
  on a view that starts one element in, and on a batch of leaves each
  padded with zeros to whole chunks, as the store build hands K3 a layer.
  Tolerance: exact equality (integer bit work).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import bitpack as ref_bitpack
from repro.kernels import fused_plane as ref_fused_plane
from repro_torch.core import device_entropy, huffman
from repro_torch.kernels import (
    bitpack_encode_chunks,
    bitpack_encode_chunks_plain,
    bitpack_encode_chunks_single,
    bitpack_encode_chunks_single_plain,
    launch_counts,
    ops,
    plane_producer,
    plane_producer_plain,
)
from repro_torch.kernels.bitpack import MAXL, SEGMENT_SYMS, segments

INTS = {2: np.int16, 4: np.int32}
UINTS = {2: np.uint16, 4: np.uint32}


# ---------------------------------------------------------------------------
# host logic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk_syms, want", [
    (4, 1), (6004, 1), (8192, 1), (8196, 2), (131_072, 16), (262_144, 32),
])
def test_k7_segment_plan(chunk_syms, want):
    assert SEGMENT_SYMS == 8192
    assert segments(chunk_syms) == want
    # the last segment holds the rest of the chunk, at least one word
    last = chunk_syms - (want - 1) * SEGMENT_SYMS
    assert 4 <= last <= SEGMENT_SYMS and last % 4 == 0


# ---------------------------------------------------------------------------
# a table with a length outside 0..15
# ---------------------------------------------------------------------------

def _skewed(n, seed):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(120, 3, n), 0, 255).astype(np.uint8)


def _bad_table(sample):
    lens = huffman.code_lengths(np.bincount(sample, minlength=256) + 1)
    codes = huffman.canonical_codes(lens)
    bad = lens.copy()
    bad[int(np.argmax(lens))] = MAXL + 1
    return bad.astype(np.int32), codes.astype(np.int32)


def test_bad_length_raises_through_ops_on_cpu():
    data = _skewed(3 * 8192 + 5, 1)
    lens, codes = _bad_table(data)
    with pytest.raises(ValueError, match="0..15"):
        ops.huffman_encode_chunks(data, lens, codes, chunk_syms=8192, device="cpu")
    with pytest.raises(ValueError, match="0..15"):
        ops.huffman_encode_chunks(torch.from_numpy(data), torch.from_numpy(lens),
                                  torch.from_numpy(codes), chunk_syms=8192)


def test_bad_length_raises_through_pack_jobs_on_cpu():
    plane = _skewed(2 * 8192, 2)
    lens, codes = _bad_table(plane)
    with pytest.raises(ValueError, match="0..15"):
        device_entropy._pack_jobs([plane], [(0, 0, 8192), (0, 1, 8192)], lens[None],
                                  codes[None], 8192, torch.device("cpu"))


@pytest.mark.parametrize("negative", [False, True])
def test_bad_length_raises_through_the_plain_wrappers(negative):
    syms = torch.from_numpy(_skewed(8192, 3))
    lens, codes = _bad_table(syms.numpy())
    if negative:
        lens[lens > MAXL] = -1
    before = launch_counts()
    with pytest.raises(ValueError, match="0..15"):
        bitpack_encode_chunks(syms, torch.zeros(1, dtype=torch.int32),
                              torch.from_numpy(lens[None]), torch.from_numpy(codes[None]),
                              chunk_syms=8192)
    with pytest.raises(ValueError, match="0..15"):
        bitpack_encode_chunks_single(syms, torch.from_numpy(lens), torch.from_numpy(codes),
                                     chunk_syms=8192)
    assert launch_counts() == before


# ---------------------------------------------------------------------------
# plain versions against the reference's Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _k7_case(chunk, seed):
    """Four tables (skewed, 7 symbols, all length 1, all length 15) and six
    chunks, one of them expanding and one zero-padded."""
    rng = np.random.default_rng(seed)
    skewed = _skewed(3 * chunk, seed)
    rows = []
    for sample in (skewed, (np.arange(5000) % 7).astype(np.uint8)):
        lens = huffman.code_lengths(np.bincount(sample, minlength=256) + 1)
        rows.append((lens, huffman.canonical_codes(lens)))
    ones = np.zeros(256, np.int64)
    ones[[3, 200]] = 1
    rows.append((ones, huffman.canonical_codes(ones)))
    rows.append((np.full(256, MAXL, np.int64), np.arange(256, dtype=np.int64) * 37 % (1 << MAXL)))
    tail = skewed[2 * chunk :].copy()
    tail[chunk - 777 :] = 0
    syms = np.concatenate([
        skewed[: 2 * chunk], rng.integers(0, 256, chunk).astype(np.uint8), tail,
        rng.choice([3, 200], chunk).astype(np.uint8), rng.integers(0, 256, chunk).astype(np.uint8),
    ])
    pids = np.asarray([0, 0, 1, 0, 2, 3], np.int32)
    lens = np.stack([r[0] for r in rows]).astype(np.int32)
    codes = np.stack([r[1] for r in rows]).astype(np.int32)
    return syms, pids, lens, codes


# 6004: a segment that ends off a word boundary; 8196: a second segment of
# one word; 12_004: a partial second segment
@pytest.mark.parametrize("chunk", [6004, 8192, 8196, 12_004])
def test_k7_plain_matches_reference_at_segment_edges(chunk):
    syms, pids, lens, codes = _k7_case(chunk, chunk % 13)
    words, nbits = ref_bitpack.bitpack_encode_chunks_multi(
        jnp.asarray(syms), jnp.asarray(pids), jnp.asarray(lens), jnp.asarray(codes),
        chunk_syms=chunk, interpret=True,
    )
    got_w, got_n = bitpack_encode_chunks_plain(
        *(torch.from_numpy(a) for a in (syms, pids, lens, codes)), chunk_syms=chunk)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(nbits))
    np.testing.assert_array_equal(got_w.numpy().view(np.uint32), np.asarray(words))
    assert int(got_n[4]) == chunk and int(got_n[5]) == MAXL * chunk > 8 * chunk
    assert int(got_n[2]) > 8 * chunk


@pytest.mark.parametrize("chunk", [4096, 8192])
def test_k8_plain_matches_reference_over_several_chunks(chunk):
    syms, _, lens, codes = _k7_case(chunk, 5)
    syms = syms[: 4 * chunk]
    want_w, want_n = ref_bitpack.bitpack_encode_chunks(
        jnp.asarray(syms), jnp.asarray(lens[0]), jnp.asarray(codes[0]),
        chunk_syms=chunk, interpret=True,
    )
    args = (torch.from_numpy(syms), torch.from_numpy(lens[0]), torch.from_numpy(codes[0]))
    w, nb = bitpack_encode_chunks_single_plain(*args, chunk_syms=chunk)
    np.testing.assert_array_equal(nb.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(w.numpy().view(np.uint32), np.asarray(want_w))
    w2, nb2 = bitpack_encode_chunks_single(*args, chunk_syms=chunk)      # CPU: the plain version
    assert torch.equal(w, w2) and torch.equal(nb, nb2)


def _k3_bits(kind, itemsize, n, seed):
    rng = np.random.default_rng(seed)
    udt = UINTS[itemsize]
    if kind == "random_bits":
        return rng.integers(0, np.iinfo(udt).max, n, dtype=np.uint64, endpoint=True).astype(udt)
    x = (rng.standard_normal(n) * 0.02).astype(
        ml_dtypes.bfloat16 if itemsize == 2 else np.float32).view(udt)
    if kind == "same_exponent":              # one exponent byte after the rotate
        keep, exp = (0x007F, 0x3C00) if itemsize == 2 else (0x007FFFFF, 0x3C000000)
        x = (x & udt(keep)) | udt(exp)
    return x


# offset_view: the port's input is a view that starts one element in
@pytest.mark.parametrize("kind", ["same_exponent", "random_bits", "offset_view"])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("with_base", [False, True])
def test_k3_plain_matches_reference(kind, itemsize, with_base):
    n = ref_fused_plane.ALIGN_ELEMS_U16 if itemsize == 2 else 2 * ref_fused_plane.ALIGN_ELEMS_U32
    chunk = 16384
    full = _k3_bits(kind, itemsize, n + 1, itemsize * 10 + with_base)
    x = full[1:] if kind == "offset_view" else full[:n]
    base = _k3_bits("random_bits", itemsize, n, 99) if with_base else None
    planes, hists = ref_fused_plane.plane_producer(
        jnp.asarray(x).reshape(-1, 128),
        None if base is None else jnp.asarray(base).reshape(-1, 128),
        itemsize=itemsize, chunk_elems=chunk, interpret=True,
    )
    xt = torch.from_numpy(full.view(INTS[itemsize]))
    xt = xt[1:] if kind == "offset_view" else xt[:n]
    bt = None if base is None else torch.from_numpy(base.view(INTS[itemsize]))
    got_planes, got_hists = plane_producer_plain(xt, bt, itemsize=itemsize, chunk_elems=chunk)
    for p in range(itemsize):
        np.testing.assert_array_equal(got_planes[p].numpy(), np.asarray(planes[p]).reshape(-1))
    np.testing.assert_array_equal(got_hists.numpy(), np.asarray(hists))
    # the wrapper takes the same CPU view to the plain version
    wp, wh = plane_producer(xt, bt, itemsize=itemsize, chunk_elems=chunk)
    assert torch.equal(wp, got_planes) and torch.equal(wh, got_hists)
    if kind == "same_exponent" and not with_base:
        assert int((got_hists[:, 0] > 0).sum()) == n // chunk      # one bin a chunk


@pytest.mark.parametrize("itemsize", [2, 4])
def test_k3_plain_matches_reference_on_a_padded_batch(itemsize):
    """Leaves of several sizes, each zero-padded to whole chunks and laid
    back to back, as ``core.device_plane`` batches a layer for one launch."""
    chunk = 16384
    align = ref_fused_plane.ALIGN_ELEMS_U16 if itemsize == 2 else ref_fused_plane.ALIGN_ELEMS_U32
    parts = []
    for k, size in enumerate((5000, 16384, 20_001)):
        leaf = _k3_bits("weights", itemsize, size, 40 + k)
        parts += [leaf, np.zeros(-size % chunk, UINTS[itemsize])]
    x = np.concatenate(parts)
    x = np.concatenate([x, np.zeros(-x.size % align, UINTS[itemsize])])
    planes, hists = ref_fused_plane.plane_producer(
        jnp.asarray(x).reshape(-1, 128), None, itemsize=itemsize, chunk_elems=chunk,
        interpret=True,
    )
    got_planes, got_hists = plane_producer_plain(
        torch.from_numpy(x.view(INTS[itemsize])), itemsize=itemsize, chunk_elems=chunk)
    for p in range(itemsize):
        np.testing.assert_array_equal(got_planes[p].numpy(), np.asarray(planes[p]).reshape(-1))
    np.testing.assert_array_equal(got_hists.numpy(), np.asarray(hists))
    assert int(got_hists[0, 0, 0]) >= 16384 - 5000        # the first leaf's zero padding
