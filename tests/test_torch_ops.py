"""The port's ``kernels.ops`` (K4–K6, K8–K11) against the reference's Pallas
kernels in interpret mode.

The CUDA kernels run only on the card (``tests/test_torch_gpu.py`` and
``chip_smoke.py`` hold them against their plain versions there).  Here the
CPU tensors go through the plain versions, and each is held against
``repro.kernels.ops`` (and ``histogram.chunk_histogram_2d`` /
``xor_delta.xor_elems_2d``, called as ``tests/test_kernels.py`` calls
them) and the oracles of ``repro.kernels.ref``, on the same inputs made
from numpy seeds, over the reference's size sweep plus ``n = 0``.
Tolerance: none — integer bit work, so planes, counts, deltas and bytes
must be equal.  The slice as a whole runs on the reduced
``repro_gpt_100m`` weights exported from the JAX model as numpy.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import bitlayout as ref_bitlayout
from repro.core import huffman as ref_huffman
from repro.core import stats as ref_stats
from repro.kernels import bitpack as ref_bitpack
from repro.kernels import histogram as ref_histogram
from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro.kernels import xor_delta as ref_xor
from repro.models import build_model
from repro_torch.core import bitlayout, codec, huffman
from repro_torch.kernels import (
    bitpack_encode_chunks_single,
    bitpack_encode_chunks_single_plain,
    chunk_histogram,
    launch_counts,
    ops,
    xor_elems,
)

SIZES = [0, 1, 100, 128, 4096, 65_536, 200_000]
CHUNK = 8192


def _u16(n, seed):
    return np.random.default_rng(seed).integers(0, 1 << 16, n).astype(np.uint16)


def _u32(n, seed):
    return np.random.default_rng(seed).integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    """A numpy uint16/uint32 array as the port's int16/int32 element bits."""
    ints = {2: np.int16, 4: np.int32}[a.dtype.itemsize]
    return torch.from_numpy(a.view(ints).copy())


def _np(t: torch.Tensor, dtype) -> np.ndarray:
    return t.numpy().view(dtype)


def _eq(port, want):
    np.testing.assert_array_equal(port, np.asarray(want))


@pytest.mark.parametrize("n", SIZES)
def test_bytegroup_bf16_matches_reference(n):
    x = _u16(n, n)
    e, f = ops.bytegroup_bf16(_t(x).view(torch.uint16))
    re, rf = ref_ops.bytegroup_bf16(jnp.asarray(x))
    oe, of = ref.bytegroup_bf16(jnp.asarray(x))
    for port, kernel, oracle in ((e, re, oe), (f, rf, of)):
        assert port.dtype == torch.uint8 and port.shape == (n,)
        _eq(port.numpy(), kernel)
        _eq(port.numpy(), oracle)
    back = ops.ungroup_bf16(e, f)
    assert back.dtype == torch.int16
    _eq(_np(back, np.uint16), ref_ops.ungroup_bf16(re, rf))
    _eq(_np(back, np.uint16), x)


@pytest.mark.parametrize("n", SIZES)
def test_bytegroup_fp32_matches_reference(n):
    x = _u32(n, n)
    planes = ops.bytegroup_fp32(_t(x))
    want = ref_ops.bytegroup_fp32(jnp.asarray(x))
    oracle = ref.bytegroup_fp32(jnp.asarray(x))
    assert len(planes) == 4
    for p, k, o in zip(planes, want, oracle):
        _eq(p.numpy(), k)
        _eq(p.numpy(), o)
    back = ops.ungroup_fp32(*planes)
    assert back.dtype == torch.int32
    _eq(_np(back, np.uint32), ref_ops.ungroup_fp32(*want))
    _eq(_np(back, np.uint32), x)


@pytest.mark.parametrize("n", [100, 65_536])
def test_bf16_exponent_plane_matches_host_planes(n):
    w = (np.random.default_rng(n).standard_normal(n) * 0.02).astype(ml_dtypes.bfloat16)
    bits = w.view(np.uint16)
    e, f = ops.bytegroup_bf16(_t(bits))
    he, hf = bitlayout.to_planes(bits.view(np.uint8), bitlayout.layout_for("bfloat16"))
    _eq(e.numpy(), he)
    _eq(f.numpy(), hf)
    _eq(e.numpy().astype(np.int32), ref_bitlayout.exponent_view(w))


@pytest.mark.parametrize("n", SIZES)
def test_byte_histogram_matches_reference(n):
    x = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    h = ops.byte_histogram(torch.from_numpy(x))
    assert h.dtype == torch.int32 and h.shape == (256,)
    _eq(h.numpy(), ref_ops.byte_histogram(jnp.asarray(x)))
    _eq(h.numpy(), ref.histogram(jnp.asarray(x)))
    _eq(h.numpy(), np.bincount(x, minlength=256))


@pytest.mark.parametrize("chunks", [1, 2, 5])
def test_chunk_histogram_matches_reference(chunks):
    chunk_elems = ref_histogram.HIST_ROWS * 128 * 2
    x = np.random.default_rng(chunks).integers(0, 256, chunks * chunk_elems).astype(np.uint8)
    want = ref_histogram.chunk_histogram_2d(
        jnp.asarray(x).reshape(-1, 128), chunk_rows=chunk_elems // 128, interpret=True
    )
    h = chunk_histogram(torch.from_numpy(x), chunk_elems)
    assert h.dtype == torch.int32 and h.shape == (chunks, 256)
    _eq(h.numpy(), want)
    _eq(h.numpy(), ref.chunk_histogram(jnp.asarray(x), chunk_elems))


@pytest.mark.parametrize("n, chunk_elems", [(0, 7), (1, 7), (100, 7), (200_000, 3000), (4096, 5000)])
def test_chunk_histogram_ragged_chunks(n, chunk_elems):
    """A chunk length that divides nothing: the last row counts the short
    last chunk."""
    x = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    h = chunk_histogram(torch.from_numpy(x), chunk_elems).numpy()
    starts = range(0, n, chunk_elems)
    assert h.shape == (len(starts), 256)
    for c, lo in enumerate(starts):
        _eq(h[c], np.bincount(x[lo : lo + chunk_elems], minlength=256))


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_xor_elems_matches_reference(dtype):
    n = ref_xor.XOR_ROWS * 128
    a, b = (_u16 if dtype == np.uint16 else _u32)(n, 3), (_u16 if dtype == np.uint16 else _u32)(n, 4)
    want = ref_xor.xor_elems_2d(
        jnp.asarray(a).reshape(-1, 128), jnp.asarray(b).reshape(-1, 128), interpret=True
    )
    d = xor_elems(_t(a), _t(b))
    assert d.dtype == _t(a).dtype
    _eq(_np(d, dtype), np.asarray(want).reshape(-1))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_xor_elems_any_length(n, dtype):
    a, b = (_u16 if dtype == np.uint16 else _u32)(n, n), (_u16 if dtype == np.uint16 else _u32)(n, 1)
    _eq(_np(xor_elems(_t(a), _t(b)), dtype), a ^ b)


@pytest.mark.parametrize("n", SIZES)
def test_xor_delta_u32_matches_reference(n):
    a, b = _u32(n, n), _u32(n, n + 7)
    d, c = ops.xor_delta_u32(_t(a).view(torch.uint32), _t(b).view(torch.uint32))
    rd, rc = ref_ops.xor_delta_u32(jnp.asarray(a), jnp.asarray(b))
    od, oc = ref.xor_delta(jnp.asarray(a), jnp.asarray(b))
    assert d.dtype == torch.uint32 and c.dtype == torch.int32 and c.shape == ()
    _eq(_np(d.view(torch.int32), np.uint32), rd)
    _eq(_np(d.view(torch.int32), np.uint32), od)
    assert int(c) == int(rc) == int(oc)


def test_xor_delta_changed_byte_count():
    a = np.zeros(1000, dtype=np.uint32)
    b = a.copy()
    b[:10] = 0x000000FF          # 10 words, 1 byte each
    b[10] = 0xFFFFFFFF           # 1 word, 4 bytes
    b[11] = 0x00FF0000           # 1 word, its third byte
    _, c = ops.xor_delta_u32(_t(a), _t(b))
    _, rc = ref_ops.xor_delta_u32(jnp.asarray(a), jnp.asarray(b))
    assert int(c) == int(rc) == 15
    d, c = ops.xor_delta_u32(_t(b), _t(b))
    assert int(c) == 0 and not d.any()


def _table(data):
    lens = huffman.code_lengths(np.bincount(data, minlength=256))
    return lens, huffman.canonical_codes(lens)


@pytest.mark.parametrize("n", [0, 64, 8192, 16384, 20_000])
def test_huffman_encode_chunks_matches_reference(n):
    rng = np.random.default_rng(n)
    p = np.r_[np.full(12, 0.08), np.full(244, 0.04 / 244)]
    data = rng.choice(256, p=p / p.sum(), size=n).astype(np.uint8)
    lens, codes = _table(data) if n else _table(np.arange(4, dtype=np.uint8))
    got = ops.huffman_encode_chunks(data, lens, codes, chunk_syms=CHUNK, device="cpu")
    assert got == ref_ops.huffman_encode_chunks(data, lens, codes, chunk_syms=CHUNK)
    counts = [min(CHUNK, n - o) for o in range(0, n, CHUNK)]
    assert got == huffman.encode_chunks(data, np.asarray(counts), lens, codes)
    if n:
        decoded = ref_huffman.decode_many(got, counts, lens)
        np.testing.assert_array_equal(np.concatenate(decoded), data)


@pytest.mark.parametrize("nsyms", [2, 5, 256])
def test_huffman_encode_chunks_alphabet_sweep(nsyms):
    data = np.random.default_rng(nsyms).integers(0, nsyms, CHUNK).astype(np.uint8)
    lens, codes = _table(data)
    got = ops.huffman_encode_chunks(torch.from_numpy(data), torch.from_numpy(lens.astype(np.int32)),
                                    torch.from_numpy(codes.astype(np.int32)), chunk_syms=CHUNK)
    assert got == ref_ops.huffman_encode_chunks(data, lens, codes, chunk_syms=CHUNK)


def _expanding_case():
    """Chunk 0 codes uniform bytes under a table built for a skewed
    distribution, so its codes take more bits than its raw size; chunk 1
    is skewed and partial."""
    rng = np.random.default_rng(11)
    skewed = np.clip(rng.normal(120, 2, 3 * CHUNK), 0, 255).astype(np.uint8)
    lens = huffman.code_lengths(np.bincount(skewed, minlength=256) + 1)
    codes = huffman.canonical_codes(lens)
    data = np.concatenate([rng.integers(0, 256, CHUNK).astype(np.uint8), skewed[:5000]])
    return data, lens, codes


def test_huffman_encode_chunks_expanding_chunk_cut_as_in_reference():
    """The reference's words hold ``chunk_syms / 4`` words per chunk, so an
    expanding chunk's bytes stop at ``chunk_syms``: shorter than the host
    encoder's stream for it.  The port returns exactly those bytes."""
    data, lens, codes = _expanding_case()
    got = ops.huffman_encode_chunks(data, lens, codes, chunk_syms=CHUNK, device="cpu")
    assert got == ref_ops.huffman_encode_chunks(data, lens, codes, chunk_syms=CHUNK)
    host = huffman.encode_chunks(data, np.asarray([CHUNK, 5000]), lens, codes)
    assert len(host[0]) > CHUNK and len(got[0]) == CHUNK
    assert got[0] == host[0][:CHUNK]
    assert got[1] == host[1]


def test_bitpack_single_matches_reference_kernel():
    """K8's words and bit counts against ``bitpack.bitpack_encode_chunks``,
    pad symbols and the expanding chunk included."""
    data, lens, codes = _expanding_case()
    syms = np.zeros(2 * CHUNK, np.uint8)
    syms[: data.size] = data
    want_w, want_n = ref_bitpack.bitpack_encode_chunks(
        jnp.asarray(syms), jnp.asarray(lens, jnp.int32), jnp.asarray(codes, jnp.int32),
        chunk_syms=CHUNK, interpret=True,
    )
    args = (torch.from_numpy(syms), torch.from_numpy(lens.astype(np.int32)),
            torch.from_numpy(codes.astype(np.int32)))
    before = launch_counts()["bitpack_encode_chunks_single"]
    w, nb = bitpack_encode_chunks_single(*args, chunk_syms=CHUNK)
    assert launch_counts()["bitpack_encode_chunks_single"] == before     # CPU: plain, uncounted
    _eq(_np(w, np.uint32), want_w)
    _eq(nb.numpy(), want_n)
    assert int(nb[0]) > 8 * CHUNK
    w2, nb2 = bitpack_encode_chunks_single_plain(*args, chunk_syms=CHUNK)
    assert torch.equal(w, w2) and torch.equal(nb, nb2)


def test_numpy_symbols_need_a_card_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = np.arange(100, dtype=np.uint8) % 4
    lens, codes = _table(data)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.huffman_encode_chunks(data, lens, codes)
    assert ops.huffman_encode_chunks(data, lens, codes, device="cpu") == \
        ref_ops.huffman_encode_chunks(data, lens, codes)


@pytest.mark.parametrize("call", [
    lambda t: ops.bytegroup_bf16(t.to(torch.int16)),
    lambda t: ops.bytegroup_fp32(t.to(torch.int32)),
    lambda t: ops.ungroup_bf16(t, t),
    lambda t: ops.ungroup_fp32(t, t, t, t),
    lambda t: ops.byte_histogram(t),
    lambda t: chunk_histogram(t, 8),
    lambda t: ops.xor_delta_u32(t.to(torch.int32), t.to(torch.int32)),
    lambda t: xor_elems(t.to(torch.int16), t.to(torch.int16)),
    lambda t: bitpack_encode_chunks_single(t, torch.ones(256, dtype=torch.int32, device="meta"),
                                           torch.zeros(256, dtype=torch.int32, device="meta"),
                                           chunk_syms=16),
])
def test_wrappers_raise_off_the_cpu_without_a_card(call):
    """A tensor on another device goes to the kernel or raises; it never
    falls back to the plain version."""
    t = torch.zeros(32, dtype=torch.uint8, device="meta")
    before = launch_counts()
    with pytest.raises((ValueError, RuntimeError, NotImplementedError)):
        call(t)
    assert launch_counts() == before


def test_ops_reject_wrong_dtypes():
    with pytest.raises(ValueError):
        ops.bytegroup_bf16(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.bytegroup_fp32(torch.zeros(4, dtype=torch.float32))
    with pytest.raises(ValueError):
        ops.byte_histogram(torch.zeros(4, dtype=torch.int16))
    with pytest.raises(ValueError):
        ops.xor_delta_u32(torch.zeros(4, dtype=torch.int32), torch.zeros(5, dtype=torch.int32))


# ---------------------------------------------------------------------------
# The slice as a whole on the reduced repro_gpt_100m weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    """The reduced model's leaves, made from a seed as numpy bf16, and the
    same leaves after one small update step."""
    model = build_model(ref_get_config("repro_gpt_100m").reduced())
    leaves = jax.tree_util.tree_leaves(model.abstract_params())
    rng = np.random.default_rng(0)
    out = []
    for leaf in leaves:
        assert np.dtype(leaf.dtype) == ml_dtypes.bfloat16
        base = (rng.standard_normal(leaf.shape) * 0.02).astype(np.float32)
        new = base + 1e-3 * rng.standard_normal(leaf.shape).astype(np.float32)
        out.append((base.astype(ml_dtypes.bfloat16), new.astype(ml_dtypes.bfloat16)))
    return out


def test_slice_exponent_histograms_and_round_trip(weights):
    for base, _ in weights:
        bits = base.reshape(-1).view(np.uint16)
        exp, frac = ops.bytegroup_bf16(_t(bits))
        _eq(ops.byte_histogram(exp).numpy(), ref_stats.exponent_histogram(base)["hist"])
        _eq(_np(ops.ungroup_bf16(exp, frac), np.uint16), bits)


def test_slice_xor_delta_matches_reference(weights):
    total = 0
    for base, new in weights:
        a, b = new.reshape(-1).view(np.uint32), base.reshape(-1).view(np.uint32)
        d, c = ops.xor_delta_u32(_t(a), _t(b))
        rd, rc = ref_ops.xor_delta_u32(jnp.asarray(a), jnp.asarray(b))
        _eq(_np(d, np.uint32), rd)
        assert int(c) == int(rc) == np.count_nonzero(a.view(np.uint8) != b.view(np.uint8))
        total += int(c)
    assert total > 0


def test_slice_huffman_encode_matches_reference(weights):
    """The exponent plane of a layer's MLP weight, cut to 20,000 symbols
    (three 8,192-symbol chunks, the last partial), under the table the
    port's host codec builds for it."""
    leaf = max((b for b, _ in weights if b.ndim == 3), key=lambda b: b[0].size)[0]
    exp, _ = ops.bytegroup_bf16(_t(leaf.reshape(-1).view(np.uint16)))
    syms = exp.numpy()[:20_000]
    pc = codec.PlaneCodec(codec.CodecParams(chunk_bytes=CHUNK, backend="huffman"))
    pc.build_table(syms)
    got = ops.huffman_encode_chunks(syms, pc.table, pc.codes, chunk_syms=CHUNK, device="cpu")
    assert got == ref_ops.huffman_encode_chunks(syms, pc.table, pc.codes, chunk_syms=CHUNK)
    assert got == huffman.encode_chunks(syms, np.asarray([CHUNK, CHUNK, 20_000 - 2 * CHUNK]),
                                        pc.table, pc.codes)
    assert all(len(g) < CHUNK for g in got)
