"""The port's statistics and baselines (``repro_torch.core.stats`` /
``baselines``) against the reference's (``repro.core.stats`` /
``baselines``) on the same seeded numpy arrays.

The stats count on the tensor's device (K4 planes and K9 counts; here on
the CPU their plain versions) and do the float work on the host with the
reference's numpy arithmetic, so every dict, histogram and float is held
with ``==``; the baselines' bytes are held equal.  Cases: bf16, fp16 and
fp32 (fp64 and fp8 beside them), an empty array, odd element counts, uniform
bytes for ``byte_entropy``, a "clean" and a "regular" tree for
``classify_model``, an odd byte count for ``ee_zlib``.  Inputs go in as
numpy arrays (moved to ``device="cpu"``) and as CPU tensors.

A ``gpu`` test (skipped without a card) holds the card's results equal to
the CPU's, with K4 and K9 launched.  The reference imports JAX's
``ml_dtypes`` in a ``try``: the card's machine has neither, and there only
the ``gpu`` test runs.
"""

import numpy as np
import pytest
import torch

try:                 # the card's machine has no JAX: only the ``gpu`` test runs there
    import ml_dtypes
    from repro.core import baselines as ref_baselines
    from repro.core import stats as ref_stats
except ImportError:
    ml_dtypes = None
from repro_torch import convert
from repro_torch.core import baselines, stats
from repro_torch.kernels import launch_counts, reset_launch_counts

needs_ref = pytest.mark.skipif(ml_dtypes is None, reason="needs the reference package")

DTYPES = ["bfloat16", "float16", "float32"]
MORE_DTYPES = ["float64", "float8_e4m3fn", "float8_e5m2"]
SIZES = {"empty": 0, "odd": 10_001, "leaf": 65_536}


def _np_dtype(name):
    return np.dtype(getattr(ml_dtypes, name, name))


def _weights(name, n, seed=0, scale=0.02):
    """Seeded weights at ``scale`` (integer dtypes: seeded integers)."""
    rng = np.random.default_rng(seed)
    if name.startswith(("int", "uint")):
        return rng.integers(0, 200, n).astype(name)
    return (rng.standard_normal(n) * scale).astype(_np_dtype(name))


def _t(a):
    return convert.tensor_from_numpy(a, torch.device("cpu"))


def _same_hist(want, got):
    assert set(want) == set(got)
    assert isinstance(got["hist"], np.ndarray) and got["hist"].dtype == want["hist"].dtype
    assert np.array_equal(want["hist"], got["hist"])
    assert all(got[k] == want[k] and type(got[k]) is type(want[k]) for k in want if k != "hist")


# -- exponent histograms, plane reports, ratios ----------------------------------

@needs_ref
@pytest.mark.parametrize("size", list(SIZES), ids=list(SIZES))
@pytest.mark.parametrize("name", DTYPES + MORE_DTYPES)
def test_exponent_histogram_equals_reference(name, size):
    n = SIZES[size] + (SIZES[size] % 2 if name.startswith("float8") else 0)
    a = _weights(name, n, seed=n)
    want = ref_stats.exponent_histogram(a)
    _same_hist(want, stats.exponent_histogram(a, device="cpu"))
    _same_hist(want, stats.exponent_histogram(_t(a)))


@needs_ref
@pytest.mark.parametrize("size", list(SIZES), ids=list(SIZES))
@pytest.mark.parametrize("name", DTYPES + MORE_DTYPES + ["int32", "uint8"])
def test_plane_report_and_theoretical_ratio_equal_reference(name, size):
    n = SIZES[size] + (SIZES[size] % 2 if name.startswith("float8") else 0)
    a = _weights(name, n, seed=n + 1)
    want = ref_stats.plane_report(a)
    assert stats.plane_report(a, device="cpu") == want
    assert stats.plane_report(_t(a)) == want
    assert all(type(r["entropy_bits"]) is float for r in want)
    assert stats.theoretical_ratio(_t(a)) == ref_stats.theoretical_ratio(a)


@needs_ref
def test_exponent_histogram_of_a_skewed_tree_is_fig2():
    """Weights at 0.02 use few exponents: the top 12 hold nearly all of the
    mass (the paper's Fig. 2), ties included in ``argsort``'s order."""
    a = np.concatenate([_weights("bfloat16", 50_000, seed=3),
                        np.zeros(1000, _np_dtype("bfloat16"))])
    got = stats.exponent_histogram(_t(a))
    _same_hist(ref_stats.exponent_histogram(a), got)
    assert got["top12_mass"] > 0.99 and got["distinct_values"] < 40


def test_no_exponent_raises():
    with pytest.raises(ValueError, match="no exponent"):
        stats.exponent_histogram(torch.zeros(8, dtype=torch.int32))


# -- byte entropy --------------------------------------------------------------

@needs_ref
@pytest.mark.parametrize("case", ["uniform", "zeros", "empty", "skewed", "two-values"])
def test_byte_entropy_equals_reference(case):
    rng = np.random.default_rng(7)
    data = {
        "uniform": rng.integers(0, 256, 100_000).astype(np.uint8),
        "zeros": np.zeros(1000, np.uint8),
        "empty": np.zeros(0, np.uint8),
        "skewed": rng.geometric(0.3, 50_001).clip(0, 255).astype(np.uint8),
        "two-values": np.array([3, 200] * 777, np.uint8),
    }[case]
    want = ref_stats.byte_entropy(data)
    assert stats.byte_entropy(data, device="cpu") == want
    assert stats.byte_entropy(torch.from_numpy(data)) == want
    assert stats.byte_entropy(data.tobytes(), device="cpu") == want
    if case == "uniform":
        assert 7.9 < want <= 8.0


def test_byte_entropy_takes_bytes_only():
    with pytest.raises(ValueError, match="uint8"):
        stats.byte_entropy(torch.zeros(8, dtype=torch.int16))


# -- classify_model ----------------------------------------------------------

def _regular_and_clean():
    rng = np.random.default_rng(0)
    regular = (rng.standard_normal(100_000) * 0.02).astype(np.float32)
    clean = (regular.view(np.uint32) & np.uint32(0xFFFFF000)).view(np.float32).copy()
    return regular, clean


@needs_ref
@pytest.mark.parametrize("kind", ["regular", "clean"])
@pytest.mark.parametrize("as_tensors", [False, True], ids=["numpy", "tensors"])
def test_classify_model_equals_reference(kind, as_tensors):
    """The reference's own case (a 0xFFFFF000 mask makes fp32 fraction
    planes compressible), in a tree with leaves the classifier skips:
    integers, leaves under 1024 elements, and ninth-largest and smaller
    leaves (only the 8 largest are sampled)."""
    regular, clean = _regular_and_clean()
    big = {"regular": regular, "clean": clean}[kind]
    rng = np.random.default_rng(1)
    tree = [big, np.arange(200_000, dtype=np.int32), _weights("float32", 1000, seed=2)]
    tree += [_weights("bfloat16", 2048 + i, seed=10 + i) for i in range(7)]
    tree += [(rng.standard_normal(512) * 0.02).astype(np.float32)]
    want = ref_stats.classify_model(tree)
    assert want == kind
    leaves = [_t(a) for a in tree] if as_tensors else tree
    assert stats.classify_model(leaves, device="cpu") == want


@needs_ref
def test_classify_model_samples_the_first_mib_of_each_fraction_plane():
    """A bf16 leaf over 2^20 elements whose fraction plane is constant in
    its first 2^20 bytes and random after: clean by the sample."""
    rng = np.random.default_rng(4)
    a = (rng.standard_normal((1 << 20) + 4096) * 0.02).astype(_np_dtype("bfloat16"))
    bits = a.view(np.uint16)
    bits[: 1 << 20] &= np.uint16(0xFF80)
    assert ref_stats.classify_model([a]) == "clean"
    assert stats.classify_model([_t(a)]) == "clean"
    assert stats.classify_model([]) == ref_stats.classify_model([]) == "regular"


# -- small helpers -----------------------------------------------------------

@needs_ref
@pytest.mark.parametrize("n_bytes, seconds", [(3 << 30, 1.5), (12345, 0.0), (1 << 20, -1.0)])
def test_gib_and_human_gbps_equal_reference(n_bytes, seconds):
    assert stats.gib(n_bytes) == ref_stats.gib(n_bytes)
    assert stats.human_gbps(n_bytes, seconds) == ref_stats.human_gbps(n_bytes, seconds)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stats.byte_entropy(np.zeros(4, np.uint8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stats.exponent_histogram(np.zeros(4, np.float32))
    # a tensor runs on its own device whatever ``device`` says
    assert stats.byte_entropy(torch.zeros(4, dtype=torch.uint8)) == 0.0


# -- baselines ---------------------------------------------------------------

def _raw_bytes(n=300_001, seed=5):
    return _weights("bfloat16", n // 2, seed=seed).tobytes() + bytes([n % 251]) * (n % 2)


@needs_ref
@pytest.mark.parametrize("name", ["zlib", "zlib-1", "huffman-only(zlib)", "fast-lz"])
def test_baselines_equal_reference(name):
    raw = _raw_bytes()
    want = ref_baselines.BASELINES[name](raw)
    assert baselines.BASELINES[name](raw) == want
    assert baselines.BASELINES[name](torch.frombuffer(bytearray(raw), dtype=torch.uint8)) == want
    assert baselines.run_baseline(name, raw)[0] == len(want) == ref_baselines.run_baseline(
        name, raw)[0]
    out, seconds = baselines.decompress_time(name, raw)
    assert out == raw and seconds >= 0.0


@needs_ref
@pytest.mark.parametrize("level", [1, 6])
@pytest.mark.parametrize("tail", [0, 1, 3], ids=["whole", "odd-byte", "three-bytes"])
@pytest.mark.parametrize("name", DTYPES + ["float64", "uint8"])
def test_ee_zlib_equals_reference(name, tail, level):
    """Bytes in, including a tail past the last whole element (appended
    unplaned), and a tensor in (its planes from K4's plain version)."""
    a = _weights(name, 40_000, seed=len(name))
    raw = a.tobytes() + bytes(range(7, 7 + tail))
    want = ref_baselines.ee_zlib(raw, name, level)
    assert baselines.ee_zlib(raw, name, level) == want
    if tail == 0:
        assert baselines.ee_zlib(_t(a), name, level) == want
    # a uint8 tensor of the raw bytes, tail included, viewed at an odd offset
    buf = torch.frombuffer(bytearray(b"\0" + raw), dtype=torch.uint8)[1:]
    assert baselines.ee_zlib(buf, name, level) == want


@needs_ref
def test_ee_zlib_of_an_empty_stream():
    assert baselines.ee_zlib(b"", "bfloat16") == ref_baselines.ee_zlib(b"", "bfloat16")
    assert baselines.ee_zlib(torch.zeros(0, dtype=torch.bfloat16), "bfloat16") == \
        ref_baselines.ee_zlib(b"", "bfloat16")


# -- the card ----------------------------------------------------------------

@pytest.mark.gpu
def test_stats_on_the_card_equal_the_cpu():
    """bf16, fp16 and fp32 leaves on the card: every histogram and float
    equal to the same function on the CPU, K4 and K9 launched on the card;
    ``ee_zlib`` of a card tensor equals the host bytes' blob."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator().manual_seed(0)
    leaves = {dt: (torch.randn(3072 * 768 + 5, generator=g) * 0.02).to(dt)
              for dt in (torch.bfloat16, torch.float16, torch.float32)}
    reset_launch_counts()
    for dt, x in leaves.items():
        card = x.cuda()
        want_h = stats.exponent_histogram(x)
        got_h = stats.exponent_histogram(card)
        assert np.array_equal(want_h["hist"], got_h["hist"])
        assert all(got_h[k] == want_h[k] for k in want_h if k != "hist")
        assert stats.plane_report(card) == stats.plane_report(x)
        assert stats.theoretical_ratio(card) == stats.theoretical_ratio(x)
        name = str(dt).removeprefix("torch.")
        host_bytes = x.view(torch.uint8).numpy().tobytes()
        assert baselines.ee_zlib(card, name) == baselines.ee_zlib(host_bytes, name)
    assert stats.classify_model([x.cuda() for x in leaves.values()]) == \
        stats.classify_model(list(leaves.values()))
    counts = launch_counts()
    assert counts["bytegroup_bf16"] > 0 and counts["bytegroup_fp32"] > 0
    assert counts["byte_histogram"] > 0
