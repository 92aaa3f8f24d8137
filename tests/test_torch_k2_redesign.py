"""K2's kernel as a pipeline of bulk copies (``csrc/unplane.cu``): the
host-side plan on the CPU, the kernel's three paths on the card.

The wrapper splits a launch on the host (``fused_unplane._unplane_plan``):
whole tiles through the bulk-copy pipeline, the ragged remainder in
16-element groups and then element by element, and every element alone
when a pointer is not 16-byte aligned.  On the CPU the plan must cover
each element exactly once, and the plain version applied piece by piece
over it must equal one call over the whole.  On the card (``gpu`` tests,
which skip here inside the test) the kernel must equal
``plane_consumer_plain`` (K11: ``ungroup_*_plain``) bit for bit on every
path and at every edge of a tile, count one launch on the path the plan
names, run on two streams at once, from two host threads with tiles of
two sizes, and inside a CUDA graph, and raise, not fall back, when a
launch asks for more shared memory than the kernel is set for.
Tolerance: none, the kernel moves bits.  This file does not import JAX;
the plain version is held against the reference's Pallas kernel in
``tests/test_torch_kernels.py``.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_k2_redesign.py
"""

import numpy as np
import pytest
import torch

from _hyp_compat import given, settings, strategies as st
from repro_torch.kernels import (
    fused_unplane,
    launch_counts,
    plane_consumer,
    plane_consumer_plain,
    reset_launch_counts,
    ungroup_bf16,
    ungroup_bf16_plain,
    ungroup_fp32,
    ungroup_fp32_plain,
)
from repro_torch.kernels import _build
from repro_torch.kernels.fused_unplane import (
    BIG_WAVES, MIN_TILE, PATHS, TILE_IN_BYTES, VECTOR_TILES_PER_SM, WAVE_TILES, Plan,
    _unplane_plan,
)

DTYPES = {2: torch.int16, 4: torch.int32}
H100_SMS = 132


def max_tile(itemsize, with_base):
    return TILE_IN_BYTES // (itemsize * (2 if with_base else 1))


def vector_below(itemsize, sms):
    """Elements under which an aligned call takes the vector path."""
    return max(MIN_TILE, VECTOR_TILES_PER_SM[itemsize] * sms * MIN_TILE)


def pieces(plan):
    """The plan's pieces as (start, stop, kind), in order."""
    out = [(t * plan.tile, (t + 1) * plan.tile, "tile") for t in range(plan.tiles)]
    start = plan.tiles * plan.tile
    out.append((start, start + plan.vec_elems, "vector"))
    out.append((start + plan.vec_elems, start + plan.vec_elems + plan.tail, "element"))
    return out


def inputs(n, itemsize, with_base, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    planes = [torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8)).to(device)
              for _ in range(itemsize)]
    dt = DTYPES[itemsize]
    base = (torch.from_numpy(rng.integers(torch.iinfo(dt).min, torch.iinfo(dt).max, n,
                                          dtype=np.int64, endpoint=True)).to(dt).to(device)
            if with_base else None)
    return planes, base


# ---------------------------------------------------------------------------
# the host-side plan (CPU)
# ---------------------------------------------------------------------------

@given(
    st.integers(min_value=0, max_value=20_000_000),
    st.sampled_from([2, 4]),
    st.booleans(),
    st.booleans(),
    st.sampled_from([1, 8, 114, 132]),
)
@settings(max_examples=200, deadline=None)
def test_plan_covers_every_element_once(n, itemsize, with_base, aligned, sms):
    plan = _unplane_plan(n, itemsize, with_base, aligned, sms)
    assert plan.tiles * plan.tile + plan.vec_elems + plan.tail == n
    assert min(plan) >= 0 and plan.vec_elems % 16 == 0
    if not aligned:
        assert plan == Plan(0, 0, 0, n) and plan.path == "element"
        return
    assert plan.tail < 16
    if plan.tiles:
        assert n >= vector_below(itemsize, sms)
        assert plan.tile % 16 == 0 and MIN_TILE <= plan.tile <= max_tile(itemsize, with_base)
        assert plan.tile * itemsize * (2 if with_base else 1) <= TILE_IN_BYTES
        # a ragged remainder: under a tile, or under 16 elements a tile of whole waves
        assert plan.vec_elems + plan.tail < max(plan.tile, 16 * plan.tiles)
        if plan.tile != max_tile(itemsize, with_base):      # a smaller call: whole waves
            assert plan.tiles <= BIG_WAVES * WAVE_TILES * sms
            assert plan.tiles % (WAVE_TILES * sms) == 0 or plan.tile == MIN_TILE
        assert plan.path == "bulk"
    else:
        assert plan.tile == 0 and n < vector_below(itemsize, sms)
        assert plan.path == ("vector" if plan.vec_elems else "element")
    cur = 0
    for start, stop, _ in pieces(plan):                       # contiguous, in order
        assert start == cur and stop >= start
        cur = stop
    assert cur == n


BF16_VECTOR_BELOW = VECTOR_TILES_PER_SM[2] * H100_SMS * MIN_TILE


@pytest.mark.parametrize("itemsize, n, aligned, path", [
    (2, 1, True, "element"), (2, 15, True, "element"), (2, 16, True, "vector"),
    (2, 17, True, "vector"), (4, MIN_TILE - 1, True, "vector"), (4, MIN_TILE, True, "bulk"),
    (2, MIN_TILE, True, "vector"), (2, 3072 * 768, True, "vector"),
    (2, BF16_VECTOR_BELOW - 1, True, "vector"), (2, BF16_VECTOR_BELOW, True, "bulk"),
    (4, 3072 * 768, True, "bulk"),
    (2, 1 << 24, True, "bulk"), (2, 1 << 24, False, "element"),
])
def test_plan_paths(itemsize, n, aligned, path):
    plan = _unplane_plan(n, itemsize, False, aligned, H100_SMS)
    assert plan.path == path and path in PATHS


def test_plan_tile_follows_the_call_size():
    """A call of more than BIG_WAVES waves takes the largest tile (zamba2's
    stack, past 2^32 bytes); a smaller one whole waves of tiles up to it,
    the same number for every SM; a main-path leaf (3072x768) at fp32, too
    small for one wave, tiles of MIN_TILE, and at bf16 the vector path; a
    base halves the largest tile."""
    wave = WAVE_TILES * H100_SMS
    zamba = _unplane_plan(4_074_749_952, 2, False, True, H100_SMS)
    assert zamba.tile == max_tile(2, False) == 16_384
    assert zamba.tiles * zamba.tile == 4_074_749_952 and zamba.vec_elems == zamba.tail == 0
    assert _unplane_plan(1 << 31, 4, True, True, H100_SMS).tile == max_tile(4, True) == 4_096
    mid = _unplane_plan(1 << 28, 2, False, True, H100_SMS)
    assert mid.tiles % wave == 0 and mid.tile <= max_tile(2, False)
    assert mid.tile > max_tile(2, False) * (BIG_WAVES - 1) // BIG_WAVES
    leaf = _unplane_plan(3072 * 768, 4, False, True, H100_SMS)
    assert leaf == Plan(3072 * 768 // MIN_TILE, MIN_TILE, 0, 0)
    assert _unplane_plan(3072 * 768, 2, True, True, H100_SMS) == Plan(0, 0, 3072 * 768, 0)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("n, sms", [(17, 132), (5_000, 4), (100_003, 132), (100_003, 2),
                                    (3 * 4096 + 7, 1)])
def test_plain_piece_by_piece_equals_whole(itemsize, with_base, n, sms):
    planes, base = inputs(n, itemsize, with_base, seed=n + itemsize + 10 * with_base)
    whole = plane_consumer_plain(planes, base, itemsize=itemsize)
    plan = _unplane_plan(n, itemsize, with_base, True, sms)
    parts = [plane_consumer_plain([p[a:b] for p in planes],
                                  None if base is None else base[a:b], itemsize=itemsize)
             for a, b, _ in pieces(plan)]
    assert len(parts) == plan.tiles + 2
    assert torch.equal(torch.cat(parts), whole)


def test_largest_stages_fit_in_shared_memory():
    """The kernel's STAGES stages of the largest tile (input, and output
    tile) fit in the 227 KB a block may take on an H100, in each variant."""
    src = (_build.CSRC / "unplane.cu").read_text()
    stages = int(src.split("constexpr int STAGES = ")[1].split(";")[0])
    for itemsize in (2, 4):
        for with_base in (False, True):
            tile = max_tile(itemsize, with_base)
            stage = itemsize * tile * (3 if with_base else 2)
            assert stages * (stage + 8) <= 232_448


def test_tile_bound_agrees_with_the_kernel():
    """The plan's largest tile is the kernel's: the kernel raises its
    shared-memory limit once, to the stages of that tile, and refuses a
    larger one."""
    src = (_build.CSRC / "unplane.cu").read_text()
    expr = src.split("constexpr int TILE_IN_BYTES = ")[1].split(";")[0]
    assert eval(expr, {}) == TILE_IN_BYTES


def test_cpu_tensors_run_the_plain_version_uncounted():
    planes, base = inputs(4096, 2, True, seed=3)
    reset_launch_counts()
    got = plane_consumer(planes, base, itemsize=2)
    assert torch.equal(got, plane_consumer_plain(planes, base, itemsize=2))
    assert torch.equal(ungroup_bf16(*planes), ungroup_bf16_plain(*planes))
    assert launch_counts()["plane_consumer"] == 0 == launch_counts()["ungroup_bf16"]
    assert plane_consumer.launches_by_path == dict.fromkeys(PATHS, 0)
    assert ungroup_bf16.launches_by_path == dict.fromkeys(PATHS, 0)


def test_reset_launch_counts_zeroes_the_paths():
    plane_consumer.launches_by_path["bulk"] = 3
    ungroup_fp32.launches_by_path["element"] = 2
    reset_launch_counts()
    assert plane_consumer.launches_by_path == dict.fromkeys(PATHS, 0)
    assert ungroup_fp32.launches_by_path == dict.fromkeys(PATHS, 0)


# ---------------------------------------------------------------------------
# the kernel on the card (gpu)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def sm_count(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def size_of(case, itemsize, with_base, dev):
    t, v = max_tile(itemsize, with_base), vector_below(itemsize, sm_count(dev))
    return {"1": 1, "15": 15, "16": 16, "17": 17, "T-1": t - 1, "T": t, "T+1": t + 1,
            "3T+7": 3 * t + 7, "2 waves+5": 2 * sm_count(dev) * t + 5,
            "vector-1": v - 1, "vector+17": v + 17}[case]


def run_counted(fn, *args, **kw):
    reset_launch_counts()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, fn.launches, dict(fn.launches_by_path)


def expect_one(launches, by_path, path):
    assert launches == 1
    assert by_path == dict(dict.fromkeys(PATHS, 0), **{path: 1})


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["1", "15", "16", "17", "T-1", "T", "T+1", "3T+7",
                                  "2 waves+5", "vector-1", "vector+17"])
@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_kernel_equals_plain_at_tile_edges(cuda, itemsize, with_base, case):
    n = size_of(case, itemsize, with_base, cuda)
    planes, base = inputs(n, itemsize, with_base, seed=n % 1000 + itemsize, device=cuda)
    plan = _unplane_plan(n, itemsize, with_base, True, sm_count(cuda))
    got, launches, by_path = run_counted(plane_consumer, planes, base, itemsize=itemsize)
    assert torch.equal(got, plane_consumer_plain(planes, base, itemsize=itemsize))
    expect_one(launches, by_path, plan.path)
    assert plan.path == ("bulk" if n >= vector_below(itemsize, sm_count(cuda)) else
                         "vector" if n >= 16 else "element")
    if not with_base:                                   # K11: the same kernel, no base
        ungroup, plain = ((ungroup_bf16, ungroup_bf16_plain) if itemsize == 2
                          else (ungroup_fp32, ungroup_fp32_plain))
        got, launches, by_path = run_counted(ungroup, *planes)
        assert torch.equal(got, plain(*planes))
        expect_one(launches, by_path, plan.path)


@pytest.mark.gpu
@pytest.mark.parametrize("what, with_base", [("plane", False), ("plane", True), ("base", True),
                                             ("views at n", False), ("views at n", True)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_misaligned_calls_take_the_element_path(cuda, itemsize, with_base, what):
    n = 100_003
    planes, base = inputs(n + 1, itemsize, with_base, seed=40 + itemsize, device=cuda)
    planes = [p[:n] for p in planes]
    base = None if base is None else base[:n]
    if what == "plane":                      # one plane off by a byte, the others aligned
        planes[-1] = torch.cat([planes[-1][:1], planes[-1]])[1:]
        assert planes[-1].data_ptr() % 16 and planes[0].data_ptr() % 16 == 0
    elif what == "base":
        base = torch.cat([base[:1], base])[1:]
        assert base.data_ptr() % 16
    else:                                    # as _ResidentStream.planes cuts one buffer
        buf = torch.cat(planes)
        planes = [buf[k * n:(k + 1) * n] for k in range(itemsize)]
        assert planes[1].data_ptr() % 16
    got, launches, by_path = run_counted(plane_consumer, planes, base, itemsize=itemsize)
    assert torch.equal(got, plane_consumer_plain(planes, base, itemsize=itemsize))
    expect_one(launches, by_path, "element")


@pytest.mark.gpu
@pytest.mark.parametrize("itemsize", [2, 4])
def test_views_of_one_buffer_at_an_aligned_n_take_the_bulk_path(cuda, itemsize):
    n = vector_below(itemsize, sm_count(cuda)) + 16 * 40_001
    buf = torch.cat(inputs(n, itemsize, False, seed=7, device=cuda)[0])
    planes = [buf[k * n:(k + 1) * n] for k in range(itemsize)]
    got, launches, by_path = run_counted(plane_consumer, planes, itemsize=itemsize)
    assert torch.equal(got, plane_consumer_plain(planes, itemsize=itemsize))
    expect_one(launches, by_path, "bulk")


@pytest.mark.gpu
def test_bf16_past_four_gib_of_output(cuda):
    """Offsets pass 2^32 bytes (zamba2's stack does): held against the
    plain version slice by slice."""
    n = (1 << 31) + 4_099
    g = torch.Generator(device=cuda).manual_seed(5)
    planes = [torch.randint(0, 256, (n,), dtype=torch.uint8, device=cuda, generator=g)
              for _ in range(2)]
    got, launches, by_path = run_counted(plane_consumer, planes, itemsize=2)
    expect_one(launches, by_path, "bulk")
    step = 1 << 28
    for a in range(0, n, step):
        want = plane_consumer_plain([p[a:a + step] for p in planes], itemsize=2)
        assert torch.equal(got[a:a + step], want)


@pytest.mark.gpu
@pytest.mark.parametrize("itemsize", [2, 4])
def test_two_streams_at_once(cuda, itemsize):
    n = 3 * max_tile(itemsize, False) * sm_count(cuda) + 7
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    args = [inputs(n, itemsize, True, seed=60 + s + itemsize, device=cuda) for s in range(2)]
    want = [plane_consumer_plain(p, b, itemsize=itemsize) for p, b in args]
    got = [[], []]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda))
    reset_launch_counts()
    for _ in range(8):
        for i, (s, (p, b)) in enumerate(zip(streams, args)):
            with torch.cuda.stream(s):
                got[i].append(plane_consumer(p, b, itemsize=itemsize))
    torch.cuda.synchronize()
    assert all(torch.equal(x, w) for xs, w in zip(got, want) for x in xs)
    assert plane_consumer.launches_by_path["bulk"] == 16


@pytest.mark.gpu
@pytest.mark.parametrize("itemsize", [2, 4])
def test_two_host_threads_with_tiles_of_two_sizes(cuda, itemsize):
    """Host threads launch at once, as the file engine's frame pipeline
    does, with calls whose plans take tiles of different sizes (a full
    frame's and a smaller ragged last one's): every launch runs and is
    right; the kernel's shared-memory limit is set once for all of them."""
    import threading

    sms = sm_count(cuda)
    sizes = (64 * 2 ** 20 // itemsize, vector_below(itemsize, sms) + 12_345)
    plans = [_unplane_plan(n, itemsize, False, True, sms) for n in sizes]
    assert plans[0].tile != plans[1].tile and {p.path for p in plans} == {"bulk"}
    args = [inputs(n, itemsize, False, seed=90 + i + itemsize, device=cuda)[0]
            for i, n in enumerate(sizes)]
    want = [plane_consumer_plain(p, itemsize=itemsize) for p in args]
    errors, bad = [], []

    def worker(i):
        try:
            s = torch.cuda.Stream(cuda)
            with torch.cuda.stream(s):
                for _ in range(40):
                    got = plane_consumer(args[i], itemsize=itemsize)
                    s.synchronize()
                    if not torch.equal(got, want[i]):
                        bad.append(i)
        except Exception as e:             # reported below, in the test's thread
            errors.append(e)

    torch.cuda.synchronize()
    reset_launch_counts()
    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert not bad
    assert plane_consumer.launches_by_path["bulk"] == 80


@pytest.mark.gpu
@pytest.mark.parametrize("with_base", [False, True])
def test_k2_in_a_cuda_graph(cuda, with_base):
    """A launch captured in a CUDA graph reads the inputs anew at each replay."""
    n = 2 * max_tile(4, with_base) * sm_count(cuda) + 13
    planes, base = inputs(n, 4, with_base, seed=70, device=cuda)
    plane_consumer(planes, base, itemsize=4)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = plane_consumer(planes, base, itemsize=4)
    for seed in (71, 72):
        new, new_base = inputs(n, 4, with_base, seed=seed, device=cuda)
        for p, q in zip(planes, new):
            p.copy_(q)
        if with_base:
            base.copy_(new_base)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, plane_consumer_plain(planes, base, itemsize=4))


@pytest.mark.gpu
def test_too_much_shared_memory_raises(cuda, monkeypatch):
    n = 1 << 18
    planes, _ = inputs(n, 2, False, seed=80, device=cuda)
    monkeypatch.setattr(fused_unplane, "_unplane_plan",
                        lambda *a, **k: Plan(2, 1 << 17, 0, 0))     # 4 stages of 512 KiB
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="plane_consumer launch: CUDA error"):
        plane_consumer(planes, itemsize=2)
    assert plane_consumer.launches == 0
    assert plane_consumer.launches_by_path == dict.fromkeys(PATHS, 0)
    monkeypatch.undo()                         # the next launch is not poisoned
    got = plane_consumer(planes, itemsize=2)
    assert torch.equal(got, plane_consumer_plain(planes, itemsize=2))
