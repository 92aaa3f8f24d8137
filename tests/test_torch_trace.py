"""The port's spans (``repro_torch.trace``): off, a span is one shared
no-op object; under a recording, spans nest with parents and self time on
their own thread, pool threads' spans are kept with their thread, and the
recording carries the program's launch and upload counters' change; under
the torch profiler, spans are ``record_function`` events.  Then the spans
of one store build, one ring step and one plain step at ``reduced()``
size, counted against the store's own plan.

No test reads a duration: a timing assertion would be flaky.  The card
twin of the ring's counters is marked ``gpu``.
"""

import ast
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import _util, trace
from repro_torch.configs import get_config
from repro_torch.core import zipnn
from repro_torch.core.options import CodecOptions
from repro_torch.models.model import init_decode_state, param_shapes
from repro_torch.serve import CompressedParamStore, make_compressed_serve_step, make_serve_step

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
HUFF = zipnn.ZipNNConfig(chunk_param_bytes=512, backend="huffman")


def test_off_span_is_one_shared_no_op():
    a, b = trace.span("serve.step"), trace.span("feed.decode")
    assert a is b
    with a as got:
        assert got is None
    with trace.recording() as rec:
        pass
    assert rec.spans == [] and rec.totals == {}


def test_nesting_parents_and_self_time():
    with trace.recording() as rec:
        with trace.span("serve.step"):
            with trace.span("model.attention"):
                with trace.span("feed.decode"):
                    pass
            with trace.span("model.mlp"):
                pass
    parents = {name: parent for name, parent, *_ in rec.spans}
    assert parents == {"serve.step": None, "model.attention": "serve.step",
                       "feed.decode": "model.attention", "model.mlp": "serve.step"}
    assert [s[0] for s in rec.spans] == ["feed.decode", "model.attention", "model.mlp",
                                         "serve.step"]           # closing order
    for name, parent, thread, t0, t1 in rec.spans:
        assert thread == threading.get_ident() and t0 <= t1
    tot = rec.totals
    assert all(t["count"] == 1 for t in tot.values())
    assert tot["serve.step"]["self_ns"] == (
        tot["serve.step"]["ns"] - tot["model.attention"]["ns"] - tot["model.mlp"]["ns"])
    assert tot["model.attention"]["self_ns"] == (
        tot["model.attention"]["ns"] - tot["feed.decode"]["ns"])
    assert tot["feed.decode"]["self_ns"] == tot["feed.decode"]["ns"]
    assert trace.span("serve.step") is trace._OFF          # closed: off again


def test_unknown_name_is_refused_while_recording():
    with trace.recording():
        with pytest.raises(ValueError, match="unknown span"):
            trace.span("model.everything")


def test_pool_threads_record_their_own_thread_and_no_parent():
    """More workers than cores and a short switch interval: every span of
    every thread is kept, and each thread's spans nest on that thread."""
    workers, per = 16, 200

    def work(_):
        for _ in range(per):
            with trace.span("encode.plan"):
                with trace.span("encode.k7"):
                    pass
        return threading.get_ident()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.recording() as rec:
            with trace.span("store.encode"):
                with ThreadPoolExecutor(workers) as pool:
                    threads = set(pool.map(work, range(workers), timeout=120))
    finally:
        sys.setswitchinterval(old)
    assert rec.totals["encode.plan"]["count"] == rec.totals["encode.k7"]["count"] == (
        workers * per)
    plan = [s for s in rec.spans if s[0] == "encode.plan"]
    assert {s[2] for s in plan} <= threads and threading.get_ident() not in threads
    assert all(s[1] is None for s in plan)
    assert all(s[1] == "encode.plan" for s in rec.spans if s[0] == "encode.k7")
    (outer,) = [s for s in rec.spans if s[0] == "store.encode"]
    assert outer[1] is None and outer[2] == threading.get_ident()
    assert rec.totals["store.encode"]["self_ns"] == rec.totals["store.encode"]["ns"]


def test_profiler_sees_spans_only_while_it_is_on():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("model.mlp"):
            torch.ones(4).sum()
        with trace.recording() as rec:
            with trace.span("model.tail"):
                pass
    names = [e.name for e in prof.events()]
    assert names.count("model.mlp") == 1 and names.count("model.tail") == 1
    assert [s[0] for s in rec.spans] == ["model.tail"]
    assert trace.span("model.mlp") is trace._OFF


def _opened_names():
    """Every literal name passed to ``trace.span`` in the package."""
    found = {}
    for path in sorted(SRC.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "span" and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "trace"):
                arg = node.args[0]
                assert isinstance(arg, ast.Constant), f"{path}:{node.lineno}"
                found.setdefault(arg.value, []).append(f"{path.name}:{node.lineno}")
    return found


def test_every_name_opened_is_declared_and_every_declared_name_is_opened():
    opened = _opened_names()
    assert set(opened) == set(trace.NAMES), (sorted(set(opened) ^ set(trace.NAMES)))
    assert len(trace.NAMES) == len(set(trace.NAMES))


@pytest.fixture(scope="module")
def tiny():
    """repro_gpt_100m at ``reduced()`` size, built into a store under a
    recording: (cfg, params, store, build recording)."""
    cfg = get_config("repro_gpt_100m").reduced()
    rng = np.random.default_rng(0)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(node[k]) for k in sorted(node)}
        a = (rng.standard_normal(node) * 0.02).astype(np.float32)
        return torch.from_numpy(a).to(torch.bfloat16)

    params = fill(param_shapes(cfg))
    with trace.recording() as build:
        store = CompressedParamStore.from_params(
            params, HUFF, options=CodecOptions(backend="device"), payload_feed=True,
            device="cpu")
    return cfg, params, store, build


def _plan(store):
    """(leaves with a feed, leaves whose feed launches K1) of one step."""
    feeds = [f for layer in store.feeds("layers") for f in layer if f is not None]
    return len(feeds), sum(f.n_launches["huffdecode_chunks"] for f in feeds)


def test_store_build_spans(tiny):
    cfg, _, store, build = tiny
    count = {k: v["count"] for k, v in build.totals.items()}
    leaves, _ = _plan(store)
    assert count["store.encode"] == count["store.feed"] == cfg.n_layers
    assert count["feed.verify"] == count["feed.pack"] == count["feed.index"] == leaves
    assert count["feed.upload"] >= leaves
    assert count["encode.plan"] == count["encode.finalize"] == leaves
    by_parent = {}
    for name, parent, *_ in build.spans:
        by_parent.setdefault(name, set()).add(parent)
    assert by_parent["store.encode"] == by_parent["store.feed"] == {None}
    assert by_parent["feed.index"] == {"store.feed"}
    assert by_parent["encode.k7"] == {"store.encode"}
    assert build.counters["payload_uploads"] > 0


def _step_recording(cfg, step, state_device="cpu"):
    state = init_decode_state(cfg, 2, 4, start_pos=0, device=state_device)
    toks = torch.zeros((2, 1), dtype=torch.int32, device=state_device)
    with trace.recording() as rec:
        step(state, toks)
    return rec


def test_ring_step_spans_and_counters(tiny):
    """One ring step: a ``ring.decode`` a layer and a ``feed.decode`` a
    leaf, under the step; no payload upload.  (On the CPU the kernels'
    plain versions run and count no launch; the card's count is below.)"""
    cfg, _, store, _ = tiny
    rec = _step_recording(cfg, make_compressed_serve_step(cfg, store, ring=2))
    count = {k: v["count"] for k, v in rec.totals.items()}
    leaves, k1 = _plan(store)
    assert k1 == leaves > 0              # every leaf of this store has Huffman chunks
    assert count == {"serve.step": 1, "model.front": 1, "ring.decode": cfg.n_layers,
                     "feed.decode": leaves, "model.attention": cfg.n_layers,
                     "model.mlp": cfg.n_layers, "model.write_caches": 1, "model.tail": 1}
    assert {p for n, p, *_ in rec.spans if n == "feed.decode"} == {"ring.decode"}
    assert rec.counters["payload_uploads"] == 0
    assert rec.counters["huffdecode_chunks"] == rec.counters["plane_consumer"] == 0


def test_plain_step_spans(tiny):
    cfg, params, _, _ = tiny
    plain = make_serve_step(cfg)
    rec = _step_recording(cfg, lambda s, t: plain(params, s, t))
    count = {k: v["count"] for k, v in rec.totals.items()}
    assert count == {"serve.step": 1, "model.front": 1, "model.attention": cfg.n_layers,
                     "model.mlp": cfg.n_layers, "model.write_caches": 1, "model.tail": 1}
    assert {p for n, p, *_ in rec.spans if n != "serve.step"} == {"serve.step"}


@pytest.mark.gpu
def test_ring_step_counters_on_card(tiny):
    """On the card one ring step launches K2 once a leaf and K1's sync
    decode once a leaf with Huffman chunks, and uploads no payload."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, params, _, _ = tiny
    cuda = torch.device("cuda", 0)
    store = CompressedParamStore.from_params(
        {k: _util.tree_map(lambda a: a.to(cuda), v) for k, v in params.items()},
        HUFF, options=CodecOptions(backend="device"), payload_feed=True, device=cuda)
    step = make_compressed_serve_step(cfg, store, ring=2)
    _step_recording(cfg, step, cuda)                      # first launches build the kernels
    rec = _step_recording(cfg, step, cuda)
    torch.cuda.synchronize()
    leaves, k1 = _plan(store)
    assert rec.counters["plane_consumer"] == leaves
    assert rec.counters["huffdecode_chunks"] == k1 > 0
    assert rec.counters["payload_uploads"] == 0
    assert rec.totals["feed.decode"]["count"] == leaves
