"""The reduction of the program's spans (``harness/spans.py``) and the run
that records them (``run_spans.py``): device events go to the innermost
program span open on their launching thread; the harness's own reduction
and every metric read from it are unchanged by the program's spans in a
trace; the readings come out of a run at ``reduced()`` size on the CPU;
and a checkout whose program has no spans reads None where the readings
are and the runner's metrics as before."""

import types

import pytest

from _bench_small import BENCH, small_cell
from harness import cell as cells, spans, trace

LIMIT = 2e-2


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": tid,
            "args": args}


def _hand_trace(program_spans=True):
    """One step of 100 us on thread 1.  The ring decodes a leaf (K1 and K2
    launched inside ``feed.decode`` inside ``ring.decode``), then a layer's
    attention and MLP launch a gemm each, and the step's argmax launches
    outside every program span.  A pool thread (2) launches a copy inside
    its own ``feed.upload``; one device event has no launch in the trace,
    and one lies outside the step."""
    ev = [
        _ev("user_annotation", trace.STEP, 0, 100),
        _ev("user_annotation", trace.DECODE, 2, 18),
        _ev("cuda_runtime", "cudaLaunchKernel", 5, 1, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 8, 1, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 30, 1, correlation=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 50, 1, correlation=4),
        _ev("cuda_runtime", "cudaLaunchKernel", 90, 1, correlation=5),
        _ev("cuda_runtime", "cudaMemcpyAsync", 40, 1, tid=2, correlation=6),
        _ev("cpu_op", "aten::argmax", 88, 5),
        _ev("kernel", "k1", 10, 20, tid=7, correlation=1, stream=7),
        _ev("kernel", "k2", 30, 5, tid=7, correlation=2, stream=7),
        _ev("kernel", "gemm_a", 35, 10, tid=8, correlation=3, stream=0),
        _ev("kernel", "gemm_m", 55, 20, tid=8, correlation=4, stream=0),
        _ev("kernel", "argmax", 92, 4, tid=8, correlation=5, stream=0),
        _ev("gpu_memcpy", "copy", 45, 2, tid=8, correlation=6, stream=0),
        _ev("gpu_memset", "set", 80, 3, tid=8, correlation=99, stream=0),
        _ev("kernel", "late", 150, 10, tid=8, correlation=5, stream=0),
    ]
    if program_spans:
        ev += [
            _ev("user_annotation", "serve.step", 1, 86),
            _ev("user_annotation", "ring.decode", 3, 16),
            _ev("user_annotation", "feed.decode", 4, 14),
            _ev("user_annotation", "model.attention", 25, 10),
            _ev("user_annotation", "model.mlp", 45, 30),
            _ev("user_annotation", "feed.upload", 39, 3, tid=2),
        ]
    return ev


def test_device_time_goes_to_the_innermost_program_span():
    got = spans.device_us(_hand_trace(), spans.program.NAMES)
    assert got == {"feed.decode": 25.0, "model.attention": 10.0, "model.mlp": 20.0,
                   "feed.upload": 2.0, spans.OUTSIDE: 4.0 + 3.0}


def test_harness_reduction_and_metrics_unchanged_by_program_spans():
    """The program's spans move no number the harness reduced before, and
    its idle gaps now name what the host was doing inside the step."""
    plain, spanned = trace.reduce(_hand_trace(False)), trace.reduce(_hand_trace())
    assert {k: v for k, v in plain.items() if k != "idle_gaps"} == {
        k: v for k, v in spanned.items() if k != "idle_gaps"}
    assert sum(us for _, us in plain["idle_gaps"]) == sum(us for _, us in spanned["idle_gaps"])
    assert "serve.step" in dict(spanned["idle_gaps"])
    rec = {"batch": 4, "setup_s": 1.0, "peak_bytes": 1e9, "flops": 1e12,
           "counters": {"device_payload_bytes": 6, "raw_bytes": 10},
           "window": {"seconds": 1.0, "steps": 10, "gaps_s": [0.1] * 10}}
    for m in (BENCH / "metrics").glob("*.py"):
        read = cells.load_module(m).read
        assert read(dict(rec, trace=plain)) == read(dict(rec, trace=spanned)), m.stem


def _recording(totals, counters):
    return types.SimpleNamespace(
        totals={n: {"count": c, "ns": ns, "self_ns": s} for n, (c, ns, s) in totals.items()},
        counters=counters)


def test_readings_by_hand():
    steps = _recording({"serve.step": (2, 40_000_000, 1_000_000),
                        "ring.wait": (10, 6_000_000, 6_000_000),
                        "feed.decode": (36, 20_000_000, 20_000_000)},
                       {spans.K1: 30, spans.K2: 36, "payload_uploads": 0})
    build = _recording({"store.encode": (2, 3_000_000_000, 1_000_000),
                        "store.feed": (2, 1_500_000_000, 2_000_000)}, {})
    rec = {"spans": spans.reduce(_hand_trace(), steps, build)}
    got = {n: spans.read(rec, n) for n in spans.READINGS}
    assert got == pytest.approx({
        "attention_ms": 0.010, "mlp_ms": 0.020, "cache_write_ms": None,
        "step_host_ms": 40.0 - 6.0, "decode_host_ms": 20.0, "decode_launches": 66.0,
        "build_encode_s": 3.0, "build_feed_s": 1.5})
    assert rec["spans"]["counters"] == {spans.K1: 30, spans.K2: 36}


def test_plain_step_reads_no_ring_or_build_reading():
    steps = _recording({"serve.step": (1, 5_000_000, 5_000_000)}, {})
    rec = {"spans": spans.reduce(_hand_trace(), steps, _recording({}, {}))}
    assert spans.read(rec, "step_host_ms") == 5.0
    for n in ("decode_host_ms", "decode_launches", "build_encode_s", "build_feed_s"):
        assert spans.read(rec, n) is None, n


def _run(workload, **traffic):
    import run_spans

    cell = small_cell(workload, **traffic)
    cell.limits = {"logit_gap": {"limit": LIMIT}}
    return run_spans.traced(cell, 2 ** 34 + 7, 0.05, "cpu")


def test_ring_run_reads_the_host_spans():
    """A traced ring run at reduced size: the build and the step's host
    spans read; the CPU launches no kernel (the plain versions count
    none) and gives no device event."""
    r = _run("granite_20b-8L.ring-b64-c2k", output_tokens=2, warmup_steps=1, trace_steps=1)
    assert r["correct"]
    got = r["spans"]["readings"]
    assert got["build_encode_s"] > 0 and got["build_feed_s"] > 0
    assert got["step_host_ms"] > 0 and got["decode_host_ms"] > 0
    assert got["decode_launches"] == 0
    assert got["attention_ms"] is got["mlp_ms"] is got["cache_write_ms"] is None
    host = r["spans"]["host_ms"]
    assert host["serve.step"]["count"] == host["model.front"]["count"] == 1
    assert host["ring.decode"]["count"] == host["model.mlp"]["count"] == 2   # 2 layers


def test_without_program_spans_readings_are_none(monkeypatch):
    """As on a checkout whose program has no ``repro_torch.trace``: the
    runner's result is the same but for the spans, which read None."""
    with_spans = _run("yi_6b.plain-b64-c2k")
    monkeypatch.setattr(spans, "program", None)
    with spans.recording() as rec:
        assert rec is None
    without = _run("yi_6b.plain-b64-c2k")
    assert set(without["spans"]) == {"readings"}
    assert set(without["spans"]["readings"].values()) == {None}
    assert with_spans["spans"]["readings"]["step_host_ms"] > 0
    assert with_spans["checks"] == without["checks"] and without["correct"]
    assert set(with_spans["metrics"]) == set(without["metrics"])
