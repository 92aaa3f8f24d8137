"""The yardstick's arithmetic at ``reduced()`` sizes against hand counts
(a family's model FLOPs are its reference's),
the interval unions, the trace's reduction on a hand-made trace, and the
metric readers on hand-made records."""

import json

import pytest

from _bench_small import BENCH, ROOT, small_cell
from harness import arith, cell as cells, inputs, trace


@pytest.mark.parametrize("workload", ["granite_20b-8L.ring-b64-c2k", "yi_6b.plain-b64-c2k"])
def test_matrix_params_against_the_program_at_reduced_size(workload):
    """Two FLOPs a weight: the matrices of the program's own tree, less the
    embedding (looked up, not multiplied) and the norms and biases."""
    from repro_torch.models.model import param_shapes

    c = small_cell(workload)
    cfg = c.program_config()
    total = 0
    for path, shape in inputs.leaves(param_shapes(cfg)):
        if path[-1] in ("w", "w_in", "w_out", "w_gate", "w_up", "w_down"):
            total += shape[0] * shape[1] * shape[2]
    total += cfg.vocab_size * cfg.d_model            # the head
    assert c.reference().matrix_params(c.conf) == total


def test_decode_flops_by_hand():
    dense = cells.load_module(BENCH / "reference" / "dense.py")
    # reduced granite: d 128, 4 heads of 32, 1 kv head, ff 256, vocab 512, 2 layers
    conf = {"d_model": 128, "head_dim": 32, "n_heads": 4, "n_kv_heads": 1, "d_ff": 256,
            "vocab_size": 512, "n_layers": 2, "mlp": "gelu"}
    attn_w = 128 * 128 + 2 * 128 * 32 + 128 * 128            # wq, wk, wv, wo
    mlp_w = 2 * 128 * 256
    params = 2 * (attn_w + mlp_w) + 512 * 128
    assert dense.matrix_params(conf) == params == 278528
    # B = 3 at position 9: 10 positions attended, 4 * hd FLOPs each, per head and layer
    assert dense.decode_flops(conf, 3, 9) == 3 * (2 * params + 2 * 4 * 4 * 32 * 10)
    swiglu = dict(conf, mlp="swiglu", n_kv_heads=2)
    assert dense.matrix_params(swiglu) == 2 * (128 * 128 * 2 + 2 * 128 * 64 + 3 * 128 * 256) \
        + 512 * 128


def test_weight_decode_bytes_and_peaks():
    assert arith.weight_decode_bytes(66, 100) == 166
    assert arith.PEAKS == {"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}


def test_intervals():
    iv = [(5, 7), (0, 2), (1, 3), (6, 9), (4, 4)]
    assert arith.union(iv) == [(0, 3), (5, 9)]
    assert arith.length(iv) == 7
    assert arith.overlap([(0, 10)], [(2, 3), (5, 7), (9, 12)]) == 4
    assert arith.overlap([(0, 2), (4, 6)], [(1, 5)]) == 2
    assert arith.gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]
    assert arith.clip([(0, 3), (5, 9)], 2, 6) == [(2, 3), (5, 6)]


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": tid,
            "args": args}


def _hand_trace():
    """Two steps of 100 us.  Step 1: a decode span launches k1 (device
    10-30, stream 7); the compute launches gemm (device 20-60, stream 0).
    Step 2: gemm only (device 120-150).  A copy on stream 7 has no launch
    in the trace (device 35-40)."""
    return [
        _ev("user_annotation", trace.STEP, 0, 100),
        _ev("user_annotation", trace.STEP, 100, 100),
        _ev("user_annotation", trace.DECODE, 2, 5),
        _ev("cuda_runtime", "cudaLaunchKernel", 3, 1, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 9, 1, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 105, 1, correlation=3),
        _ev("cuda_runtime", "cudaStreamSynchronize", 60, 39),
        _ev("cpu_op", "aten::argmax", 160, 30),
        _ev("kernel", "k1", 10, 20, tid=7, correlation=1, stream=7),
        _ev("kernel", "gemm", 20, 40, tid=8, correlation=2, stream=0),
        _ev("kernel", "gemm", 120, 30, tid=8, correlation=3, stream=0),
        _ev("gpu_memcpy", "copy", 35, 5, tid=7, correlation=99, stream=7),
        _ev("gpu_user_annotation", trace.STEP, 0, 100, tid=8),
    ]


def test_trace_reduction_by_hand():
    r = trace.reduce(_hand_trace())
    assert r["steps"] == 2 and r["window_us"] == 200
    assert sorted(r["decode"]) == [(10.0, 30.0), (35.0, 40.0)]
    assert sorted(r["compute"]) == [(20.0, 60.0), (120.0, 150.0)]
    assert r["unattributed"] == 1
    assert r["busy_us"] == 50 + 30                       # 10-60 and 120-150
    assert dict(r["device_ops"]) == {"gemm": 70.0, "k1": 20.0, "copy": 5.0}
    # gaps 0-10, 60-120 and 150-200, named by the innermost host event
    # at each gap's middle (5, 90, 175)
    assert dict(r["idle_gaps"]) == {trace.DECODE: 10.0, "cudaStreamSynchronize": 60.0,
                                    "aten::argmax": 50.0}


def _reader(name):
    return cells.load_module(BENCH / "metrics" / f"{name}.py").read


def test_metric_readers_by_hand():
    t = trace.reduce(_hand_trace())
    rec = {"trace": t, "batch": 4, "setup_s": 12.5, "peak_bytes": 3e9, "flops": 989e12 * 2,
           "counters": {"device_payload_bytes": 670_000_000, "raw_bytes": 1_005_000_000},
           "window": {"seconds": 4.0, "steps": 10, "gaps_s": [0.1] * 18 + [0.2, 0.3]}}
    assert _reader("decode_tokens_per_s")(rec) == 10.0
    assert _reader("token_gap_ms_p95")(rec) == pytest.approx(200.0)
    assert _reader("peak_card_gb")(rec) == 3.0
    assert _reader("setup_s")(rec) == 12.5
    assert _reader("weight_decode_ms")(rec) == pytest.approx(25 / 2 / 1e3)
    assert _reader("compute_ms")(rec) == pytest.approx(70 / 2 / 1e3)
    # decode 10-30 and 35-40 (25 us), compute over 20-60: overlap 10 + 5
    assert _reader("ring_overlap_pct")(rec) == pytest.approx(60.0)
    assert _reader("payload_bytes_pct")(rec) == pytest.approx(100 * 670 / 1005)
    least = (670_000_000 + 1_005_000_000) / 3.35e12
    assert _reader("weight_decode_roofline")(rec) == pytest.approx(
        100 * least / 12.5e-6)
    assert _reader("step_mfu_pct")(rec) == pytest.approx(50.0)
    # 80 us busy over 2 traced steps, against the untraced window's mean
    # step of 2.3 s / 20
    assert _reader("device_idle_pct")(rec) == pytest.approx(100 * (1 - 40e-6 / 0.115))


def test_readers_find_nothing_where_nothing_runs():
    """The plain mode has no decode spans and no store: those metrics are
    left out, never 0."""
    ev = [e for e in _hand_trace() if e["name"] != trace.DECODE]
    rec = {"trace": trace.reduce(ev), "counters": {}, "window": {"steps": 0, "seconds": 1.0}}
    for name in ("weight_decode_ms", "ring_overlap_pct", "payload_bytes_pct",
                 "weight_decode_roofline", "step_mfu_pct", "device_idle_pct"):
        assert _reader(name)(rec) is None, name
    assert _reader("compute_ms")(rec) > 0


def test_cells_find_their_metrics():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        c = cells.load(w["name"])
        assert {m["name"] for m in c.end_to_end} == {
            m["name"] for m in spec["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])}
        for m in c.per_layer:
            assert m["moves"] in {e["name"] for e in c.end_to_end}
    ring = cells.load("yi_6b.ring-b64-c2k")
    plain = cells.load("yi_6b.plain-b64-c2k")
    assert "weight_decode_ms" in {m["name"] for m in ring.per_layer}
    assert "weight_decode_ms" not in {m["name"] for m in plain.per_layer}
    assert "token_gap_ms_p95" in {m["name"] for m in plain.end_to_end}
    assert "token_gap_ms_p95" not in {
        m["name"] for m in cells.load("granite_20b-8L.plain-b64-c2k").end_to_end}
