"""Run one cell as ``bench/run.py --trace 1`` does, with the program's own
spans recorded, or time its step with tracing off and on.

    python3 bench/run_spans.py --workload <name> --seed <n> --seconds <s>
    python3 bench/run_spans.py --workload <name> --seed <n> --cost <steps>

The first form runs ``harness.runner.run`` (set-up, window, traced steps,
the reference's judgement) with a recording of the program's spans
(``repro_torch.trace``) around the serving mode's set-up and another
around the profiled steps.  Its last line is the runner's result object
with ``spans`` added: the readings of :data:`harness.spans.READINGS`,
device and host ms a step by span, the counters a step, the store build's
seconds by span, and the spans' checks against the runner's own metrics.

The second form sets the cell up and times ``steps`` steps at a time in
three modes, in turns, five rounds: tracing off, a recording open, and a
recording open under the profiler as a traced run profiles; then the cost
of an off span.  Its last line gives each mode's step times (ms).

On a checkout whose program has no spans the readings are null and the
recording mode is left out.  Needs a card, as ``bench/run.py`` does.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import timeit  # noqa: E402
import types  # noqa: E402

from run import _env  # noqa: E402

ROUNDS = 5


def _ratio(a, b):
    return a / b if a is not None and b else None


def _gaps(times):
    return [1e3 * (b - a) for a, b in zip(times, times[1:])]


def traced(cell, seed, seconds, device):
    """The runner's result with the program's spans read."""
    from harness import runner, spans
    from harness import trace as htrace

    kept = {"build": None, "steps": None, "events": None}
    mode = cell.mode()

    def setup(cfg, params, dev):
        with spans.recording() as rec:
            entry = mode.setup(cfg, params, dev)
        kept["build"] = rec
        return entry

    profile_steps = htrace.profile_steps

    def profiled(step, steps, instrument):
        with spans.recording() as rec:
            events = profile_steps(step, steps, instrument)
        kept["steps"], kept["events"] = rec, events
        return events

    cell.mode = lambda: types.SimpleNamespace(setup=setup)
    htrace.profile_steps = profiled
    try:
        result, rec = runner.run(cell, seed, seconds, True, device, T_START)
    finally:
        htrace.profile_steps = profile_steps
    rec["spans"] = spans.reduce(kept["events"], kept["steps"], kept["build"])
    s = rec["spans"]
    out = {"readings": {n: spans.read(rec, n) for n in spans.READINGS}}
    if s:
        m = {k: v["value"] for k, v in result["metrics"].items()}
        idle = dict(result.get("breakdown", {}).get("idle_gaps", []))
        dev = s["device_ms"]
        model = sum(dev.get(n, 0.0) for n in ("model.attention", "model.mlp",
                                             "model.write_caches"))
        out.update(s, checks={
            "feed_decode_over_weight_decode": _ratio(dev.get("feed.decode"),
                                                     m.get("weight_decode_ms")),
            "attention_mlp_cache_write_over_compute": _ratio(model, m.get("compute_ms")),
            "idle_under_harness_spans_only": _ratio(
                idle.get(htrace.STEP, 0.0) + idle.get(htrace.DECODE, 0.0),
                sum(idle.values())),
            "setup_s": rec["setup_s"],
        })
    result["spans"] = out
    return result


def cost(cell, seed, steps, device):
    """Step times in the three modes, and an off span's cost in us."""
    import torch

    from harness import inputs, runner, spans
    from harness import trace as htrace
    from harness.serving import ClosedLoop

    conf, traffic = cell.conf, cell.traffic
    ref = cell.reference()
    entry = cell.mode().setup(cell.program_config(), inputs.weights(
        ref.param_shapes(conf), seed, device, getattr(torch, conf["param_dtype"])), device)
    loop = ClosedLoop(entry, conf, traffic, seed, device,
                      inputs.caches(ref, conf, traffic, seed, device))
    for _ in range(traffic["warmup_steps"]):
        loop.step()
    runner._sync(device)

    def off():
        return _gaps([loop.step() for _ in range(steps + 1)])

    def host(mode, rec):
        """The step's host ms inside ``serve.step`` less its waits."""
        if rec is not None and "serve.step" in rec.totals:
            t = rec.totals
            host_ms[mode].append((t["serve.step"]["ns"] - t.get("ring.wait", {"ns": 0})["ns"])
                                 / t["serve.step"]["count"] / 1e6)

    def recorded():
        with spans.recording() as rec:
            times = [loop.step() for _ in range(steps + 1)]
        counts.update({n: t["count"] / (steps + 1) for n, t in rec.totals.items()})
        host("recording", rec)
        return _gaps(times)

    def profiled():
        times = []
        with spans.recording() as rec:
            htrace.profile_steps(lambda: times.append(loop.step()), steps + 1, entry.instrument)
        host("profiler", rec)
        return _gaps(times)

    counts, host_ms = {}, {"recording": [], "profiler": []}
    modes = {"off": off, "profiler": profiled}
    if spans.program is not None:
        modes = {"off": off, "recording": recorded, "profiler": profiled}
    got = {m: [] for m in modes}
    for _ in range(ROUNDS):
        for m, fn in modes.items():
            got[m] += fn()
    out = {"step_ms": {m: {"median": statistics.median(v), "n": len(v), "all": v}
                       for m, v in got.items()},
           "spans_a_step": counts,
           "step_host_ms": {m: statistics.median(v) for m, v in host_ms.items() if v}}
    if spans.program is not None:
        span = spans.program.span
        n = 100_000
        empty = min(timeit.repeat("pass", number=n, repeat=5))
        off_span = min(timeit.repeat("with span('serve.step'): pass", number=n, repeat=5,
                                     globals={"span": span}))
        out["off_span_us"] = (off_span - empty) / n * 1e6
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--cost", type=int, default=0, help="steps a mode a round")
    args = ap.parse_args(argv)
    _env()
    import torch

    from harness import cell as cells

    cell = cells.load(args.workload)
    if not torch.cuda.is_available():
        print(f"run_spans: {args.workload} needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    if args.cost:
        out = cost(cell, args.seed, args.cost, device)
    else:
        out = traced(cell, args.seed, args.seconds, device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
