"""One run of one cell: set-up, the measured window, the traced steps (with
``--trace 1``), the comparison with the reference, and the result line.

Set-up draws the weights on the device, lets the serving mode build its
entry over them, draws the context into the caches and warms the loop up
(``warmup_steps`` steps: every shape the window uses, and on the ring the
first load of its kernels).  The window then runs the closed loop for
``seconds`` of host time.  With ``trace`` the loop continues for
``trace_steps`` steps under the profiler.  The round under way is decoded
to its end, the peak is read, the program is dropped, and the reference
judges a sample of the finished requests.
"""

from __future__ import annotations

import gc
import subprocess
import time
from typing import Any, Dict, Iterable, List, Tuple

import torch

from . import check, inputs, trace
from .cell import BENCH, Cell, load_module
from .serving import ClosedLoop

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """Of the module ``names`` (``sys.modules``), the top-level names that
    are JAX's, Flax's or the JAX package's, compared whole: ``repro_torch``
    is not ``repro``."""
    return sorted({m.split(".")[0] for m in list(names)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
        else "unknown"


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float, *,
        control: bool = False) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The result line's object and the records the metrics were read
    from.  ``control`` adds the control's reading to the records (for the
    calibration of limits; a benchmark run never sets it)."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    conf, traffic = cell.conf, cell.traffic
    ref = cell.reference()
    entry = cell.mode().setup(cell.program_config(), inputs.weights(
        ref.param_shapes(conf), seed, device, getattr(torch, conf["param_dtype"])), device)
    loop = ClosedLoop(entry, conf, traffic, seed, device,
                      inputs.caches(ref, conf, traffic, seed, device))
    for _ in range(traffic["warmup_steps"]):
        loop.step()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    win = loop.window(seconds)
    _sync(device)
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    rec: Dict[str, Any] = {"setup_s": setup_s, "window": win, "batch": traffic["batch"],
                           "peak_bytes": window_peak, "trace": None,
                           "flops": sum(ref.decode_flops(conf, traffic["batch"], p)
                                        for p in win["positions"])}
    if traced:
        rec["trace"] = trace.reduce(trace.profile_steps(loop.step, traffic["trace_steps"],
                                                        entry.instrument))
    loop.finish_round()
    _sync(device)
    peak = max(setup_peak, window_peak,
               torch.cuda.max_memory_allocated(device) if on_card else 0)
    rec["counters"] = entry.counters()
    req = loop.requests(inputs.sample(seed, loop.finished_rounds, traffic["batch"],
                                      traffic["sample_requests"]))
    del loop, entry
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    reading = check.readings(ref, conf, traffic, seed, device, req, control=control)
    rec["reading"] = reading
    verdict = check.judge(reading, cell.limits)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = load_module(BENCH / "metrics" / f"{m['name']}.py").read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.workload["chips"], "memory_peak_bytes": peak}
    if on_card:
        dev["power_limit"] = power_limit()
    result: Dict[str, Any] = {"correct": verdict["correct"], "attempted": win["requests"],
                              "failed": verdict["failed"], "metrics": metrics, "device": dev}
    t = rec["trace"]
    if t and t["steps"]:
        dev["busy_s"] = t["busy_us"] / 1e6
        dev["window_s"] = t["window_us"] / 1e6
        result["breakdown"] = {
            "device_ops": [[n, us / 1e6] for n, us in t["device_ops"]],
            "idle_gaps": [[n, us / 1e6] for n, us in t["idle_gaps"]],
        }
    result["checks"] = verdict["checks"]
    return result, rec
