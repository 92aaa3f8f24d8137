"""The comparison that decides ``correct``.

After the window, once the program is gone, the reference draws the
weights and the context again from the seed and runs over each sampled
request's tokens (its first token and every served token but the last).
At each position the served token is the program's greedy choice; its
reading is the gap by which the reference's logit of that token lies below
the reference's best logit there.  The widest gap over the sample is the
number compared with the cell's limit (``checks/<workload>.json``).

The control (:func:`readings` with ``control=True``; the benchmark's runs
never compute it) is the reference computed with every weight product's
operands in float8 e4m3 over the same tokens: its greedy choice at each
position, read the same way against the float32 reference, and judged
by :func:`judge_control` against the same limits: it has to come out not
correct.
"""

from __future__ import annotations

import sys
from typing import Any, Dict

import torch

from . import inputs

GAP = "logit_gap"
BLOCK = 4                 # requests the reference runs at once


def readings(ref, conf: Dict[str, Any], traffic: Dict[str, Any], seed: int, device,
             req: Dict[str, torch.Tensor], *, control: bool = False) -> Dict[str, Any]:
    """Widest gap over the requests ``req`` (``ClosedLoop.requests``), and
    each request's own; with ``control`` the control's too."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _readings(ref, conf, traffic, seed, device, req, control)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _readings(ref, conf, traffic, seed, device, req, control):
    params = inputs.weights(ref.param_shapes(conf), seed, device,
                            getattr(torch, conf["param_dtype"]))
    slots = req["slots"].to(device)
    ctx = {name: c.index_select(1, slots)[:, :, :traffic["context"]].contiguous()
           for name, c in inputs.caches(ref, conf, traffic, seed, device).items()}
    per_req, ctl_req = [], []
    for a in range(0, len(slots), BLOCK):
        rows = slice(a, a + BLOCK)
        toks = req["tokens"][rows].to(device)
        served = req["served"][rows].to(device)
        part = {name: c[:, rows] for name, c in ctx.items()}
        exact = ref.logits(conf, params, part, toks)
        best = exact.max(dim=-1).values
        per_req += _widest(best - exact.gather(-1, served[..., None])[..., 0])
        if control:
            low = ref.logits(conf, params, part, toks, quant="fp8")
            pick = low.argmax(dim=-1, keepdim=True)
            ctl_req += _widest(best - exact.gather(-1, pick)[..., 0])
            del low
        del exact
    out = {GAP: max(per_req), "per_request": per_req}
    if control:
        out["control"] = max(ctl_req)
        out["control_per_request"] = ctl_req
    return out


def _widest(gaps: torch.Tensor):
    """Each row's widest gap; NaN reads as infinite."""
    g = torch.nan_to_num(gaps.float(), nan=float("inf"))
    return [float(x) for x in g.max(dim=-1).values.cpu()]


def judge(reading: Dict[str, Any], limits: Dict[str, Any]) -> Dict[str, Any]:
    """Each number compared beside its limit, and whether all hold."""
    limit = float(limits[GAP]["limit"])
    failed = sum(1 for g in reading["per_request"] if not g <= limit)
    return {
        "correct": reading[GAP] <= limit,
        "failed": failed,
        "checks": {GAP: {"value": min(reading[GAP], sys.float_info.max), "limit": limit}},
    }


def judge_control(reading: Dict[str, Any], limits: Dict[str, Any]) -> Dict[str, Any]:
    """:func:`judge` of the control's reading (``readings(control=True)``)
    in the program's place."""
    return judge({GAP: reading["control"], "per_request": reading["control_per_request"]},
                 limits)
