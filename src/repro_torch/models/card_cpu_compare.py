"""Where a prefill on the card parts from the same prefill on the CPU.

    PYTHONPATH=src python3 -m repro_torch.models.card_cpu_compare

On one CUDA card, two readings, each a JSON line:

1. bf16 products ``x @ w`` (f32 accumulation, one rounding) at the widths
   the vlm and audio models multiply at: the share of output entries that
   differ from the exact product rounded to bf16, on the card and on the
   CPU;
2. one layer of ``qwen2_vl_2b`` and of ``hubert_xlarge`` at their
   published widths (the reference's norms, ``data.make_batch``'s batch):
   every call of the model's primitives (``layers.dense``, the norms,
   RoPE / M-RoPE, the MLPs, ``unembed``, ``attention.flash_attention``)
   run on the CPU, then run again on the card from the CPU's own inputs:
   the share of entries that differ and the largest gap over the largest
   entry.  A primitive that rounds the same on both reads 0.
"""

from __future__ import annotations

import dataclasses
import json

import torch

from .. import _util
from ..configs import get_config
from ..data import DataConfig, make_batch
from . import attention, layers
from .model import init_params, reference_norms

PRODUCTS = ((256, 1536, 8960), (256, 8960, 1536), (512, 1280, 5120), (512, 5120, 1280))
OPS = [(layers, n) for n in ("dense", "rmsnorm", "layernorm", "apply_mrope", "apply_rope",
                             "swiglu", "gelu_mlp", "unembed")] + [(attention, "flash_attention")]
LAYER_BATCH = {"qwen2_vl_2b": (1, 256), "hubert_xlarge": (1, 512)}


def _to(a, dev):
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    if isinstance(a, dict):
        return {k: _to(v, dev) for k, v in a.items()}
    if isinstance(a, (tuple, list)):
        return type(a)(_to(v, dev) for v in a)
    return a


def products(dev) -> list:
    gen = torch.Generator().manual_seed(0)
    rows = []
    for M, K, N in PRODUCTS:
        x = torch.randn(M, K, generator=gen).to(torch.bfloat16)
        w = (torch.randn(K, N, generator=gen) * 0.02).to(torch.bfloat16)
        exact = (x.double() @ w.double()).to(torch.bfloat16)
        card = (x.to(dev) @ w.to(dev)).cpu()
        rows.append({"M": M, "K": K, "N": N,
                     "card_differ_share": float((card != exact).float().mean()),
                     "cpu_differ_share": float(((x @ w) != exact).float().mean())})
    return rows


def layer_ops(dev, name: str) -> list:
    """One layer of ``name`` at its published widths: each primitive's call
    on the CPU replayed on the card from the same inputs."""
    from ..serve import make_prefill

    cfg = dataclasses.replace(get_config(name), n_layers=1)
    params = reference_norms(init_params(cfg, 0, device="cpu"))
    B, S = LAYER_BATCH[name]
    batch = make_batch(cfg, DataConfig(S, B), 1, device="cpu")
    calls, saved = [], {}
    for mod, n in OPS:
        fn = saved[(mod, n)] = getattr(mod, n)

        def rec(*a, _fn=fn, _n=n, **k):
            out = _fn(*a, **k)
            calls.append((_n, _fn, a, k, out))
            return out

        setattr(mod, n, rec)
    try:
        make_prefill(cfg)(params, batch)
    finally:
        for (mod, n), fn in saved.items():
            setattr(mod, n, fn)
    rows = []
    for n, fn, a, k, out in calls:
        got = fn(*_to(a, dev), **_to(k, dev))
        if got.device != dev:
            raise AssertionError(f"{n} did not run on {dev}")
        got = got.cpu().float()
        ref = out.float()
        rows.append({"op": n, "shape": list(out.shape), "dtype": _util.dtype_name(out.dtype),
                     "differ_share": float((got != ref).float().mean()),
                     "max_gap_rel": float((got - ref).abs().max() / ref.abs().max())})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("card_cpu_compare: no CUDA device available")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "products": products(dev)}))
    for name in LAYER_BATCH:
        print(json.dumps({"model": name, "ops": layer_ops(dev, name)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
