"""The training slice on the card (``gpu`` marker): each test skips inside
itself without a CUDA card.  This file imports no JAX (the card's machine
has none): the card is held against the port's own CPU run.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_gpu.py

Limits: a step's loss within ``LOSS_REL`` (1e-4) of the CPU's, each
gradient leaf's largest gap within ``GRAD_REL`` (5e-2) of its largest CPU
entry, floored at 1% of the largest entry of any leaf (the limit the CPU
tests hold the port to against ``jax.grad``: the card's bf16 products
round other entries than the CPU's); a step's gradients on the card equal
a second run's bit for bit (the custom backward passes sum in a fixed
order); ``GradSync`` round-trips them bit for bit.
"""

import dataclasses

import pytest
import torch

from repro_torch import _util
from repro_torch.configs import get_config
from repro_torch.core import zipnn
from repro_torch.core.options import CodecOptions
from repro_torch.data import DataConfig, make_batch
from repro_torch.distributed import GradSync
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.train import init_train_state, loss_and_grads

pytestmark = pytest.mark.gpu

LOSS_REL = 1e-4
GRAD_REL = 5e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _step(cfg, dev, seed=0):
    params = init_train_state(cfg, seed, device="cpu")["params"]
    batch = make_batch(cfg, DataConfig(64, 2), 0, device="cpu")
    card = (_util.tree_map(lambda t: t.to(dev), params), {k: v.to(dev) for k, v in batch.items()})
    return (params, batch), card


@pytest.mark.parametrize("arch", ["repro_gpt_100m", "olmoe_1b_7b", "mamba2_130m"])
def test_card_step_matches_cpu(cuda, arch):
    """Loss and gradients of one reduced step on the card against the CPU."""
    cfg = get_config(arch).reduced()
    host, card = _step(cfg, cuda)
    lh, _, gh = loss_and_grads(cfg, *host)
    lc, _, gc = loss_and_grads(cfg, *card)
    assert abs(float(lc) - float(lh)) <= LOSS_REL * float(lh)
    want, got = _util.tree_leaves(gh), _util.tree_leaves(gc)
    top = max(float(w.abs().max()) for w in want)
    for w, g in zip(want, got):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        gap = float((w.float() - g.float().cpu()).abs().max())
        assert gap <= GRAD_REL * max(float(w.abs().max()), 1e-2 * top)


def test_card_gradients_are_deterministic(cuda):
    """Two runs of one MoE step at a capacity where pairs drop (the
    dispatch and combine backward, the fused CE, the flash backward, the
    embedding's) give the same gradients bit for bit."""
    cfg = dataclasses.replace(get_config("olmoe_1b_7b").reduced(), capacity_factor=0.5)
    _, card = _step(cfg, cuda, seed=3)
    _, _, a = loss_and_grads(cfg, *card)
    _, _, b = loss_and_grads(cfg, *card)
    for x, y in zip(_util.tree_leaves(a), _util.tree_leaves(b)):
        assert torch.equal(x, y)


def test_grad_sync_round_trip_on_card(cuda):
    """``GradSync`` packs card gradients with K3 and K7 and unpacks them
    onto the card with K1's one-shot decode and K2, bit for bit; the blobs
    equal the host's."""
    cfg = get_config("repro_gpt_100m").reduced()
    _, card = _step(cfg, cuda)
    _, _, grads = loss_and_grads(cfg, *card)
    zcfg = zipnn.ZipNNConfig(backend="huffman")
    gs = GradSync(zcfg, options=CodecOptions(backend="device", device_resident=True),
                  device=cuda)
    reset_launch_counts()
    manifest, stats = gs.pack(grads)
    back = gs.unpack(manifest)
    counts = launch_counts()
    for k in ("plane_producer", "bitpack_encode_chunks", "huffdecode_serial", "plane_consumer"):
        assert counts[k] > 0, k
    for a, b in zip(_util.tree_leaves(grads), _util.tree_leaves(back)):
        assert b.device.type == "cuda" and torch.equal(a.view(torch.int16), b.view(torch.int16))
    host, _ = GradSync(zcfg, options=CodecOptions(backend="host"), device="cpu").pack(
        _util.tree_map(lambda t: t.cpu(), grads))
    assert [c.blob for c in manifest["leaves"]] == [c.blob for c in host["leaves"]]
    assert stats.ratio_pct < 100.0
