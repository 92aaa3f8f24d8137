"""The port's CUDA kernels and ring on the card (``gpu`` marker).

Every test here needs a CUDA card: the ``cuda`` fixture skips inside the
test when there is none, so every worker collects the same tests.  Run
them on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Contract: each kernel equals its plain PyTorch version on the same card
tensors bit for bit (integer bit work: no tolerance), each wrapper counts
its launches, and the compressed ring's logits equal the plain step's
bit for bit on the card.
"""

import zlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import codec, container, device_entropy, zipnn
from repro_torch.kernels import (
    huffdecode_chunks,
    huffdecode_chunks_plain,
    launch_counts,
    plane_consumer,
    plane_consumer_plain,
    reset_launch_counts,
)
from repro_torch.models import decode_step, init_decode_state
from repro_torch.models.model import param_shapes
from repro_torch.serve import CompressedParamStore, make_compressed_serve_step

pytestmark = pytest.mark.gpu

HUFF = zipnn.ZipNNConfig(chunk_param_bytes=1 << 12, backend="huffman")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _bf16(shape, seed, device):
    a = (np.random.default_rng(seed).standard_normal(shape) * 0.02).astype(np.float32)
    return torch.from_numpy(a).to(torch.bfloat16).to(device)


def test_k1_kernel_matches_plain(cuda):
    leaf = _bf16((256, 384), 1, "cpu")
    ct = zipnn.compress_array(leaf, HUFF)
    feed = zipnn.build_array_feed(ct, HUFF, device=cuda)
    args = feed.launch_args()
    n = args.pop("out_bytes")
    out_k = torch.zeros(n, dtype=torch.uint8, device=cuda)
    out_p = torch.zeros(n, dtype=torch.uint8, device=cuda)
    reset_launch_counts()
    cur_k = huffdecode_chunks(**args, out=out_k)
    cur_p = huffdecode_chunks_plain(**args, out=out_p)
    torch.cuda.synchronize()
    assert launch_counts()["huffdecode_chunks"] == 1
    assert torch.equal(cur_k, cur_p) and torch.equal(out_k, out_p)
    assert torch.equal(feed.decode().cpu().view(torch.int16), leaf.view(torch.int16))


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("with_base", [False, True])
def test_k2_kernel_matches_plain(cuda, itemsize, with_base):
    n = 100_003
    g = torch.Generator().manual_seed(itemsize + 10 * with_base)
    planes = [torch.randint(0, 256, (n,), dtype=torch.uint8, generator=g).to(cuda)
              for _ in range(itemsize)]
    dt = torch.int16 if itemsize == 2 else torch.int32
    base = torch.randint(torch.iinfo(dt).min, torch.iinfo(dt).max, (n,), dtype=dt,
                         generator=g).to(cuda) if with_base else None
    reset_launch_counts()
    k = plane_consumer(planes, base, itemsize=itemsize)
    p = plane_consumer_plain(planes, base, itemsize=itemsize)
    assert launch_counts()["plane_consumer"] == 1
    assert torch.equal(k, p)


def test_corrupt_payload_raises_on_card(cuda):
    leaf = _bf16((128, 128), 2, "cpu")
    ct = zipnn.compress_array(leaf, HUFF)
    meta, mv = container.unpack_stream(ct.blob)
    payloads = [[container.payload_view(meta, mv, p, c) for c in range(len(meta.entries[p]))]
                for p in range(meta.n_planes)]
    cut = payloads[0][0][: len(payloads[0][0]) // 2]
    entries = [list(pe) for pe in meta.entries]
    e = entries[0][0]
    assert e.method == codec.Method.HUFF
    entries[0][0] = codec.ChunkEntry(e.method, len(cut), e.raw_len, zlib.crc32(cut))
    payloads[0][0] = cut
    params = codec.CodecParams(chunk_bytes=meta.chunk_bytes, backend="huffman")
    with pytest.raises(ValueError, match="cursor|pad"):
        device_entropy.decode_planes(entries, payloads, meta.tables, params, device=cuda)


def test_ring_bit_identical_on_card(cuda):
    cfg = get_config("repro_gpt_100m").reduced()
    rng = np.random.default_rng(0)

    def fill(node):                   # shape tuples are leaves here
        if isinstance(node, dict):
            return {k: fill(node[k]) for k in sorted(node)}
        a = (rng.standard_normal(node) * 0.02).astype(np.float32)
        return torch.from_numpy(a).to(torch.bfloat16).to(cuda)

    params = fill(param_shapes(cfg))
    store = CompressedParamStore.from_params(params, HUFF, payload_feed=True, device=cuda)
    cstep = make_compressed_serve_step(cfg, store, ring=2)
    sa = init_decode_state(cfg, 2, 4, start_pos=0, device=cuda)
    sb = init_decode_state(cfg, 2, 4, start_pos=0, device=cuda)
    device_entropy.reset_transfer_stats()
    reset_launch_counts()
    for t in range(4):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)).to(cuda)
        la, sa = decode_step(cfg, params, sa, toks)
        lb, sb = cstep(sb, toks)
        assert torch.equal(la.view(torch.int32), lb.view(torch.int32)), t
    assert launch_counts()["huffdecode_chunks"] > 0
    assert launch_counts()["plane_consumer"] == 4 * sum(len(l) for l in store.feeds("layers"))
    assert device_entropy.transfer_stats()["payload_uploads"] == 0
    assert store.peak_resident <= 2
