"""Decentralized training's gradient exchange with ZipNN on the PyTorch
port (paper §2.1.2): compress the gradient tree before it crosses the
slow link between sites.

    PYTHONPATH=src python examples/torch_decentralized_grad_sync.py            # on a card
    PYTHONPATH=src python examples/torch_decentralized_grad_sync.py --device cpu
"""

import argparse

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, make_batch
from repro_torch.distributed.grad_sync import GradSync
from repro_torch.models import model
from repro_torch.train.step import loss_and_grads


def main(device: str = "cuda") -> dict:
    cfg = get_config("repro_gpt_100m").reduced()
    params = model.init_params(cfg, seed=0, device=device)
    batch = make_batch(cfg, DataConfig(seq_len=128, global_batch=4), 0, device=device)
    _, _, grads = loss_and_grads(cfg, params, batch)

    gs = GradSync(device=device)
    reports = []
    for peers, gbps in [(4, 1.0), (16, 1.0), (16, 10.0)]:
        rep = gs.exchange(grads, n_peers=peers, link_gbps=gbps)
        reports.append(rep)
        print(f"peers={peers:3d} link={gbps:4.0f}Gb/s  "
              f"raw={rep['raw_s'] * 1e3:7.1f}ms  zipnn={rep['zipnn_s'] * 1e3:7.1f}ms  "
              f"payload={rep['ratio_pct']:.1f}%  (lossless ✓)")
    return {"ratio_pct": reports[-1]["ratio_pct"]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
