"""Model-hub transfer with ZipNN on the PyTorch port (paper §2.1.1 and
Fig. 10): how much wire time does lossless compression save on upload and
download?

    PYTHONPATH=src python examples/torch_hub_transfer_sim.py            # on a card
    PYTHONPATH=src python examples/torch_hub_transfer_sim.py --device cpu
"""

import argparse

import torch

from repro_torch.checkpoint.hub import CHANNELS, simulate_transfer


def main(device: str = "cuda") -> dict:
    gen = torch.Generator(device=device).manual_seed(0)
    model = (torch.randn(8_000_000, generator=gen, device=device) * 0.02).to(torch.bfloat16)
    raw = model.view(torch.uint8).cpu().numpy().tobytes()
    print(f"model: {len(raw) / 1e6:.0f} MB BF16 (regular category)\n")
    print(f"{'channel':26s} {'raw s':>8s} {'zipnn s':>8s} {'speedup':>8s}")
    reports = {}
    for ch in CHANNELS:
        direction = "upload" if ch.startswith("upload") else "download"
        rep = simulate_transfer(raw, "bfloat16", ch, direction=direction, device=device)
        reports[ch] = rep
        print(f"{ch:26s} {rep.total_raw_s:8.1f} {rep.total_comp_s:8.1f} {rep.speedup:7.2f}x")
    print(f"\n(compression ratio {100 * rep.comp_bytes / rep.raw_bytes:.1f}% — "
          "paper: ~66% for BF16)")
    return {"ratio_pct": 100 * rep.comp_bytes / rep.raw_bytes,
            "speedup": {ch: r.speedup for ch, r in reports.items()}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
