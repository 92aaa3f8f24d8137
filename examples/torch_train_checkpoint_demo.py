"""Training with ZipNN checkpoints on the PyTorch port, crash recovery and
delta chains (the paper's §2.1.3 use case as a running system), then
serving from the compressed checkpoint.

    PYTHONPATH=src python examples/torch_train_checkpoint_demo.py [--full-100m]
    PYTHONPATH=src python examples/torch_train_checkpoint_demo.py --device cpu

By default a small LM trains for 60 steps; ``--full-100m`` runs the
~100M-parameter config (the same code path, longer).  Each phase is its
own ``python -m repro_torch.launch.train`` / ``.serve`` process.
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(module, args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-m", module, *args], env=env, cwd=ROOT, check=True)


def main(device: str = "cuda", full_100m: bool = False, steps: int = 60) -> dict:
    ckpt = tempfile.mkdtemp(prefix="zipnn_demo_ckpt_")
    try:
        common = ["--arch", "repro_gpt_100m", "--ckpt-dir", ckpt, "--device", device,
                  "--ckpt-every", str(steps // 6), "--base-every", "3"]
        if full_100m:
            common += ["--batch", "4", "--seq", "256", "--lr", "1e-3"]
        else:
            common += ["--reduced", "--batch", "8", "--seq", "128"]

        print(f"=== phase 1: train to step {steps // 2} (checkpoints every {steps // 6}) ===")
        _run("repro_torch.launch.train", common + ["--steps", str(steps // 2)])

        print(f"\n=== phase 2: 'crash' + resume to step {steps} (auto-restore) ===")
        _run("repro_torch.launch.train", common + ["--steps", str(steps)])

        print("\n=== phase 3: serve from the compressed checkpoint ===")
        serve = ["--arch", "repro_gpt_100m", "--ckpt-dir", ckpt, "--gen", "16",
                 "--device", device]
        if not full_100m:
            serve.append("--reduced")
        _run("repro_torch.launch.serve", serve)
        saved = sorted(os.listdir(ckpt))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return {"checkpoint_entries": saved}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--full-100m", action="store_true",
                    help="train the full ~100M repro_gpt config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.device, args.full_100m)
