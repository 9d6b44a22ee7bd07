"""End-to-end training on the PyTorch port: a ~100M-param
llama3.2-family model trained for a few hundred steps on the sharded data
pipeline, with async checkpointing and a mid-run simulated crash + resume.
Runs on the GPU; ``--device cpu`` runs it on the CPU.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--device cpu]
"""
import argparse
import tempfile
from pathlib import Path

import numpy as np

from repro_torch.launch.train import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    with tempfile.TemporaryDirectory() as td:
        data = str(Path(td) / "data")
        ckpt = str(Path(td) / "ckpt")
        half = args.steps // 2
        print(f"=== phase 1: {half} steps, then 'crash' ===")
        _, losses1 = train(args.arch, steps=half, batch=8, seq=128,
                           data_dir=data, ckpt_dir=ckpt, ckpt_every=25,
                           device=args.device)
        print(f"=== phase 2: resume from checkpoint, to {args.steps} ===")
        _, losses2 = train(args.arch, steps=args.steps, batch=8, seq=128,
                           data_dir=data, ckpt_dir=ckpt, ckpt_every=50,
                           resume=True, device=args.device)
        print(f"loss: start {np.mean(losses1[:10]):.3f} -> "
              f"end {np.mean(losses2[-10:]):.3f}")
        assert np.mean(losses2[-10:]) < np.mean(losses1[:10]), \
            "training should reduce loss"
        print("OK")


if __name__ == "__main__":
    main()
