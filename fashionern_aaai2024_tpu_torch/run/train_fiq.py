"""Mirror of the reference `run/train/train_fiq.py` entry point
(preset: train --dataset fashioniq); flags are the port CLI's `train` flags."""

import sys

from fashionern_aaai2024_tpu_torch.run import _run

if __name__ == "__main__":
    sys.exit(_run("train", "fashioniq"))
