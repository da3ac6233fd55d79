"""Mirror of the reference `run/traintrain_shoes.py` entry point
(preset: train --dataset shoes); flags are the port CLI's `train` flags."""

import sys

from fashionern_aaai2024_tpu_torch.run import _run

if __name__ == "__main__":
    sys.exit(_run("train", "shoes"))
