"""Mirror of the reference `run/traintrain_cirr.py` entry point
(preset: train --dataset cirr); flags are the port CLI's `train` flags."""

import sys

from fashionern_aaai2024_tpu_torch.run import _run

if __name__ == "__main__":
    sys.exit(_run("train", "cirr"))
