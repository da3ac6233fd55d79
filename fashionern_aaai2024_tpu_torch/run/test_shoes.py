"""Mirror of the reference `run/test_shoes.py` entry point
(preset: eval --dataset shoes); flags are the port CLI's `eval` flags."""

import sys

from fashionern_aaai2024_tpu_torch.run import _run

if __name__ == "__main__":
    sys.exit(_run("eval", "shoes"))
