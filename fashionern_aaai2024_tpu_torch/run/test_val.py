"""Mirror of the reference `run/test_val.py` entry point
(preset: eval --dataset fashioniq-val); flags are the port CLI's `eval` flags."""

import sys

from fashionern_aaai2024_tpu_torch.run import _run

if __name__ == "__main__":
    sys.exit(_run("eval", "fashioniq-val"))
