"""Per-dataset entry points of the reference's `run/` scripts, as presets
over the port's CLI.

JAX counterpart: `fashionern_aaai2024_tpu/run/`. The reference ships ten
`__main__` scripts (`run/train/train_*.py`, `run/test/test_*.py`); each
is a preset here, so that

    python -m torch.distributed.launch ... run/train_fiq.py --lr 4e-5 ...

becomes

    python -m fashionern_aaai2024_tpu_torch.run.train_fiq --lr 4e-5 --data-root ...
"""

import sys

from fashionern_aaai2024_tpu_torch.cli.main import main as _main


def _run(command: str, dataset: str) -> int:
    return _main([command, "--dataset", dataset, *sys.argv[1:]])
