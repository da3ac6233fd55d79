"""Running metric accumulators (role of `utils/utils.py:143-161` in the reference).

A copy of `fashionern_aaai2024_tpu/utils/meters.py`, kept in the port so
that it imports nothing of the JAX package."""

from __future__ import annotations


class AverageMeter:
    """Tracks current value, running mean, sum and count."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    def __repr__(self) -> str:  # pragma: no cover
        return f"AverageMeter({self.name}: val={self.val:.4f} avg={self.avg:.4f})"
