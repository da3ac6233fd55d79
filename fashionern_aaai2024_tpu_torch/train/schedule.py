"""Learning-rate schedules matching the reference trainers.

JAX counterpart: `fashionern_aaai2024_tpu/train/schedule.py` (`:24`,
`:34`). Both are closed forms of the step, evaluated in Python floats:

  * `cosine_annealing_schedule`: torch `CosineAnnealingLR`'s closed form,
    stepped per iteration (`run/train/train_fiq.py:101,140`),
        lr(t) = eta_min + (base - eta_min) * (1 + cos(pi * t / T_max)) / 2,
    periodic with period 2·T_max, not clamped at T_max;
  * `warmup_cosine_schedule`: the reference `WarmupCosineSchedule`
    (`utils/utils.py:186-198`), linear warmup then cosine decay floored
    at 0.

The train step sets each Adam parameter group's `lr` to `schedule(step)`
before every update, with step counted from 0 as optax counts it: the
first update uses lr(0). A torch `LRScheduler` is not used; its
`step()` bookkeeping would shift the trajectory by one update.
"""

from __future__ import annotations

import math
from typing import Callable


def cosine_annealing_schedule(base_lr: float, t_max: int,
                              eta_min: float = 0.0) -> Callable[[int], float]:
    """Per-step LR, torch `CosineAnnealingLR` closed-form semantics."""

    def schedule(step: int) -> float:
        return eta_min + (base_lr - eta_min) * (1.0 + math.cos(math.pi * step / t_max)) / 2.0

    return schedule


def warmup_cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                           cycles: float = 0.5) -> Callable[[int], float]:
    """Linear 0 -> base over `warmup_steps`, then cosine decay with
    `cycles` half-periods over the remaining steps (floored at 0)."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * step / max(1.0, warmup_steps)
        progress = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
        return base_lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * 2.0 * cycles * progress)))

    return schedule
