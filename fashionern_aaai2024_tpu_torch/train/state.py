"""Train state: trainable ERN + frozen CLIP + Adam + step + seed.

JAX counterpart: `fashionern_aaai2024_tpu/train/state.py` (`:26-79`).
The reference optimizes only the fusion parameters
(`run/train/train_fiq.py:92-100`); in JAX the split is structural
(`ern_params` is the only optax tree). Here the state holds the composed
model itself: `create_train_state` turns off `requires_grad` on every
CLIP parameter and gives Adam only `model.ern`'s parameters. The ERN
BatchNorm running statistics are buffers of the model and update in the
train-mode forward (`models/ern/layers.py TorchBatchNorm`), where JAX
returned them as the mutated `batch_stats`.

Adam is `torch.optim.Adam` with optax.adam's constants (b1 0.9, b2
0.999, eps 1e-8, bias correction by the update count); the learning
rate of each update is set by the train step from the schedule
(`train/schedule.py`).

Unlike the JAX state, which is immutable and replaced by each step, this
state is updated in place by the train step.
"""

from __future__ import annotations

import dataclasses

import torch

from fashionern_aaai2024_tpu_torch.models.composed import ComposedCIRModel

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@dataclasses.dataclass
class CIRTrainState:
    model: ComposedCIRModel
    optimizer: torch.optim.Adam
    seed: int            # seeds the dropout masks with the step (train/step.py)
    step: int = 0        # optimizer updates taken

    @property
    def device(self) -> torch.device:
        return next(self.model.ern.parameters()).device


def create_train_state(model: ComposedCIRModel, seed: int) -> CIRTrainState:
    """Freeze CLIP and build Adam over the ERN parameters, on whatever
    device the model already lives on."""
    model.clip.requires_grad_(False)
    model.ern.requires_grad_(True)
    optimizer = torch.optim.Adam(model.ern.parameters(), lr=0.0, betas=ADAM_BETAS,
                                 eps=ADAM_EPS)
    return CIRTrainState(model=model, optimizer=optimizer, seed=seed)


def trainable_param_count(state: CIRTrainState) -> int:
    return sum(p.numel() for p in state.model.ern.parameters())


def cast_frozen_clip_bf16(state: CIRTrainState) -> CIRTrainState:
    """The mixed-precision train policy (`state.py:63-79`): the frozen
    CLIP towers store and compute in bf16; the ERN stack, Adam and the
    loss stay exact fp32. Not the serve policy
    (`models/composed.py apply_precision`), which also rounds the ERN
    weights to bf16."""
    state.model.clip.to(torch.bfloat16)
    return state
