"""Dropout for the port's train mode: one mask function for every site.

JAX counterpart: `flax.linen.Dropout` (`random.bernoulli`, then
`select(mask, x / keep, 0)`) and the probability dropout of
`fashionern_aaai2024_tpu/ops/attention.py:648-650 _mha_ref`, both of
which draw through `jax.random.bernoulli`.

Every dropout site of the port (the ERN fusion stack and the attention
probabilities) calls `dropout`, which draws its keep mask through
`dropout_mask` from an explicit `torch.Generator`. A generator of the
tensor's device draws the mask where the tensor lives. `jax.random` and
`torch.Generator` give different masks from one seed, so the parity
tests make both sides keep everything (patching `jax.random.bernoulli`
on the JAX side and `dropout_mask` here); the scaling by 1 / keep then
still applies on both sides.

The train step seeds one generator per step from (seed, step)
(`train/step.py step_generator`), as the JAX step folds the step into
its dropout key (`train/step.py:130`), so a resumed run draws the masks
of the uninterrupted one.
"""

from __future__ import annotations

import torch


def dropout_mask(shape: tuple[int, ...], keep: float, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """Bool mask of `shape`, each element True with probability `keep`."""
    return torch.rand(shape, generator=generator, device=device) < keep


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """`flax.linen.Dropout`: identity without a generator (eval) or at
    rate 0; otherwise kept elements are scaled by 1 / (1 - rate) and the
    rest are 0."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = dropout_mask(tuple(x.shape), keep, generator, x.device)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
