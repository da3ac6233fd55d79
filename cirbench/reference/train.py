"""The reference's train step: FashionERN's training of the fusion stack on
frozen CLIP towers, in fp32 with TF32 off.

One step (FashionERN's recipe, as the configuration states it):
  1. the frozen towers: the reference image's and the target image's
     globals, the caption's token features (no gradient);
  2. TME over the token features and the reference patches (trained);
  3. the fusion stack in train mode: the DVR query tower on the raw query
     side, the index tower on the L2-normalized target globals, with
     dropout and BatchNorm batch statistics;
  4. the batch-based classification loss: the mean over rows of
     logsumexp(100 · q · tᵀ) − the row's positive (the diagonal);
  5. the gradients of the trained parameters (autograd), and one Adam
     update (betas 0.9, 0.999, eps 1e-8) at the step's learning rate
     (cosine annealing from `lr` over `schedule_epochs` epochs).

Dropout: a step's masks are drawn in forward order from one generator
seeded from (seed, step) as the training recipe seeds it: the BLAKE2b-64
digest of "seed:step", little-endian, shifted right by one; each mask is
`rand(shape) < keep` on the generator's device.
"""

from __future__ import annotations

import hashlib
import math

import torch

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
TEMPERATURE = 100.0


class TrainMode:
    """Train mode of the ERN reference: the step's dropout generator."""

    def __init__(self, seed: int, step: int, device: torch.device):
        digest = hashlib.blake2b(f"{seed}:{step}".encode(), digest_size=8).digest()
        self.generator = torch.Generator(device=device).manual_seed(
            int.from_bytes(digest, "little") >> 1)

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        keep = 1.0 - rate
        mask = torch.rand(tuple(x.shape), generator=self.generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))

    @staticmethod
    def dropout_of(train: "TrainMode | None"):
        return train.dropout if train is not None else (lambda x, rate: x)


def cosine_lr(lr: float, t_max: int, step: int) -> float:
    return lr * (1.0 + math.cos(math.pi * step / t_max)) / 2.0


def bbc_loss(query: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    s = TEMPERATURE * query @ target.t()
    return (torch.logsumexp(s, dim=-1) - torch.diagonal(s)).mean()


class Adam:
    """torch.optim.Adam's update, written out, on a dict of tensors."""

    def __init__(self, params: dict[str, torch.Tensor]):
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor], lr: float):
        self.t += 1
        b1, b2 = BETAS
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(1 - b2 ** self.t)).add_(ADAM_EPS)
            p.addcdiv_(self.m[k], denom, value=-lr / (1 - b1 ** self.t))
