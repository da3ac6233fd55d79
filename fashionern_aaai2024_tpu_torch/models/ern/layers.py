"""PyTorch-semantics primitives of the ERN fusion stack.

JAX counterpart: `fashionern_aaai2024_tpu/models/ern/layers.py`, which
re-created these torch idioms in flax; here most are torch itself.

  * `torch_normalize`: `F.normalize`, eps 1e-12 inside the max.
  * `sr_l2norm`: VisualSR's x / (||x|| + eps), eps added.
  * `TorchMultiheadAttention`: `nn.MultiheadAttention`'s parameter
    layout (packed in_proj_weight [3d, d], out_proj), computed as the JAX
    module computes it rather than by PyTorch's fused path: eval through
    kernel B8 (`ops.attention.packed_kv_cross_attention`, its plain
    version on a CPU tensor), train mode (`:68-85`) through
    `multi_head_attention` with probability dropout.
  * `TorchBatchNorm`: `nn.BatchNorm1d`'s state_dict names and eval
    formula, with the train mode of flax's `nn.BatchNorm`, which the JAX
    module runs (`:107-113`) and which this port is held against:
    batch statistics over every axis but `feature_axis`, variance as
    max(0, E[x²] − E[x]²) (flax's fast variance), and the *biased* batch
    variance in the running average, where `torch.nn.BatchNorm1d` keeps
    the unbiased one. Momentum 0.1, eps 1e-5.

Train mode: every forward that has dropout or BatchNorm takes
`generator`. None means eval (no dropout, running statistics); a
`torch.Generator` means train mode (dropout masks drawn from it, batch
statistics, running statistics updated in place), as `deterministic=False`
with a dropout key does in flax.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fashionern_aaai2024_tpu_torch.ops.attention import (
    multi_head_attention,
    packed_kv_cross_attention,
)


def torch_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps)."""
    return F.normalize(x, dim=dim, eps=eps)


def sr_l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    """x / (||x|| + eps) (`layers.py:28`)."""
    return x / (torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True)) + eps)


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, d = t.shape
    return t.reshape(b, s, heads, d // heads).transpose(1, 2)


class TorchMultiheadAttention(nn.Module):
    """`nn.MultiheadAttention(d, heads, dropout, batch_first=True)`
    parameters; inputs [B, S, d]."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        q, k, v = F.linear(query, wq, bq), F.linear(key, wk, bk), F.linear(value, wv, bv)
        if generator is None or self.dropout == 0.0:
            o = packed_kv_cross_attention(q, torch.cat([k, v], dim=-1), self.num_heads)
        else:
            h = self.num_heads
            o = multi_head_attention(_split_heads(q, h), _split_heads(k, h),
                                     _split_heads(v, h), dropout_rate=self.dropout,
                                     generator=generator)
            b, _, sq, dh = o.shape
            o = o.transpose(1, 2).reshape(b, sq, h * dh)
        return self.out_proj(o)


class TorchBatchNorm(nn.Module):
    """BatchNorm with `nn.BatchNorm1d`'s parameters and buffers (weight,
    bias, running_mean, running_var, num_batches_tracked) and flax's
    train-mode statistics (see the module docstring). `feature_axis` is
    1 for a [B, 13, d] input normalized per patch (`BatchNorm1d(13)`) and
    -1 for a [B, d] input."""

    def __init__(self, num_features: int, feature_axis: int = -1, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.feature_axis = feature_axis
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        axis = self.feature_axis % x.ndim
        shape = [1] * x.ndim
        shape[axis] = x.shape[axis]
        if train:
            dims = tuple(i for i in range(x.ndim) if i != axis)
            mean = x.mean(dim=dims)
            var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(m * mean.detach())
                self.running_var.mul_(1.0 - m).add_(m * var.detach())
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
