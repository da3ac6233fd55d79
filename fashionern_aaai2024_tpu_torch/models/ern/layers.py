"""PyTorch-semantics primitives of the ERN fusion stack.

JAX counterpart: `fashionern_aaai2024_tpu/models/ern/layers.py`, which
re-created these torch idioms in flax; here most are torch itself.

  * `torch_normalize`: `F.normalize`, eps 1e-12 inside the max.
  * `sr_l2norm`: VisualSR's x / (||x|| + eps), eps added.
  * `TorchMultiheadAttention`: `nn.MultiheadAttention`'s parameter
    layout (packed in_proj_weight [3d, d], out_proj), computed with the
    plain `_mha_ref` formula through `ops.attention.packed_kv_cross_attention`
    rather than PyTorch's fused path, so it computes what the JAX
    module computes.
  * `TorchBatchNorm` is `nn.BatchNorm1d` itself: over the patch axis of a
    [B, 13, d] input it is `nn.BatchNorm1d(13)` (`fusion.py:99`).

Eval mode only: the port serves; dropout sites are identity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fashionern_aaai2024_tpu_torch.ops.attention import packed_kv_cross_attention


def torch_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps)."""
    return F.normalize(x, dim=dim, eps=eps)


def sr_l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    """x / (||x|| + eps) (`layers.py:28`)."""
    return x / (torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True)) + eps)


class TorchMultiheadAttention(nn.Module):
    """`nn.MultiheadAttention(d, heads, batch_first=True)` parameters;
    inputs [B, S, d]."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor) -> torch.Tensor:
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        kv = torch.cat([F.linear(key, wk, bk), F.linear(value, wv, bv)], dim=-1)
        o = packed_kv_cross_attention(F.linear(query, wq, bq), kv, self.num_heads)
        return self.out_proj(o)
