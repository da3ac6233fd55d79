"""Pre-LN transformer blocks shared by the CLIP ViT and text towers.

JAX counterpart: `fashionern_aaai2024_tpu/models/clip/transformer.py`.
open_clip's `ResidualAttentionBlock`:

    x = x + attn(ln_1(x));  x = x + mlp(ln_2(x)),  mlp = c_fc -> act -> c_proj

Each block calls kernel B1 (`ops.attention.attention_subblock`) and then
kernel B2 (`ops.mlp.mlp_subblock`). That is all the JAX package's
`ops/block.py` does at head dim 64 (`block.py:217-226`: its whole-block
kernel B10 is off by dispatch), so `ops/block.py` is not ported as a
module. Parameter names follow open_clip (`resblocks.{i}.attn.in_proj_weight`,
`.ln_1.weight`, `.mlp.c_fc.weight`, ...), the names that
`models/clip/convert.py:45 _resblock` reads.
"""

from __future__ import annotations

import torch
from torch import nn

from fashionern_aaai2024_tpu_torch.ops.attention import attention_subblock
from fashionern_aaai2024_tpu_torch.ops.mlp import mlp_subblock


class _AttentionParams(nn.Module):
    """`nn.MultiheadAttention`'s parameter layout: packed in-projection
    [3W, W] + out_proj Linear. The forward is kernel B1."""

    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, activation: str = "gelu",
                 causal: bool = False):
        super().__init__()
        self.heads = heads
        self.activation = activation
        self.causal = causal
        self.ln_1 = nn.LayerNorm(width)
        self.attn = _AttentionParams(width)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = nn.ModuleDict({"c_fc": nn.Linear(width, 4 * width),
                                  "c_proj": nn.Linear(4 * width, width)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, S, W]
        x = attention_subblock(
            x, self.ln_1.weight, self.ln_1.bias, self.attn.in_proj_weight,
            self.attn.in_proj_bias, self.attn.out_proj.weight, self.attn.out_proj.bias,
            self.heads, causal=self.causal, eps=self.ln_1.eps)
        return mlp_subblock(
            x, self.ln_2.weight, self.ln_2.bias, self.mlp["c_fc"].weight,
            self.mlp["c_fc"].bias, self.mlp["c_proj"].weight, self.mlp["c_proj"].bias,
            activation=self.activation, eps=self.ln_2.eps)


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, activation: str = "gelu",
                 causal: bool = False):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, activation, causal) for _ in range(layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x)
        return x
