"""Pre-LN transformer blocks shared by the CLIP ViT and text towers.

JAX counterpart: `fashionern_aaai2024_tpu/models/clip/transformer.py`.
open_clip's `ResidualAttentionBlock`:

    x = x + attn(ln_1(x));  x = x + mlp(ln_2(x)),  mlp = c_fc -> act -> c_proj

A float block dispatches as the JAX block does (`transformer.py:114-127`):
at head dim 64 and W % 128 == 0 (the ViT-B-16 trunk and the text towers
of ViT-B-16 and RN50x4) it calls `ops.block.transformer_block`, which
runs the whole block as kernel B10 where its rule says so and otherwise
kernel B1 (`ops.attention.attention_subblock`) then kernel B2
(`ops.mlp.mlp_subblock`); every other shape calls B1 then B2. Parameter
names follow open_clip (`resblocks.{i}.attn.in_proj_weight`,
`.ln_1.weight`, `.mlp.c_fc.weight`, ...), the names that
`models/clip/convert.py:45 _resblock` reads.

With `quantize` (`CLIPConfig.quantize_mlp`, the `--quantize-towers`
serving tier) a block dispatches as the JAX block does
(`transformer.py:128-164`): at head dim 64 and W % 128 == 0, kernel B6
(`ops.qmlp.int8_attention_subblock`), otherwise the float attention
(LN as kernel B11, `fused_qkv_self_attention` as kernel B7, the
out-projection in plain PyTorch); then kernel B5
(`ops.qmlp.int8_mlp_subblock`).

The int8 weights are cached per block: each of the four matrices
quantized once (`quantize_colwise` of the JAX layout, kept in the torch
layout [out, in] with one fp32 scale per output row), from the weights
as they are stored, so after a bf16 cast they are bf16-rounded weights,
as JAX's `_cast_precision` then in-graph `quantize_colwise` computes.
The cache is rebuilt whenever a weight changes: any in-place write,
`load_state_dict` included (the tensors' version counters are part of
the cache key), and a module cast or move (`_apply`).
"""

from __future__ import annotations

import torch
from torch import nn

from fashionern_aaai2024_tpu_torch.ops.attention import (
    attention_subblock,
    fused_qkv_self_attention,
)
from fashionern_aaai2024_tpu_torch.ops.block import transformer_block
from fashionern_aaai2024_tpu_torch.ops.layernorm import layer_norm
from fashionern_aaai2024_tpu_torch.ops.mlp import mlp_subblock
from fashionern_aaai2024_tpu_torch.ops.qmatmul import quantize_rowwise
from fashionern_aaai2024_tpu_torch.ops.qmlp import int8_attention_subblock, int8_mlp_subblock


class _AttentionParams(nn.Module):
    """`nn.MultiheadAttention`'s parameter layout: packed in-projection
    [3W, W] + out_proj Linear."""

    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, activation: str = "gelu",
                 causal: bool = False, quantize: bool = False):
        super().__init__()
        self.heads = heads
        self.activation = activation
        self.causal = causal
        self.quantize = quantize
        self.ln_1 = nn.LayerNorm(width)
        self.attn = _AttentionParams(width)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = nn.ModuleDict({"c_fc": nn.Linear(width, 4 * width),
                                  "c_proj": nn.Linear(4 * width, width)})
        self._int8: tuple | None = None     # (key, {name: (values, scales)})

    def _float_weights(self) -> dict[str, torch.Tensor]:
        return {"qkv": self.attn.in_proj_weight, "out": self.attn.out_proj.weight,
                "fc": self.mlp["c_fc"].weight, "proj": self.mlp["c_proj"].weight}

    def int8_weights(self) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
        """{name: (int8 [out, in], fp32 scales [out])} of the four
        matrices, quantized from the weights as they are now."""
        weights = self._float_weights()
        key = tuple((id(w), w.data_ptr(), w.dtype, w.device, w._version)
                    for w in weights.values())
        if self._int8 is None or self._int8[0] != key:
            with torch.no_grad():
                quantized = {}
                for name, w in weights.items():
                    q, scale = quantize_rowwise(w.detach())
                    quantized[name] = (q, scale.reshape(-1))
            self._int8 = (key, quantized)
        return self._int8[1]

    def _apply(self, fn, *args, **kwargs):
        # the key misses one case: a cast replaces each weight's data
        # without a version bump, and a round trip (fp32 -> bf16 -> fp32)
        # can land the rounded values at the old address
        self._int8 = None
        return super()._apply(fn, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, S, W]
        if self.quantize:
            return self._forward_int8(x)
        if x.shape[-1] // self.heads == 64 and x.shape[-1] % 128 == 0:
            return transformer_block(
                x, self.ln_1.weight, self.ln_1.bias, self.attn.in_proj_weight,
                self.attn.in_proj_bias, self.attn.out_proj.weight, self.attn.out_proj.bias,
                self.ln_2.weight, self.ln_2.bias, self.mlp["c_fc"].weight,
                self.mlp["c_fc"].bias, self.mlp["c_proj"].weight, self.mlp["c_proj"].bias,
                self.heads, causal=self.causal, activation=self.activation, eps=self.ln_1.eps)
        x = attention_subblock(
            x, self.ln_1.weight, self.ln_1.bias, self.attn.in_proj_weight,
            self.attn.in_proj_bias, self.attn.out_proj.weight, self.attn.out_proj.bias,
            self.heads, causal=self.causal, eps=self.ln_1.eps)
        return mlp_subblock(
            x, self.ln_2.weight, self.ln_2.bias, self.mlp["c_fc"].weight,
            self.mlp["c_fc"].bias, self.mlp["c_proj"].weight, self.mlp["c_proj"].bias,
            activation=self.activation, eps=self.ln_2.eps)

    def _forward_int8(self, x: torch.Tensor) -> torch.Tensor:
        q = self.int8_weights()
        w = x.shape[-1]
        if w // self.heads == 64 and w % 128 == 0:
            x = int8_attention_subblock(
                x, self.ln_1.weight, self.ln_1.bias, *q["qkv"], self.attn.in_proj_bias,
                *q["out"], self.attn.out_proj.bias, self.heads, causal=self.causal,
                eps=self.ln_1.eps)
        else:
            y = layer_norm(x, self.ln_1.weight, self.ln_1.bias, self.ln_1.eps)
            o = fused_qkv_self_attention(y, self.attn.in_proj_weight, self.attn.in_proj_bias,
                                         self.heads, causal=self.causal)
            x = x + (o @ self.attn.out_proj.weight.t() + self.attn.out_proj.bias)
        return int8_mlp_subblock(
            x, self.ln_2.weight, self.ln_2.bias, *q["fc"], self.mlp["c_fc"].bias, *q["proj"],
            self.mlp["c_proj"].bias, activation=self.activation, eps=self.ln_2.eps)


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, activation: str = "gelu",
                 causal: bool = False, quantize: bool = False):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, activation, causal, quantize)
            for _ in range(layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x)
        return x
