"""CLIP ViT image tower (ViT-B-16).

JAX counterpart: `fashionern_aaai2024_tpu/models/clip/vit.py`. open_clip
`VisionTransformer` semantics: 16×16 patch embed (conv1, no bias),
class token + positional embedding, ln_pre, pre-LN blocks, ln_post,
projection of all tokens to the joint dim. `forward` returns
(global [B, d], tokens [B, 197, d]), global being the projected class
token. ln_pre and ln_post are kernel B11 (`ops.layernorm.layer_norm`).

The input stays NHWC, as in the JAX API. The patch embed is an unfold
and one matrix product with conv1's weight, which is the convolution's
arithmetic; it avoids cuDNN, whose fp32 convolutions default to TF32.

Deliberate difference from the JAX package: the image batch is cast to
the tower's weight dtype on entry. In JAX, a float32 image feed meets
bf16 weights in `nn.Conv`, which promotes to float32, so under
`--precision bf16` with the default float32 feed the JAX tower really
runs in fp32. Here bf16 weights mean a bf16 tower, as the u8 feed
(`models/clip/model.py:57`) and `bench.py:72-75` already have it in JAX.
In fp32 the two agree.
"""

from __future__ import annotations

import torch
from torch import nn

from fashionern_aaai2024_tpu_torch.models import init as I
from fashionern_aaai2024_tpu_torch.models.clip.config import VisionConfig
from fashionern_aaai2024_tpu_torch.models.clip.transformer import Transformer
from fashionern_aaai2024_tpu_torch.ops.layernorm import layer_norm


class ViTTower(nn.Module):
    def __init__(self, config: VisionConfig, activation: str = "gelu", quantize: bool = False):
        super().__init__()
        self.config = config
        w, p = config.width, config.patch_size
        grid = config.image_size // p
        self.conv1 = nn.Conv2d(3, w, kernel_size=p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, w))
        self.ln_pre = nn.LayerNorm(w)
        self.transformer = Transformer(w, config.layers, config.heads, activation,
                                       quantize=quantize)
        self.ln_post = nn.LayerNorm(w)
        self.proj = nn.Parameter(torch.empty(w, config.embed_dim))

    def flax_variables(self) -> list[I.Variable]:
        """The JAX tower's variables (`vit.py:36-68`): the embeddings and
        `proj` normal(width^-0.5), in that order."""
        w, p = self.config.width, self.config.patch_size
        std = I.normal(w ** -0.5)
        return [*I.conv("conv1", p, 3, w),
                I.param("class_embedding", self.class_embedding.shape, std, 1),
                I.param("positional_embedding", self.positional_embedding.shape, std, 2),
                *I.layer_norm("ln_pre", w),
                *I.scope("transformer", self.transformer.flax_variables()),
                *I.layer_norm("ln_post", w), I.param("proj", self.proj.shape, std, 3)]

    def forward(self, images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """images: [B, H, W, 3] NHWC, CLIP-normalized."""
        cfg = self.config
        p = cfg.patch_size
        g = cfg.image_size // p
        b = images.shape[0]
        x = images.to(self.proj.dtype)
        patches = (x.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 5, 2, 4)
                   .reshape(b, g * g, 3 * p * p))          # (c, ky, kx) order
        x = patches @ self.conv1.weight.reshape(cfg.width, -1).t()
        cls = self.class_embedding.reshape(1, 1, -1).expand(b, 1, cfg.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = layer_norm(x, self.ln_pre.weight, self.ln_pre.bias, self.ln_pre.eps)
        x = self.transformer(x.contiguous())
        x = layer_norm(x, self.ln_post.weight, self.ln_post.bias, self.ln_post.eps)
        tokens = x @ self.proj                              # [B, 197, d]
        return tokens[:, 0], tokens
