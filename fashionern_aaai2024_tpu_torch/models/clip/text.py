"""CLIP text tower.

JAX counterpart: `fashionern_aaai2024_tpu/models/clip/text.py`: the
vanilla single-branch tower at any `TextConfig.tme`, since TME lives in
the trainable ERN subtree (`models/ern/tme.py`, applied by
`models/composed.py encode_text`). Causal pre-LN
trunk, ln_final (kernel B11), projection of every position to the joint
dim. The global feature is the projected token at argmax(text_ids), the
EOT position, since EOT has the highest id (`text.py:62-65`).

open_clip keeps the text tower's parameters at the top level of its
`CLIP` module (`token_embedding.weight`, `positional_embedding`,
`transformer.resblocks.*`, `ln_final.*`, `text_projection`), the names
`models/clip/convert.py:105 _text_tower` reads, so `models/clip/model.py
CLIP` extends this class instead of holding it under a prefix.
"""

from __future__ import annotations

import torch
from torch import nn

from fashionern_aaai2024_tpu_torch.models import init as I
from fashionern_aaai2024_tpu_torch.models.clip.config import TextConfig
from fashionern_aaai2024_tpu_torch.models.clip.transformer import Transformer
from fashionern_aaai2024_tpu_torch.ops.layernorm import layer_norm


class TextTower(nn.Module):
    def __init__(self, config: TextConfig, activation: str = "gelu", quantize: bool = False):
        super().__init__()
        self.text_config = config
        self.token_embedding = nn.Embedding(config.vocab_size, config.width)
        self.positional_embedding = nn.Parameter(
            torch.empty(config.context_length, config.width))
        self.transformer = Transformer(config.width, config.layers, config.heads,
                                       activation, causal=True, quantize=quantize)
        self.ln_final = nn.LayerNorm(config.width)
        self.text_projection = nn.Parameter(torch.empty(config.width, config.embed_dim))

    def text_flax_variables(self) -> list[I.Variable]:
        """The JAX tower's variables (`text.py:40-70`): token embedding
        normal(0.02), positional normal(0.01), projection
        normal(width^-0.5)."""
        w = self.text_config.width
        return [I.param("token_embedding", self.token_embedding.weight.shape, I.normal(0.02), 1),
                I.param("positional_embedding", self.positional_embedding.shape,
                        I.normal(0.01), 2),
                *I.scope("transformer", self.transformer.flax_variables()),
                *I.layer_norm("ln_final", w),
                I.param("text_projection", self.text_projection.shape, I.normal(w ** -0.5), 3)]

    def forward(self, text_ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """text_ids: integer [B, L] -> (global [B, d], seq [B, L, d])."""
        x = self.token_embedding(text_ids) + self.positional_embedding
        x = self.transformer(x)
        x = layer_norm(x, self.ln_final.weight, self.ln_final.bias, self.ln_final.eps)
        seq = x @ self.text_projection
        eot = text_ids.argmax(dim=-1)
        return seq[torch.arange(seq.shape[0], device=seq.device), eot], seq
