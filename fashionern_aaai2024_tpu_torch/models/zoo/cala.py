"""CaLa twin-attention compositor (`models/others/CaLa_Model.py:5-62`).

JAX counterpart: `fashionern_aaai2024_tpu/models/zoo/cala.py`. Two
single-head cross-attentions (`nn.MultiheadAttention` parameters,
`models/ern/layers.py TorchMultiheadAttention`), each applied 4 times
(first reference against target, then the query against its own refined
output); the two CLS rows are averaged.

One head over the whole width makes the head dim 512 on ViT-B-16 and 640
on RN50x4, which the attention core does not take: on the card each
attention runs kernel B8's wide route (`ops/attention.py
wide_cross_attention`, csrc/attention_wide.cu), on a CPU tensor B8's
plain version. CaLa trains on the card: under autograd each attention
runs the same wide-route launch inside `PackedCrossFunction`, whose
backward is autograd of B8's plain version, as JAX differentiates
`_packed_cross_ref` in XLA (`chip_smoke.py` phase 20 takes Adam steps
of it against the CPU).
"""

from __future__ import annotations

import torch
from torch import nn

from fashionern_aaai2024_tpu_torch.models import init as I
from fashionern_aaai2024_tpu_torch.models.ern.layers import TorchMultiheadAttention

REFINEMENTS = 3


class TwinAttentionCompositor(nn.Module):
    def __init__(self, embedding_dim: int):
        super().__init__()
        self.reference_as_query_attention = TorchMultiheadAttention(embedding_dim, 1)
        self.target_as_query_attention = TorchMultiheadAttention(embedding_dim, 1)
        for attn in (self.reference_as_query_attention, self.target_as_query_attention):
            nn.init.xavier_uniform_(attn.in_proj_weight)
            nn.init.zeros_(attn.in_proj_bias)

    def flax_variables(self) -> list[I.Variable]:
        """The JAX module's variables (`cala.py:15-24`): two
        `TorchMultiheadAttention`s, xavier-uniform `in_proj_weight`."""
        return [*I.scope("reference_as_query_attention",
                         self.reference_as_query_attention.flax_variables()),
                *I.scope("target_as_query_attention",
                         self.target_as_query_attention.flax_variables())]

    @staticmethod
    def _refine(attn: TorchMultiheadAttention, query: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        out = attn(query, context, context)
        for _ in range(REFINEMENTS):
            out = attn(query, out, out)
        return out

    def forward(self, reference_embeddings: torch.Tensor,
                target_embeddings: torch.Tensor) -> torch.Tensor:
        """[B, S, d] reference and target tokens -> [B, d]."""
        out1 = self._refine(self.reference_as_query_attention, reference_embeddings,
                            target_embeddings)
        out2 = self._refine(self.target_as_query_attention, target_embeddings,
                            reference_embeddings)
        return (out1[:, 0, :] + out2[:, 0, :]) / 2
