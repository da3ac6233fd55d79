"""ARTEMIS scoring model (`models/others/ARTEMIS_Model.py:6-93`, ICLR'22).

JAX counterpart: `fashionern_aaai2024_tpu/models/zoo/artemis.py`.
Explicit-Matching (EM) + Implicit-Similarity (IS) attention scores; the
l2norm is x / max(||x||, 1e-12), as in JAX (the reference file imports a
symbol that does not exist). Parameter names are the reference's
(`Transform_m.0`, `Attention_{EM,IS}.attention.{0,2}`, `temperature` of
shape [1]), the names the JAX `artemis_from_torch` reads.

`score(r, m, t)`: per-triple scores [B]; `score_broadcast(r, m, t)`: the
[Bq, Bt] matrix, each query's attention applied to every target.
"""

from __future__ import annotations

import torch
from torch import nn

from fashionern_aaai2024_tpu_torch.models import init as I
from fashionern_aaai2024_tpu_torch.models.ern.layers import torch_normalize

TEMPERATURE_INIT = 2.65926


class AttentionMechanism(nn.Module):
    """MLP gate with a softmax over the feature axis
    (`ARTEMIS_Model.py:76-93`, `Softmax(dim=1)` on [B, d])."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.attention = nn.Sequential(nn.Linear(embed_dim, embed_dim), nn.ReLU(),
                                       nn.Linear(embed_dim, embed_dim), nn.Softmax(dim=1))

    def flax_variables(self) -> list[I.Variable]:
        return [*I.dense_like("attention_0", self.attention[0]),
                *I.dense_like("attention_2", self.attention[2])]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.attention(x)


class Artemis(nn.Module):
    def __init__(self, clip_feature_dim: int):
        super().__init__()
        d = clip_feature_dim
        self.Transform_m = nn.Sequential(nn.Linear(d, d))
        self.Attention_EM = AttentionMechanism(d)
        self.Attention_IS = AttentionMechanism(d)
        self.temperature = nn.Parameter(torch.tensor([TEMPERATURE_INIT]))

    def flax_variables(self) -> list[I.Variable]:
        """The JAX module's variables (`artemis.py:35-44`). `temperature`'s
        initializer is a constant, but flax still hands it a key: the
        scope's first `make_rng`, counter 1."""
        return [*I.dense_like("Transform_m", self.Transform_m[0]),
                *I.scope("Attention_EM", self.Attention_EM.flax_variables()),
                *I.scope("Attention_IS", self.Attention_IS.flax_variables()),
                I.param("temperature", (1,), I.constant(TEMPERATURE_INIT), 1)]

    def score_em(self, r: torch.Tensor, m: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        tr_m = torch_normalize(self.Transform_m(m))
        return torch.sum(tr_m * torch_normalize(self.Attention_EM(m) * t), dim=-1)

    def score_is(self, r: torch.Tensor, m: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        a = self.Attention_IS(m)
        return torch.sum(torch_normalize(a * r) * torch_normalize(a * t), dim=-1)

    def score(self, r: torch.Tensor, m: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self.score_em(r, m, t) + self.score_is(r, m, t)

    def score_broadcast(self, r: torch.Tensor, m: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
        """[Bq, Bt] EM + IS scores (`compute_score_broadcast_artemis`)."""
        a_em = self.Attention_EM(m)
        tr_m = torch_normalize(self.Transform_m(m))
        em = torch.sum(tr_m[:, None, :] * torch_normalize(a_em[:, None, :] * t[None]), dim=-1)
        a_is = self.Attention_IS(m)
        a_is_r = torch_normalize(a_is * r)
        is_ = torch.sum(a_is_r[:, None, :] * torch_normalize(a_is[:, None, :] * t[None]),
                        dim=-1)
        return em + is_

    def forward(self, r: torch.Tensor, m: torch.Tensor, t: torch.Tensor,
                broadcast: bool = False) -> torch.Tensor:
        return self.score_broadcast(r, m, t) if broadcast else self.score(r, m, t)
