"""DQU-CIR fusion head (`models/others/DQU_CIR_Model.py:8-72`, SIGIR'24).

JAX counterpart: `fashionern_aaai2024_tpu/models/zoo/dqu_cir.py`. The
head is backbone-agnostic: it takes already-encoded (unnormalized) text
and image query features. Parameter names are the reference's
(`combiner_fc.0`, `scaler_fc.{0,3}`), the names the JAX
`dqu_cir_from_torch` reads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fashionern_aaai2024_tpu_torch.models import init as I
from fashionern_aaai2024_tpu_torch.models.ern.layers import torch_normalize
from fashionern_aaai2024_tpu_torch.ops.dropout import dropout


class DQUCIRHead(nn.Module):
    """Gated mix of the L2-normalized text and image queries
    (`DQU_CIR_Model.py:44-53`); returns the normalized query. `generator`:
    None is eval, a `torch.Generator` drops out at `dropout` after each
    hidden layer."""

    def __init__(self, clip_feature_dim: int, hidden_dim: int = 1024, dropout: float = 0.5):
        super().__init__()
        self.dropout = dropout
        self.combiner_fc = nn.Sequential(nn.Linear(2 * clip_feature_dim, hidden_dim),
                                         nn.ReLU())
        self.scaler_fc = nn.Sequential(nn.Linear(hidden_dim, hidden_dim), nn.ReLU(),
                                       nn.Dropout(dropout), nn.Linear(hidden_dim, 1),
                                       nn.Sigmoid())

    def flax_variables(self) -> list[I.Variable]:
        """The JAX head's variables (`dqu_cir.py:19-38`)."""
        return [*I.dense_like("combiner_fc_0", self.combiner_fc[0]),
                *I.dense_like("scaler_fc_0", self.scaler_fc[0]),
                *I.dense_like("scaler_fc_3", self.scaler_fc[3])]

    def forward(self, textual_query: torch.Tensor, visual_query: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        tq, vq = torch_normalize(textual_query), torch_normalize(visual_query)
        combined = F.relu(self.combiner_fc[0](torch.cat([tq, vq], dim=-1)))
        h = dropout(combined, self.dropout, generator)
        h = dropout(F.relu(self.scaler_fc[0](h)), self.dropout, generator)
        scaler = torch.sigmoid(self.scaler_fc[3](h))
        return torch_normalize(scaler * tq + (1 - scaler) * vq)


def ranking_nce_loss(query: torch.Tensor, target: torch.Tensor,
                     loss_weight: float = 10.0) -> torch.Tensor:
    """`DQU_CIR.ranking_nce_loss` (`DQU_CIR_Model.py:67-72`): cross-entropy
    of `loss_weight`·query·targetᵀ against the diagonal, in fp32."""
    x = loss_weight * (query.float() @ target.float().t())
    return F.cross_entropy(x, torch.arange(x.shape[0], device=x.device))
