"""AMC dynamic-routing fusion (`models/others/AMC_Model.py:16-194`).

JAX counterpart: `fashionern_aaai2024_tpu/models/zoo/amc.py`. Three
cells (Rescell, GlobalCell, StyleCell) mixed by a sigmoid Router over
[region, sentence] features, stacked in two DynamicInteraction layers;
and the unrouted Ensemble. Plain torch ops, as JAX computes them in XLA.

Inputs follow the reference: rgn [B, K, d] region features, img [B, d]
global image, wrd [B, T, d] word features, stc [B, d] sentence feature;
img, wrd and stc_lens are taken for the reference's signature and not
read by any cell.

Parameter names are the reference's, the names the JAX
`amc_interaction_from_torch` reads: `router.mlp.{0,1,3}` (the Linears
without bias, `.1` a LayerNorm), `glo.linear`, `glo.SA.norm1`,
`glo.SA.norm2`, `glo.SA.att_layer.linears.{0,1,2}` (q, k, v),
`glo.SA.feed_forward_layer.{fc1,fc2}`, `sty.fc_gamma.0`, `sty.fc_beta.0`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fashionern_aaai2024_tpu_torch.models import init as I

LN_EPS = 1e-5
SA_HEADS = 8


def _torch_layer_norm(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm(elementwise_affine=False)."""
    return F.layer_norm(x, x.shape[-1:], eps=LN_EPS)


def _with_sentence(rgn: torch.Tensor, stc: torch.Tensor) -> torch.Tensor:
    """[B, K, d] regions beside the sentence feature: [B, K, 2d]."""
    return torch.cat([rgn, stc[:, None, :].expand(-1, rgn.shape[1], -1)], dim=-1)


class Router(nn.Module):
    """Sigmoid path gates (`AMC_Model.py:63-77`): one independent sigmoid
    per cell, not a softmax, despite the reference's `path_prob`."""

    def __init__(self, num_out_path: int, embed_size: int, hid: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(2 * embed_size, hid, bias=False),
                                 nn.LayerNorm(hid, eps=LN_EPS), nn.ReLU(),
                                 nn.Linear(hid, num_out_path, bias=False), nn.Sigmoid())

    def flax_variables(self) -> list[I.Variable]:
        """`mlp_0` and `mlp_3` without bias, `mlp_1` a LayerNorm."""
        return [*I.dense_like("mlp_0", self.mlp[0]),
                *I.layer_norm("mlp_1", self.mlp[1].normalized_shape[0]),
                *I.dense_like("mlp_3", self.mlp[3])]

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [B, K, 2d] -> [B, cells]
        return self.mlp(x.mean(dim=-2))


class Rescell(nn.Module):
    """NIN cell: affine-free LayerNorm (`AMC_Model.py:91-98`)."""

    def forward(self, rgn: torch.Tensor) -> torch.Tensor:
        return _torch_layer_norm(rgn)


class StyleCell(nn.Module):
    """GTN cell: FiLM-style sentence modulation (`AMC_Model.py:99-115`)."""

    def __init__(self, embed_size: int):
        super().__init__()
        self.fc_gamma = nn.Sequential(nn.Linear(embed_size, embed_size))
        self.fc_beta = nn.Sequential(nn.Linear(embed_size, embed_size))

    def flax_variables(self) -> list[I.Variable]:
        return [*I.dense_like("fc_gamma_0", self.fc_gamma[0]),
                *I.dense_like("fc_beta_0", self.fc_beta[0])]

    def forward(self, rgn, img, wrd, stc, stc_lens=None) -> torch.Tensor:
        return _torch_layer_norm(rgn * self.fc_gamma(stc)[:, None, :]
                                 + self.fc_beta(stc)[:, None, :])


class _Linears(nn.Module):
    """The reference's attention layer: `linears.{0,1,2}` (q, k, v)."""

    def __init__(self, d: int):
        super().__init__()
        self.linears = nn.ModuleList(nn.Linear(d, d) for _ in range(3))


class _FeedForward(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.fc1 = nn.Linear(d, int(d * 0.5))
        self.fc2 = nn.Linear(int(d * 0.5), d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(x)))


class SelfAttentionCell(nn.Module):
    """Pre-norm 8-head self-attention + FF (`AMC_Model.py:178-194`). The
    residual is `att + ff(norm2(att))`: the attention output, not the
    input, carries the skip (the reference's semantics)."""

    def __init__(self, embed_size: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(embed_size, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(embed_size, eps=LN_EPS)
        self.att_layer = _Linears(embed_size)
        self.feed_forward_layer = _FeedForward(embed_size)

    def flax_variables(self) -> list[I.Variable]:
        d = self.norm1.normalized_shape[0]
        q, k, v = self.att_layer.linears
        return [*I.layer_norm("norm1", d), *I.dense_like("att_q", q),
                *I.dense_like("att_k", k), *I.dense_like("att_v", v),
                *I.layer_norm("norm2", d),
                *I.dense_like("ff_1", self.feed_forward_layer.fc1),
                *I.dense_like("ff_2", self.feed_forward_layer.fc2)]

    def forward(self, local_emb: torch.Tensor) -> torch.Tensor:
        b, s, d = local_emb.shape
        head = d // SA_HEADS
        x = self.norm1(local_emb)

        def split(t):
            return t.reshape(b, s, SA_HEADS, head).transpose(1, 2)

        q, k, v = (split(lin(x)) for lin in self.att_layer.linears)
        p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(head), dim=-1)
        att = torch.matmul(p, v).transpose(1, 2).reshape(b, s, d)
        return att + self.feed_forward_layer(self.norm2(att))


class GlobalCell(nn.Module):
    """CRN cell (`AMC_Model.py:118-132`)."""

    def __init__(self, embed_size: int):
        super().__init__()
        self.linear = nn.Linear(2 * embed_size, embed_size)
        self.SA = SelfAttentionCell(embed_size)

    def flax_variables(self) -> list[I.Variable]:
        return [*I.dense_like("linear", self.linear), *I.scope("SA", self.SA.flax_variables())]

    def forward(self, rgn, img, wrd, stc, stc_lens=None) -> torch.Tensor:
        return _torch_layer_norm(self.SA(self.linear(_with_sentence(rgn, stc))))


class _Cells(nn.Module):
    """The three cells, `ric`, `glo` and `sty`."""

    def __init__(self, embed_size: int):
        super().__init__()
        self.ric = Rescell()
        self.glo = GlobalCell(embed_size)
        self.sty = StyleCell(embed_size)

    def flax_variables(self) -> list[I.Variable]:
        """The cells' variables (`ric` has none)."""
        return [*I.scope("glo", self.glo.flax_variables()),
                *I.scope("sty", self.sty.flax_variables())]

    def cells(self, rgn, img, wrd, stc, stc_lens=None) -> list[torch.Tensor]:
        return [self.ric(rgn), self.glo(rgn, img, wrd, stc, stc_lens),
                self.sty(rgn, img, wrd, stc, stc_lens)]


class DynamicInteractionLayer(_Cells):
    def __init__(self, embed_size: int, hid_router: int, num_cells: int = 3):
        super().__init__(embed_size)
        self.router = Router(num_cells, embed_size, hid_router)

    def flax_variables(self) -> list[I.Variable]:
        return [*I.scope("router", self.router.flax_variables()), *super().flax_variables()]

    def forward(self, rgn, img, wrd, stc, stc_lens=None) -> tuple[torch.Tensor, torch.Tensor]:
        path_prob = self.router(_with_sentence(rgn, stc))                    # [B, cells]
        embs = torch.stack(self.cells(rgn, img, wrd, stc, stc_lens), dim=1)  # [B, 3, K, d]
        return torch.sum(embs * path_prob[:, :, None, None], dim=1), path_prob


class AMCInteractionModule(nn.Module):
    """Two stacked routing layers (`AMC_Model.py:16-28`): returns
    (emb1, emb2, path_prob1, path_prob2)."""

    def __init__(self, embed_size: int, hid_router: int):
        super().__init__()
        self.dynamic_itr_l0 = DynamicInteractionLayer(embed_size, hid_router)
        self.dynamic_itr_l1 = DynamicInteractionLayer(embed_size, hid_router)

    def flax_variables(self) -> list[I.Variable]:
        """The JAX module's variables (`amc.py:27-163`)."""
        return [*I.scope("dynamic_itr_l0", self.dynamic_itr_l0.flax_variables()),
                *I.scope("dynamic_itr_l1", self.dynamic_itr_l1.flax_variables())]

    def forward(self, rgn, img, wrd, stc, stc_lens=None):
        emb1, p1 = self.dynamic_itr_l0(rgn, img, wrd, stc, stc_lens)
        emb2, p2 = self.dynamic_itr_l1(emb1, img, wrd, stc, stc_lens)
        return emb1, emb2, p1, p2


class AMCEnsemble(_Cells):
    """Unrouted sum of the three cells (`AMC_Model.py:79-88`)."""

    def forward(self, rgn, img, wrd, stc, stc_lens=None) -> torch.Tensor:
        ric, glo, sty = self.cells(rgn, img, wrd, stc, stc_lens)
        return ric + glo + sty
