"""CLIP4Cir Combiner, VTF and AttentionPooling fusion heads.

JAX counterpart: `fashionern_aaai2024_tpu/models/zoo/combiner.py`.
Parameter names are the reference torch modules' (the names the JAX
`combiner_from_torch`, `vtf_from_torch` and `attention_pooling_from_torch`
read; `models/convert.py` writes them from the JAX params). JAX computes
these heads in plain XLA, so the port uses plain torch ops.

Every forward takes `generator`: None is eval; a `torch.Generator` is
train mode, dropout 0.5 where JAX drops out, masks drawn from it
(`ops/dropout.py`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fashionern_aaai2024_tpu_torch.models import init as I
from fashionern_aaai2024_tpu_torch.models.ern.layers import torch_normalize
from fashionern_aaai2024_tpu_torch.ops.dropout import dropout

DROPOUT = 0.5


def _scalar_mlp(d_in: int, hidden: int) -> nn.Sequential:
    """Linear, ReLU, Dropout, Linear (, Sigmoid / Softmax): parameters at
    `.0` and `.3`, as the reference's `nn.Sequential`s hold them."""
    return nn.Sequential(nn.Linear(d_in, hidden), nn.ReLU(), nn.Dropout(DROPOUT),
                         nn.Linear(hidden, 1))


def _scalar_mlp_variables(name: str, mlp: nn.Sequential) -> list[I.Variable]:
    """flax's `{name}_0` and `{name}_3` Denses of a `_scalar_mlp`."""
    return [*I.dense_like(f"{name}_0", mlp[0]), *I.dense_like(f"{name}_3", mlp[3])]


class Clip4CirCombiner(nn.Module):
    """Gated residual mix over 2·dim concatenated CLIP features
    (`Combiner_Model.py:6-70`): inputs and output [B, 2·clip_feature_dim]."""

    def __init__(self, clip_feature_dim: int, projection_dim: int, hidden_dim: int):
        super().__init__()
        d2 = 2 * clip_feature_dim
        self.text_projection_layer = nn.Linear(d2, projection_dim)
        self.image_projection_layer = nn.Linear(d2, projection_dim)
        self.combiner_layer = nn.Linear(2 * projection_dim, hidden_dim)
        self.output_layer = nn.Linear(hidden_dim, d2)
        self.dynamic_scalar = _scalar_mlp(2 * projection_dim, hidden_dim)

    def _projection_variables(self) -> list[I.Variable]:
        return [*I.dense_like("text_projection_layer", self.text_projection_layer),
                *I.dense_like("image_projection_layer", self.image_projection_layer),
                *I.dense_like("combiner_layer", self.combiner_layer),
                *_scalar_mlp_variables("dynamic_scalar", self.dynamic_scalar)]

    def flax_variables(self) -> list[I.Variable]:
        """The JAX module's variables (`combiner.py:22-46`), in flax's
        order of creation."""
        return [*self._projection_variables(), *I.dense_like("output_layer", self.output_layer)]

    def mix(self, image_features: torch.Tensor, text_features: torch.Tensor,
            generator: torch.Generator | None) -> torch.Tensor:
        """output_layer(combined) + σ·text + (1 − σ)·image, unnormalized."""
        def relu_drop(x):
            return dropout(F.relu(x), DROPOUT, generator)

        raw = torch.cat([relu_drop(self.text_projection_layer(text_features)),
                         relu_drop(self.image_projection_layer(image_features))], dim=-1)
        combined = relu_drop(self.combiner_layer(raw))
        h = relu_drop(self.dynamic_scalar[0](raw))
        scalar = torch.sigmoid(self.dynamic_scalar[3](h))
        return (self.output_layer(combined) + scalar * text_features
                + (1 - scalar) * image_features)

    def forward(self, image_features: torch.Tensor, text_features: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return torch_normalize(self.mix(image_features, text_features, generator))


class VTFModule(Clip4CirCombiner):
    """The Combiner plus a per-feature self-gating branch
    (`VTF_Model.py:6-112`).

    Reference quirks kept: the image stream calls `text_mlp`
    (`VTF_Model.py:92-99`), so `image_mlp` is dead weight held only so
    that checkpoints load one to one; the softmax over a [B, 1] gate is
    identically 1. The JAX module keeps a copy of `text_mlp` as
    `text_mlp_shared`; the port, like the reference, holds one."""

    def __init__(self, clip_feature_dim: int, projection_dim: int, hidden_dim: int):
        super().__init__(clip_feature_dim, projection_dim, hidden_dim)
        d2 = 2 * clip_feature_dim
        self.image_mlp = _scalar_mlp(d2, d2)
        self.text_mlp = _scalar_mlp(d2, d2)
        self.combiner_layer2 = nn.Linear(2 * d2, hidden_dim)
        self.output_layer2 = nn.Linear(hidden_dim, d2)
        self.dynamic_scalar2 = _scalar_mlp(2 * d2, hidden_dim)

    def flax_variables(self) -> list[I.Variable]:
        """The JAX module's variables (`combiner.py:49-104`), in flax's
        order of creation, `text_mlp_shared_{0,3}` included: the JAX
        module draws that copy of `text_mlp` apart (`zoo.jax_init_` drops
        the draw, ROADMAP C28)."""
        return [*_scalar_mlp_variables("image_mlp", self.image_mlp),
                *self._projection_variables(),
                *_scalar_mlp_variables("text_mlp", self.text_mlp),
                *_scalar_mlp_variables("text_mlp_shared", self.text_mlp),
                *I.dense_like("combiner_layer2", self.combiner_layer2),
                *_scalar_mlp_variables("dynamic_scalar2", self.dynamic_scalar2),
                *I.dense_like("output_layer", self.output_layer),
                *I.dense_like("output_layer2", self.output_layer2)]

    def forward(self, image_features: torch.Tensor, text_features: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        def relu_drop(x):
            return dropout(F.relu(x), DROPOUT, generator)

        def gate(x):
            g = self.text_mlp[3](relu_drop(self.text_mlp[0](x)))
            return torch.softmax(g, dim=-1)

        out = self.mix(image_features, text_features, generator)
        text_sa = relu_drop(text_features * gate(text_features))
        image_sa = relu_drop(image_features * gate(image_features))
        raw2 = torch.cat([text_sa, image_sa], dim=-1)
        combined2 = relu_drop(self.combiner_layer2(raw2))
        h2 = relu_drop(self.dynamic_scalar2[0](raw2))
        scalar2 = torch.sigmoid(self.dynamic_scalar2[3](h2))
        out = (out + self.output_layer2(combined2) + scalar2 * text_sa
               + (1 - scalar2) * image_sa)
        return torch_normalize(out)


class AttentionPooling(nn.Module):
    """Softmax pooling over T embeddings (`attention_fusion_model.py:6-23`):
    [B, T, H] -> [B, H]."""

    def __init__(self, emb_dim: int, emb_num: int):
        super().__init__()
        self.projection = nn.Linear(emb_dim * emb_num, emb_num)

    def flax_variables(self) -> list[I.Variable]:
        """The JAX module's variables (`combiner.py:107-119`)."""
        return I.dense_like("projection", self.projection)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        energy = self.projection(inputs.reshape(inputs.shape[0], -1))
        weights = torch.softmax(energy, dim=1)
        return torch.sum(inputs * weights[..., None], dim=1)
