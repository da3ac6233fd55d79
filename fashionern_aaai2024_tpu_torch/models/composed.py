"""ComposedCIRModel: frozen CLIP + ERN, the serving half of the API.

JAX counterpart: `fashionern_aaai2024_tpu/models/composed.py`
(`encode_image`, `encode_text`, `index`, `query`). State_dict keys are
`clip.*` (open_clip names) and `ern.*` (reference ERN names).

Also here:
  * `apply_precision`, the port of `cli/main.py:554 _cast_precision`
    as the serve path sees it;
  * `random_init_`, seeded weights for runs without a checkpoint.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from fashionern_aaai2024_tpu_torch.models.clip.config import CLIPConfig
from fashionern_aaai2024_tpu_torch.models.clip.model import CLIP
from fashionern_aaai2024_tpu_torch.models.ern.ern import ERN


class ComposedCIRModel(nn.Module):
    def __init__(self, clip_config: CLIPConfig, patch_num: int = 13):
        super().__init__()
        self.clip_config = clip_config
        self.clip = CLIP(clip_config)
        self.ern = ERN(clip_config.feature_dim, patch_num=patch_num)

    def encode_image(self, images: torch.Tensor):
        return self.clip.encode_image(images)

    def encode_text(self, text_ids: torch.Tensor, mode: str = "global"):
        return self.clip.encode_text(text_ids, mode=mode)

    def index(self, tar_feats: torch.Tensor, tar_local_feats: torch.Tensor) -> torch.Tensor:
        return self.ern.index(tar_feats, tar_local_feats)

    def query(self, ref_feats: torch.Tensor, ref_local_feats: torch.Tensor,
              text_feats: torch.Tensor, text_seq_feats: torch.Tensor) -> torch.Tensor:
        return self.ern.query(ref_feats, ref_local_feats, text_feats, text_seq_feats)


@torch.no_grad()
def apply_precision(model: ComposedCIRModel, precision: str) -> ComposedCIRModel:
    """The serve precision policy, in place.

    "fp32": unchanged. "bf16" (the serve default): the CLIP towers are
    stored and computed in bf16; the ERN stack keeps fp32 storage with
    every weight rounded to bf16. That is what JAX computes when
    `_cast_precision`'s bf16 leaves meet the fp32 inputs that
    `InferenceAPI.query` passes (`evaluate.py:213-216`): flax promotes
    to fp32."""
    if precision == "fp32":
        return model
    if precision != "bf16":
        raise ValueError(f"unknown precision {precision!r}")
    model.clip.to(torch.bfloat16)
    for t in list(model.ern.parameters()) + list(model.ern.buffers()):
        if t.dtype == torch.float32:
            t.copy_(t.to(torch.bfloat16).to(torch.float32))
    return model


# std of the seeded normal init, by parameter name; the rest follows the
# module type (see random_init_)
_NAMED_STD = {
    "token_embedding.weight": lambda p: 0.02,
    "positional_embedding": lambda p: p.shape[-1] ** -0.5,
    "class_embedding": lambda p: p.shape[-1] ** -0.5,
    "proj": lambda p: p.shape[0] ** -0.5,
    "text_projection": lambda p: p.shape[0] ** -0.5,
    "position_embeddings.weight": lambda p: 0.02,
    "token_type_embeddings.weight": lambda p: 0.02,
    "cls_token": lambda p: 0.02,
}


@torch.no_grad()
def random_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights, in place (there is no checkpoint in the
    repository). Matrices are normal with std fan_in^-0.5, embeddings as
    in the JAX initializers, biases normal(0.02), norm scales
    1 + normal(0.02), BN running statistics near (0, 1). Draws on the CPU
    from `generator`, so a seed gives the same weights on any device."""
    def normal(p: torch.Tensor, std: float, mean: float = 0.0) -> None:
        p.copy_(torch.randn(p.shape, generator=generator) * std + mean)

    norm_types = (nn.LayerNorm, nn.BatchNorm1d)
    for mod_name, mod in model.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{name}" if mod_name else name
            rule = next((f for k, f in _NAMED_STD.items() if full.endswith(k)), None)
            if name == "logit_scale":
                p.fill_(math.log(1 / 0.07))
            elif rule is not None:
                normal(p, rule(p))
            elif isinstance(mod, norm_types) and name == "weight":
                normal(p, 0.02, 1.0)
            elif name.endswith("bias"):
                normal(p, 0.02)
            else:  # Linear / in_proj [out, in], conv [out, in, kh, kw]
                normal(p, p[0].numel() ** -0.5)
        if isinstance(mod, nn.BatchNorm1d):
            normal(mod.running_mean, 0.02)
            mod.running_var.copy_(1.0 + 0.1 * torch.rand(
                mod.running_var.shape, generator=generator))
    return model
