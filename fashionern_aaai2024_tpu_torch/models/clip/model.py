"""The CLIP dual encoder.

JAX counterpart: `fashionern_aaai2024_tpu/models/clip/model.py`. The
image tower, the ViT (`models/clip/vit.py`) or the modified ResNet of
RN50x4 (`models/clip/resnet.py`) as the config's `vision.kind` says
(`model.py:25-29`), sits under `visual.`; the text tower's parameters
are at the top level, as in open_clip (see `models/clip/text.py`), with
`logit_scale` beside them.

`config.quantize_mlp` (the `--quantize-towers` serving tier) runs the
transformer towers' blocks with int8 projections
(`models/clip/transformer.py`).

`encode_image` takes uint8 images as well and CLIP-normalizes them on
the device (`model.py:47-57`), then casts to the tower's weight dtype.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from fashionern_aaai2024_tpu_torch.data.transforms import normalize_on_device
from fashionern_aaai2024_tpu_torch.models import init as I
from fashionern_aaai2024_tpu_torch.models.clip.config import CLIPConfig
from fashionern_aaai2024_tpu_torch.models.clip.resnet import ModifiedResNet
from fashionern_aaai2024_tpu_torch.models.clip.text import TextTower
from fashionern_aaai2024_tpu_torch.models.clip.vit import ViTTower


class CLIP(TextTower):
    def __init__(self, config: CLIPConfig):
        super().__init__(config.text, config.activation, config.quantize_mlp)
        self.config = config
        if config.vision.kind == "vit":
            self.visual = ViTTower(config.vision, config.activation, config.quantize_mlp)
        elif config.vision.kind == "resnet":
            self.visual = ModifiedResNet(config.vision)
        else:
            raise ValueError(f"unknown image tower kind {config.vision.kind!r}")
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def flax_variables(self) -> list[I.Variable]:
        """The JAX model's variables (`model.py:23-32`): the towers under
        `visual` and `text`, `logit_scale` the constant log(1 / 0.07)."""
        return [*I.scope("visual", self.visual.flax_variables()),
                *I.scope("text", self.text_flax_variables()),
                I.param("logit_scale", (), I.constant(math.log(1 / 0.07)), 1)]

    def encode_image(self, images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """[B, H, W, 3] -> (global [B, d], tokens [B, S, d]). uint8
        images are normalized here; float images are taken as already
        normalized."""
        if images.dtype == torch.uint8:
            images = normalize_on_device(images, images.device)
        return self.visual(images)

    def encode_text(self, text_ids: torch.Tensor, mode: str = "global"):
        """mode="global" -> (global [B, d], seq [B, L, d]); "seq" -> seq."""
        global_feat, seq = TextTower.forward(self, text_ids)
        if mode == "seq":
            return seq
        return global_feat, seq

    def forward(self, images: torch.Tensor, text_ids: torch.Tensor):
        return self.encode_image(images)[0], self.encode_text(text_ids)[0], self.logit_scale
