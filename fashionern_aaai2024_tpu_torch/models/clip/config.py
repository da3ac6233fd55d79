"""CLIP backbone configurations.

A copy of `fashionern_aaai2024_tpu/models/clip/config.py`: the JAX
module cannot be imported without flax (its package `__init__` imports
it), and the two must describe the same models. The reference supports
two backbones:
  * RN50x4  — modified ResNet, feature_dim 640, input 288
  * ViT-B-16 — feature_dim 512, input 224
Text context length is always 77.

`activation` mirrors open_clip: models built without pretrained weights
use exact GELU; OpenAI-published checkpoints use QuickGELU (x·σ(1.702x)).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    kind: str                       # "vit" | "resnet"
    image_size: int
    embed_dim: int                  # joint space dim
    width: int                      # transformer width / resnet base width
    layers: tuple[int, ...] | int   # int for ViT depth, tuple for resnet stages
    heads: int
    patch_size: int = 16            # ViT only


@dataclasses.dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    heads: int = 8
    layers: int = 12
    embed_dim: int = 512
    tme: bool = False               # TME text enhancement (ERN subtree, models/ern/tme.py)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    name: str
    vision: VisionConfig
    text: TextConfig
    activation: str = "gelu"        # "gelu" | "quick_gelu"
    quantize_mlp: bool = False      # int8 towers (serving; kernels B5 / B6, ops/qmlp.py)

    @property
    def feature_dim(self) -> int:
        return self.text.embed_dim

    @property
    def input_dim(self) -> int:
        return self.vision.image_size


VIT_B_16 = CLIPConfig(
    name="ViT-B-16",
    vision=VisionConfig(
        kind="vit", image_size=224, embed_dim=512, width=768, layers=12, heads=12,
        patch_size=16,
    ),
    text=TextConfig(width=512, heads=8, layers=12, embed_dim=512),
)

RN50X4 = CLIPConfig(
    name="RN50x4",
    vision=VisionConfig(
        kind="resnet", image_size=288, embed_dim=640, width=80,
        layers=(4, 6, 10, 6), heads=40,
    ),
    text=TextConfig(width=640, heads=10, layers=12, embed_dim=640),
)

_CONFIGS = {"ViT-B-16": VIT_B_16, "RN50x4": RN50X4}


def get_clip_config(name: str, activation: str | None = None,
                    quantize_mlp: bool | None = None,
                    tme: bool | None = None) -> CLIPConfig:
    cfg = _CONFIGS[name]
    if activation is not None:
        cfg = dataclasses.replace(cfg, activation=activation)
    if quantize_mlp is not None:
        cfg = dataclasses.replace(cfg, quantize_mlp=quantize_mlp)
    if tme:
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, tme=True))
    return cfg
