"""The system under test, as the benchmark builds it: the PyTorch port's
`ComposedCIRModel` from a configuration file, loaded with the benchmark's
weights (`weights.py`) and put under the configuration's serve policy.
This module and the drivers are the only parts of the benchmark that
import the port; the reference imports none of it.
"""

from __future__ import annotations

import torch

from fashionern_aaai2024_tpu_torch.models.clip.config import CLIPConfig, TextConfig, VisionConfig
from fashionern_aaai2024_tpu_torch.models.composed import ComposedCIRModel, apply_precision

from cirbench import weights


def clip_config(config: dict) -> CLIPConfig:
    v, t = config["vision"], config["text"]
    vision = VisionConfig(kind=v["kind"], image_size=v["image_size"], embed_dim=v["embed_dim"],
                          width=v["width"],
                          layers=v["layers"] if v["kind"] == "vit" else tuple(v["layers"]),
                          heads=v["heads"], patch_size=v.get("patch_size", 16))
    text = TextConfig(vocab_size=t["vocab_size"], context_length=t["context_length"],
                      width=t["width"], heads=t["heads"], layers=t["layers"],
                      embed_dim=t["embed_dim"], tme=config["tme"])
    return CLIPConfig(name=config["name"], vision=vision, text=text,
                      activation=config["activation"])


def build(config: dict, seed: int, device: torch.device, serve: bool = True
          ) -> tuple[ComposedCIRModel, dict[str, torch.Tensor]]:
    """(the model on `device`, the drawn fp32 weights) from `seed`, under the
    configuration's serve policy (`serve`) or as drawn, for the Trainer to
    cast."""
    with torch.device(device):
        model = ComposedCIRModel(clip_config(config), patch_num=config["patch_num"])
    drawn = weights.seeded(weights.layout_of(model.state_dict()), seed, device, config)
    model.load_state_dict(drawn)
    model.eval()
    if not serve:
        return model, drawn
    if config["serve"]["towers"] != "bf16":
        raise ValueError(f"no serve policy for {config['serve']}")
    apply_precision(model, "bf16")
    return model, drawn
