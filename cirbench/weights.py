"""The benchmark's seeded weights: one state dict in the layout the
program's model loads (`load_state_dict`), drawn on the device.

Every floating tensor's values come from one normal draw of the total
size on a `torch.Generator` of the device seeded with the run's seed,
sliced in the order of the names, then scaled by rule:
  * a matrix or convolution kernel: N(0, 1) / sqrt(fan_in), fan_in the
    input width (the product of all dimensions but the output one; for
    the towers' `proj` and `text_projection`, which multiply from the
    right, the first dimension);
  * an embedding table, positional or class embedding, or a [CLS] token:
    N(0, 0.02);
  * a LayerNorm or BatchNorm scale: 1 (the last BatchNorm of each
    ResNet bottleneck branch: `RESIDUAL_BN_SCALE`); every bias:
    N(0, 0.02);
  * BatchNorm running statistics: mean 0, variance 1; in a ResNet
    tower (`calibrate_resnet`) each BatchNorm's mean is set to the
    per-channel mean of what reaches it when two seeded noise images go
    through the trunk in fp32, and its variance to the channels' mean
    variance there, so that the activations stay O(1) through the 26
    bottlenecks of RN50x4 and the tower's output depends on its input.
A few large calls on the device: the draw, then one scale a tensor.
"""

from __future__ import annotations

import torch

from cirbench.reference import clip
from cirbench.reference.ops import Ops, exact_fp32

RESIDUAL_BN_SCALE = 0.25
EMBEDDINGS = ("token_embedding.weight", "positional_embedding", "class_embedding",
              "position_embeddings.weight", "token_type_embeddings.weight", "cls_token")
RIGHT_MULTIPLIED = ("visual.proj", "text_projection")


def _is_norm(name: str, shapes: dict) -> bool:
    """A LayerNorm / BatchNorm parameter (a 1-D weight whose module has
    no 2-D weight beside it)."""
    module = name.rsplit(".", 1)[0]
    return shapes.get(module + ".weight", (0, 0)).__len__() == 1


def draw(layout: dict[str, tuple[tuple[int, ...], torch.dtype]], seed: int,
         device: torch.device | str) -> dict[str, torch.Tensor]:
    """{name: (shape, dtype)} -> {name: tensor on `device`}."""
    floats = [(n, s) for n, (s, dt) in layout.items() if dt.is_floating_point]
    total = sum(torch.Size(s).numel() for _, s in floats)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    shapes = {n: s for n, (s, _) in layout.items()}
    out, offset = {}, 0
    for name, (shape, dtype) in layout.items():
        if not dtype.is_floating_point:
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        n = torch.Size(shape).numel()
        values = flat[offset:offset + n].view(shape)
        offset += n
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_mean":
            t = torch.zeros_like(values)
        elif leaf == "running_var":
            t = torch.ones_like(values)
        elif name.endswith(EMBEDDINGS):
            t = values * 0.02
        elif leaf == "bias" or name.endswith("_bias"):
            t = values * 0.02
        elif leaf == "weight" and _is_norm(name, shapes):
            scale = RESIDUAL_BN_SCALE if (".bn3." in name and "visual.layer" in name) else 1.0
            t = torch.full_like(values, scale)
        elif len(shape) >= 2:
            fan_in = shape[0] if name.endswith(RIGHT_MULTIPLIED) else n // shape[0]
            t = values * fan_in ** -0.5
        else:
            t = values * 0.02
        out[name] = t.to(dtype)
    return out


def layout_of(state_dict: dict[str, torch.Tensor]) -> dict:
    return {k: (tuple(v.shape), v.dtype) for k, v in state_dict.items()}


class _Calibrate(Ops):
    """fp32 products; each BatchNorm first takes its running statistics
    from its input (the mean per channel, the variance averaged over
    the channels)."""

    def batch_norm(self, x: torch.Tensor, W: dict, pre: str) -> torch.Tensor:
        W[pre + "running_mean"].copy_(x.mean(dim=(0, 2, 3)))
        W[pre + "running_var"].fill_(x.var(dim=(0, 2, 3), unbiased=False).mean())
        return super().batch_norm(x, W, pre)


@torch.no_grad()
def calibrate_resnet(drawn: dict[str, torch.Tensor], config: dict, seed: int) -> None:
    """Sets the ResNet tower's BatchNorm statistics in `drawn`, in place."""
    vision = config["vision"]
    device = drawn["clip.visual.conv1.weight"].device
    gen = torch.Generator(device=device).manual_seed(seed ^ 0xCA1B)
    side = vision["image_size"]
    images = torch.randint(0, 256, (2, side, side, 3), generator=gen, device=device,
                           dtype=torch.uint8)
    W = {k.removeprefix("clip."): v for k, v in drawn.items()}
    with exact_fp32():
        clip.resnet_trunk(clip.normalize_uint8(images), W, vision, _Calibrate())


def seeded(layout: dict, seed: int, device: torch.device | str, config: dict
           ) -> dict[str, torch.Tensor]:
    """`draw`, then the ResNet tower's statistics (`calibrate_resnet`)."""
    drawn = draw(layout, seed, device)
    if config["vision"]["kind"] == "resnet":
        calibrate_resnet(drawn, config, seed)
    return drawn


def statistics(drawn: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The running statistics of `drawn` (a redraw reuses them, so that the
    reference reads the very statistics the program was given)."""
    return {k: v.clone() for k, v in drawn.items() if k.endswith(("running_mean", "running_var"))}
