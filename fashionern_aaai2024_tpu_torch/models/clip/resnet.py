"""CLIP modified-ResNet image tower (RN50x4).

JAX counterpart: `fashionern_aaai2024_tpu/models/clip/resnet.py`. The
"modified" ResNet of CLIP: a 3-conv stem (each conv -> BN -> ReLU) and a
2x2 average pool; bottlenecks whose stride-2 convolutions are stride-1
convolutions followed by a 2x2 average pool, in the shortcut too; an
attention-pool head instead of global average pooling. RN50x4: base
width 80, stages (4, 6, 10, 6), image 288 -> a 9x9x2560 grid, attention
pool with 40 heads of 64 -> the 640-d joint space.

Names are open_clip's, the ones `models/clip/convert.py:74 _resnet_tower`
reads: `conv{1,2,3}`, `bn{1,2,3}`, `layer{n}.{j}.conv{i}` / `.bn{i}` /
`.downsample.{0,1}`, `attnpool.{positional_embedding,q_proj,k_proj,
v_proj,c_proj}`.

The input is NHWC, as in the JAX API; as a permuted view it is an NCHW
tensor in the channels-last memory format, which the convolutions keep
throughout. The convolutions are `F.conv2d` (cuDNN on the card) and the
pools `F.avg_pool2d`: XLA ran them on the TPU, outside any Pallas
kernel. fp32 convolutions on the card follow
`torch.backends.cudnn.allow_tf32` (PyTorch's default lets cuDNN use
TF32; the port's card tests and `chip_smoke.py` turn it off). The towers
are frozen: every BatchNorm applies its running statistics, whatever
the module's train flag, as the JAX tower's `train=False` does. The
attention pool's projections are `F.linear`, as XLA ran them; the
attention between them is kernel B8 (`ops.attention.packed_kv_cross_attention`).

`forward` returns (global [B, d], tokens [B, 1 + h*w, d]): the tokens
are `c_proj(v)` at the mean token and at every grid position in (h, w)
order (`resnet.py:79-82, :101`). Its two parts run in the profiler spans
`image_tower/trunk` and `image_tower/attnpool`.

Also here: `fold_batchnorm` (the `--fold-bn` serving transform,
`resnet.py:105`) and `calibrate_batchnorm_` (seeded running statistics
for runs without a checkpoint, `models/composed.py random_init_`).
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from fashionern_aaai2024_tpu_torch.models import init as I
from fashionern_aaai2024_tpu_torch.models.clip.config import VisionConfig
from fashionern_aaai2024_tpu_torch.ops.attention import packed_kv_cross_attention


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    """A bias-free convolution with its weight in the channels-last layout
    the activations use (a copy into it keeps the layout: `load_state_dict`,
    casts and moves)."""
    conv = nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)
    conv.weight.data = conv.weight.data.contiguous(memory_format=torch.channels_last)
    return conv


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d`'s parameters and buffers; the forward is always the
    eval formula over the running statistics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1, self.bn1 = _conv(inplanes, planes, 1), FrozenBatchNorm2d(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), FrozenBatchNorm2d(planes)
        self.conv3, self.bn3 = _conv(planes, 4 * planes, 1), FrozenBatchNorm2d(4 * planes)
        self.downsample = None
        if stride > 1 or inplanes != 4 * planes:
            # open_clip's Sequential("-1": AvgPool2d, "0": conv, "1": BN); the
            # pool has no state, so the forward applies it
            self.downsample = nn.Sequential(OrderedDict(
                [("0", _conv(inplanes, 4 * planes, 1)), ("1", FrozenBatchNorm2d(4 * planes))]))

    def flax_variables(self) -> list[I.Variable]:
        """The JAX bottleneck's variables (`resnet.py:45-66`): each BN
        under its `BNRelu` (`bn{i}/bn`)."""
        out = []
        convs = [("conv1", "bn1", self.conv1), ("conv2", "bn2", self.conv2),
                 ("conv3", "bn3", self.conv3)]
        if self.downsample is not None:
            convs.append(("downsample_conv", "downsample_bn", self.downsample[0]))
        for conv_name, bn_name, conv in convs:
            c_out, c_in, k, _ = conv.weight.shape
            out += [*I.conv(conv_name, k, c_in, c_out),
                    *I.scope(bn_name, I.batch_norm("bn", c_out))]
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)), inplace=True)
        out = F.relu(self.bn2(self.conv2(out)), inplace=True)
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = self.bn3(self.conv3(out))
        identity = x
        if self.downsample is not None:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = self.downsample(identity)
        return F.relu(out + identity, inplace=True)


class AttentionPool2d(nn.Module):
    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int, output_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(torch.empty(spacial_dim ** 2 + 1, embed_dim))
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)

    def flax_variables(self) -> list[I.Variable]:
        """The JAX pool's variables (`resnet.py:73-91`): the positional
        embedding normal(embed_dim^-0.5), then q, k, v and c_proj."""
        e = self.q_proj.weight.shape[0]
        return [I.param("positional_embedding", self.positional_embedding.shape,
                        I.normal(e ** -0.5), 1),
                *I.dense("q_proj", e, e), *I.dense("k_proj", e, e), *I.dense("v_proj", e, e),
                *I.dense("c_proj", e, self.c_proj.weight.shape[0])]

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:  # [B, C, H, W]
        b, c = x.shape[:2]
        x = x.permute(0, 2, 3, 1).reshape(b, -1, c)              # (h, w) order
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1) + self.positional_embedding
        q = self.q_proj(x[:, :1])
        k, v = self.k_proj(x), self.v_proj(x)
        o = packed_kv_cross_attention(q, torch.cat([k, v], dim=-1), self.num_heads)
        return self.c_proj(o)[:, 0], self.c_proj(v)


class ModifiedResNet(nn.Module):
    def __init__(self, config: VisionConfig):
        super().__init__()
        self.config = config
        width = config.width
        self.conv1, self.bn1 = _conv(3, width // 2, 3, stride=2), FrozenBatchNorm2d(width // 2)
        self.conv2, self.bn2 = _conv(width // 2, width // 2, 3), FrozenBatchNorm2d(width // 2)
        self.conv3, self.bn3 = _conv(width // 2, width, 3), FrozenBatchNorm2d(width)
        inplanes = width
        for i, blocks in enumerate(config.layers):
            planes = width * 2 ** i
            layer = [Bottleneck(inplanes, planes, 1 if i == 0 else 2)]
            inplanes = 4 * planes
            layer += [Bottleneck(inplanes, planes) for _ in range(1, blocks)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
        self.attnpool = AttentionPool2d(config.image_size // 32, width * 32, config.heads,
                                        config.embed_dim)

    def flax_variables(self) -> list[I.Variable]:
        """The JAX tower's variables (`resnet.py:164-193`): the stem, then
        `layer{n}_{j}` for each bottleneck, then `attnpool`."""
        out = []
        for i in (1, 2, 3):
            conv = getattr(self, f"conv{i}")
            c_out, c_in, k, _ = conv.weight.shape
            out += [*I.conv(f"conv{i}", k, c_in, c_out),
                    *I.scope(f"bn{i}", I.batch_norm("bn", c_out))]
        for i in range(len(self.config.layers)):
            for j, block in enumerate(getattr(self, f"layer{i + 1}")):
                out += I.scope(f"layer{i + 1}_{j}", block.flax_variables())
        return out + I.scope("attnpool", self.attnpool.flax_variables())

    def forward(self, images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """images: [B, H, W, 3] NHWC, CLIP-normalized."""
        with record_function("image_tower/trunk"):
            x = images.to(self.conv1.weight.dtype).contiguous().permute(0, 3, 1, 2)
            for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2),
                             (self.conv3, self.bn3)):
                x = F.relu(bn(conv(x)), inplace=True)
            x = F.avg_pool2d(x, 2)
            for i in range(len(self.config.layers)):
                x = getattr(self, f"layer{i + 1}")(x)
        with record_function("image_tower/attnpool"):
            return self.attnpool(x)

    def conv_bn_pairs(self) -> list[tuple[nn.Conv2d, FrozenBatchNorm2d]]:
        """Every convolution with the BatchNorm that follows it."""
        pairs = [(self.conv1, self.bn1), (self.conv2, self.bn2), (self.conv3, self.bn3)]
        for m in self.modules():
            if isinstance(m, Bottleneck):
                pairs += [(m.conv1, m.bn1), (m.conv2, m.bn2), (m.conv3, m.bn3)]
                if m.downsample is not None:
                    pairs.append((m.downsample[0], m.downsample[1]))
        return pairs


@torch.no_grad()
def fold_batchnorm(tower: ModifiedResNet) -> ModifiedResNet:
    """Fold each frozen BatchNorm's affine into the convolution before it,
    in place (`resnet.py:105-156`): with a = weight * rsqrt(var + eps),
    conv weight <- weight * a (per output channel), BN bias <- bias -
    mean * a, and the BN left at weight 1, mean 0, var 1 - eps, so that it
    computes x + bias. The same forward up to one float rounding."""
    for conv, bn in tower.conv_bn_pairs():
        a = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
        conv.weight.copy_(conv.weight * a.reshape(-1, 1, 1, 1))
        bn.bias.copy_(bn.bias - bn.running_mean * a)
        bn.weight.fill_(1.0)
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0 - bn.eps)
    return tower


@torch.no_grad()
def calibrate_batchnorm_(tower: ModifiedResNet, images: torch.Tensor) -> ModifiedResNet:
    """Set every BatchNorm's running statistics, in forward order, from
    what reaches it when `images` [B, H, W, 3] go through the tower: the
    per-channel mean, and the (biased) variance averaged over the
    channels, so that each BN's output has unit variance on average and
    the activations stay O(1) through any depth. Random weights have no
    trained statistics; running means near 0 and variances near 1 let the
    26 bottlenecks of RN50x4 grow or shrink the activations
    geometrically, and per-channel variances from a few images blow up
    the channels that those images hardly excite."""
    def set_stats(bn: FrozenBatchNorm2d, args: tuple) -> None:
        x = args[0].float()
        bn.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.running_var.fill_(x.var(dim=(0, 2, 3), unbiased=False).mean().item())

    hooks = [m.register_forward_pre_hook(set_stats) for m in tower.modules()
             if isinstance(m, FrozenBatchNorm2d)]
    try:
        tower(images)
    finally:
        for h in hooks:
            h.remove()
    return tower
