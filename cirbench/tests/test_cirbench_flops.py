"""The FLOP counts of `cirbench/flops.py`, checked by hand at one ViT-B/16
block and one RN50x4 bottleneck, and against PyTorch's own count of the
reference's products at those shapes."""

from __future__ import annotations

import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from cirbench import flops, peaks
from cirbench.reference import clip
from cirbench.spec import BENCH_DIR

VIT = json.loads((BENCH_DIR / "configs" / "fashionern-vitb16.json").read_text())
RN = json.loads((BENCH_DIR / "configs" / "fashionern-rn50x4.json").read_text())


def test_one_vit_b16_block_by_hand():
    s, w = 197, 768
    qkv = 2 * s * w * 3 * w            # 697,171,968
    attention = 2 * 2 * s * s * w      # scores and context: 119,221,248
    out = 2 * s * w * w                # 232,390,656
    mlp = 2 * 2 * s * w * 4 * w        # c_fc and c_proj: 1,859,125,248
    assert qkv + attention + out + mlp == 2_907_909_120 == flops.block_flops(s, w)


def test_one_rn50x4_bottleneck_by_hand():
    # layer2.0: 72 x 72 x 320 in, planes 160, stride 2 (pool before conv3
    # and in the shortcut), 36 x 36 x 640 out
    conv1 = 2 * 72 * 72 * 160 * 320           # 530,841,600
    conv2 = 2 * 72 * 72 * 160 * 160 * 9       # 2,388,787,200
    conv3 = 2 * 36 * 36 * 640 * 160           # 265,420,800
    shortcut = 2 * 36 * 36 * 640 * 320        # 530,841,600
    assert conv1 + conv2 + conv3 + shortcut == 3_715_891_200
    assert flops.bottleneck_flops(RN["vision"], 2, 0) == 3_715_891_200


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_counts_agree_with_pytorch_on_the_reference():
    g = torch.Generator().manual_seed(0)
    w = 768
    W = {}
    for name, shape in (("ln_1.weight", (w,)), ("ln_1.bias", (w,)), ("ln_2.weight", (w,)),
                        ("ln_2.bias", (w,)), ("attn.in_proj_weight", (3 * w, w)),
                        ("attn.in_proj_bias", (3 * w,)), ("attn.out_proj.weight", (w, w)),
                        ("attn.out_proj.bias", (w,)), ("mlp.c_fc.weight", (4 * w, w)),
                        ("mlp.c_fc.bias", (4 * w,)), ("mlp.c_proj.weight", (w, 4 * w)),
                        ("mlp.c_proj.bias", (w,))):
        W["b." + name] = torch.randn(shape, generator=g) * 0.02
    x = torch.randn((1, 197, w), generator=g)
    assert _counted(lambda: clip.residual_block(x, W, "b.", 12, "quick_gelu", False)) == \
        flops.block_flops(197, w)
    planes, inplanes = 160, 320
    RW = {}
    for conv, cin, cout, k in (("conv1", inplanes, planes, 1), ("conv2", planes, planes, 3),
                               ("conv3", planes, 4 * planes, 1),
                               ("downsample.0", inplanes, 4 * planes, 1)):
        RW[f"l.{conv}.weight"] = torch.randn((cout, cin, k, k), generator=g) * 0.02
        bn = "downsample.1" if conv == "downsample.0" else "bn" + conv[-1]
        for leaf, value in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                            ("running_var", 1.0)):
            RW[f"l.{bn}.{leaf}"] = torch.full((cout,), value)
    x = torch.randn((1, inplanes, 72, 72), generator=g)
    assert _counted(lambda: clip.bottleneck(x, RW, "l.", 2)) == flops.bottleneck_flops(
        RN["vision"], 2, 0)


def test_whole_towers_and_least_times():
    assert abs(flops.vit_flops(VIT["vision"]) / 1e9 - 35.28) < 0.01
    assert flops.vit_params(VIT["vision"]) == 86_192_640
    tower = flops.image_tower(VIT, 128)
    assert peaks.least_time_s(tower) == tower.flops["bf16"] / 989e12   # bound by operations
    call = flops.serve_call(VIT, 15_536, 10)
    assert peaks.least_time_s(call) == call.bytes / 3.35e12              # bound by bytes
