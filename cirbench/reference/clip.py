"""The CLIP towers in plain fp32 PyTorch: the benchmark's reference.

Written from OpenAI CLIP's `clip/model.py` (VisionTransformer,
ModifiedResNet with its AttentionPool2d, the causal text transformer)
with the FashionERN port's conventions for what the towers return:
  * the image towers return (global [B, d], tokens [B, S, d]): the ViT
    projects every token (global = the class token), the ResNet's
    attention pool returns c_proj of its output at the mean token and
    c_proj of v at every position;
  * the text tower returns (global [B, d], seq [B, L, d]): every
    position projected, global at the EOT position (argmax of the ids).

Weights are a dict of tensors under open_clip's state-dict names
(`visual.*`, `transformer.*`, `token_embedding.weight`, ...), the layout
the benchmark draws. Nothing here imports the program under test.
Images come in NHWC, CLIP-normalized, fp32. `W` may hold the weights in
any float dtype: every product runs in fp32 (`f32`), unless `ops`
(`reference/ops.py`) rounds its operands first.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cirbench.reference.ops import PLAIN, Ops

LN_EPS = 1e-5


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = LN_EPS):
    return F.layer_norm(x, (x.shape[-1],), f32(w), f32(b), eps)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if kind == "gelu":
        return F.gelu(x)
    raise ValueError(f"unknown activation {kind!r}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              causal: bool = False, ops: Ops = PLAIN, drop=None, rate: float = 0.0
              ) -> torch.Tensor:
    """Multi-head scaled dot-product attention of [B, Sq, W] against
    [B, Sk, W] -> [B, Sq, W]; scale head_dim^-0.5; `drop(p, rate)` on the
    probabilities where given (train mode)."""
    b, sq, w = q.shape
    sk = k.shape[1]
    dh = w // heads
    qh = q.reshape(b, sq, heads, dh).transpose(1, 2)
    kh = k.reshape(b, sk, heads, dh).transpose(1, 2)
    vh = v.reshape(b, sk, heads, dh).transpose(1, 2)
    s = ops.matmul(qh, kh.transpose(-1, -2)) * dh ** -0.5
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    if drop is not None:
        p = drop(p, rate)
    return ops.matmul(p, vh).transpose(1, 2).reshape(b, sq, w)


def residual_block(x: torch.Tensor, W: dict, pre: str, heads: int, act: str,
                   causal: bool, ops: Ops = PLAIN) -> torch.Tensor:
    """open_clip ResidualAttentionBlock: x + attn(ln_1(x)), then
    x + c_proj(act(c_fc(ln_2(x))))."""
    y = layer_norm(x, W[pre + "ln_1.weight"], W[pre + "ln_1.bias"])
    qkv = ops.linear(y, W[pre + "attn.in_proj_weight"], W[pre + "attn.in_proj_bias"])
    q, k, v = qkv.chunk(3, dim=-1)
    o = attention(q, k, v, heads, causal, ops)
    x = x + ops.linear(o, W[pre + "attn.out_proj.weight"], W[pre + "attn.out_proj.bias"])
    y = layer_norm(x, W[pre + "ln_2.weight"], W[pre + "ln_2.bias"])
    h = activation(ops.linear(y, W[pre + "mlp.c_fc.weight"], W[pre + "mlp.c_fc.bias"]), act)
    return x + ops.linear(h, W[pre + "mlp.c_proj.weight"], W[pre + "mlp.c_proj.bias"])


def vit(images: torch.Tensor, W: dict, cfg: dict, act: str, ops: Ops = PLAIN):
    """ViT image tower: images [B, H, W, 3] -> (global [B, d], tokens [B, S, d])."""
    p, w = cfg["patch_size"], cfg["width"]
    x = ops.conv2d(images.permute(0, 3, 1, 2), W["visual.conv1.weight"], stride=p)
    x = x.flatten(2).transpose(1, 2)                              # [B, grid², w]
    cls = f32(W["visual.class_embedding"]).reshape(1, 1, w).expand(x.shape[0], 1, w)
    x = torch.cat([cls, x], dim=1) + f32(W["visual.positional_embedding"])
    x = layer_norm(x, W["visual.ln_pre.weight"], W["visual.ln_pre.bias"])
    for i in range(cfg["layers"]):
        x = residual_block(x, W, f"visual.transformer.resblocks.{i}.", cfg["heads"], act,
                           False, ops)
    x = layer_norm(x, W["visual.ln_post.weight"], W["visual.ln_post.bias"])
    tokens = ops.matmul(x, W["visual.proj"])
    return tokens[:, 0], tokens


def _conv_bn(x: torch.Tensor, W: dict, conv: str, bn: str, stride: int = 1,
             ops: Ops = PLAIN) -> torch.Tensor:
    k = W[conv + ".weight"].shape[-1]
    return ops.batch_norm(ops.conv2d(x, W[conv + ".weight"], stride=stride, padding=k // 2), W,
                          bn + ".")


def bottleneck(x: torch.Tensor, W: dict, pre: str, stride: int, ops: Ops = PLAIN):
    """CLIP's Bottleneck: 1x1, 3x3, (avg pool at stride 2), 1x1, each with
    its BatchNorm; the shortcut pooled and projected where the shape changes."""
    out = F.relu(_conv_bn(x, W, pre + "conv1", pre + "bn1", ops=ops))
    out = F.relu(_conv_bn(out, W, pre + "conv2", pre + "bn2", ops=ops))
    if stride > 1:
        out = F.avg_pool2d(out, stride)
    out = _conv_bn(out, W, pre + "conv3", pre + "bn3", ops=ops)
    identity = x
    if pre + "downsample.0.weight" in W:
        if stride > 1:
            identity = F.avg_pool2d(identity, stride)
        identity = _conv_bn(identity, W, pre + "downsample.0", pre + "downsample.1", ops=ops)
    return F.relu(out + identity)


def resnet_trunk(images: torch.Tensor, W: dict, cfg: dict, ops: Ops = PLAIN) -> torch.Tensor:
    """The stem and the four stages: [B, H, W, 3] -> [B, 32 width, H/32, W/32]."""
    x = images.permute(0, 3, 1, 2)
    for i, stride in ((1, 2), (2, 1), (3, 1)):
        x = F.relu(_conv_bn(x, W, f"visual.conv{i}", f"visual.bn{i}", stride, ops))
    x = F.avg_pool2d(x, 2)
    for i, blocks in enumerate(cfg["layers"]):
        for j in range(blocks):
            x = bottleneck(x, W, f"visual.layer{i + 1}.{j}.", 2 if (i > 0 and j == 0) else 1,
                           ops)
    return x


def attention_pool(x: torch.Tensor, W: dict, heads: int, ops: Ops = PLAIN):
    """CLIP's AttentionPool2d with every token kept: x [B, C, h, w] ->
    (c_proj(attn(mean token)) [B, d], c_proj(v) at every token [B, 1 + hw, d])."""
    b, c = x.shape[:2]
    x = x.flatten(2).transpose(1, 2)                              # (h, w) order
    x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1) + f32(
        W["visual.attnpool.positional_embedding"])
    pre = "visual.attnpool."
    q = ops.linear(x[:, :1], W[pre + "q_proj.weight"], W[pre + "q_proj.bias"])
    k = ops.linear(x, W[pre + "k_proj.weight"], W[pre + "k_proj.bias"])
    v = ops.linear(x, W[pre + "v_proj.weight"], W[pre + "v_proj.bias"])
    o = attention(q, k, v, heads, ops=ops)
    c_w, c_b = W[pre + "c_proj.weight"], W[pre + "c_proj.bias"]
    return ops.linear(o, c_w, c_b)[:, 0], ops.linear(v, c_w, c_b)


def resnet(images: torch.Tensor, W: dict, cfg: dict, ops: Ops = PLAIN):
    """ModifiedResNet image tower -> (global [B, d], tokens [B, 1 + hw, d])."""
    return attention_pool(resnet_trunk(images, W, cfg, ops), W, cfg["heads"], ops)


def image_tower(images: torch.Tensor, W: dict, config: dict, ops: Ops = PLAIN):
    vision = config["vision"]
    if vision["kind"] == "vit":
        return vit(images, W, vision, config["activation"], ops)
    return resnet(images, W, vision, ops)


def text_tower(ids: torch.Tensor, W: dict, config: dict, ops: Ops = PLAIN):
    """ids [B, L] (int) -> (global [B, d] at the EOT position, seq [B, L, d])."""
    cfg = config["text"]
    x = f32(W["token_embedding.weight"])[ids.long()] + f32(W["positional_embedding"])
    for i in range(cfg["layers"]):
        x = residual_block(x, W, f"transformer.resblocks.{i}.", cfg["heads"],
                           config["activation"], True, ops)
    x = layer_norm(x, W["ln_final.weight"], W["ln_final.bias"])
    seq = ops.matmul(x, W["text_projection"])
    eot = ids.long().argmax(dim=-1)
    return seq[torch.arange(seq.shape[0], device=seq.device), eot], seq


def normalize_uint8(images: torch.Tensor) -> torch.Tensor:
    """CLIP normalization of uint8 NHWC pixels: (x / 255 - mean) / std, fp32."""
    mean = torch.tensor(CLIP_MEAN, device=images.device)
    std = torch.tensor(CLIP_STD, device=images.device)
    return (images.float() / 255.0 - mean) / std


CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
