"""Attention for the port: kernels B1 and B3, and the plain formulas.

JAX counterpart: `fashionern_aaai2024_tpu/ops/attention.py`.

  * `attention_subblock` (B1, TPU kernel `_subblock_pallas`, `:520`):
    x + out_proj(attention(qkv_proj(LN(x)))). On a CUDA tensor it runs
    four hand-written kernels (csrc/): LN, GEMM + bias, the attention
    core, GEMM + bias + residual. The TPU held both weight matrices in
    VMEM for one program per image; 227 KB of shared memory cannot, so
    the program is split where the data reuse changes.
  * `packed_qkv_self_attention` (B3, TPU kernel `_packed_pallas`,
    `:147`): attention straight from packed [B, S, 3W] qkv
    (csrc/attention.cu). It is also B1's attention core: B1 calls it,
    so each B1 launch counts one B3 launch too.
  * `packed_kv_cross_attention`, `multi_head_attention` and
    `fused_qkv_self_attention` are plain PyTorch, the `_packed_cross_ref`,
    `_mha_ref` and `_qkv_fused_ref` formulas: on the TPU their call
    sites ran on XLA (`:353`, `:739`, and the bf16-only gate at `:466`
    that the fp32 fusion stack never passed). `multi_head_attention`
    also carries the train mode's probability dropout.

Weights are in the torch layout: in_proj_weight [3W, W] and Linear
weight [out, in].

Each kernel has a plain version beside it with the Pallas kernel's
rounding points (LN output cast to x.dtype, bias added to the fp32
accumulator before the cast, probabilities normalized in fp32 then cast,
each head's output cast, the projection cast before `x + proj`). A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fashionern_aaai2024_tpu_torch.ops import common
from fashionern_aaai2024_tpu_torch.ops.dropout import dropout

NEG_INF = -1e30
_HEAD_DIM = 64
_MAX_SEQ = 256


def causal_bias(s: int, device: torch.device | str) -> torch.Tensor:
    """[S, S] fp32: 0 on and below the diagonal, -1e30 above."""
    keep = torch.ones((s, s), dtype=torch.bool, device=device).tril()
    return torch.where(keep, 0.0, NEG_INF).to(torch.float32)


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, w = t.shape
    return t.reshape(b, s, heads, w // heads).transpose(1, 2)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    b, h, s, dh = t.shape
    return t.transpose(1, 2).reshape(b, s, h * dh)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = False, scale: float | None = None,
                         dropout_rate: float = 0.0,
                         generator: torch.Generator | None = None) -> torch.Tensor:
    """[B, H, S, Dh] attention, the `_mha_ref` formula (`:636`): scores
    in the operand dtype, softmax in fp32, probabilities cast back, then
    probability dropout when a generator is given (`:648-650`)."""
    sq, sk, dh = q.shape[2], k.shape[2], q.shape[3]
    if scale is None:
        scale = dh ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * torch.tensor(scale, dtype=q.dtype)
    if causal:
        s = s + causal_bias(sq, q.device)[:, :sk].to(s.dtype)
    p = torch.softmax(s.float(), dim=-1).to(v.dtype)
    p = dropout(p, dropout_rate, generator)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)


def packed_kv_cross_attention(q: torch.Tensor, kv: torch.Tensor, heads: int, *,
                              scale: float | None = None) -> torch.Tensor:
    """q [B, Sq, W], kv [B, Sk, 2W] (k | v) -> [B, Sq, W];
    `_packed_cross_ref` (`:286`)."""
    w = q.shape[-1]
    o = multi_head_attention(_split_heads(q, heads), _split_heads(kv[..., :w], heads),
                             _split_heads(kv[..., w:], heads), scale=scale)
    return _merge_heads(o)


def fused_qkv_self_attention(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                             heads: int, *, causal: bool = False,
                             scale: float | None = None) -> torch.Tensor:
    """QKV projection + self-attention, `_qkv_fused_ref` (`:409`).
    x [B, S, W], weight [3W, W], bias [3W]. Plain PyTorch: the mini-BERT
    that calls it runs in fp32, where the TPU never took kernel B7."""
    qkv = F.linear(x, weight, bias)
    w = x.shape[-1]
    o = multi_head_attention(_split_heads(qkv[..., :w], heads),
                             _split_heads(qkv[..., w:2 * w], heads),
                             _split_heads(qkv[..., 2 * w:], heads),
                             causal=causal, scale=scale)
    return _merge_heads(o)


# --- B3: packed-qkv self-attention ---------------------------------------


def packed_qkv_self_attention_plain(qkv: torch.Tensor, heads: int, *,
                                    causal: bool = False, scale: float | None = None,
                                    out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of B3 with `_packed_kernel`'s rounding points
    (`:124-143`): fp32 scores and softmax, p / denom cast to the qkv
    dtype, fp32 P.V, output cast to `out_dtype` (default: the qkv dtype;
    B6 keeps it fp32)."""
    b, s, w3 = qkv.shape
    w = w3 // 3
    dh = w // heads
    if scale is None:
        scale = dh ** -0.5
    q, k, v = (_split_heads(t, heads).float() for t in qkv.split(w, dim=-1))
    sc = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        sc = sc + causal_bias(s, qkv.device)
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(qkv.dtype).float()
    return _merge_heads(torch.matmul(p, v).to(out_dtype or qkv.dtype))


def packed_qkv_self_attention(qkv: torch.Tensor, heads: int, *, causal: bool = False,
                              scale: float | None = None) -> torch.Tensor:
    """Self-attention from packed qkv [B, S, 3W] -> [B, S, W] (B3).

    CUDA: csrc/attention.cu, head dim 64 and S <= 256 only. CPU: the
    plain version."""
    if not common.is_cuda(qkv):
        return packed_qkv_self_attention_plain(qkv, heads, causal=causal, scale=scale)
    common.check_cuda_operands("packed_qkv_self_attention", qkv)
    out = launch_attention_core(qkv, heads, causal=causal, scale=scale, out_dtype=qkv.dtype)
    packed_qkv_self_attention.launches += 1
    return out


def launch_attention_core(qkv: torch.Tensor, heads: int, *, causal: bool,
                          scale: float | None, out_dtype: torch.dtype) -> torch.Tensor:
    """The attention core kernel (csrc/attention.cu) on a checked CUDA
    qkv [B, S, 3W]; output in the qkv dtype or fp32 (B6). Counts nothing:
    its callers (B3, B6) do."""
    b, s, w3 = qkv.shape
    if w3 % 3 or w3 // 3 != heads * _HEAD_DIM:
        raise ValueError(f"packed_qkv_self_attention: qkv width {w3} with {heads} "
                         f"heads; the kernel takes head dim {_HEAD_DIM} only")
    if s > _MAX_SEQ:
        raise ValueError(f"packed_qkv_self_attention: S={s} > {_MAX_SEQ}")
    if scale is None:
        scale = _HEAD_DIM ** -0.5
    out = torch.empty((b, s, w3 // 3), dtype=out_dtype, device=qkv.device)
    common.launch("fern_attention", qkv.data_ptr(), out.data_ptr(), b, s, heads,
                  int(causal), scale, common.DTYPE_CODES[qkv.dtype],
                  common.DTYPE_CODES[out_dtype], qkv.device.index, common.stream_of(qkv))
    return out


packed_qkv_self_attention.launches = 0


# --- B1: the whole attention sub-block ----------------------------------


def attention_subblock_plain(x: torch.Tensor, ln_weight: torch.Tensor,
                             ln_bias: torch.Tensor, in_proj_weight: torch.Tensor,
                             in_proj_bias: torch.Tensor, out_weight: torch.Tensor,
                             out_bias: torch.Tensor, heads: int, *, causal: bool = False,
                             scale: float | None = None, eps: float = 1e-5) -> torch.Tensor:
    """Plain version of B1 with `_subblock_kernel`'s rounding points
    (`:479-515`)."""
    y = common.layer_norm(x, ln_weight, ln_bias, eps)
    qkv = F.linear(y.float(), in_proj_weight.float(), in_proj_bias.float()).to(x.dtype)
    o = packed_qkv_self_attention_plain(qkv, heads, causal=causal, scale=scale)
    proj = F.linear(o.float(), out_weight.float(), out_bias.float()).to(x.dtype)
    return x + proj


def attention_subblock(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                       in_proj_weight: torch.Tensor, in_proj_bias: torch.Tensor,
                       out_weight: torch.Tensor, out_bias: torch.Tensor, heads: int, *,
                       causal: bool = False, scale: float | None = None,
                       eps: float = 1e-5) -> torch.Tensor:
    """x + out_proj(attention(in_proj(LN(x)))) for x [B, S, W] (B1).

    in_proj_weight [3W, W], out_weight [W, W] (torch layout). CUDA:
    LN kernel -> GEMM + bias -> B3 core -> GEMM + bias + residual, all
    in x.dtype (fp32 or bf16) with every weight in the same dtype. CPU:
    the plain version."""
    if not common.is_cuda(x):
        return attention_subblock_plain(
            x, ln_weight, ln_bias, in_proj_weight, in_proj_bias, out_weight, out_bias,
            heads, causal=causal, scale=scale, eps=eps)
    b, s, w = x.shape
    if in_proj_weight.shape != (3 * w, w) or out_weight.shape != (w, w):
        raise ValueError(f"attention_subblock: weights {tuple(in_proj_weight.shape)}, "
                         f"{tuple(out_weight.shape)} for width {w}")
    common.check_cuda_operands("attention_subblock", x, ln_weight, ln_bias, in_proj_weight,
                               in_proj_bias, out_weight, out_bias)
    x2 = x.view(b * s, w)
    y = common.launch_layer_norm(x2, ln_weight, ln_bias, eps)
    qkv = common.launch_gemm(y, in_proj_weight, in_proj_bias)
    o = packed_qkv_self_attention(qkv.view(b, s, 3 * w), heads, causal=causal, scale=scale)
    out = common.launch_gemm(o.view(b * s, w), out_weight, out_bias, residual=x2)
    attention_subblock.launches += 1
    return out.view(b, s, w)


attention_subblock.launches = 0
