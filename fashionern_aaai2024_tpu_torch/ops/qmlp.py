"""The int8 sub-blocks of the `--quantize-towers` serving tier: kernels
B5 and B6 and their plain versions.

JAX counterpart: `fashionern_aaai2024_tpu/ops/qmlp.py`:

  * `int8_mlp_subblock` (B5, TPU kernel `_qmlp_pallas`, `:85`; kernel
    body `_qmlp_kernel`, `:50`): x + c_proj(act(c_fc(LN(x)))) with both
    products int8;
  * `int8_attention_subblock` (B6, `_qattn_pallas`, `:213`; body
    `_qattn_kernel`, `:168`): x + out_proj(attention(in_proj(LN(x))))
    with both projections int8 and the attention in x.dtype / fp32.

On a CUDA tensor each runs hand-written kernels (csrc/), four launches
for B5 and five for B6: B5 = LN + row int8 (`quant.cu`) -> int8 GEMM +
rescale + bias + activation, fp32 hidden (`qgemm.cu`) -> row int8 per
hidden group (`quant.cu`) -> one int8 GEMM over every group, each
group's rescaled product added to the earlier groups' fp32 sum in
registers, then the bias and the residual. B6 = LN + row int8 -> int8
GEMM + rescale + bias, cast to x.dtype -> the attention core with an
fp32 output (`attention.cu`) -> row int8 (one group) -> int8 GEMM +
rescale + bias + residual. The TPU kept the int8 weights resident in
VMEM for one program per row block; here they stream through shared
memory and stay hot in L2, and the program splits where a row's int8
scale needs the whole row (or hidden group), which no output tile sees.

Weights arrive quantized: int8 values in the torch layout [out, in] and
one fp32 scale per output row, i.e. `quantize_colwise` of the JAX
layout, transposed (`models/clip/transformer.py` keeps them cached).
JAX quantized the float weights in the graph on every call and XLA
hoisted it; the values are the same.

Rounding points follow the Pallas kernels, not their XLA twins
`_qmlp_ref` / `_qattn_ref`, which JAX runs off the TPU and at b < 8:
  * B5 quantizes the hidden activations per row and per hidden group of
    `pick_splits(F)` groups (2 at F = 3072 and F = 2048), and sums the
    groups' rescaled products in fp32 (`qmlp.py:63-78`); `_qmlp_ref`
    quantizes each whole hidden row. Exact `gelu` never reached the
    Pallas kernel (`qmlp.py:149-153`): with it the port uses one group,
    which is `_qmlp_ref`'s arithmetic.
  * B6 computes fp32 scores and keeps the attention output fp32 before
    quantizing it (`qmlp.py:191-202`); `_qattn_ref` rounds both to bf16
    in a bf16 tower. In fp32 the two agree. In an fp32 tower the TPU
    kernel's products ran at the MXU's default (bf16-pass) precision;
    the port computes them to fp32 accuracy (true fp32 on the CPU, as
    interpret mode does; 3xTF32 on the card).

Forward only, as in JAX: the CUDA path raises if grad mode is on and an
operand requires grad (`ops/common.py check_no_grad`).
"""

from __future__ import annotations

import torch

from fashionern_aaai2024_tpu_torch.ops import attention as A
from fashionern_aaai2024_tpu_torch.ops import common, library
from fashionern_aaai2024_tpu_torch.ops.mlp import act_f32
from fashionern_aaai2024_tpu_torch.ops.qmatmul import int8_product, quantize_rowwise

# hidden columns per group of the TPU kernel (`ops/mlp.py:46 _MAX_CHUNK`)
_MAX_CHUNK = 1536


def pick_splits(f: int) -> int:
    """`ops/mlp.py:58 _pick_splits`: the smallest group count whose
    group is <= 1536 columns, divides f and is a multiple of 128."""
    for splits in range(1, f // 128 + 1):
        if f % splits:
            continue
        chunk = f // splits
        if chunk <= _MAX_CHUNK and chunk % 128 == 0:
            return splits
    return 1


def hidden_groups(f: int, activation: str) -> int:
    """Hidden quantization groups of B5: the Pallas kernel's splits for
    quick_gelu; one group for exact gelu, which only `_qmlp_ref` ran."""
    return pick_splits(f) if activation == "quick_gelu" else 1


def ln_quantize(x2: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 LN (`qmlp.py:54-59`) then row int8 (`_quant_rows_f32`)."""
    xf = x2.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return quantize_rowwise(y)


# --- B5: the int8 MLP sub-block -----------------------------------------


def int8_mlp_subblock_plain(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                            fc_q: torch.Tensor, fc_scale: torch.Tensor, fc_bias: torch.Tensor,
                            proj_q: torch.Tensor, proj_scale: torch.Tensor,
                            proj_bias: torch.Tensor, *, activation: str = "quick_gelu",
                            eps: float = 1e-5) -> torch.Tensor:
    """Plain version of B5 with `_qmlp_kernel`'s rounding points."""
    b, s, w = x.shape
    f = fc_q.shape[0]
    x2 = x.reshape(b * s, w)
    yq, ys = ln_quantize(x2, ln_weight, ln_bias, eps)
    h = int8_product(yq, fc_q) * ys * fc_scale + fc_bias.float()
    h = act_f32(h, activation)
    groups = hidden_groups(f, activation)
    c = f // groups
    acc = None
    for i in range(groups):
        hq, hs = quantize_rowwise(h[:, c * i:c * (i + 1)])
        o = int8_product(hq, proj_q[:, c * i:c * (i + 1)]) * hs * proj_scale
        acc = o if acc is None else acc + o
    return (x2 + (acc + proj_bias.float()).to(x.dtype)).view(b, s, w)


@library.exportable(library.like)
def int8_mlp_subblock(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                      fc_q: torch.Tensor, fc_scale: torch.Tensor, fc_bias: torch.Tensor,
                      proj_q: torch.Tensor, proj_scale: torch.Tensor, proj_bias: torch.Tensor,
                      *, activation: str = "quick_gelu", eps: float = 1e-5) -> torch.Tensor:
    """x + c_proj(act(c_fc(LN(x)))) with int8 products, x [B, S, W] (B5).

    fc_q int8 [F, W] with fc_scale fp32 [F]; proj_q int8 [W, F] with
    proj_scale fp32 [W]; LN parameters and biases in x.dtype. CUDA: the
    kernels, x in fp32 or bf16. CPU: the plain version."""
    if activation not in ("quick_gelu", "gelu"):
        raise ValueError(f"unknown activation {activation!r}")
    if not common.is_cuda(x):
        return int8_mlp_subblock_plain(x, ln_weight, ln_bias, fc_q, fc_scale, fc_bias, proj_q,
                                       proj_scale, proj_bias, activation=activation, eps=eps)
    b, s, w = x.shape
    f = fc_q.shape[0]
    if fc_q.shape != (f, w) or proj_q.shape != (w, f):
        raise ValueError(f"int8_mlp_subblock: weights {tuple(fc_q.shape)}, "
                         f"{tuple(proj_q.shape)} for width {w}")
    common.check_cuda_operands("int8_mlp_subblock", x, ln_weight, ln_bias, fc_bias, proj_bias)
    common.check_int8_operands("int8_mlp_subblock", x.device, fc_q, fc_scale, proj_q,
                               proj_scale)
    x2 = x.view(b * s, w)
    yq, ys = common.launch_ln_quant(x2, ln_weight, ln_bias, eps)
    h = common.launch_qgemm(yq, ys, fc_q, fc_scale, bias=fc_bias, activation=activation,
                            out_dtype=torch.float32)
    groups = hidden_groups(f, activation)
    hq, hs = common.launch_quant_groups(h, groups)
    out = common.launch_qgemm(hq, hs, proj_q, proj_scale, groups=groups, bias=proj_bias,
                              residual=x2, out_dtype=x.dtype)
    common.count(int8_mlp_subblock)
    return out.view(b, s, w)


int8_mlp_subblock.launches = 0


# --- B6: the int8 attention sub-block ----------------------------------


def int8_attention_subblock_plain(x: torch.Tensor, ln_weight: torch.Tensor,
                                  ln_bias: torch.Tensor, qkv_q: torch.Tensor,
                                  qkv_scale: torch.Tensor, qkv_bias: torch.Tensor,
                                  out_q: torch.Tensor, out_scale: torch.Tensor,
                                  out_bias: torch.Tensor, heads: int, *, causal: bool = False,
                                  scale: float | None = None, eps: float = 1e-5
                                  ) -> torch.Tensor:
    """Plain version of B6 with `_qattn_kernel`'s rounding points."""
    b, s, w = x.shape
    x2 = x.reshape(b * s, w)
    yq, ys = ln_quantize(x2, ln_weight, ln_bias, eps)
    qkv = (int8_product(yq, qkv_q) * ys * qkv_scale + qkv_bias.float()).to(x.dtype)
    attn = A.packed_qkv_self_attention_plain(qkv.view(b, s, 3 * w), heads, causal=causal,
                                             scale=scale, out_dtype=torch.float32)
    aq, as_ = quantize_rowwise(attn.reshape(b * s, w))
    proj = int8_product(aq, out_q) * as_ * out_scale + out_bias.float()
    return (x2 + proj.to(x.dtype)).view(b, s, w)


@library.exportable(library.like)
def int8_attention_subblock(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                            qkv_q: torch.Tensor, qkv_scale: torch.Tensor,
                            qkv_bias: torch.Tensor, out_q: torch.Tensor,
                            out_scale: torch.Tensor, out_bias: torch.Tensor, heads: int, *,
                            causal: bool = False, scale: float | None = None,
                            eps: float = 1e-5) -> torch.Tensor:
    """x + out_proj(attention(in_proj(LN(x)))) with int8 projections,
    x [B, S, W] (B6).

    qkv_q int8 [3W, W] with qkv_scale fp32 [3W]; out_q int8 [W, W] with
    out_scale fp32 [W]. CUDA: the kernels, head dim 64 and S <= 256. CPU:
    the plain version."""
    if not common.is_cuda(x):
        return int8_attention_subblock_plain(x, ln_weight, ln_bias, qkv_q, qkv_scale,
                                             qkv_bias, out_q, out_scale, out_bias, heads,
                                             causal=causal, scale=scale, eps=eps)
    b, s, w = x.shape
    if qkv_q.shape != (3 * w, w) or out_q.shape != (w, w):
        raise ValueError(f"int8_attention_subblock: weights {tuple(qkv_q.shape)}, "
                         f"{tuple(out_q.shape)} for width {w}")
    common.check_cuda_operands("int8_attention_subblock", x, ln_weight, ln_bias, qkv_bias,
                               out_bias)
    common.check_int8_operands("int8_attention_subblock", x.device, qkv_q, qkv_scale, out_q,
                               out_scale)
    x2 = x.view(b * s, w)
    yq, ys = common.launch_ln_quant(x2, ln_weight, ln_bias, eps)
    qkv = common.launch_qgemm(yq, ys, qkv_q, qkv_scale, bias=qkv_bias, out_dtype=x.dtype)
    attn = A.launch_attention_core(qkv.view(b, s, 3 * w), heads, causal=causal, scale=scale,
                                   out_dtype=torch.float32)
    aq, as_ = common.launch_quant_groups(attn.view(b * s, w), 1)
    out = common.launch_qgemm(aq, as_, out_q, out_scale, bias=out_bias, residual=x2,
                              out_dtype=x.dtype)
    common.count(int8_attention_subblock)
    return out.view(b, s, w)


int8_attention_subblock.launches = 0
