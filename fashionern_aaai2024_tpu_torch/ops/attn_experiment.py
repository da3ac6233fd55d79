"""The attention experiment's four kernels, X1-X4, and their plain versions.

JAX counterpart: `benchmarks/attn_experiment.py`, four Pallas kernels that
tried ways to fuse CLIP ViT attention at the bench batch (B=128, 12 heads
of 64, 197 tokens) on the TPU:

  * `mha_grouped` (X1, `:50`): G (batch, head) pairs a program over q
    padded to [BH, 208, 128] and k, v to [BH, 256, 128], with a shared
    fp32 [208, 256] bias that masks the padding. Here: the grouped kernel
    (csrc/attention_grouped.cu), which also runs B9 where the one-pass
    core does not (`ops/attention.py multi_head_attention`).
  * `mha_packed` (X2, `:168`): attention straight from packed [B, 208, 3W]
    qkv with a shared [208, 208] bias, gb images a program. Here: B3
    (`ops/attention.py packed_qkv_self_attention`) with the bias and gb
    images a block.
  * `qkvattn` (X3, `:257`): x [B, S, W] (post-LN) -> QKV projection +
    bias -> per-head attention with a shared [S, S] bias. Here: B7
    (`fused_qkv_self_attention`) with the bias.
  * `attnblock` (X4, `:364`): LN -> QKV -> attention -> out-projection +
    residual. Here: B1 (`attention_subblock`) with the bias.

X2-X4 are adapters: they take the experiment's arguments, derive the
heads from the width, and call B3, B7 or B1 with `attn_bias`; each keeps
its own launch count beside the one B3, B7 or B1 counts.

Weights are in the torch layout: w_qkv [3W, W], w_out [W, W]
(`models/convert.py attn_experiment_params_from_jax` carries the JAX
[in, out] arrays over). Heads are DH = 64 wide, as the Pallas kernels
slice them.

Each kernel has a plain version with the Pallas kernel's rounding points
(those of B9, B3, B7 and B1's plain versions: fp32 scores times the
scale plus the fp32 bias, p / denom cast to the operand dtype, fp32 P.V;
the projections in fp32 with their bias added before the cast to
x.dtype). A CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. `attention_ref` is `xla_ref` (`:76`), the
experiment's XLA yardstick, whose scores round to the operand dtype.
"""

from __future__ import annotations

import torch

from fashionern_aaai2024_tpu_torch.ops import attention as A
from fashionern_aaai2024_tpu_torch.ops import common

# the experiment's shapes: CLIP ViT-B-16 attention at the bench batch
B, H, S, DH = 128, 12, 197, 64
SP = 208   # S padded to the TPU's bf16 sublane tile (16)
SKP = 256  # the key side padded to the TPU's lanes
DP = 128   # the head dim padded to the TPU's lanes
W = H * DH
LN_EPS = 1e-5


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """`xla_ref`: q, k, v [BH, S, Dh]; scores in the operand dtype, times
    the scale in that dtype, softmax in fp32 cast to v.dtype, P.V in the
    operand dtype."""
    s = torch.einsum("bqd,bkd->bqk", q, k) * torch.tensor(scale, dtype=q.dtype)
    p = torch.softmax(s.float(), dim=-1).to(v.dtype)
    return torch.einsum("bqk,bkd->bqd", p, v)


def _check_divides(name: str, n: int, per_program: int, what: str) -> None:
    if per_program < 1 or n % per_program:
        raise ValueError(f"{name}: {per_program} {what} a program do not divide {n}")


def _heads(name: str, width: int) -> int:
    if width % DH:
        raise ValueError(f"{name}: width {width} is not a whole number of {DH}-wide heads")
    return width // DH


# --- X1: G (batch, head) pairs a program ---------------------------------


def mha_grouped_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias: torch.Tensor | None, scale: float, g: int) -> torch.Tensor:
    """Plain version of X1 (`_kernel`, `:30-46`); g only has to divide BH."""
    _check_divides("mha_grouped", q.shape[0], g, "pairs")
    return A.mha_plain(q, k, v, bias, scale)


def mha_grouped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor | None,
                scale: float, g: int) -> torch.Tensor:
    """q [BH, Sq, D], k and v [BH, Sk, D], bias fp32 [Sq, Sk] or None ->
    [BH, Sq, D] in q's dtype (X1), g pairs a program.

    CUDA: csrc/attention_grouped.cu, D even and at most 128, any Sk. CPU:
    the plain version."""
    if not common.is_cuda(q):
        return mha_grouped_plain(q, k, v, bias, scale, g)
    bh, sq, dh = q.shape
    sk = k.shape[1]
    if k.shape != (bh, sk, dh) or v.shape != k.shape:
        raise ValueError(f"mha_grouped: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; expected [BH, S, D] with shared BH and D")
    common.check_cuda_operands("mha_grouped", q, k, v)
    _check_divides("mha_grouped", bh, g, "pairs")
    out = A.launch_grouped_attention("mha_grouped", q, k, v, bias, batch=bh, heads=1, dh=dh,
                                     sq=sq, sk=sk, q_ld=dh, kv_ld=dh, group=g, split_rows=False,
                                     scale=scale)
    mha_grouped.launches += 1
    return out


mha_grouped.launches = 0


# --- X2: attention from packed qkv, gb images a program ------------------


def mha_packed_plain(qkv: torch.Tensor, bias: torch.Tensor | None, scale: float,
                     gb: int) -> torch.Tensor:
    """Plain version of X2 (`_packed_kernel`, `:147-165`)."""
    _check_divides("mha_packed", qkv.shape[0], gb, "images")
    return A.packed_qkv_self_attention_plain(qkv, _heads("mha_packed", qkv.shape[-1] // 3),
                                             scale=scale, attn_bias=bias)


def mha_packed(qkv: torch.Tensor, bias: torch.Tensor | None, scale: float,
               gb: int) -> torch.Tensor:
    """qkv [B, S, 3W], bias fp32 [S, S] or None -> [B, S, W] (X2), heads
    of 64, gb images a program.

    CUDA: B3 with the bias, gb images a block, S <= 256; B % gb != 0
    raises (the Pallas grid of B // gb would leave the last images
    unwritten). CPU: the plain version."""
    if not common.is_cuda(qkv):
        return mha_packed_plain(qkv, bias, scale, gb)
    _check_divides("mha_packed", qkv.shape[0], gb, "images")
    out = A.packed_qkv_self_attention(qkv, _heads("mha_packed", qkv.shape[-1] // 3),
                                      scale=scale, attn_bias=bias, images_per_block=gb)
    mha_packed.launches += 1
    return out


mha_packed.launches = 0


# --- X3: QKV projection + attention --------------------------------------


def qkvattn_plain(x: torch.Tensor, w_qkv: torch.Tensor, b_qkv: torch.Tensor,
                  bias: torch.Tensor | None, scale: float) -> torch.Tensor:
    """Plain version of X3 (`_qkvattn_kernel`, `:230-254`): B7's."""
    return A.fused_qkv_self_attention_plain(x, w_qkv, b_qkv, _heads("qkvattn", x.shape[-1]),
                                            scale=scale, attn_bias=bias)


def qkvattn(x: torch.Tensor, w_qkv: torch.Tensor, b_qkv: torch.Tensor,
            bias: torch.Tensor | None, scale: float) -> torch.Tensor:
    """x [B, S, W] (post-LN), w_qkv [3W, W], b_qkv [3W], bias fp32 [S, S]
    or None -> [B, S, W] (X3).

    CUDA: B7 with the bias (GEMM + bias into packed qkv in x.dtype, then
    the attention core), S <= 256. CPU: the plain version."""
    if not common.is_cuda(x):
        return qkvattn_plain(x, w_qkv, b_qkv, bias, scale)
    out = A.fused_qkv_self_attention(x, w_qkv, b_qkv, _heads("qkvattn", x.shape[-1]),
                                     scale=scale, attn_bias=bias)
    qkvattn.launches += 1
    return out


qkvattn.launches = 0


# --- X4: the whole attention sub-block -----------------------------------


def attnblock_plain(x: torch.Tensor, g: torch.Tensor, be: torch.Tensor, w_qkv: torch.Tensor,
                    b_qkv: torch.Tensor, w_out: torch.Tensor, b_out: torch.Tensor,
                    bias: torch.Tensor | None, scale: float) -> torch.Tensor:
    """Plain version of X4 (`_attnblock_kernel`, `:324-361`): B1's."""
    return A.attention_subblock_plain(x, g, be, w_qkv, b_qkv, w_out, b_out,
                                      _heads("attnblock", x.shape[-1]), scale=scale,
                                      eps=LN_EPS, attn_bias=bias)


def attnblock(x: torch.Tensor, g: torch.Tensor, be: torch.Tensor, w_qkv: torch.Tensor,
              b_qkv: torch.Tensor, w_out: torch.Tensor, b_out: torch.Tensor,
              bias: torch.Tensor | None, scale: float) -> torch.Tensor:
    """x + out_proj(attention(qkv_proj(LN(x)))) for x [B, S, W] (X4), LN
    eps 1e-5, w_qkv [3W, W], w_out [W, W], bias fp32 [S, S] or None.

    CUDA: B1 with the bias (LN -> GEMM + bias -> the attention core ->
    GEMM + bias + residual), every operand in x.dtype. CPU: the plain
    version."""
    if not common.is_cuda(x):
        return attnblock_plain(x, g, be, w_qkv, b_qkv, w_out, b_out, bias, scale)
    out = A.attention_subblock(x, g, be, w_qkv, b_qkv, w_out, b_out,
                               _heads("attnblock", x.shape[-1]), scale=scale, eps=LN_EPS,
                               attn_bias=bias)
    attnblock.launches += 1
    return out


attnblock.launches = 0
