"""The MLP sub-block for the port: kernel B2 and its plain version.

JAX counterpart: `fashionern_aaai2024_tpu/ops/mlp.py` (`mlp_subblock`,
TPU kernel `_mlp_pallas` at `:121`):

    x + c_proj(act(c_fc(LN(x))))

On a CUDA tensor it runs three hand-written kernels (csrc/): LN, GEMM +
bias + activation, GEMM + bias + residual. The activation runs in fp32
in the first GEMM's epilogue and is cast to x.dtype, as the Pallas
kernel does off its accumulator. Both `quick_gelu` and exact erf `gelu`
run in the kernel: the TPU's lack of an erf lowering in Mosaic
(`mlp.py:211-215`) has no counterpart on the GPU.

The TPU kernel chunked the hidden axis (<= 1536 columns) to keep an fp32
[S, chunk] transient in VMEM; here the hidden [B*S, F] activations go
through device memory once in x.dtype, and each GEMM tiles its own
operands.

Weights are in the torch layout: c_fc weight [F, W], c_proj weight
[W, F].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fashionern_aaai2024_tpu_torch.ops import common
from fashionern_aaai2024_tpu_torch.ops.layernorm import layer_norm_plain


def act_f32(h: torch.Tensor, name: str) -> torch.Tensor:
    """`_act_f32` (`mlp.py:50`)."""
    if name == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    if name == "gelu":
        return F.gelu(h)
    raise ValueError(f"unknown activation {name!r}")


def mlp_subblock_plain(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                       fc_weight: torch.Tensor, fc_bias: torch.Tensor,
                       proj_weight: torch.Tensor, proj_bias: torch.Tensor, *,
                       activation: str = "quick_gelu", eps: float = 1e-5) -> torch.Tensor:
    """Plain version of B2 with `_mlp_kernel`'s rounding points
    (`mlp.py:94-115`)."""
    y = layer_norm_plain(x, ln_weight, ln_bias, eps)
    h = F.linear(y.float(), fc_weight.float(), fc_bias.float())
    h = act_f32(h, activation).to(x.dtype)
    o = F.linear(h.float(), proj_weight.float(), proj_bias.float()).to(x.dtype)
    return x + o


def mlp_subblock(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                 fc_weight: torch.Tensor, fc_bias: torch.Tensor, proj_weight: torch.Tensor,
                 proj_bias: torch.Tensor, *, activation: str = "quick_gelu",
                 eps: float = 1e-5) -> torch.Tensor:
    """x + c_proj(act(c_fc(LN(x)))) for x [B, S, W] (B2). CUDA: the
    kernels, in x.dtype (fp32 or bf16) with every weight in the same
    dtype. CPU: the plain version."""
    if activation not in ("quick_gelu", "gelu"):
        raise ValueError(f"unknown activation {activation!r}")
    if not common.is_cuda(x):
        return mlp_subblock_plain(x, ln_weight, ln_bias, fc_weight, fc_bias, proj_weight,
                                  proj_bias, activation=activation, eps=eps)
    b, s, w = x.shape
    f = fc_weight.shape[0]
    if fc_weight.shape != (f, w) or proj_weight.shape != (w, f):
        raise ValueError(f"mlp_subblock: weights {tuple(fc_weight.shape)}, "
                         f"{tuple(proj_weight.shape)} for width {w}")
    common.check_cuda_operands("mlp_subblock", x, ln_weight, ln_bias, fc_weight, fc_bias,
                               proj_weight, proj_bias)
    x2 = x.view(b * s, w)
    y = common.launch_layer_norm(x2, ln_weight, ln_bias, eps)
    h = common.launch_gemm(y, fc_weight, fc_bias, activation=activation)
    out = common.launch_gemm(h, proj_weight, proj_bias, residual=x2)
    mlp_subblock.launches += 1
    return out.view(b, s, w)


mlp_subblock.launches = 0
