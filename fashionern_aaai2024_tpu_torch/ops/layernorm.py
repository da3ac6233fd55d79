"""LayerNorm for the port: kernel B11 and its plain version.

JAX counterpart: `fashionern_aaai2024_tpu/ops/layernorm.py` (`layer_norm`,
TPU kernel `_layer_norm_pallas` at `:46`, body `_ln_kernel` `:27-34`).
Row LayerNorm over the last axis with fp32 statistics and the output in
x.dtype: eps 1e-5 in the CLIP towers, 1e-12 in the mini-BERT.

`layer_norm` is every standalone LN of the port: the ViT's ln_pre and
ln_post, the text tower's ln_final and the BERT's embedding LN and its
two post-LNs per layer. (The LNs inside B1, B2, B5 and B6 are pieces of
those kernels.) On the TPU its dispatch kept XLA (`:92`); here a CUDA
tensor launches `csrc/layernorm.cu` over its rows, seen as one flat
[rows, W] buffer (no view is taken), for any row count and width: one
warp a row with the row in registers (`csrc/layernorm_row.cuh`), and a
CPU tensor takes `layer_norm_plain`.

The BERT's LNs carry gradients in the train step, so there the CUDA
launch goes through `LayerNormFunction`, a `torch.autograd.Function`
whose forward is the kernel and whose backward differentiates the plain
version, recomputed from the saved inputs: the pattern of the JAX
kernels' custom VJPs (`ops/attention.py:424-430`) and of B4
(`ops/losses.py BBCMeanLoss`). Where no gradient is wanted (the frozen
towers, the serve path) the kernel is launched without it.
"""

from __future__ import annotations

import torch

from fashionern_aaai2024_tpu_torch.ops import common


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """The `_ln_kernel` formula: fp32 mean and variance (of the centred
    values), (x - mean) * rsqrt(var + eps) * weight + bias in fp32, the
    result cast to x.dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype)


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            eps: float) -> torch.Tensor:
    common.check_cuda_operands("layer_norm", x, weight, bias)
    return common.launch_layer_norm(x, weight, bias, eps)


class LayerNormFunction(torch.autograd.Function):
    """Forward: the LN kernel. Backward: autograd of `layer_norm_plain`."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
        ctx.save_for_backward(x, weight, bias)
        ctx.eps = eps
        return _launch(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        saved = [t.detach().requires_grad_(need)
                 for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in saved if t.requires_grad]
        with torch.enable_grad():
            y = layer_norm_plain(*saved, ctx.eps)
        grads = iter(torch.autograd.grad(y, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in saved), None)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm of x [..., W] (B11). CUDA: the kernel, fp32 or bf16,
    weight and bias [W] in x.dtype; through `LayerNormFunction` when
    autograd has to reach an operand, else launched straight away (the
    serve path's inference mode). CPU: the plain version."""
    if not common.is_cuda(x):
        return layer_norm_plain(x, weight, bias, eps)
    width = x.shape[-1]
    if weight.shape != (width,) or bias.shape != (width,):
        raise ValueError(f"layer_norm: weight {tuple(weight.shape)}, bias "
                         f"{tuple(bias.shape)} for width {width}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        out = LayerNormFunction.apply(x, weight, bias, eps)
    else:
        out = _launch(x, weight, bias, eps)
    layer_norm.launches += 1
    return out


layer_norm.launches = 0
