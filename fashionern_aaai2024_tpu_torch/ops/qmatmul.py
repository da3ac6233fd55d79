"""Dynamic symmetric int8 quantization for the int8 serving tier.

JAX counterpart: `fashionern_aaai2024_tpu/ops/qmatmul.py` (`:28-61`),
a copy in PyTorch with the same layouts at the public functions:

  * `quantize_rowwise(x)`: [..., K] -> (int8 values, [..., 1] fp32
    scales), one scale per row (activations);
  * `quantize_colwise(w)`: [K, N] -> (int8, [1, N] fp32), one scale per
    output column (weights in the JAX layout);
  * `int8_matmul(x, w, bias)`: both quantized, int32 product, fp32
    rescale.

The rule: scale = max(absmax, 1e-8) / 127; values = clip(round(x /
scale), -127, 127), round half to even (`torch.round`, as `jnp.round`),
a true division, never a multiply by a reciprocal.

`int8_product` is the exact int32 product of two int8 matrices,
returned as fp32 after one rounding of each int32 sum (as `.astype(
jnp.float32)` of the int32 `dot_general`). It multiplies in float64,
where every such product is exact (|sum| <= K * 127^2 < 2^53); the
conversion of the exact sum to fp32 is the same round-to-nearest-even as
int32 -> fp32. It is the plain version's product and the gallery
search's (`ops/quant.py`); the kernels of B5 and B6 run theirs on the
int8 tensor cores (`csrc/qgemm.cu`).
"""

from __future__ import annotations

import torch

from fashionern_aaai2024_tpu_torch.ops import library

_EPS = 1e-8


def quantize_rowwise(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., K] float -> (int8 values, [..., 1] fp32 scales)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True).clamp_min(_EPS)
    # a tensor divisor: PyTorch divides a CUDA tensor by a Python scalar
    # through the scalar's reciprocal, which is not the IEEE quotient
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_colwise(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[K, N] float -> (int8 values, [1, N] fp32 scales) per out-channel."""
    q, scale = quantize_rowwise(w.t())
    return q.t(), scale.t()


def _int8_product_fake(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    return a.new_empty((*a.shape[:-1], bt.shape[0]), dtype=torch.float32)


@library.exportable(_int8_product_fake)
def int8_product(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """a int8 [..., K] . bt int8 [N, K]^T -> the int32 sums as fp32."""
    return (a.double() @ bt.double().t()).float()


def int8_matmul(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x [..., K] float; w [K, N] float -> [..., N]: both dynamically
    quantized, the int32 product rescaled in fp32 (`qmatmul.py:44-61`)."""
    xq, xs = quantize_rowwise(x)
    wq, ws = quantize_colwise(w)
    y = int8_product(xq, wq.t()) * xs * ws
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype or x.dtype)
