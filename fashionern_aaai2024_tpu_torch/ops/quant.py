"""Int8 gallery quantization for retrieval serving (`--quantize-gallery`).

JAX counterpart: `fashionern_aaai2024_tpu/ops/quant.py`: `quantize_rows`
and `dequantize_rows` (`:24-36`) and the exact tier of
`blocked_top_k_similarity_int8` (`:53-117`) with its approximate tier
(`approx_recall`, `ops/similarity.py select_top_k`). `quantize_rows`
on a CPU tensor is also JAX's host twin `quantize_rows_np` (`:39-51`):
the gallery and the serve program's reference rows are quantized on the
host, so that only int8 bytes and scales go to the device.

The gallery recipe differs from the activations' (`ops/qmatmul.py`):
scale = absmax / 127, or 1.0 for an all-zero row. Both divisions are
IEEE quotients on every device (a tensor divisor: PyTorch divides a
CUDA tensor by a Python scalar through its reciprocal), so the host and
the device quantize alike.

The search quantizes the queries per row, takes the int8 x int8 product
of each gallery chunk as exact int32 sums (`ops/qmatmul.py
int8_product`), rescales them in fp32 by (query scale, gallery scale),
and keeps a running top-k through `ops/similarity.py`'s selection and
merge, so ties break as in the fp32 search. In JAX this product was an
XLA `dot_general`, not a Pallas kernel; here it is a library product.
"""

from __future__ import annotations

import torch

from fashionern_aaai2024_tpu_torch.ops.qmatmul import int8_product
from fashionern_aaai2024_tpu_torch.ops.similarity import _auto_chunk, chunked_top_k, pad_rows


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, d] float -> (int8 values [N, d], fp32 scales [N]) with
    x ~ values * scales[:, None]."""
    absmax = x.abs().amax(dim=-1)
    scales = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                         1.0).to(torch.float32)
    q = torch.clamp(torch.round(x / scales[:, None]), -127, 127).to(torch.int8)
    return q, scales


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return q.float() * scales[:, None]


def blocked_top_k_similarity_int8(queries: torch.Tensor, gallery_q: torch.Tensor,
                                  gallery_scales: torch.Tensor, k: int = 51,
                                  chunk: int | None = None,
                                  approx_recall: float | None = None
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k cosine similarity of queries [Q, d] against an int8 gallery
    (values [N, d], scales [N]) -> (scores [Q, k] fp32 descending,
    gallery rows [Q, k] int64). Chunks as in `blocked_top_k_similarity`:
    the last one zero-padded (values and scales), its pad columns
    masked. `approx_recall` as in `blocked_top_k_similarity`."""
    q_vals, q_scales = quantize_rows(queries.float())
    n = gallery_q.shape[0]
    chunk = _auto_chunk(q_vals.shape[0], n) if chunk is None else min(chunk, n)

    def score_chunk(start: int, size: int) -> torch.Tensor:
        acc = int8_product(q_vals, pad_rows(gallery_q[start:start + size], size))
        sc = pad_rows(gallery_scales[start:start + size], size)
        return acc * q_scales[:, None] * sc[None, :]

    return chunked_top_k(score_chunk, n, min(k, n), chunk, approx_recall)
