"""Retrieval similarity + exact top-k.

JAX counterpart: `fashionern_aaai2024_tpu/ops/similarity.py`, the exact
tier of `blocked_top_k_similarity` (`:65`) and `merge_top_k` (`:137`).
The TPU ran these on XLA; here they are plain PyTorch. The approximate
tier (`lax.approx_max_k`, a TPU hardware reduction) is not ported.

Ties go to the lower gallery row, as `lax.top_k` breaks them: selection
is a stable descending sort, because `torch.topk` leaves the order of
equal scores unspecified.
"""

from __future__ import annotations

from typing import Callable

import torch

_CHUNK_BUDGET_BYTES = 1 << 30  # ~1 GB of fp32 score matrix per scan step


def _auto_chunk(q: int, n: int) -> int:
    """Largest chunk whose [Q, chunk] fp32 score tile fits the budget."""
    return max(8192, min(n, _CHUNK_BUDGET_BYTES // (4 * max(q, 1))))


def stable_top_k(s: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along dim 1, descending, lower column first among ties."""
    order = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(s, 1, order), order


def merge_top_k(scores: torch.Tensor, indices: torch.Tensor,
                k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of candidate (scores, indices) along dim 1: higher score
    first, then smaller gallery index."""
    order = torch.sort(indices, dim=1, stable=True).indices
    s = torch.gather(scores, 1, order)
    i = torch.gather(indices, 1, order)
    top_s, pos = stable_top_k(s, k)
    return top_s, torch.gather(i, 1, pos)


def pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """`t` with zero rows appended up to `rows`."""
    if t.shape[0] == rows:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0], *t.shape[1:]))])


def chunked_top_k(score_chunk: Callable[[int, int], torch.Tensor], n: int, k: int,
                  chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Running exact top-k over a gallery of `n` rows scanned in chunks.
    `score_chunk(start, chunk)` gives the [Q, chunk] scores of rows
    start:start + chunk, the rows past the gallery's end zero-padded;
    their columns are masked to -inf here."""
    best_s = best_i = None
    for start in range(0, n, chunk):
        valid = min(chunk, n - start)
        s = score_chunk(start, chunk)
        s[:, valid:] = -torch.inf
        cs, ci = stable_top_k(s, min(k, chunk))
        ci = ci + start
        if best_s is None:
            best_s, best_i = cs, ci
        else:
            best_s, best_i = merge_top_k(torch.cat([best_s, cs], dim=1),
                                         torch.cat([best_i, ci], dim=1), k)
    return best_s, best_i


def blocked_top_k_similarity(queries: torch.Tensor, gallery: torch.Tensor, k: int = 51,
                             chunk: int | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k cosine similarity of queries [Q, d] against gallery [N, d]
    (both L2-normalized by the caller). Returns (scores [Q, k] fp32
    descending, gallery rows [Q, k] int64). The gallery is scanned in
    chunks so the score tile stays bounded; each chunk's candidates are
    merged into the running top-k. As in JAX, the last chunk is
    zero-padded to full size and its pad columns masked to -inf: every
    chunk is then one product of one shape, so duplicate gallery rows
    score bit-identically wherever they sit and ties stay ties."""
    n = gallery.shape[0]
    chunk = _auto_chunk(queries.shape[0], n) if chunk is None else min(chunk, n)
    qf = queries.float()

    def score_chunk(start: int, size: int) -> torch.Tensor:
        return qf @ pad_rows(gallery[start:start + size].float(), size).t()

    return chunked_top_k(score_chunk, n, min(k, n), chunk)
