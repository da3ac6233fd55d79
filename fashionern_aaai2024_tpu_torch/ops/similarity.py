"""Retrieval similarity + top-k: the exact tier and the approximate tier.

JAX counterpart: `fashionern_aaai2024_tpu/ops/similarity.py`:
`_select_top_k` (`:55-59`), `blocked_top_k_similarity` (`:65-135`),
`merge_top_k` (`:137`) and `measured_approx_recall` (`:154-200`). The
TPU ran these on XLA; here they are plain PyTorch. `lax.approx_max_k`
is an XLA operation, outside every Pallas kernel, so plain PyTorch is
its port too.

Ties go to the lower gallery row, as `lax.top_k` breaks them: selection
is a stable descending sort, because `torch.topk` leaves the order of
equal scores unspecified.

The approximate tier (`approx_recall`, `--topk-recall`). JAX lowers
`lax.approx_max_k` by platform: on the CPU to the exact sort with
`lax.top_k`'s tie-break (JAX `:22-24`), on the TPU to the PartialReduce
hardware operation. The port follows the tensor's device the same way:

  * a CPU tensor takes `stable_top_k`, bit for bit JAX's CPU answer,
    except at k = 1, where XLA's CPU fallback reduces to the last
    maximal column and so does the port;
  * a CUDA tensor takes the TPU's two-stage form (`folded_top_k`): the
    [Q, N] scores are padded with -inf to L * 2^r columns, folded into L
    bins by `amax`, the top-k of the L bin maxima is taken by
    `stable_top_k`, and each chosen bin maps back to the gallery row
    that held its maximum (the lowest such row on a tie). The bins are
    strided: bin j holds columns j, j + L, j + 2L, ... (the [2^r, L]
    view of the padded row, reduced over its first axis). (L, r) come
    from `reduction_output_size`, the port's copy of XLA's
    `ApproxTopKReductionOutputSize` for a rank-2 operand (128-lane
    tiling): it picks the fold so that the expected recall of uniformly
    spread scores is the target; `measured_approx_recall` measures the
    recall on a real gallery.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

_CHUNK_BUDGET_BYTES = 1 << 30  # ~1 GB of fp32 score matrix per scan step
_LANE_TILING = 128             # XLA's kTpuLaneTiling: the rank-2 operand's tile


def _auto_chunk(q: int, n: int) -> int:
    """Largest chunk whose [Q, chunk] fp32 score tile fits the budget."""
    return max(8192, min(n, _CHUNK_BUDGET_BYTES // (4 * max(q, 1))))


def stable_top_k(s: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along dim 1, descending, lower column first among ties."""
    order = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(s, 1, order), order


def _log2_floor(x: int) -> int:
    return x.bit_length() - 1 if x > 0 else 0


def _log2_ceiling(x: int) -> int:
    return (x - 1).bit_length() if x > 1 else 0


def reduction_output_size(n: int, k: int, recall_target: float) -> tuple[int, int]:
    """(L, r): the bins the approximate top-k folds `n` scores into, and
    log2 of the columns per bin (r = 0: no fold, the exact top-k). XLA's
    rule for a rank-2 operand reduced along its last axis, without an
    input size override; the recall target is a float32, as XLA takes
    it."""
    if n <= _LANE_TILING:
        return n, 0
    if k == 1:
        return _LANE_TILING, _log2_ceiling(-(-n // _LANE_TILING))
    recall = float(np.float32(recall_target))
    if recall == 1.0:
        return n, 0
    if not 0.0 < recall < 1.0:
        raise ValueError(f"recall_target {recall_target} should range in (0, 1]")
    m = min(max(int((1.0 - k) / math.log(recall)), _LANE_TILING), n)
    r = _log2_floor(n // m)
    if r == 0:
        return n, 0
    r = min(r, _log2_ceiling(n // _LANE_TILING))
    return -(-(-(-n // _LANE_TILING)) // (1 << r)) * _LANE_TILING, r


def folded_top_k(s: torch.Tensor, k: int,
                 recall_target: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The TPU's two-stage approximate top-k of [Q, N] scores, in plain
    PyTorch (module docstring): fold into strided bins by `amax`, then
    the exact top-k of the bin maxima."""
    q, n = s.shape
    bins, r = reduction_output_size(n, k, recall_target)
    if r == 0:
        return stable_top_k(s, k)
    if k > bins:
        raise ValueError(f"approximate top-{k} over {n} scores folds them into {bins} bins "
                         f"(recall target {recall_target}); ask for k <= {bins}")
    padded = torch.full((q, bins << r), -torch.inf, dtype=s.dtype, device=s.device)
    padded[:, :n] = s
    folded = padded.view(q, 1 << r, bins)
    best, slot = folded.max(dim=1)   # first maximal slot: the lowest row among ties
    top, chosen = stable_top_k(best, k)
    rows = torch.gather(slot, 1, chosen) * bins + chosen
    return top, rows


def select_top_k(s: torch.Tensor, k: int,
                 approx_recall: float | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-chunk selection (JAX `_select_top_k`): the exact top-k, or the
    approximate tier at `approx_recall` by the tensor's device (module
    docstring)."""
    if approx_recall is None:
        return stable_top_k(s, k)
    if s.device.type != "cpu":
        return folded_top_k(s, k, approx_recall)
    if k == 1:
        last = s.shape[1] - 1 - torch.argmax(s.flip(1), dim=1, keepdim=True)
        return torch.gather(s, 1, last), last
    return stable_top_k(s, k)


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
                  chunk: int, approx_recall: float | None = None,
                  n_valid: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Running top-k over a gallery of `n` rows scanned in chunks.
    `score_chunk(start, chunk)` gives the [Q, chunk] scores of rows
    start:start + chunk, the rows past the gallery's end zero-padded;
    their columns, and those at or past `n_valid` (rows of external
    padding, JAX `similarity.py:82-87`), are masked to -inf here. Each
    chunk's candidates come from `select_top_k`; the merge is exact."""
    nv = n if n_valid is None else min(n_valid, n)
    best_s = best_i = None
    for start in range(0, n, chunk):
        valid = max(0, min(chunk, nv - start))
        s = score_chunk(start, chunk)
        s[:, valid:] = -torch.inf
        cs, ci = select_top_k(s, min(k, chunk), approx_recall)
        ci = ci + start
        if best_s is None:
            best_s, best_i = cs, ci
        else:
            best_s, best_i = merge_top_k(torch.cat([best_s, cs], dim=1),
                                         torch.cat([best_i, ci], dim=1), k)
    return best_s, best_i


def blocked_top_k_similarity(queries: torch.Tensor, gallery: torch.Tensor, k: int = 51,
                             chunk: int | None = None, approx_recall: float | None = None,
                             n_valid: int | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k cosine similarity of queries [Q, d] against gallery [N, d]
    (both L2-normalized by the caller). Returns (scores [Q, k] fp32
    descending, gallery rows [Q, k] int64). The gallery is scanned in
    chunks so the score tile stays bounded; each chunk's candidates are
    merged into the running top-k. As in JAX, the last chunk is
    zero-padded to full size and its pad columns masked to -inf: every
    chunk is then one product of one shape, so duplicate gallery rows
    score bit-identically wherever they sit and ties stay ties.
    `approx_recall`: None is the exact tier; a float selects each chunk's
    candidates through the approximate tier at that recall target.
    `n_valid`: rows at or past it are padding and score -inf (the
    sharded callers' pad tail)."""
    n = gallery.shape[0]
    chunk = _auto_chunk(queries.shape[0], n) if chunk is None else min(chunk, n)
    qf = queries.float()

    def score_chunk(start: int, size: int) -> torch.Tensor:
        return qf @ pad_rows(gallery[start:start + size].float(), size).t()

    return chunked_top_k(score_chunk, n, min(k, n), chunk, approx_recall, n_valid)


def measured_approx_recall(gallery: torch.Tensor, k: int = 51, recall_target: float = 0.95,
                           n_queries: int = 256, seed: int = 0) -> float:
    """Empirical recall of the approximate tier on this gallery (JAX
    `:154-200`): `n_queries` gallery rows, jittered by 0.05 of a normal
    draw and renormalized (numpy, from `seed`: JAX's draws), searched by
    the exact and the approximate tier on the gallery's device (so a
    CUDA gallery measures the fold, a CPU one the exact sort); the mean
    per-query overlap of the two top-k sets, over k clamped to the
    gallery size."""
    gal = gallery.float()
    n = gal.shape[0]
    k = min(k, n)
    g = np.random.default_rng(seed)
    rows = g.choice(n, size=min(n_queries, n), replace=False)
    q = gal[torch.as_tensor(rows, device=gal.device)].cpu().numpy()
    q = q + 0.05 * g.standard_normal(q.shape).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True) + 1e-12
    qt = torch.from_numpy(q).to(gal.device)
    _, exact_idx = blocked_top_k_similarity(qt, gal, k=k)
    _, approx_idx = blocked_top_k_similarity(qt, gal, k=k, approx_recall=recall_target)
    exact_idx, approx_idx = exact_idx.cpu().numpy(), approx_idx.cpu().numpy()
    overlap = [len(set(e.tolist()) & set(a.tolist())) / exact_idx.shape[1]
               for e, a in zip(exact_idx, approx_idx)]
    return float(np.mean(overlap))
