"""Recall over top-k retrieval results.

A copy of `recall_at_k` from `fashionern_aaai2024_tpu/retrieval/metrics.py`
(numpy only), kept in the port so that it imports nothing of the JAX
package. The reference computes recall from a full Q×N argsort
(`run/valid/validate_fiq.py:33-47`); here it derives from top-k indices,
which is exact for a single positive (FIQ / Shoes: R@K = target in
top-K) and for Fashion200k's multi-positive galleries (duplicated ids).
The dataset suites built on it (CIRR's reference drop and subset recall,
the VAL protocol) come with the evaluators that call them (ROADMAP A9).
"""

from __future__ import annotations

import numpy as np


def recall_at_k(
    topk_ids: np.ndarray, target_ids: np.ndarray, ks: tuple[int, ...]
) -> dict[int, float]:
    """topk_ids: [Q, K] gallery ids per query (desc score);
    target_ids: [Q]. Multi-positive falls out when gallery ids repeat."""
    hits = topk_ids == target_ids[:, None]  # [Q, K]
    out = {}
    for k in ks:
        out[k] = float(np.mean(hits[:, :k].any(axis=1))) * 100.0
    return out
