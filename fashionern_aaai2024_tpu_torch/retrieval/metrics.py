"""Recall metrics over top-k retrieval results.

A copy of `fashionern_aaai2024_tpu/retrieval/metrics.py` (numpy only),
kept in the port so that it imports nothing of the JAX package. The
reference computes every metric from a full QxN argsort
(`run/valid/validate_fiq.py:33-47`); here everything derives from top-k
indices (and a small per-query member-score gather for CIRR's subset
recall), which is exact for every published metric:
  * FIQ / Shoes / VAL protocol: single positive, R@K = target in top-K
    (`validate_fiq.py:44-47`, `test_val.py:58-67`);
  * Fashion200k: multi-positive, a hit if ANY top-K gallery item shares
    the target's caption id (`run/test/test_200k.py:53-61`); gallery ids
    are caption strings, so duplicated ids give this for free;
  * CIRR: the reference image removed from the ranking before recall
    (`validate_cirr.py:40-50`), subset recall among the 6 group members
    (`:55-71`).
"""

from __future__ import annotations

import numpy as np


def names_to_id_array(names, vocab: dict[str, int]) -> np.ndarray:
    return np.asarray([vocab[n] for n in names], np.int32)


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


def drop_reference(topk_ids: np.ndarray, reference_ids: np.ndarray, k: int) -> np.ndarray:
    """Remove the query's own reference image from each row, keeping the
    first `k` of the remainder (CIRR semantics, `validate_cirr.py:40-50`).
    Input must have >= k+1 columns."""
    q, kk = topk_ids.shape
    assert kk >= k + 1
    out = np.empty((q, k), topk_ids.dtype)
    for i in range(q):
        row = topk_ids[i][topk_ids[i] != reference_ids[i]]
        out[i] = row[:k]
    return out


def subset_recall(member_scores: np.ndarray, member_ids: np.ndarray, target_ids: np.ndarray,
                  reference_ids: np.ndarray, ks: tuple[int, ...] = (1, 2, 3)) -> dict[int, float]:
    """CIRR subset recall: rank of the target among its query's group
    members, with the reference member excluded (`validate_cirr.py:55-71`).

    member_scores: [Q, G] similarity of each query to its G group members
    member_ids:    [Q, G] gallery ids of those members
    """
    q, g = member_scores.shape
    scores = member_scores.copy()
    scores[member_ids == reference_ids[:, None]] = -np.inf
    target_mask = member_ids == target_ids[:, None]
    assert (target_mask.sum(axis=1) == 1).all(), "target must appear once per group"
    target_score = member_scores[target_mask].reshape(q)
    # strict >: for distinct fp scores this matches the argsort order
    rank = (scores > target_score[:, None]).sum(axis=1)
    return {k: float(np.mean(rank < k)) * 100.0 for k in ks}


def fiq_metrics(topk_ids, target_ids):
    r = recall_at_k(topk_ids, target_ids, (10, 50))
    return {"recall_at10": r[10], "recall_at50": r[50], "avg": (r[10] + r[50]) / 2}


def fashion200k_metrics(topk_ids, target_ids):
    """Same recall computation; multi-positivity comes from caption-id
    galleries (duplicate ids across images sharing a caption)."""
    return fiq_metrics(topk_ids, target_ids)


def val_protocol_metrics(topk_ids, target_ids):
    ks = (1, 5, 10, 15, 20, 30, 40, 50)
    r = recall_at_k(topk_ids, target_ids, ks)
    return {f"recall_at{k}": r[k] for k in ks}


def cirr_metrics(topk_ids, reference_ids, target_ids, member_scores, member_ids):
    """Full CIRR suite. `topk_ids` needs >= 51 columns for an exact R@50
    (real CIRR galleries); smaller (test) galleries cap at gallery - 1."""
    kcap = min(50, topk_ids.shape[1] - 1)
    dropped = drop_reference(topk_ids, reference_ids, kcap)
    r = recall_at_k(dropped, target_ids, tuple(min(k, kcap) for k in (1, 5, 10, 50)))
    r = {k: r[min(k, kcap)] for k in (1, 5, 10, 50)}
    sub = subset_recall(member_scores, member_ids, target_ids, reference_ids)
    return {
        "recall_at1": r[1],
        "recall_at5": r[5],
        "recall_at10": r[10],
        "recall_at50": r[50],
        "group_recall_at1": sub[1],
        "group_recall_at2": sub[2],
        "group_recall_at3": sub[3],
        "headline": (r[5] + sub[1]) / 2,
    }
