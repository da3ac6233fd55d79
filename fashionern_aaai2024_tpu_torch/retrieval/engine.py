"""Gallery embedding + retrieval index.

JAX counterpart: `fashionern_aaai2024_tpu/retrieval/engine.py`:
`names_to_ids` (`:27`), `GalleryFeatures`, `embed_gallery` (`:74`) and
`RetrievalIndex` (`:136-235`), fp32 or int8 (`quantize=True`,
`--quantize-gallery`), exact or approximate (`approx_recall`,
`--topk-recall`, with `calibrate_approx`), with the name ids, top-k
ids, member scores and row lookups the evaluators use. `embed_gallery`
is serial here (the JAX version's prefetch thread is not ported).
`sharded_search` (`:238-286`) is the top-k over a gallery row-sharded
over a data-parallel mesh (`parallel/mesh.py`).

Features stay on the model's device as fp32 tensors, so a query's
reference-row gather and the search run there without a host round
trip.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from fashionern_aaai2024_tpu_torch.ops.quant import (
    blocked_top_k_similarity_int8,
    quantize_rows,
)
from fashionern_aaai2024_tpu_torch.ops.similarity import (
    blocked_top_k_similarity,
    measured_approx_recall,
    merge_top_k,
    pad_rows,
)
from fashionern_aaai2024_tpu_torch.parallel.mesh import ProcessMesh, all_gather_cols


def names_to_ids(names: Sequence[str]) -> tuple[np.ndarray, dict[str, int]]:
    """Dense int ids for gallery names. Duplicate names (Fashion200k
    caption-id galleries) share an id, which is exactly the
    multi-positive semantics."""
    vocab: dict[str, int] = {}
    ids = np.empty(len(names), np.int32)
    for i, n in enumerate(names):
        ids[i] = vocab.setdefault(n, len(vocab))
    return ids, vocab


@dataclasses.dataclass
class GalleryFeatures:
    names: list[str]
    features: torch.Tensor                        # [N, d] global, fp32
    local_features: torch.Tensor | None = None    # [N, 13, d] patch features, fp32


def embed_gallery(encode_image_fn: Callable, loader: Iterable[dict]) -> GalleryFeatures:
    """Gallery pass. `loader` yields batches with "name", "image" and
    optionally "patch" (numpy or tensors); `encode_image_fn` maps an
    image batch to (global, tokens) tensors on the model's device."""
    names: list[str] = []
    feats: list[torch.Tensor] = []
    locals_: list[torch.Tensor] = []
    for batch in loader:
        g, _ = encode_image_fn(batch["image"])
        names.extend(batch["name"])
        feats.append(g.float())
        if "patch" in batch:
            locals_.append(torch.as_tensor(batch["patch"]).to(g.device, torch.float32))
    return GalleryFeatures(names=names, features=torch.cat(feats),
                           local_features=torch.cat(locals_) if locals_ else None)


class RetrievalIndex:
    """Refined gallery embeddings + top-k search.

    `quantize=True` stores the gallery on its device as int8 with one fp32
    scale per row (`ops/quant.py quantize_rows`, run on the host, so that
    only the int8 bytes and the scales go to the device; 4x fewer bytes
    than fp32) and searches it (`blocked_top_k_similarity_int8`). The
    fp32 features stay on the host, as the JAX index keeps them there for
    `scores_for`.

    `approx_recall`: None is the exact top-k (the parity tier); a float
    selects through the approximate tier at that recall target
    (`ops/similarity.py`), which `calibrate_approx` measures on this
    gallery."""

    def __init__(self, names: Sequence[str], features: torch.Tensor, quantize: bool = False,
                 approx_recall: float | None = None):
        self.names = list(names)
        self.ids, self.vocab = names_to_ids(self.names)
        self._rows: dict[str, int] | None = None
        self.quantized = quantize
        self.approx_recall = approx_recall
        self.features_q = self.scales = None
        if quantize:
            self.features = features.float().cpu()
            values, scales = quantize_rows(self.features)
            self.features_q, self.scales = values.to(features.device), scales.to(features.device)
        else:
            self.features = features.float()

    def calibrate_approx(self, k: int = 51, n_queries: int = 256, min_margin: float = 0.05,
                         strict: bool = False) -> float | None:
        """The approximate tier's recall measured on this gallery, where the
        search runs (None on the exact tier). Warns on stderr when it is
        below `approx_recall`; with `strict`, raises when it is below by
        more than `min_margin` (JAX `engine.py:163-198`, same wording)."""
        if self.approx_recall is None:
            return None
        device = self.features_q.device if self.quantized else self.features.device
        measured = measured_approx_recall(self.features.to(device), k=k,
                                          recall_target=self.approx_recall,
                                          n_queries=n_queries)
        if measured < self.approx_recall:
            msg = (f"--topk-recall {self.approx_recall}: measured recall "
                   f"on this gallery is {measured:.4f} "
                   f"({len(self.names)} rows, k={k})")
            if strict and measured < self.approx_recall - min_margin:
                raise RuntimeError(msg + " — below the requested target by more than "
                                   f"{min_margin}; use a higher --topk-recall or the "
                                   "exact tier")
            print(f"WARNING: {msg}", file=sys.stderr)
        return measured

    def search(self, query_features: torch.Tensor, k: int = 51,
               chunk: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """-> (scores [Q, k], gallery row indices [Q, k]) as host arrays."""
        if self.quantized:
            q = torch.as_tensor(query_features).to(self.features_q.device)
            scores, idx = blocked_top_k_similarity_int8(q, self.features_q, self.scales, k=k,
                                                        chunk=chunk,
                                                        approx_recall=self.approx_recall)
        else:
            q = torch.as_tensor(query_features).to(self.features.device)
            scores, idx = blocked_top_k_similarity(q, self.features, k=k, chunk=chunk,
                                                   approx_recall=self.approx_recall)
        return scores.cpu().numpy(), idx.cpu().numpy()

    def topk_ids(self, indices: np.ndarray) -> np.ndarray:
        """Gallery row indices -> name ids (for the recall metrics)."""
        return self.ids[indices]

    def scores_for(self, query_features: torch.Tensor, member_rows: np.ndarray) -> np.ndarray:
        """Similarity of each query to a small per-query member set (CIRR
        subset recall) from the fp32 features; member_rows [Q, G] -> [Q, G]."""
        q = torch.as_tensor(query_features).to(self.features.device, torch.float32)
        members = self.features[torch.as_tensor(member_rows, device=self.features.device)]
        return torch.einsum("qd,qgd->qg", q, members).cpu().numpy()

    def row_of(self, name: str) -> int:
        """The first row named `name` (list.index semantics, for the
        Fashion200k duplicate-name case)."""
        if self._rows is None:
            self._rows = {}
            for i, n in enumerate(self.names):
                self._rows.setdefault(n, i)
        return self._rows[name]


def sharded_search(mesh: ProcessMesh, query_features, gallery_features, k: int = 51,
                   chunk: int | None = None, approx_recall: float | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Top-k over a gallery row-sharded over the mesh (JAX `:238-286`),
    called by every rank with the same queries and the whole gallery:
    this rank keeps rows [r · per, (r + 1) · per) of it, per = ceil(n /
    size), zero-padded on the last shards; the pad tail is masked before
    the local top-k (a zero row scores 0, above real negative-scoring
    rows); the candidates carry global row ids (invalid ones the largest
    id) and only the [Q, k] candidate sets cross the mesh (an all-gather)
    before the exact merge. -> (scores [Q, k], gallery rows [Q, k]) as
    host arrays, the same on every rank."""
    gallery = torch.as_tensor(gallery_features)
    n = gallery.shape[0]
    per = -(-n // mesh.size)
    start = mesh.rank * per
    local = pad_rows(gallery[start:start + per].to(mesh.device, torch.float32), per)
    q = torch.as_tensor(query_features).to(mesh.device, torch.float32)
    s, i = blocked_top_k_similarity(q, local, k=min(k, per), chunk=chunk,
                                    approx_recall=approx_recall,
                                    n_valid=max(0, min(per, n - start)))
    gi = torch.where(s > -torch.inf, i + start, torch.iinfo(torch.int64).max)
    scores, idx = merge_top_k(all_gather_cols(mesh, s), all_gather_cols(mesh, gi), min(k, n))
    return scores.cpu().numpy(), idx.cpu().numpy()
