"""Gallery embedding + retrieval index.

JAX counterpart: `fashionern_aaai2024_tpu/retrieval/engine.py`:
`names_to_ids` (`:27`), `GalleryFeatures`, `embed_gallery` (`:74`) and
the exact tier of `RetrievalIndex` (`:136-235`), fp32 or int8
(`quantize=True`, `--quantize-gallery`), with the name ids, top-k ids,
member scores and row lookups the evaluators use. `embed_gallery` is
serial here: the JAX version's prefetch thread, approximate top-k (and
with it `calibrate_approx`) and mesh sharding are not ported yet
(ROADMAP A1, A8).

Features stay on the model's device as fp32 tensors, so a query's
reference-row gather and the search run there without a host round
trip.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from fashionern_aaai2024_tpu_torch.ops.quant import (
    blocked_top_k_similarity_int8,
    quantize_rows,
)
from fashionern_aaai2024_tpu_torch.ops.similarity import blocked_top_k_similarity


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
    """Refined gallery embeddings + exact top-k search.

    `quantize=True` stores the gallery on its device as int8 with one fp32
    scale per row (`ops/quant.py quantize_rows`; 4x fewer bytes than
    fp32) and searches it (`blocked_top_k_similarity_int8`). The fp32
    features then move to the host, as the JAX index keeps them there
    for `scores_for`."""

    def __init__(self, names: Sequence[str], features: torch.Tensor, quantize: bool = False):
        self.names = list(names)
        self.ids, self.vocab = names_to_ids(self.names)
        self._rows: dict[str, int] | None = None
        self.quantized = quantize
        self.features_q = self.scales = None
        if quantize:
            self.features_q, self.scales = quantize_rows(features.float())
            self.features = features.float().cpu()
        else:
            self.features = features.float()

    def search(self, query_features: torch.Tensor, k: int = 51,
               chunk: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """-> (scores [Q, k], gallery row indices [Q, k]) as host arrays."""
        if self.quantized:
            q = torch.as_tensor(query_features).to(self.features_q.device)
            scores, idx = blocked_top_k_similarity_int8(q, self.features_q, self.scales, k=k,
                                                        chunk=chunk)
        else:
            q = torch.as_tensor(query_features).to(self.features.device)
            scores, idx = blocked_top_k_similarity(q, self.features, k=k, chunk=chunk)
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
