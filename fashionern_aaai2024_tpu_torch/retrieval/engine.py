"""Gallery embedding + retrieval index.

JAX counterpart: `fashionern_aaai2024_tpu/retrieval/engine.py`:
`GalleryFeatures`, `embed_gallery` (`:74`) and the exact tier of
`RetrievalIndex.search` (`:136`). `embed_gallery` is serial here: the
JAX version's prefetch thread, int8 gallery, approximate top-k and mesh
sharding are not ported yet.

Features stay on the model's device as fp32 tensors, so a query's
reference-row gather and the search run there without a host round
trip.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from fashionern_aaai2024_tpu_torch.ops.similarity import blocked_top_k_similarity


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
    """Refined gallery embeddings + exact top-k search."""

    def __init__(self, names: Sequence[str], features: torch.Tensor):
        self.names = list(names)
        self.features = features.float()

    def search(self, query_features: torch.Tensor, k: int = 51,
               chunk: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """-> (scores [Q, k], gallery row indices [Q, k]) as host arrays."""
        q = torch.as_tensor(query_features).to(self.features.device)
        scores, idx = blocked_top_k_similarity(q, self.features, k=k, chunk=chunk)
        return scores.cpu().numpy(), idx.cpu().numpy()
