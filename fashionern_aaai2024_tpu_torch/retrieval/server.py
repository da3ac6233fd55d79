"""The composed-retrieval service: gallery resident, queries answered.

JAX counterpart: `fashionern_aaai2024_tpu/retrieval/server.py`
`RetrievalService` (`:91`). At construction it embeds the gallery through
the ViT tower, refines it through the ERN index tower and builds the
index; `query` answers composed queries (reference image name + caption)
along the JAX service's multi-dispatch path (`server.py:291-296`): text
tower, DVR query tower, exact top-k. Results have the JAX service's
`_format_results` shape.

Not ported yet: the one-dispatch serve program, live adds
(`--capacity`), the HTTP handler and the micro-batcher.
"""

from __future__ import annotations

import time
from typing import Iterable, Sequence

import numpy as np
import torch

from fashionern_aaai2024_tpu_torch.retrieval.engine import RetrievalIndex, embed_gallery
from fashionern_aaai2024_tpu_torch.retrieval.evaluate import InferenceAPI, last_wins_rows


class RetrievalService:
    def __init__(self, api: InferenceAPI, classic_loader: Iterable[dict]):
        t0 = time.perf_counter()
        self.api = api
        self.gallery = embed_gallery(api.encode_image, classic_loader)
        refined = api.refine_gallery(self.gallery.features, self.gallery.local_features)
        self.index = RetrievalIndex(self.gallery.names, refined)
        self.rows = last_wins_rows(self.gallery.names)
        self.startup_seconds = time.perf_counter() - t0

    @property
    def gallery_size(self) -> int:
        return len(self.gallery.names)

    @staticmethod
    def _format_results(names, scores, idx, n: int):
        return [
            [{"name": str(names[idx[q, j]]), "score": float(scores[q, j])}
             for j in range(idx.shape[1])]
            for q in range(n)
        ]

    def query(self, ref_names: Sequence[str], captions: Sequence[str], k: int = 10):
        """Composed queries -> (per-query top-k [{"name", "score"}...],
        latency seconds)."""
        if len(ref_names) != len(captions):
            raise ValueError("ref_names and captions length mismatch")
        unknown = [r for r in ref_names if r not in self.rows]
        if unknown:
            raise KeyError(f"unknown reference image(s): {unknown[:5]}")
        t0 = time.perf_counter()
        ids = self.api.tokenize(list(captions))
        rows = torch.as_tensor([self.rows[r] for r in ref_names],
                               device=self.gallery.features.device)
        text_g, text_seq = self.api.encode_text(ids)
        preds = self.api.query(self.gallery.features[rows],
                               self.gallery.local_features[rows], text_g, text_seq)
        scores, idx = self.index.search(preds, k=min(k, self.gallery_size))
        latency = time.perf_counter() - t0
        names = np.asarray(self.gallery.names, dtype=object)
        return self._format_results(names, scores, idx, len(ref_names)), latency
