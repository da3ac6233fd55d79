"""The composed-retrieval service: gallery resident, queries answered.

JAX counterpart: `fashionern_aaai2024_tpu/retrieval/server.py`
`RetrievalService` (`:91`). At construction it embeds the gallery through
the image tower (ViT-B-16 or RN50x4), refines it through the ERN index
tower and builds the
index; `query` answers composed queries (reference image name + caption)
along the JAX service's multi-dispatch path (`server.py:291-296`): text
tower (with TME on a TME model), DVR query tower, exact top-k (over an
int8 gallery when the API was built with `quantize_gallery`,
`server.py:119-121`). Results have the JAX service's `_format_results`
shape. The text tower gets the request rows' reference patches, as the
one-dispatch program gives them to a TME model (`evaluate.py:309-317`);
the JAX multi-dispatch fallback omits them and fails on a TME model
(ROADMAP C7).

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
        self.index = RetrievalIndex(self.gallery.names, refined,
                                    quantize=api.quantize_gallery)
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
        ref_patch = self.gallery.local_features[rows]
        text_g, text_seq = self.api.encode_text(ids, visual_emb=ref_patch)
        preds = self.api.query(self.gallery.features[rows], ref_patch, text_g, text_seq)
        scores, idx = self.index.search(preds, k=min(k, self.gallery_size))
        latency = time.perf_counter() - t0
        names = np.asarray(self.gallery.names, dtype=object)
        return self._format_results(names, scores, idx, len(ref_names)), latency
