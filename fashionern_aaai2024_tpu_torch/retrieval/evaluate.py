"""The inference API over a composed model.

JAX counterpart: `fashionern_aaai2024_tpu/retrieval/evaluate.py`
`InferenceAPI` (`:39`): `encode_image`, `encode_text`, `query`,
`refine_gallery` and `tokenize`, and `last_wins_rows`.
The dataset evaluators, `build_serve_fn` (the one-dispatch serve program)
and the mesh path are not ported yet.

The batch wrappers take host arrays or tensors and run in slices of
`batch_size`. JAX padded the last slice to keep one compiled program;
eager PyTorch compiles nothing per shape, so the last slice runs at its
own size. Outputs are tensors on the API's device.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from fashionern_aaai2024_tpu_torch.models.composed import ComposedCIRModel


def resolve_device(device: torch.device | str) -> torch.device:
    """The device an entry point was asked for; a CUDA device without a
    CUDA runtime raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


class InferenceAPI:
    """Batched forwards of a composed model in eval mode."""

    def __init__(self, model: ComposedCIRModel, *, tokenizer: Callable,
                 device: torch.device | str, batch_size: int = 32,
                 context_length: int = 77):
        """`tokenizer`: callable (captions, context_length) -> int32
        [B, L]. The CLIP BPE table is not in the repository, so there is
        no default."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.context_length = context_length
        self._tokenizer = tokenizer

    def _slices(self, n: int):
        return (slice(i, i + self.batch_size) for i in range(0, n, self.batch_size))

    def _to_device(self, a, dtype: torch.dtype | None = None) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device, dtype)

    @torch.inference_mode()
    def encode_image(self, images) -> tuple[torch.Tensor, torch.Tensor]:
        """[N, H, W, 3] (normalized float or uint8) -> (global, tokens)."""
        out = [self.model.encode_image(self._to_device(images[s]))
               for s in self._slices(len(images))]
        return torch.cat([g for g, _ in out]), torch.cat([t for _, t in out])

    @torch.inference_mode()
    def encode_text(self, token_ids) -> tuple[torch.Tensor, torch.Tensor]:
        """int [N, L] -> (global [N, d], seq [N, L, d])."""
        out = [self.model.encode_text(self._to_device(token_ids[s]))
               for s in self._slices(len(token_ids))]
        return torch.cat([g for g, _ in out]), torch.cat([t for _, t in out])

    @torch.inference_mode()
    def query(self, ref_feats, ref_patch, text_g, text_seq) -> torch.Tensor:
        """DVR query tower; inputs are cast to fp32 first, as the JAX API
        does (`evaluate.py:213-216`)."""
        f32 = torch.float32
        return torch.cat([
            self.model.query(self._to_device(ref_feats[s], f32),
                             self._to_device(ref_patch[s], f32),
                             self._to_device(text_g[s], f32),
                             self._to_device(text_seq[s], f32))
            for s in self._slices(len(ref_feats))])

    @torch.inference_mode()
    def refine_gallery(self, features, local_features, chunk: int = 4096) -> torch.Tensor:
        """Index tower over the gallery: L2-normalize (eps 1e-12 added,
        `evaluate.py:101-104`), then SR + Combiner."""
        out = []
        for i in range(0, len(features), chunk):
            tf = self._to_device(features[i:i + chunk], torch.float32)
            tl = self._to_device(local_features[i:i + chunk], torch.float32)
            tf = tf / (torch.linalg.vector_norm(tf, dim=-1, keepdim=True) + 1e-12)
            out.append(self.model.index(tf, tl))
        return torch.cat(out)

    def tokenize(self, captions: Sequence[str]) -> np.ndarray:
        return self._tokenizer(captions, self.context_length)


def last_wins_rows(names: Sequence[str]) -> dict[str, int]:
    """name -> gallery row, duplicates resolved to the last occurrence
    (the reference's `dict(zip(names, features))` semantics)."""
    return {n: i for i, n in enumerate(names)}
