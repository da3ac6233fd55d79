"""Gallery embedding + retrieval index.

JAX counterpart: `fashionern_aaai2024_tpu/retrieval/engine.py`:
`names_to_ids` (`:27`), `GalleryFeatures` (`:66-71`), `embed_gallery`
(`:74-133`) and `RetrievalIndex` (`:136-235`), fp32 or int8
(`quantize=True`, `--quantize-gallery`), exact or approximate
(`approx_recall`, `--topk-recall`, with `calibrate_approx`), with the
name ids, top-k ids, member scores and row lookups the evaluators use.
`embed_gallery` runs JAX's three-deep pipeline on CUDA streams: a
thread stages batches ahead of dispatch (`Placer`: pinned host memory,
then a copy on a copy stream of its own), the main thread dispatches
the encode once its stream has waited on the batch's copy, and the
tokens' read-back trails dispatch by one batch. `sharded_search`
(`:238-286`) is the top-k over a gallery row-sharded over a
data-parallel mesh (`parallel/mesh.py`).

Features stay on the model's device as fp32 tensors, so a query's
reference-row gather and the search run there without a host round
trip; the tokens (`keep_tokens`) come to the host, as JAX's do.
"""

from __future__ import annotations

import contextlib
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
    token_features: torch.Tensor | None = None    # [N, S, w] tower tokens, on the host


@dataclasses.dataclass
class PlacedBatch:
    """One staged batch: the images (this rank's rows on a mesh) and the
    patches on the placer's device, and the event of their copies (None
    off the card)."""
    images: torch.Tensor
    patch: torch.Tensor | None
    event: torch.cuda.Event | None

    def ready(self) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The tensors, once the current stream has waited on their copy.
        Each is marked as used by that stream, so the caching allocator
        does not hand its block to the next copy while the encode reads
        it."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.images.device)
            stream.wait_event(self.event)
            for t in (self.images, self.patch):
                if t is not None:
                    t.record_stream(stream)
        return self.images, self.patch


class Placer:
    """`embed_gallery`'s stage: a loader batch's images and patches on
    `device` (JAX `InferenceAPI._place`, `retrieval/evaluate.py:171-184`).

    On a CUDA device each array is copied once into page-locked host
    memory (strided views in, contiguous out; the patches as fp32), then to
    the device with `non_blocking=True` on this placer's own stream, and
    an event on that stream marks the batch. It runs on the prefetch
    thread, which takes the device and the stream itself (both are
    thread-local); nothing here depends on grad or inference mode. A
    failed pin or copy raises: there is no pageable or serial fallback.
    On the CPU the stage is `torch.as_tensor`.

    `rows` (an n -> row-index function, `InferenceAPI._rank_rows`): only
    those rows of the images are copied, this rank's part of a batch on a
    mesh. `batches` counts the batches placed and `copies` the arrays
    copied from page-locked memory while this placer's stream was
    current."""

    def __init__(self, device: torch.device | str,
                 rows: Callable[[int], torch.Tensor] | None = None):
        self.device = torch.device(device)
        self.rows = rows
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.batches = self.copies = 0

    def __call__(self, images, patch=None) -> PlacedBatch:
        src = torch.as_tensor(images)
        idx = None if self.rows is None else self.rows(src.shape[0])
        self.batches += 1
        if self.stream is None:
            return PlacedBatch(src if idx is None else src[idx],
                               None if patch is None else torch.as_tensor(patch).float(), None)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            img = self._copy(src, idx, src.dtype)
            p = None if patch is None else self._copy(torch.as_tensor(patch), None, torch.float32)
            return PlacedBatch(img, p, self.stream.record_event())

    def _copy(self, src: torch.Tensor, idx: torch.Tensor | None, dtype: torch.dtype
              ) -> torch.Tensor:
        """`src` (its `idx` rows) -> page-locked host memory -> the device,
        on the current stream (this placer's)."""
        shape = src.shape if idx is None else (len(idx), *src.shape[1:])
        host = torch.empty(shape, dtype=dtype, pin_memory=True)
        if idx is None:
            host.copy_(src)
        else:
            torch.index_select(src, 0, idx, out=host)
        out = host.to(self.device, non_blocking=True)
        if host.is_pinned() and torch.cuda.current_stream(self.device) == self.stream:
            self.copies += 1
        return out


def embed_gallery(encode_image_fn: Callable, loader: Iterable[dict],
                  batch_size: int | None = None, keep_tokens: bool = False,
                  prefetch: int = 2) -> GalleryFeatures:
    """Gallery pass (JAX `engine.py:74-133`, the reference's
    `extract_index_features`). `loader` yields batches with "name",
    "image" and optionally "patch" (numpy or CPU tensors).

    Three deep, as JAX's:
      1. a thread (`data/prefetch.py prefetch_iter`) walks the loader and
         stages each batch `prefetch` ahead: `encode_image_fn.place` (a
         `Placer`, `InferenceAPI.gallery_encode_fn`) pins it and copies
         it on a copy stream; a callable without `.place` gets the CPU
         stage (host tensors);
      2. the main thread makes its stream wait on the batch's copy and
         dispatches `encode_image_fn` on the placed images (-> global
         [>= n, d] and tokens, on the device; rows past the batch's n,
         a mesh's padding, are dropped). Features and patches stay on
         the device, so nothing syncs;
      3. with `keep_tokens`, a batch's tokens are copied to page-locked
         host memory behind its encode and collected after the next
         batch is dispatched.
    `prefetch=0` runs the stage inline: the serial feed. An exception in
    the loader or the stage surfaces at its batch, and the thread has
    stopped when this returns or raises. `batch_size` is JAX's
    argument: JAX pads every batch to it; eager PyTorch runs each batch
    at its own size, so the port does not read it."""
    # imported here: the serve artifact's path imports this module and
    # nothing of `data/` (tests/test_torch_artifact.py)
    from fashionern_aaai2024_tpu_torch.data.prefetch import prefetch_iter

    del batch_size
    place = getattr(encode_image_fn, "place", None) or Placer("cpu")
    names: list[str] = []
    feats: list[torch.Tensor] = []
    locals_: list[torch.Tensor] = []
    tokens: list[torch.Tensor] = []
    pending: tuple | None = None   # (host tokens, their copy's event)

    def read_back(tok: torch.Tensor) -> tuple:
        if not tok.is_cuda:
            return tok, None
        host = torch.empty(tok.shape, dtype=tok.dtype, pin_memory=True)
        host.copy_(tok, non_blocking=True)
        return host, torch.cuda.current_stream(tok.device).record_event()

    def drain(entry: tuple) -> None:
        host, event = entry
        if event is not None:
            event.synchronize()
        tokens.append(host)

    def stage(_, batch):
        return batch, place(batch["image"], batch.get("patch")), len(batch["image"])

    with contextlib.closing(prefetch_iter(loader, stage, depth=prefetch)) as feed:
        for batch, placed, n in feed:
            images, patch = placed.ready()
            g, tok = encode_image_fn(images)
            names.extend(batch["name"])
            feats.append(g[:n].float())
            if patch is not None:
                locals_.append(patch)
            if keep_tokens:
                if pending is not None:
                    drain(pending)
                pending = read_back(tok[:n])
    if pending is not None:
        drain(pending)
    return GalleryFeatures(
        names=names,
        features=torch.cat(feats) if feats else torch.zeros((0, 0), device=place.device),
        local_features=torch.cat(locals_) if locals_ else None,
        token_features=torch.cat(tokens) if tokens else None)


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
