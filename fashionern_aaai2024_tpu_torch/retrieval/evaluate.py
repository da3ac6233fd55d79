"""The inference API over a composed model, and the dataset evaluators.

JAX counterpart: `fashionern_aaai2024_tpu/retrieval/evaluate.py`:
`InferenceAPI` (`:39`: `encode_image`, `encode_text`, `query`,
`refine_gallery`, `tokenize`, `gallery_encode_fn`), `last_wins_rows`,
and the evaluators of `:752-922`, the reference's `compute_*_val_metrics`
pipelines: embed the gallery (global features and the 13 patch features
of every item), tokenize the captions, run the text tower and the DVR
query tower against the raw reference features (looked up by name, the
last duplicate winning), refine the gallery through the index tower,
take the exact top-k, and score Recall@K (`retrieval/metrics.py`).
`build_serve_fn` (the one-dispatch serve program) and the mesh path are
not ported yet (ROADMAP A1, A8).

The batch wrappers take host arrays or tensors and run in slices of
`batch_size`. JAX padded the last slice to keep one compiled program;
eager PyTorch compiles nothing per shape, so the last slice runs at its
own size. Outputs are tensors on the API's device. The evaluators take
any iterables of batch dicts as loaders (`data/loader.py Loader`, or a
list of batches).
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from fashionern_aaai2024_tpu_torch.data.captions import join_fiq_captions
from fashionern_aaai2024_tpu_torch.models.clip.tokenizer import tokenize
from fashionern_aaai2024_tpu_torch.models.composed import ComposedCIRModel
from fashionern_aaai2024_tpu_torch.retrieval import metrics as M
from fashionern_aaai2024_tpu_torch.retrieval.engine import (
    GalleryFeatures,
    RetrievalIndex,
    embed_gallery,
)


def resolve_device(device: torch.device | str) -> torch.device:
    """The device an entry point was asked for; a CUDA device without a
    CUDA runtime raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


class InferenceAPI:
    """Batched forwards of a composed model in eval mode."""

    def __init__(self, model: ComposedCIRModel, *, tokenizer: Callable | None = None,
                 device: torch.device | str = "cuda", batch_size: int = 32,
                 context_length: int = 77, quantize_gallery: bool = False):
        """`tokenizer`: callable (captions, context_length) -> int32
        [B, L]; by default the port's CLIP BPE (`models/clip/tokenizer.py
        tokenize`), which finds its table at the first call
        (`default_bpe_path`) or raises FileNotFoundError there.
        `quantize_gallery`: the services built on this API store the
        refined gallery int8 for the top-k search (`--quantize-gallery`,
        `ops/quant.py`)."""
        self.device = resolve_device(device)
        self.quantize_gallery = quantize_gallery
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.context_length = context_length
        self._tokenizer = tokenizer if tokenizer is not None else tokenize

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
    def encode_text(self, token_ids, visual_emb=None) -> tuple[torch.Tensor, torch.Tensor]:
        """int [N, L] -> (global [N, d], seq [N, L, d]). `visual_emb`, the
        reference patch features [N, P, d], is required on a TME model
        (cast to fp32 first, as JAX does; the model raises without it) and
        ignored on a vanilla one (`evaluate.py:192-207`)."""
        if not self.model.clip_config.text.tme:
            visual_emb = None
        out = [self.model.encode_text(
            self._to_device(token_ids[s]),
            visual_emb=None if visual_emb is None else self._to_device(visual_emb[s],
                                                                       torch.float32))
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

    def gallery_encode_fn(self) -> Callable:
        """The image encoder `engine.embed_gallery` takes: an image batch
        -> (global, tokens) on the API's device."""
        return self.encode_image


def last_wins_rows(names: Sequence[str]) -> dict[str, int]:
    """name -> gallery row, duplicates resolved to the last occurrence
    (the reference's `dict(zip(names, features))` semantics)."""
    return {n: i for i, n in enumerate(names)}


def generate_predictions(api: InferenceAPI, relative_loader: Iterable[dict],
                         caption_fn: Callable[[dict], list[str]], gallery: GalleryFeatures,
                         collect: Sequence[str] = (),
                         ref_key: str = "ref_name") -> tuple[torch.Tensor, dict[str, list]]:
    """Query pass (the reference's `generate_*_val_predictions`). Returns
    (predictions [Q, d] on the API's device, {key: list} for every
    `collect` key)."""
    rows = last_wins_rows(gallery.names)
    preds: list[torch.Tensor] = []
    meta: dict[str, list] = {k: [] for k in collect}
    for batch in relative_loader:
        ids = api.tokenize(caption_fn(batch))
        tg, tseq = api.encode_text(ids, visual_emb=batch["ref_patch"])
        ref_rows = torch.as_tensor([rows[r] for r in batch[ref_key]],
                                   device=gallery.features.device)
        preds.append(api.query(gallery.features[ref_rows], batch["ref_patch"], tg, tseq))
        for k in collect:
            meta[k].extend(batch[k])
    return torch.cat(preds), meta


def _search_ids(api: InferenceAPI, gallery: GalleryFeatures, preds: torch.Tensor,
                k: int) -> tuple[RetrievalIndex, np.ndarray]:
    """Refine the gallery, index it, and return the top-k name ids of
    every prediction. (The JAX evaluator calibrates its approximate tier
    here, `calibrate_approx`; the port has the exact tier only, where
    that is a no-op.)"""
    refined = api.refine_gallery(gallery.features, gallery.local_features)
    index = RetrievalIndex(gallery.names, refined, quantize=api.quantize_gallery)
    _, idx = index.search(preds, k=min(k, len(gallery.names)))
    return index, index.topk_ids(idx)


def fiq_caption_fn(batch: dict) -> list[str]:
    return [join_fiq_captions(c[0], c[1]) for c in batch["captions"]]


def plain_caption_fn(batch: dict) -> list[str]:
    return list(batch["caption"])


def evaluate_fiq_split(api: InferenceAPI, classic_loader: Iterable[dict],
                       relative_loader: Iterable[dict],
                       ks: tuple[int, ...] = (10, 50)) -> dict:
    """One dress type (the reference's `compute_fiq_val_metrics`,
    `validate_fiq.py:11-47`); also the VAL protocol with its longer K
    list (`test_val.py:58-67`)."""
    gallery = embed_gallery(api.gallery_encode_fn(), classic_loader)
    preds, meta = generate_predictions(api, relative_loader, fiq_caption_fn, gallery,
                                       collect=("tar_name",))
    index, topk_ids = _search_ids(api, gallery, preds, max(ks))
    r = M.recall_at_k(topk_ids, M.names_to_id_array(meta["tar_name"], index.vocab), ks)
    out = {f"recall_at{k}": r[k] for k in ks}
    out["avg"] = float(np.mean(list(r.values())))
    return out


def evaluate_shoes(api: InferenceAPI, classic_loader: Iterable[dict],
                   relative_loader: Iterable[dict]) -> dict:
    gallery = embed_gallery(api.gallery_encode_fn(), classic_loader)
    preds, meta = generate_predictions(api, relative_loader, plain_caption_fn, gallery,
                                       collect=("tar_name",))
    index, topk_ids = _search_ids(api, gallery, preds, 50)
    return M.fiq_metrics(topk_ids, M.names_to_id_array(meta["tar_name"], index.vocab))


def evaluate_fashion200k(api: InferenceAPI, classic_loader: Iterable[dict],
                         relative_loader: Iterable[dict]) -> dict:
    """Gallery names are caption ids: duplicate ids encode the
    multi-positive semantics (`test_200k.py:53-60`)."""
    gallery = embed_gallery(api.gallery_encode_fn(), classic_loader)
    preds, meta = generate_predictions(api, relative_loader, plain_caption_fn, gallery,
                                       collect=("tar_id",), ref_key="ref_id")
    index, topk_ids = _search_ids(api, gallery, preds, 50)
    return M.fashion200k_metrics(topk_ids, M.names_to_id_array(meta["tar_id"], index.vocab))


def evaluate_cirr(api: InferenceAPI, classic_loader: Iterable[dict],
                  relative_loader: Iterable[dict]) -> dict:
    """The CIRR suite on the val split: R@K with the reference image
    dropped from the ranking, and subset recall among the 6 group
    members (`validate_cirr.py:11-126`)."""
    gallery = embed_gallery(api.gallery_encode_fn(), classic_loader)
    preds, meta = generate_predictions(api, relative_loader, plain_caption_fn, gallery,
                                       collect=("tar_name", "ref_name", "group_members"))
    index, topk_ids = _search_ids(api, gallery, preds, 51)
    rows = last_wins_rows(gallery.names)
    member_rows = np.asarray([[rows[m] for m in g] for g in meta["group_members"]])
    return M.cirr_metrics(topk_ids, M.names_to_id_array(meta["ref_name"], index.vocab),
                          M.names_to_id_array(meta["tar_name"], index.vocab),
                          index.scores_for(preds, member_rows), index.ids[member_rows])


def generate_cirr_submission(api: InferenceAPI, classic_loader: Iterable[dict],
                             relative_loader: Iterable[dict]) -> dict:
    """CIRR test1 split, whose targets are unpublished: the official
    submission payloads, per pair_id the top-50 gallery names (reference
    image removed) and the top-3 among the group members."""
    gallery = embed_gallery(api.gallery_encode_fn(), classic_loader)
    preds, meta = generate_predictions(api, relative_loader, plain_caption_fn, gallery,
                                       collect=("pair_id", "ref_name", "group_members"))
    refined = api.refine_gallery(gallery.features, gallery.local_features)
    index = RetrievalIndex(gallery.names, refined)
    _, idx = index.search(preds, k=min(51, len(gallery.names)))
    rows = last_wins_rows(gallery.names)
    ranking: dict[str, list[str]] = {}
    subset: dict[str, list[str]] = {}
    for qi, pair_id in enumerate(meta["pair_id"]):
        ref = meta["ref_name"][qi]
        ranking[str(pair_id)] = [gallery.names[j] for j in idx[qi]
                                 if gallery.names[j] != ref][:50]
        members = meta["group_members"][qi]
        member_rows = np.asarray([rows[m] for m in members])
        scores = index.scores_for(preds[qi:qi + 1], member_rows[None])[0]
        subset[str(pair_id)] = [members[j] for j in np.argsort(-scores)
                                if members[j] != ref][:3]
    return {
        "recall_submission": {"version": "rc2", "metric": "recall", **ranking},
        "recall_subset_submission": {"version": "rc2", "metric": "recall_subset", **subset},
    }


def evaluate_fiq(api: InferenceAPI, loaders_by_type: dict[str, tuple]) -> dict:
    """Every dress type: per-type recalls and the reference's selection
    metric, the mean of (R@10 + R@50) / 2 (`train_fiq.py:158-169`)."""
    out: dict = {}
    r10, r50 = [], []
    for dt, (classic, relative) in loaders_by_type.items():
        r = evaluate_fiq_split(api, classic, relative)
        out[dt] = r
        r10.append(r["recall_at10"])
        r50.append(r["recall_at50"])
    out["mean_recall_at10"] = float(np.mean(r10))
    out["mean_recall_at50"] = float(np.mean(r50))
    out["avg"] = (out["mean_recall_at10"] + out["mean_recall_at50"]) / 2
    return out
