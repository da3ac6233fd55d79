"""The inference API over a composed model, and the dataset evaluators.

JAX counterpart: `fashionern_aaai2024_tpu/retrieval/evaluate.py`:
`InferenceAPI` (`:39`: `encode_image`, `encode_text`, `query`,
`refine_gallery`, `tokenize`, `gallery_encode_fn` with its `.place`
stage, JAX `_place` at `:171-184`), `last_wins_rows`,
and the evaluators of `:752-922`, the reference's `compute_*_val_metrics`
pipelines: embed the gallery (global features and the 13 patch features
of every item), tokenize the captions, run the text tower and the DVR
query tower against the raw reference features (looked up by name, the
last duplicate winning), refine the gallery through the index tower,
take the top-k, and score Recall@K (`retrieval/metrics.py`); and
`build_serve_fn` (`:254-572`), the one-dispatch serve program
(`ServeFn`), which on the card runs as one CUDA graph per batch bucket.
Its export handles (JAX `jfn` and `consts`, `:540-572`) are
`ServeFn.consts` and `ServeFn.program`, which `retrieval/artifact.py`
exports.

Data parallel (`mesh`, a `parallel/mesh.py ProcessMesh`): every rank
makes the same calls. The batch wrappers give each rank its slice of a
batch, through the same kernels, and an all-gather gives every rank the
whole batch (JAX's `shard_map` towers, `:76-160`); `build_serve_fn`
builds the gallery-sharded serve program (`ShardedServeFn`, JAX
`_build_sharded_serve_fn`, `:574-720`).

The batch wrappers take host arrays or tensors and run in slices of
`batch_size`. JAX padded the last slice to keep one compiled program;
eager PyTorch compiles nothing per shape, so the last slice runs at its
own size. Outputs are tensors on the API's device. The evaluators take
any iterables of batch dicts as loaders (`data/loader.py Loader`, or a
list of batches).
"""

from __future__ import annotations

import copy
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from fashionern_aaai2024_tpu_torch.data.captions import join_fiq_captions
from fashionern_aaai2024_tpu_torch.models.clip.tokenizer import tokenize
from fashionern_aaai2024_tpu_torch.models.composed import ComposedCIRModel
from fashionern_aaai2024_tpu_torch.ops.graphs import BucketedCall
from fashionern_aaai2024_tpu_torch.ops.qmatmul import int8_product
from fashionern_aaai2024_tpu_torch.ops.quant import quantize_rows
from fashionern_aaai2024_tpu_torch.ops.similarity import merge_top_k, select_top_k
from fashionern_aaai2024_tpu_torch.parallel.mesh import (
    ProcessMesh,
    all_gather_cols,
    all_gather_rows,
    all_reduce_sum,
    broadcast,
)
from fashionern_aaai2024_tpu_torch.retrieval import metrics as M
from fashionern_aaai2024_tpu_torch.retrieval.engine import (
    GalleryFeatures,
    Placer,
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
                 context_length: int = 77, quantize_gallery: bool = False,
                 quantize_refs: bool = False, approx_recall: float | None = None,
                 mesh: ProcessMesh | None = None):
        """`tokenizer`: callable (captions, context_length) -> int32
        [B, L]; by default the port's CLIP BPE (`models/clip/tokenizer.py
        tokenize`), which finds its table at the first call
        (`default_bpe_path`) or raises FileNotFoundError there.
        `quantize_gallery`: the services built on this API store the
        refined gallery int8 for the top-k search (`--quantize-gallery`,
        `ops/quant.py`). `quantize_refs`: the serve program stores its
        reference rows (raw features and patches) int8 with one scale per
        row and dequantizes the gathered rows (`--quantize-refs`, ~4x
        fewer bytes on the serve program's largest array). `approx_recall`:
        None is the exact top-k; a float selects every gallery-wide top-k
        this API builds (the evaluators' search, the serve program)
        through the approximate tier at that recall target
        (`--topk-recall`, `ops/similarity.py`). `mesh`: every batch is
        split over the mesh's ranks (each encodes its slice on the mesh's
        device, then an all-gather) and the serve program is
        gallery-sharded; `batch_size` must divide by the mesh size."""
        if mesh is not None and batch_size % mesh.size:
            raise ValueError(f"batch_size {batch_size} not divisible by mesh size "
                             f"{mesh.size}")
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None else mesh.device)
        self.quantize_gallery = quantize_gallery
        self.quantize_refs = quantize_refs
        self.approx_recall = approx_recall
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.context_length = context_length
        self._tokenizer = tokenizer if tokenizer is not None else tokenize

    def _to_device(self, a, dtype: torch.dtype | None = None) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device, dtype)

    def _rank_rows(self, m: int) -> torch.Tensor:
        """The rows of an m-row slice this rank encodes on the mesh: the
        contiguous part [r · per, (r + 1) · per), per = ceil(m / size),
        padded to per rows by repeating its last row (a rank past the
        slice's rows takes its last row)."""
        per = -(-m // self.mesh.size)
        lo, hi = min(self.mesh.rank * per, m), min((self.mesh.rank + 1) * per, m)
        idx = torch.arange(lo, hi) if hi > lo else torch.tensor([m - 1])
        return torch.cat([idx, idx[-1:].expand(per - len(idx))])

    def _gather(self, res):
        """A rank's outputs (a tensor or a tuple) -> every rank's, in rank
        order, on every rank."""
        gathered = tuple(all_gather_rows(self.mesh, r.contiguous())
                         for r in (res if isinstance(res, tuple) else (res,)))
        return gathered if isinstance(res, tuple) else gathered[0]

    def _map(self, fn: Callable, n: int, *arrays, chunk: int | None = None) -> list:
        """`fn` over slices of `chunk` (default batch_size) rows of the
        arrays, as device tensors. On a mesh each rank runs `fn` on its
        rows of a slice (`_rank_rows`), and an all-gather gives every rank
        the slice's outputs. -> the outputs of every slice, in order."""
        step = chunk or self.batch_size
        out = []
        for i in range(0, n, step):
            xs = [a[i:i + step] for a in arrays]
            if self.mesh is None:
                out.append(fn(*xs))
                continue
            m = len(xs[0])
            idx = self._rank_rows(m)
            res = self._gather(fn(*(torch.as_tensor(x)[idx] for x in xs)))
            out.append(tuple(r[:m] for r in res) if isinstance(res, tuple) else res[:m])
        return out

    @torch.inference_mode()
    def encode_image(self, images) -> tuple[torch.Tensor, torch.Tensor]:
        """[N, H, W, 3] (normalized float or uint8) -> (global, tokens)."""
        out = self._map(lambda x: self.model.encode_image(self._to_device(x)),
                        len(images), images)
        return torch.cat([g for g, _ in out]), torch.cat([t for _, t in out])

    @torch.inference_mode()
    def encode_text(self, token_ids, visual_emb=None) -> tuple[torch.Tensor, torch.Tensor]:
        """int [N, L] -> (global [N, d], seq [N, L, d]). `visual_emb`, the
        reference patch features [N, P, d], is required on a TME model
        (cast to fp32 first, as JAX does; the model raises without it) and
        ignored on a vanilla one (`evaluate.py:192-207`)."""
        if not self.model.clip_config.text.tme:
            visual_emb = None
        if visual_emb is None:
            out = self._map(lambda ids: self.model.encode_text(self._to_device(ids)),
                            len(token_ids), token_ids)
        else:
            out = self._map(lambda ids, ve: self.model.encode_text(
                self._to_device(ids), visual_emb=self._to_device(ve, torch.float32)),
                len(token_ids), token_ids, visual_emb)
        return torch.cat([g for g, _ in out]), torch.cat([t for _, t in out])

    @torch.inference_mode()
    def query(self, ref_feats, ref_patch, text_g, text_seq) -> torch.Tensor:
        """DVR query tower; inputs are cast to fp32 first, as the JAX API
        does (`evaluate.py:213-216`)."""
        f32 = torch.float32
        return torch.cat(self._map(
            lambda rf, rp, tg, ts: self.model.query(
                self._to_device(rf, f32), self._to_device(rp, f32), self._to_device(tg, f32),
                self._to_device(ts, f32)),
            len(ref_feats), ref_feats, ref_patch, text_g, text_seq))

    @torch.inference_mode()
    def refine_gallery(self, features, local_features, chunk: int = 4096) -> torch.Tensor:
        """Index tower over the gallery: L2-normalize (eps 1e-12 added,
        `evaluate.py:101-104`), then SR + Combiner. On a mesh each chunk
        (rounded up to a multiple of the mesh size) is split over the
        ranks."""
        if self.mesh is not None:
            chunk = -(-chunk // self.mesh.size) * self.mesh.size

        def index(f, lf):
            tf = self._to_device(f, torch.float32)
            tf = tf / (torch.linalg.vector_norm(tf, dim=-1, keepdim=True) + 1e-12)
            return self.model.index(tf, self._to_device(lf, torch.float32))

        return torch.cat(self._map(index, len(features), features, local_features,
                                   chunk=chunk))

    def unsharded(self) -> "InferenceAPI":
        """This API on this rank alone: the same model, device and
        settings, no mesh (so no collective)."""
        if self.mesh is None:
            return self
        api = copy.copy(self)
        api.mesh = None
        return api

    def tokenize(self, captions: Sequence[str]) -> np.ndarray:
        return self._tokenizer(captions, self.context_length)

    def gallery_encode_fn(self) -> Callable:
        """The image encoder `engine.embed_gallery` takes (JAX
        `evaluate.py:735-742`): placed images -> (global, tokens) on the
        API's device. Its `.place` (`engine.Placer`) stages a batch on this
        device ahead of dispatch; on a mesh it copies only this rank's rows
        (`_rank_rows`), which the encode takes as they are, and the
        outputs are the all-gathered [size · per] rows (the engine keeps
        the batch's first n)."""
        if self.mesh is None:
            def fn(images):
                return self.encode_image(images)
        else:
            @torch.inference_mode()
            def fn(local: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
                return self._gather(self.model.encode_image(local))
        fn.place = Placer(self.device, None if self.mesh is None else self._rank_rows)
        return fn

    def build_serve_fn(self, gallery_features, k_max: int = 50,
                       buckets: Sequence[int] = (1, 8, 32), patch_num: int = 13,
                       ref_features=None, ref_patches=None, mesh=None,
                       capacity: int | None = None) -> "ServeFn":
        """The one-dispatch serve program (JAX `evaluate.py:254-572`):
        text tower -> DVR query tower -> gallery scores -> top-k in one
        call per request, at the smallest batch bucket that holds it.
        `ref_features` / `ref_patches` given (the by-rows form): the
        request names gallery rows and the program gathers them.
        `capacity` (by rows): the arrays are padded to `capacity` rows
        and `update_rows` grows or rewrites the gallery in place. See
        `ServeFn`. `mesh` (or the API's own): the gallery-sharded program
        (`ShardedServeFn`), by rows only and without capacity."""
        mesh = mesh if mesh is not None else self.mesh
        if mesh is not None:
            if ref_features is None:
                raise ValueError("mesh-sharded serving needs the by-rows form "
                                 "(pass ref_features/ref_patches)")
            if capacity is not None:
                raise ValueError("capacity (live adds) is single-device serving only; "
                                 "mesh-sharded galleries are static")
            return ShardedServeFn(self, mesh, gallery_features, k_max, buckets, patch_num,
                                  ref_features, ref_patches)
        return ServeFn(self, gallery_features, k_max, buckets, patch_num, ref_features,
                       ref_patches, capacity)


class _QueryTower(torch.nn.Module):
    """The model part of the serve program: the text tower (TME on the
    reference patches on a TME model) and the DVR query tower, as one
    module, so that `torch.func.functional_call` can run it on weights
    passed as arguments (`ServeFn.program`)."""

    def __init__(self, model: ComposedCIRModel, tme: bool):
        super().__init__()
        self.model = model
        self.tme = tme

    def forward(self, ids: torch.Tensor, rf: torch.Tensor, rp: torch.Tensor) -> torch.Tensor:
        tg, ts = self.model.encode_text(ids, visual_emb=rp.float() if self.tme else None)
        return self.model.query(rf.float(), rp.float(), tg.float(), ts.float())


def _flat(parts) -> list[torch.Tensor]:
    return [t for p in parts for t in (p if isinstance(p, tuple) else (p,))]


def _host_f32(a) -> torch.Tensor:
    return torch.as_tensor(a).detach().to("cpu", torch.float32)


def _pad_to(t: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.cat([t, t.new_zeros((rows - t.shape[0], *t.shape[1:]))])


class ServeFn:
    """The one-dispatch serve program of an `InferenceAPI` (JAX
    `build_serve_fn`, `evaluate.py:254-572`), single-device.

    `serve(token_ids, rows, k)` (by rows) or `serve(token_ids, ref_feats,
    ref_patch, k)` (by features) -> (scores [n, k], gallery rows [n, k])
    as host arrays, k clamped to `k_max` and to the valid rows. The body,
    in order: gather the reference rows (dequantized after the gather
    under `quantize_refs`), the text tower (TME on the gathered patches
    on a TME model), the DVR query tower, the gallery scores (an fp32
    product, or under `quantize_gallery` JAX's int8 form: the query rows
    quantized, the exact int32 sums, the rescale), the columns at or past
    `n_valid` masked to -inf on a growable program, and the top-k of
    `k_max` (`ops/similarity.py select_top_k`, exact or approximate).

    A request of n rows runs at the smallest bucket >= n, its rows padded
    with zero ids and row 0 (their results are dropped); a batch past the
    largest bucket raises. On the card each bucket is one CUDA graph
    (`ops/graphs.py BucketedCall`, the artifact's request path too) over
    static tensors: the request's ids
    and rows (or features) are copied into the bucket's inputs, the graph
    replays once, and `[:n, :k]` of its outputs come back to the host.
    The gallery, the reference rows and `n_valid` (a device scalar) are
    static tensors that every bucket's graph reads; the graphs share one
    memory pool. Every bucket is captured when the program is built, so
    no capture runs once it serves; `warmup()` does nothing more. On the
    CPU the same body runs eagerly on the same tensors.

    `consts` (JAX `consts`): the model's weights and buffers, the gallery
    and the reference rows, as one flat list of the tensors the body
    reads; `program(consts, ids, rows)` (JAX `jfn`): the body of the
    by-rows form on those tensors passed as arguments, what an artifact
    exports (`retrieval/artifact.py`).

    `update_rows(start, refined, ref_f, ref_p)` (growable only) checks
    every shape, then writes the rows into the static tensors in place
    and sets `n_valid`: the graphs see the new rows at their next replay,
    with no recapture. Gallery and reference rows are quantized on the
    host (`ops/quant.py quantize_rows`, JAX's `quantize_rows_np`), so only
    int8 bytes and scales go to the device. Calls and updates hold the
    buckets' lock: the static tensors serve one request at a time."""

    def __init__(self, api: InferenceAPI, gallery_features, k_max: int,
                 buckets: Sequence[int], patch_num: int, ref_features, ref_patches,
                 capacity: int | None):
        self.api = api
        self.device = api.device
        self.context_length = api.context_length
        self.patch_num = patch_num
        n_rows = int(gallery_features.shape[0])
        self.feat_dim = int(gallery_features.shape[1])
        self.k_max = min(k_max, n_rows if capacity is None else capacity)
        self.buckets = tuple(sorted(buckets))
        self.by_rows = ref_features is not None
        self.growable = capacity is not None
        self.capacity = capacity
        self.quantized = api.quantize_gallery
        self.quantize_refs = api.quantize_refs
        self.approx_recall = api.approx_recall
        self.tme = bool(api.model.clip_config.text.tme)
        rows = n_rows
        if self.growable:
            if not self.by_rows:
                raise ValueError("capacity needs the by-rows form "
                                 "(pass ref_features/ref_patches)")
            if capacity < n_rows:
                raise ValueError(f"capacity {capacity} < current gallery {n_rows}")
            rows = capacity

        def resident(a) -> torch.Tensor:
            t = _host_f32(a)
            return _pad_to(t, rows) if self.growable else t

        self.gallery = self._place(resident(gallery_features), self.quantized)
        if self.by_rows:
            self.ref_f = self._place(resident(ref_features), self.quantize_refs)
            self.ref_p = self._place(resident(ref_patches), self.quantize_refs)
        self._n_valid = n_rows
        if self.growable:
            self._n_valid_dev = torch.tensor(n_rows, dtype=torch.int64, device=self.device)
            self._cols = torch.arange(rows, device=self.device)
        self._tower = _QueryTower(api.model, self.tme)
        self._buckets = BucketedCall(self.body, self._static_inputs, self.buckets,
                                     self.device)
        # the graphs read the int8 weight sets cached when they were captured
        # (`models/clip/transformer.py int8_weights`); the program holds
        # them, so that a rebuild of the cache (any `.to()` of the model
        # drops it) cannot free memory a replay reads
        self._int8_weights = [m._int8 for m in api.model.modules()
                              if getattr(m, "_int8", None) is not None]

    def _static_inputs(self, b: int) -> tuple[torch.Tensor, ...]:
        """One bucket's inputs: ids, and rows or features and patches."""
        dev = self.device
        ids = torch.zeros((b, self.context_length), dtype=torch.int32, device=dev)
        if self.by_rows:
            return ids, torch.zeros(b, dtype=torch.int64, device=dev)
        return (ids, torch.zeros((b, self.feat_dim), device=dev),
                torch.zeros((b, self.patch_num, self.feat_dim), device=dev))

    def _place(self, host: torch.Tensor, quantize: bool):
        """A host fp32 array on the device: as it is, or as (int8 values,
        fp32 scales) with one scale per row of the last axis."""
        if not quantize:
            return host.to(self.device)
        values, scales = quantize_rows(host.reshape(-1, host.shape[-1]))
        return (values.reshape(host.shape).to(self.device),
                scales.reshape(host.shape[:-1]).to(self.device))

    def _gather(self, rows: torch.Tensor, ref_f, ref_p) -> tuple[torch.Tensor, torch.Tensor]:
        """The reference rows; int8 rows dequantize after the gather (only
        the requested rows, not the gallery)."""
        if not self.quantize_refs:
            return ref_f[rows], ref_p[rows]
        (fq, fs), (pq, ps) = ref_f, ref_p
        return fq[rows].float() * fs[rows][:, None], pq[rows].float() * ps[rows][:, :, None]

    def _scores(self, pred: torch.Tensor, gallery) -> torch.Tensor:
        if not self.quantized:
            return pred @ gallery.t()
        gq, gs = gallery
        qv, qs = quantize_rows(pred)
        return int8_product(qv, gq) * qs[:, None] * gs[None, :]

    def _select(self, scores: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if self.growable:
            # rows >= n_valid are zero padding: they must lose to every real row
            scores = scores.masked_fill(self._cols >= self._n_valid_dev, -torch.inf)
        return tuple(select_top_k(scores, self.k_max, self.approx_recall))

    @torch.no_grad()
    def body(self, ids: torch.Tensor, ref: torch.Tensor,
             patch: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """The program on device tensors: ids [b, L] int32 and rows [b]
        (by rows) or features [b, d] and patches [b, P, d] -> (scores
        [b, k_max], rows [b, k_max])."""
        rf, rp = self._gather(ref, self.ref_f, self.ref_p) if self.by_rows else (ref, patch)
        return self._select(self._scores(self._tower(ids, rf, rp), self.gallery))

    def _model_names(self) -> list[str]:
        """The tower's weights and buffers that the body reads: all but the
        image tower's (it embeds the gallery, never a query)."""
        names = ([n for n, _ in self._tower.named_parameters()]
                 + [n for n, _ in self._tower.named_buffers()])
        return [n for n in names if not n.startswith("model.clip.visual.")]

    @property
    def consts(self) -> list[torch.Tensor]:
        """The tensors the by-rows body reads, in `program`'s order: the
        model's parameters, then its buffers, then the gallery and the
        reference features and patches (each as (int8 values, scales)
        where it is quantized)."""
        if not self.by_rows:
            raise ValueError("consts: the serve program needs the by-rows form "
                             "(pass ref_features/ref_patches)")
        state = dict(self._tower.named_parameters())
        state.update(self._tower.named_buffers())
        return ([state[n].detach() for n in self._model_names()]
                + _flat((self.gallery, self.ref_f, self.ref_p)))

    def program(self, consts: Sequence[torch.Tensor], ids: torch.Tensor,
                rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The by-rows body on `consts` (in `consts`' order and shapes)
        passed as arguments: the weights through
        `torch.func.functional_call`, the gallery and the reference rows
        in place of the resident ones."""
        names = self._model_names()
        state = dict(zip(names, consts[:len(names)]))
        rest = list(consts[len(names):])

        def take(quantized: bool):
            return (rest.pop(0), rest.pop(0)) if quantized else rest.pop(0)
        gallery = take(self.quantized)
        ref_f, ref_p = take(self.quantize_refs), take(self.quantize_refs)
        with torch.no_grad():
            rf, rp = self._gather(rows, ref_f, ref_p)
            pred = torch.func.functional_call(self._tower, state, (ids, rf, rp))
            return self._select(self._scores(pred, gallery))

    def __call__(self, token_ids, ref, ref_patch=None, k: int = 10):
        # never emit masked rows: their scores are -inf, their rows invalid
        # (`_n_valid` only grows, so a concurrent update cannot shrink it)
        k = min(k, self.k_max, self._n_valid)
        return self._buckets((token_ids, ref) if self.by_rows
                             else (token_ids, ref, ref_patch), k)

    def warmup(self) -> None:
        """JAX compiles each bucket here; every bucket of the port is
        captured when the program is built."""

    def n_valid(self) -> int:
        return self._n_valid

    def update_rows(self, start: int, refined, ref_feat_rows, ref_patch_rows) -> int:
        """Write m items at rows [start, start + m) of the capacity-padded
        tensors (append when start == n_valid, overwrite otherwise); ->
        the new valid-row count. Every input is checked and prepared
        before any row is written."""
        if not self.growable:
            raise ValueError("serve fn built without capacity=")
        g32, rf32, rp32 = (_host_f32(a) for a in (refined, ref_feat_rows, ref_patch_rows))
        m, d = int(g32.shape[0]), self.feat_dim
        if start + m > self.capacity:
            raise ValueError(f"update [{start}, {start + m}) exceeds capacity "
                             f"{self.capacity}; rebuild the service with more headroom")
        if (tuple(g32.shape) != (m, d) or tuple(rf32.shape) != (m, d) or rp32.ndim != 3
                or rp32.shape[0] != m or rp32.shape[2] != d):
            raise ValueError(f"update_rows shapes: refined {tuple(g32.shape)}, ref_feats "
                             f"{tuple(rf32.shape)}, ref_patches {tuple(rp32.shape)} don't "
                             f"agree with m={m}, d={d}")
        writes = [(self.gallery, self._place(g32, self.quantized)),
                  (self.ref_f, self._place(rf32, self.quantize_refs)),
                  (self.ref_p, self._place(rp32, self.quantize_refs))]
        sl = slice(start, start + m)
        with self._buckets.lock:
            for dst, src in writes:
                for d_t, s_t in (zip(dst, src) if isinstance(dst, tuple) else [(dst, src)]):
                    d_t[sl] = s_t
            self._n_valid = max(self._n_valid, start + m)
            self._n_valid_dev.fill_(self._n_valid)
            return self._n_valid


class ShardedServeFn(ServeFn):
    """The gallery-sharded serve program (JAX `_build_sharded_serve_fn`,
    `evaluate.py:574-720`), by rows, over a data-parallel mesh: every rank
    builds it with the same arguments, and each holds rows [r · per,
    (r + 1) · per) of the gallery and of the reference features and
    patches, per = ceil(n / size), zero-padded on the last shards (int8
    values and scales under `quantize_gallery` / `quantize_refs`, as the
    single-device program stores them). So the gallery, the serving
    memory axis, divides over the mesh.

    The body on each rank: the reference rows by a masked local gather
    and an all-reduce of the sum (each row lives on one rank; the others
    add zeros), the text tower (TME conditioned on the gathered patches)
    and the DVR query tower on the whole request (b <= 32 rows: doing it
    on every rank beats moving activations), the scores of the local
    shard with its pad tail masked to -inf before the local top-k, the
    candidates' global row ids (invalid ones the largest id), an
    all-gather of the [b, k_local] candidates, and the exact merge
    (`ops/similarity.py merge_top_k`) to `k_max`.

    Requests come to rank 0 (`__call__`, the single-device program's
    signature). Before its bucket runs, rank 0 broadcasts the bucket and
    the row count, then the bucket's static inputs; the other ranks sit in
    `follow()`, which receives each dispatch into the same bucket's
    inputs and runs the same bucket in lockstep until `close()` (rank 0)
    sends the shutdown message. On the card each bucket is one CUDA graph
    with its NCCL collectives inside; a gloo group on the card is refused
    (a graph cannot hold gloo's collectives), and on the CPU the buckets
    run eagerly. What the card has shown is world 1 only: there an NCCL
    collective records into a capture and the graph replays correctly,
    but NCCL records no kernel node at world 1 (ROADMAP "Ground facts").
    That a graph holding real NCCL kernels captures, and replays in
    lockstep with the eager dispatch broadcasts, at world >= 2 is not
    verified (ROADMAP C22). Not exportable and not growable (JAX refuses
    both)."""

    def __init__(self, api: InferenceAPI, mesh: ProcessMesh, gallery_features, k_max: int,
                 buckets: Sequence[int], patch_num: int, ref_features, ref_patches):
        if api.device.type == "cuda" and mesh.backend not in (None, "nccl"):
            raise ValueError(f"a serve program on {api.device} needs an NCCL group, not "
                             f"{mesh.backend}: its buckets are CUDA graphs, which cannot "
                             "hold gloo's collectives")
        self.api = api
        self.mesh = mesh
        self.device = api.device
        self.context_length = api.context_length
        self.patch_num = patch_num
        n_rows = int(gallery_features.shape[0])
        self.feat_dim = int(gallery_features.shape[1])
        self.k_max = min(k_max, n_rows)
        self.buckets = tuple(sorted(buckets))
        self.by_rows, self.growable, self.capacity = True, False, None
        self.quantized = api.quantize_gallery
        self.quantize_refs = api.quantize_refs
        self.approx_recall = api.approx_recall
        self.tme = bool(api.model.clip_config.text.tme)
        self.per = -(-n_rows // mesh.size)
        self.start = mesh.rank * self.per
        self.k_local = min(self.k_max, self.per)
        self._n_valid = n_rows
        self._local_valid = max(0, min(self.per, n_rows - self.start))

        def shard(a) -> torch.Tensor:
            t = _host_f32(a)[self.start:self.start + self.per]
            return _pad_to(t, self.per) if t.shape[0] < self.per else t

        self.gallery = self._place(shard(gallery_features), self.quantized)
        self.ref_f = self._place(shard(ref_features), self.quantize_refs)
        self.ref_p = self._place(shard(ref_patches), self.quantize_refs)
        self._cols = torch.arange(self.per, device=self.device)
        self._tower = _QueryTower(api.model, self.tme)
        self._header = torch.zeros(2, dtype=torch.int64, device=self.device)
        self._closed = False
        self._buckets = BucketedCall(self.body, self._static_inputs, self.buckets,
                                     self.device,
                                     on_dispatch=self._dispatch if mesh.rank == 0 else None)
        self._int8_weights = [m._int8 for m in api.model.modules()
                              if getattr(m, "_int8", None) is not None]

    @torch.no_grad()
    def body(self, ids: torch.Tensor, rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One rank's program: ids [b, L] int32 and global rows [b] ->
        the merged (scores [b, k_max], rows [b, k_max]), the same on
        every rank."""
        mesh = self.mesh
        local = rows - self.start
        hit = (local >= 0) & (local < self.per)
        gf, gp = self._gather(torch.where(hit, local, torch.zeros_like(local)),
                              self.ref_f, self.ref_p)
        rf = all_reduce_sum(mesh, gf * hit[:, None].to(gf.dtype))
        rp = all_reduce_sum(mesh, gp * hit[:, None, None].to(gp.dtype))
        scores = self._scores(self._tower(ids, rf, rp), self.gallery)
        # the pad tail scores 0: it must lose to every real row
        scores = scores.masked_fill(self._cols >= self._local_valid, -torch.inf)
        s, i = select_top_k(scores, self.k_local, self.approx_recall)
        gi = torch.where(s > -torch.inf, i + self.start, torch.iinfo(torch.int64).max)
        return merge_top_k(all_gather_cols(mesh, s), all_gather_cols(mesh, gi), self.k_max)

    def _dispatch(self, b: int, n: int, bucket) -> None:
        """Rank 0, under the buckets' lock: the dispatch to the other ranks."""
        self._header.copy_(torch.tensor([b, n]))
        broadcast(self.mesh, self._header)
        for t in bucket.inputs:
            broadcast(self.mesh, t)

    def follow(self) -> int:
        """A rank other than 0: run every dispatch of rank 0 until it
        closes the program; -> the number of dispatches run."""
        if self.mesh.rank == 0:
            raise RuntimeError("follow() runs on the ranks other than 0")
        runs = 0
        while True:
            broadcast(self.mesh, self._header)
            b, _ = self._header.tolist()
            if b == 0:
                return runs
            bucket = self._buckets[b]
            for t in bucket.inputs:
                broadcast(self.mesh, t)
            bucket.run()
            runs += 1

    def close(self) -> None:
        """Rank 0: end the other ranks' `follow()` loops (once)."""
        if self.mesh.rank != 0 or self._closed:
            return
        with self._buckets.lock:
            self._header.zero_()
            broadcast(self.mesh, self._header)
            self._closed = True

    @property
    def consts(self) -> list[torch.Tensor]:
        raise ValueError("mesh-sharded serve programs are not exportable")


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
    every prediction. On the approximate tier the index first measures
    its recall on this gallery (a warning when it undershoots)."""
    refined = api.refine_gallery(gallery.features, gallery.local_features)
    index = RetrievalIndex(gallery.names, refined, quantize=api.quantize_gallery,
                           approx_recall=api.approx_recall)
    k = min(k, len(gallery.names))
    index.calibrate_approx(k=k)
    _, idx = index.search(preds, k=k)
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
    gallery = embed_gallery(api.gallery_encode_fn(), classic_loader, api.batch_size)
    preds, meta = generate_predictions(api, relative_loader, fiq_caption_fn, gallery,
                                       collect=("tar_name",))
    index, topk_ids = _search_ids(api, gallery, preds, max(ks))
    r = M.recall_at_k(topk_ids, M.names_to_id_array(meta["tar_name"], index.vocab), ks)
    out = {f"recall_at{k}": r[k] for k in ks}
    out["avg"] = float(np.mean(list(r.values())))
    return out


def evaluate_shoes(api: InferenceAPI, classic_loader: Iterable[dict],
                   relative_loader: Iterable[dict]) -> dict:
    gallery = embed_gallery(api.gallery_encode_fn(), classic_loader, api.batch_size)
    preds, meta = generate_predictions(api, relative_loader, plain_caption_fn, gallery,
                                       collect=("tar_name",))
    index, topk_ids = _search_ids(api, gallery, preds, 50)
    return M.fiq_metrics(topk_ids, M.names_to_id_array(meta["tar_name"], index.vocab))


def evaluate_fashion200k(api: InferenceAPI, classic_loader: Iterable[dict],
                         relative_loader: Iterable[dict]) -> dict:
    """Gallery names are caption ids: duplicate ids encode the
    multi-positive semantics (`test_200k.py:53-60`)."""
    gallery = embed_gallery(api.gallery_encode_fn(), classic_loader, api.batch_size)
    preds, meta = generate_predictions(api, relative_loader, plain_caption_fn, gallery,
                                       collect=("tar_id",), ref_key="ref_id")
    index, topk_ids = _search_ids(api, gallery, preds, 50)
    return M.fashion200k_metrics(topk_ids, M.names_to_id_array(meta["tar_id"], index.vocab))


def evaluate_cirr(api: InferenceAPI, classic_loader: Iterable[dict],
                  relative_loader: Iterable[dict]) -> dict:
    """The CIRR suite on the val split: R@K with the reference image
    dropped from the ranking, and subset recall among the 6 group
    members (`validate_cirr.py:11-126`)."""
    gallery = embed_gallery(api.gallery_encode_fn(), classic_loader, api.batch_size)
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
    gallery = embed_gallery(api.gallery_encode_fn(), classic_loader, api.batch_size)
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
