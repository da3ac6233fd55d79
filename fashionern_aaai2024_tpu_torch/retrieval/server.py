"""`fashionern-torch serve`: the composed-retrieval service.

JAX counterpart: `fashionern_aaai2024_tpu/retrieval/server.py`:
`_ServiceBase` (`:40-89`, request count and latency percentiles),
`RetrievalService` (`:91-302`), `MicroBatcher` (`:397-479`),
`ArtifactService` (`:304-395`), `_make_handler` (`:482-577`) and `serve`
(`:580-591`). This module imports nothing of `models/` or `data/` at
import time: the artifact-backed service runs on a host without the
model stack.

At construction the service embeds the gallery through the image tower,
refines it through the ERN index tower, indexes it (measuring the
approximate tier's recall on it with `calibrate_approx(strict=True)`),
and builds the one-dispatch serve program over the refined gallery and
the raw reference rows (`InferenceAPI.build_serve_fn`; on the card one
CUDA graph per batch bucket, all captured as it is built, before the
service takes a request; `warmup` is accepted for JAX's signature and
changes nothing). A query runs under the service lock: tokenize, then
one call of the serve program; a k past the program's `k_max` takes the
multi-dispatch path (text tower, DVR, `RetrievalIndex.search`) over an
index rebuilt lazily after live adds. That path gives the text tower
the request rows' reference patches, as the serve program does for a
TME model; the JAX fallback omits them and fails on a TME model
(ROADMAP C7).

Live adds (`capacity`): `add_items` embeds outside the lock, then
replaces a known name's row in place or appends, through the serve
program's `update_rows` (no recapture), and calls `names_changed_cb`
(the native front's name table). `add_from_paths` (`POST /add`) reads
images and patches under `add_root` only.

`ArtifactService` answers the same queries from a loaded serve artifact
(`retrieval/artifact.py`: on the card one CUDA graph per bucket) and the
port's tokenizer (`tokenizer.py`), k clamped to the exported `k_max`;
`reload` (`POST /reload`) copies republished consts into the running
programs (`ServeArtifact.reload_consts`).

HTTP (stdlib `ThreadingHTTPServer`):
  POST /query   {"ref_name", "caption", "k"=10} or {"ref_names": [...],
                "captions": [...], "k"} -> {"results", "latency_ms"}
  POST /add     {"items": [{"name", "image_path", "patch_path"}]}
                (model-backed services; 404 for an artifact)
  POST /reload  -> {"reloaded", "seconds", "gallery_size"} (artifact-backed
                services; 404 for a model-backed one)
  GET  /healthz -> {"status": "ok", "gallery_size": N}
  GET  /stats   -> request count, latency percentiles, batching counts
Concurrent single queries coalesce through the `MicroBatcher`: one
device thread runs up to the largest bucket's worth of them as one call.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterable, Sequence

import numpy as np
import torch

from fashionern_aaai2024_tpu_torch.retrieval.engine import RetrievalIndex, embed_gallery


class _ServiceBase:
    """Request bookkeeping and response formatting."""

    def _init_stats(self):
        self.batcher = None  # attached by serve(dynamic_batching=True)
        self._lock = threading.Lock()
        self.request_count = 0
        self._latencies: list[float] = []

    def _record_latency(self, latency: float) -> None:
        with self._lock:
            self.request_count += 1
            self._latencies.append(latency)
            if len(self._latencies) > 10_000:
                del self._latencies[:5_000]

    @staticmethod
    def _format_results(names, scores, idx, n: int):
        return [
            [{"name": str(names[idx[q, j]]), "score": float(scores[q, j])}
             for j in range(idx.shape[1])]
            for q in range(n)
        ]

    def stats(self) -> dict:
        with self._lock:
            count = self.request_count
            lat = sorted(self._latencies)

        def pct(p):
            return round(lat[min(len(lat) - 1, int(p * len(lat)))] * 1e3, 2) if lat else None

        out = {
            "requests": count,
            "gallery_size": self.gallery_size,
            "startup_seconds": round(self.startup_seconds, 2),
            "latency_ms": {"p50": pct(0.50), "p90": pct(0.90), "p99": pct(0.99)},
        }
        if self.batcher is not None:
            out["dynamic_batching"] = {
                "batches": self.batcher.batches_run,
                "items": self.batcher.items_run,
                "max_batch": self.batcher.max_batch,
            }
        return out


class RetrievalService(_ServiceBase):
    """Gallery-resident composed retrieval around an InferenceAPI.

    `capacity` (>= gallery size): a live-growable gallery (`add_items`).
    `image_spec` (dim, pad_mode, target_ratio, image_dtype) is the
    preprocessing of `/add` images; `add_root` confines the paths `/add`
    may read. `caption_join` maps a request's caption before the
    tokenizer."""

    def __init__(self, api: InferenceAPI, classic_loader: Iterable[dict], caption_join=None,
                 warmup: bool = True, capacity: int | None = None,
                 image_spec: dict | None = None, add_root: str | None = None):
        from fashionern_aaai2024_tpu_torch.retrieval.evaluate import last_wins_rows

        self.api = api
        self.image_spec = image_spec or {}
        self.add_root = add_root
        t0 = time.perf_counter()
        self.gallery = embed_gallery(api.gallery_encode_fn(), classic_loader, api.batch_size)
        self._refined = api.refine_gallery(self.gallery.features, self.gallery.local_features)
        self.index = RetrievalIndex(self.gallery.names, self._refined,
                                    quantize=api.quantize_gallery,
                                    approx_recall=api.approx_recall)
        # the approximate tier's recall on this gallery, before any traffic
        self.measured_topk_recall = self.index.calibrate_approx(strict=True)
        self.rows = last_wins_rows(self.gallery.names)
        self.capacity = capacity
        self._serve_fn = api.build_serve_fn(
            self._refined, patch_num=self.gallery.local_features.shape[1],
            ref_features=self.gallery.features, ref_patches=self.gallery.local_features,
            capacity=capacity)
        self.startup_seconds = time.perf_counter() - t0
        self.caption_join = caption_join or (lambda c: c)
        # a native front may tokenize on its own thread only when no
        # caption transform runs before the tokenizer
        self.caption_join_is_identity = caption_join is None
        self.names_changed_cb = None
        self._init_stats()

    @property
    def gallery_size(self) -> int:
        return len(self.gallery.names)

    def add_items(self, names: Sequence[str], images, patches) -> dict:
        """Embed and serve new gallery items on the running service
        (requires `capacity`). images [m, H, W, 3] preprocessed (float32
        normalized or uint8); patches [m, patch_num, d]. A name the
        gallery has is replaced in its row; the others are appended."""
        if self.capacity is None:
            raise ValueError("service built without --capacity; live adds need "
                             "capacity headroom (restart with serve --capacity N)")
        m = len(names)
        if images.shape[0] != m or patches.shape[0] != m:
            raise ValueError("names/images/patches length mismatch")
        t0 = time.perf_counter()
        # embed outside the lock: queries keep flowing
        feats = self.api.encode_image(images)[0].float()
        patches = torch.as_tensor(patches).to(feats.device, torch.float32)
        refined = self.api.refine_gallery(feats, patches)
        # the gallery tensors come out of inference mode: write them in it
        with self._lock, torch.inference_mode():
            replace = [j for j, n in enumerate(names) if n in self.rows]
            append = [j for j, n in enumerate(names) if n not in self.rows]
            for j in replace:
                row = self.rows[names[j]]
                self._serve_fn.update_rows(row, refined[j:j + 1], feats[j:j + 1],
                                           patches[j:j + 1])
                self.gallery.features[row] = feats[j]
                self.gallery.local_features[row] = patches[j]
                self._refined[row] = refined[j]
            if append:
                start = len(self.gallery.names)
                self._serve_fn.update_rows(start, refined[append], feats[append],
                                           patches[append])
                self.gallery.names.extend(names[j] for j in append)
                self.gallery.features = torch.cat([self.gallery.features, feats[append]])
                self.gallery.local_features = torch.cat([self.gallery.local_features,
                                                         patches[append]])
                self._refined = torch.cat([self._refined, refined[append]])
                for i, j in enumerate(append):
                    self.rows[names[j]] = start + i
            # the large-k fallback's index is rebuilt at its next use
            self.index = None
            n_valid = self._serve_fn.n_valid()
        if self.names_changed_cb is not None:
            self.names_changed_cb()
        return {"added": len(append), "replaced": len(replace), "gallery_size": n_valid,
                "seconds": round(time.perf_counter() - t0, 3)}

    def _fallback_index(self) -> RetrievalIndex:
        """The large-k path's index, rebuilt after live adds (call with
        the lock held)."""
        if self.index is None:
            self.index = RetrievalIndex(self.gallery.names, self._refined,
                                        quantize=self.api.quantize_gallery,
                                        approx_recall=self.api.approx_recall)
        return self.index

    def multi_dispatch(self, ids: np.ndarray, rows: np.ndarray,
                       k: int) -> tuple[np.ndarray, np.ndarray]:
        """The large-k path (call with the lock held): the text tower, the
        DVR query tower and the index search, each its own launches. On a
        mesh rank 0 runs it alone, without the mesh's collectives (each
        rank holds the whole gallery and its index; the other ranks wait
        in the serve program's `follow()`)."""
        api = self.api.unsharded()
        dev_rows = torch.as_tensor(rows, device=self.gallery.features.device)
        ref_patch = self.gallery.local_features[dev_rows]
        tg, tseq = api.encode_text(ids, visual_emb=ref_patch)
        preds = api.query(self.gallery.features[dev_rows], ref_patch, tg, tseq)
        return self._fallback_index().search(preds, k=k)

    def add_from_paths(self, items: Sequence[dict]) -> dict:
        """`POST /add`: items [{"name", "image_path", "patch_path"}]; each
        image decoded and preprocessed with the service's `image_spec`,
        each patch file a [patch_num, d] .npy; both under `add_root`."""
        if not self.image_spec.get("dim"):
            raise ValueError("service has no image_spec; construct RetrievalService "
                             "with image_spec=dict(dim=..., pad_mode=..., ...) to "
                             "accept path-based adds")
        if self.add_root is None:
            raise ValueError("path-based adds are disabled: construct RetrievalService "
                             "with add_root=<directory> (the serve CLI passes "
                             "--data-root) to allow reads under it")
        from fashionern_aaai2024_tpu_torch.data.transforms import load_and_preprocess

        root = os.path.realpath(self.add_root)

        def confined(p: str) -> str:
            rp = os.path.realpath(str(p))
            if os.path.commonpath([rp, root]) != root:
                raise ValueError("path outside the service add_root")
            return rp

        spec = self.image_spec
        names, imgs, patches = [], [], []
        for it in items:
            names.append(str(it["name"]))
            imgs.append(load_and_preprocess(
                confined(it["image_path"]), spec["dim"], spec.get("pad_mode", "target"),
                spec.get("target_ratio", 1.25), as_uint8=spec.get("image_dtype") == "uint8"))
            patches.append(np.load(confined(it["patch_path"])).astype(np.float32))
        return self.add_items(names, np.stack(imgs), np.stack(patches))

    def query(self, ref_names: Sequence[str], captions: Sequence[str], k: int = 10):
        """Composed queries -> (per-query top-k [{"name", "score"}...],
        latency seconds)."""
        if len(ref_names) != len(captions):
            raise ValueError("ref_names and captions length mismatch")
        unknown = [r for r in ref_names if r not in self.rows]
        if unknown:
            raise KeyError(f"unknown reference image(s): {unknown[:5]}")
        t0 = time.perf_counter()
        caps = [self.caption_join(c) for c in captions]
        rows = np.asarray([self.rows[r] for r in ref_names])
        k_eff = min(k, self.gallery_size)
        with self._lock:
            ids = self.api.tokenize(caps)
            if k_eff <= self._serve_fn.k_max:
                # one call of the serve program: one graph replay on the card
                scores, idx = self._serve_fn(ids, rows, k=k_eff)
            else:
                scores, idx = self.multi_dispatch(ids, rows, k_eff)
            names = np.asarray(self.gallery.names, dtype=object)
        latency = time.perf_counter() - t0
        self._record_latency(latency)
        return self._format_results(names, scores, idx, len(ref_names)), latency


class ArtifactService(_ServiceBase):
    """The service over a loaded serve artifact, with no model code
    (JAX `server.py:304-395`): the live service's `query`, `stats`,
    `gallery_size` and `rows`; the artifact on `device` (the card unless
    the caller asks for the CPU) and the port's tokenizer, which finds
    its table as `tokenizer.py default_bpe_path` does. Startup reads the
    programs and the consts and, on the card, captures each bucket. `k`
    is clamped to the exported `k_max`: the artifact holds the top-k
    program only, not the gallery matrix the live service searches for a
    larger k."""

    def __init__(self, artifact_dir: str, caption_join=None, warmup: bool = True,
                 allow_platform_mismatch: bool = False,
                 device: torch.device | str = "cuda"):
        from fashionern_aaai2024_tpu_torch.retrieval.artifact import load_serve_artifact
        from fashionern_aaai2024_tpu_torch.tokenizer import tokenize

        t0 = time.perf_counter()
        self.artifact = load_serve_artifact(artifact_dir, device=device,
                                            allow_platform_mismatch=allow_platform_mismatch)
        if self.artifact.names is None:
            raise ValueError("the artifact has no names.json (exported without "
                             "gallery_names); the HTTP service needs the row -> name map")
        self._tokenize = tokenize
        self._ctx = self.artifact.context_length
        self._set_names(self.artifact.names)
        # serve() reads ._serve_fn.buckets for the micro-batcher's cap
        self._serve_fn = self.artifact
        if warmup:  # on the CPU, the first call of each program; the card captured them
            for b in self.artifact.buckets:
                self.artifact.query(np.zeros((b, self._ctx), np.int32), np.zeros(b, np.int64),
                                    k=1)
        self.startup_seconds = time.perf_counter() - t0
        self.caption_join = caption_join or (lambda c: c)
        self._init_stats()

    def _set_names(self, names: Sequence[str]) -> None:
        # the last duplicate wins, as `evaluate.last_wins_rows`
        self.rows = {n: i for i, n in enumerate(names)}
        self._names = np.asarray(names, dtype=object)

    @property
    def gallery_size(self) -> int:
        return len(self._names)

    def query(self, ref_names: Sequence[str], captions: Sequence[str], k: int = 10):
        if len(ref_names) != len(captions):
            raise ValueError("ref_names and captions length mismatch")
        t0 = time.perf_counter()
        caps = [self.caption_join(c) for c in captions]
        # rows, the call and the row -> name map under one hold of the
        # lock: a /reload swaps names and consts together
        with self._lock:
            unknown = [r for r in ref_names if r not in self.rows]
            if unknown:
                raise KeyError(f"unknown reference image(s): {unknown[:5]}")
            rows = [self.rows[r] for r in ref_names]
            ids = self._tokenize(caps, self._ctx)
            scores, idx = self.artifact.query(ids, rows, k=k)
            names = self._names
        latency = time.perf_counter() - t0
        self._record_latency(latency)
        return self._format_results(names, scores, idx, len(ref_names)), latency

    def reload(self) -> dict:
        """POST /reload: the republished consts (and names) into the running
        programs, with no restart and no recapture; returns the swap's
        seconds."""
        t0 = time.perf_counter()
        with self._lock:
            self.artifact.reload_consts()
            self._set_names(self.artifact.names)
        return {"reloaded": True, "seconds": round(time.perf_counter() - t0, 3),
                "gallery_size": self.gallery_size}

    def stats(self) -> dict:
        out = super().stats()
        out["artifact"] = {"dir": self.artifact.dir,
                           "platform": self.artifact.manifest["platform"],
                           "model_name": self.artifact.manifest.get("model_name", "")}
        return out


class MicroBatcher:
    """Coalesces concurrent single composed queries into one call.

    Handler threads `submit()` and block; one device thread takes up to
    `max_batch` queued queries (waiting at most `max_wait_ms` for more
    after the first) and runs them as one `service.query`."""

    def __init__(self, service: RetrievalService, max_batch: int = 32,
                 max_wait_ms: float = 2.0):
        self.service = service
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.batches_run = 0
        self.items_run = 0
        self._cv = threading.Condition()
        self._queue: list = []
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, ref_name: str, caption: str, k: int = 10):
        """One composed query -> (top-k results, latency of its batch)."""
        if ref_name not in self.service.rows:
            # fail fast without poisoning the batch
            raise KeyError(f"unknown reference image(s): ['{ref_name}']")
        k_cap = getattr(self.service._serve_fn, "k_max", None)
        if k_cap is not None and int(k) > k_cap:
            # a large k runs the multi-dispatch path on its own: in a batch
            # (whose k is its items' largest) it would take every waiter along
            out, latency = self.service.query([ref_name], [caption], k=k)
            return out[0], latency
        slot: dict = {"event": threading.Event()}
        with self._cv:
            if self._stop:
                raise RuntimeError("batcher closed")
            self._queue.append((ref_name, caption, int(k), slot))
            self._cv.notify_all()
        slot["event"].wait()
        if "error" in slot:
            raise slot["error"]
        return slot["results"], slot["latency"]

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=5)

    def _loop(self):
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait()
                if self._stop and not self._queue:
                    return
                deadline = time.monotonic() + self.max_wait
                while len(self._queue) < self.max_batch and not self._stop:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cv.wait(timeout=left)
                items = self._queue[:self.max_batch]
                del self._queue[:self.max_batch]
            refs = [it[0] for it in items]
            caps = [it[1] for it in items]
            k = max(it[2] for it in items)
            try:
                out, latency = self.service.query(refs, caps, k=k)
            except Exception as e:  # every waiter of the batch gets the error
                for *_, slot in items:
                    slot["error"] = e
                    slot["event"].set()
                continue
            self.batches_run += 1
            self.items_run += len(items)
            for (_, _, ki, slot), res in zip(items, out):
                slot["results"] = res[:ki]
                slot["latency"] = latency
                slot["event"].set()


def _make_handler(service: RetrievalService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet: /stats counts the requests
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_json(self) -> dict:
            n = int(self.headers.get("Content-Length", "0"))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "gallery_size": service.gallery_size})
            elif self.path == "/stats":
                self._send(200, service.stats())
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path == "/reload":
                if not hasattr(service, "reload"):
                    self._send(404, {"error": "reload is only supported by "
                                              "artifact-backed services"})
                    return
                try:
                    self._send(200, service.reload())
                except (ValueError, OSError) as e:
                    self._send(409, {"error": f"{type(e).__name__}: {e}"})
                return
            if self.path == "/add":
                if not hasattr(service, "add_from_paths"):
                    self._send(404, {"error": "live adds need a model-backed service"})
                    return
                try:
                    items = list(self._read_json()["items"])
                except Exception as e:
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                try:
                    self._send(200, service.add_from_paths(items))
                except (ValueError, KeyError, OSError) as e:
                    self._send(409, {"error": f"{type(e).__name__}: {e}"})
                return
            if self.path != "/query":
                self._send(404, {"error": "unknown path"})
                return
            try:  # request shape errors -> 400
                req = self._read_json()
                batch = "ref_names" in req
                if batch:
                    refs = list(req["ref_names"])
                    caps = list(req["captions"])
                else:
                    refs = [req["ref_name"]]
                    caps = [req["caption"]]
                k = int(req.get("k", 10))
            except Exception as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return
            try:  # unknown gallery refs -> 404
                batcher = getattr(service, "batcher", None)
                if not batch and batcher is not None:
                    res0, latency = batcher.submit(refs[0], caps[0], k=k)
                    results = [res0]
                else:
                    results, latency = service.query(refs, caps, k=k)
            except KeyError as e:
                self._send(404, {"error": str(e)})
                return
            except Exception as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send(200, {"results": results if batch else results[0],
                             "latency_ms": round(latency * 1e3, 2)})

    return Handler


class _HTTPServer(ThreadingHTTPServer):
    # past the stdlib's listen backlog of 5, a burst of clients has its
    # connections dropped and waits out TCP's 1 s and 3 s retries
    request_queue_size = 1024


def serve(service: RetrievalService, host: str = "127.0.0.1", port: int = 8080,
          dynamic_batching: bool = True, max_batch: int | None = None) -> ThreadingHTTPServer:
    """The HTTP server (the caller runs `serve_forever`). With
    `dynamic_batching`, concurrent single queries coalesce
    (`MicroBatcher`, `max_batch` by default the serve program's largest
    bucket)."""
    if dynamic_batching and getattr(service, "batcher", None) is None:
        mb = max_batch or max(service._serve_fn.buckets)
        service.batcher = MicroBatcher(service, max_batch=mb)
    return _HTTPServer((host, port), _make_handler(service))
