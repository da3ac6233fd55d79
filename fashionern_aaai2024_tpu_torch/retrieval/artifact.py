"""Serve artifacts: the one-dispatch serve program through `torch.export`.

JAX counterpart: `fashionern_aaai2024_tpu/retrieval/artifact.py`. The
serve program (`retrieval/evaluate.py ServeFn`: text tower -> DVR query
tower -> gallery scores -> top-k) is exported once per batch bucket with
`torch.export` (non-strict) as a function of its consts
(`ServeFn.program`); the weights, the gallery and the reference rows
ship once, in a consts sidecar that every program takes as arguments,
not as baked constants, so that a program file holds no weights and the
sidecar can be swapped for a retrained checkpoint with the same shapes
(`refresh_consts`). A serving host needs torch, the port's `ops/` (the
kernels, registered as `torch.ops.fern.*` by `ops/library.py`, built at
first use) and this directory: none of `models/`, no checkpoint, no
dataset class, no gallery image.

Layout of an artifact directory:

    manifest.json     shapes, buckets, platform, provenance
    serve_b{B}.pt2    one exported program per bucket (`torch.export.save`)
    consts.pt         the consts, stored once (`torch.save` of a list of
                      tensors, read back with `weights_only=True`)
    names.json        gallery row -> name, the map the top-k rows index

Tokenization happens outside the program (`tokenizer.py`).

Platform: the manifest records the device type the programs were
exported for (`cuda` or `cpu`; the trace takes each op's device branch,
so a CUDA export runs the kernels and a CPU export the plain versions)
and `torch.__version__`. `load_serve_artifact` refuses a device type
other than its own unless `allow_platform_mismatch=True`.

On the card each bucket's loaded program is captured as one CUDA graph
at load (`ops/graphs.py BucketedCall`, the live serve program's request
path, with `CapturedCall`'s check of the graph's kernel nodes against
the launches its capture recorded), over static tensors: the request's
ids and rows, and the consts, which `reload_consts` overwrites in place,
so a reload needs no recapture. On the CPU the loaded programs run
eagerly. Nothing falls back to the live
model: a program that fails to load, capture or replay raises.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch

from fashionern_aaai2024_tpu_torch.ops import library
from fashionern_aaai2024_tpu_torch.ops.graphs import BucketedCall

ARTIFACT_VERSION = 1
KIND = "fashionern-serve"


class _Program(torch.nn.Module):
    """`serve_fn.program` as the module `torch.export` takes. It owns no
    parameter (the serve program is an attribute, not a submodule), so
    the exported program's state is empty: every weight is an input."""

    def __init__(self, serve_fn):
        super().__init__()
        self.__dict__["serve_fn"] = serve_fn

    def forward(self, consts: list[torch.Tensor], ids: torch.Tensor,
                rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self.serve_fn.program(consts, ids, rows)


def _specs(consts: Sequence[torch.Tensor]) -> tuple[list[str], list[list[int]]]:
    return [str(c.dtype).removeprefix("torch.") for c in consts], [list(c.shape) for c in consts]


def _read_manifest(out_dir: str) -> dict:
    with open(os.path.join(out_dir, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("kind") != KIND:
        raise ValueError(f"{out_dir} is not a fashionern serve artifact")
    return manifest


def _check_consts(consts: Sequence[torch.Tensor], manifest: dict, what: str) -> None:
    """Every const's dtype and shape against the manifest's; raises on
    the first difference (the programs need a re-export then)."""
    want_dtypes, want_shapes = manifest["consts_dtypes"], manifest["consts_shapes"]
    if len(consts) != len(want_shapes):
        raise ValueError(f"{what} has {len(consts)} consts, the artifact's programs take "
                         f"{len(want_shapes)}: the model or gallery structure changed; "
                         "re-export")
    for i, (dt, shp) in enumerate(zip(*_specs(consts))):
        if dt != want_dtypes[i] or shp != want_shapes[i]:
            raise ValueError(f"{what}: const c{i} is {dt}{shp}, the artifact's programs take "
                             f"{want_dtypes[i]}{want_shapes[i]}; re-export")


def _save_consts(path: str, consts: Sequence[torch.Tensor]) -> None:
    """Atomic write: a kill mid-save leaves the old file, never a
    truncated one that a later load or /reload would read."""
    tmp = path + ".tmp"
    try:
        torch.save([c.detach().cpu().contiguous() for c in consts], tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def export_serve_artifact(serve_fn, out_dir: str, *, model_name: str = "",
                          gallery_names: Sequence[str] | None = None,
                          extra_meta: dict | None = None) -> dict:
    """Export a by-rows `ServeFn` to `out_dir`: one program per bucket,
    the consts once. Returns the manifest."""
    if not getattr(serve_fn, "by_rows", False):
        raise ValueError("export_serve_artifact needs the by-rows serve program (build the "
                         "service with gallery ref_features/ref_patches, the "
                         "RetrievalService default)")
    if getattr(serve_fn, "growable", False):
        raise ValueError("growable (capacity=) serve programs are mutable and not "
                         "exportable; build a capacity=None serve program over the current "
                         "gallery and export that snapshot")
    if getattr(serve_fn, "mesh", None) is not None:
        raise ValueError("mesh-sharded serve programs are not exportable: the exported "
                         "program would pin this mesh's device count")
    os.makedirs(out_dir, exist_ok=True)
    consts = serve_fn.consts
    device = serve_fn.device
    ctx = serve_fn.context_length
    _save_consts(os.path.join(out_dir, "consts.pt"), consts)
    program = _Program(serve_fn)
    files = {}
    for b in serve_fn.buckets:
        ids = torch.zeros((b, ctx), dtype=torch.int32, device=device)
        rows = torch.zeros(b, dtype=torch.int64, device=device)
        with torch.no_grad():
            exported = torch.export.export(program, (list(consts), ids, rows), strict=False)
        if exported.state_dict or exported.constants:
            raise RuntimeError(f"the exported program holds tensors: "
                               f"{sorted({**exported.state_dict, **exported.constants})[:5]}")
        # the example inputs are the consts themselves: not saved with it
        exported.example_inputs = None
        name = f"serve_b{b}.pt2"
        torch.export.save(exported, os.path.join(out_dir, name))
        files[str(b)] = name
    gallery = serve_fn.gallery[0] if isinstance(serve_fn.gallery, tuple) else serve_fn.gallery
    dtypes, shapes = _specs(consts)
    manifest = {
        "artifact_version": ARTIFACT_VERSION,
        "kind": KIND,
        "model_name": model_name,
        "platform": device.type,
        "torch_version": torch.__version__,
        "buckets": list(serve_fn.buckets),
        "k_max": int(serve_fn.k_max),
        "context_length": int(ctx),
        "gallery_size": int(gallery.shape[0]),
        "feature_dim": int(gallery.shape[1]),
        "files": files,
        "consts_file": "consts.pt",
        "consts_dtypes": dtypes,
        "consts_shapes": shapes,
    }
    if gallery_names is not None:
        with open(os.path.join(out_dir, "names.json"), "w") as f:
            json.dump([str(n) for n in gallery_names], f)
        manifest["names_file"] = "names.json"
    if extra_meta:
        manifest.update(extra_meta)
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def refresh_consts(out_dir: str, serve_fn) -> dict:
    """Republish an artifact's consts from a (retrained) serve program
    without re-exporting the programs: every shape and dtype is checked
    against the manifest first, then the file is replaced atomically.
    Returns the manifest."""
    manifest = _read_manifest(out_dir)
    consts = serve_fn.consts
    _check_consts(consts, manifest, "the new serve program")
    _save_consts(os.path.join(out_dir, manifest["consts_file"]), consts)
    return manifest


class ServeArtifact:
    """A loaded serve artifact: `query(token_ids, rows, k)` -> (scores
    [n, k], gallery rows [n, k]) as host arrays, the live serve
    program's contract and request path (`ops/graphs.py BucketedCall`:
    the smallest bucket >= n, k clamped to `k_max`). Queries and
    `reload_consts` hold the buckets' lock: the static tensors serve one
    request at a time."""

    def __init__(self, out_dir: str, manifest: dict, programs: dict,
                 device: torch.device | str = "cuda"):
        self.dir = out_dir
        self.manifest = manifest
        self.device = torch.device(device)
        self.context_length = int(manifest["context_length"])
        self.buckets = sorted(int(b) for b in programs)
        self.names = None
        if manifest.get("names_file"):
            with open(os.path.join(out_dir, manifest["names_file"])) as f:
                self.names = json.load(f)
        self.consts = [c.to(self.device) for c in self._read_consts()] if programs else []

        def make_inputs(b: int) -> tuple[torch.Tensor, torch.Tensor]:
            return (torch.zeros((b, self.context_length), dtype=torch.int32,
                                device=self.device),
                    torch.zeros(b, dtype=torch.int64, device=self.device))

        def run(ids: torch.Tensor, rows: torch.Tensor):
            with torch.no_grad():
                return programs[ids.shape[0]](self.consts, ids, rows)
        self._buckets = BucketedCall(run, make_inputs, self.buckets, self.device)

    def _read_consts(self) -> list[torch.Tensor]:
        consts = torch.load(os.path.join(self.dir, self.manifest["consts_file"]),
                            map_location="cpu", weights_only=True)
        _check_consts(consts, self.manifest, "the consts file")
        return consts

    def reload_consts(self) -> None:
        """Re-read the consts (and names.json) from disk and copy them into
        the static tensors that the programs (the captured graphs) read:
        no recapture, no re-export. Every const is checked before any is
        written; queries in flight finish on the old consts (the lock)."""
        fresh = self._read_consts()
        names = self.names
        if self.manifest.get("names_file"):
            with open(os.path.join(self.dir, self.manifest["names_file"])) as f:
                names = json.load(f)
            if self.names is not None and len(names) != len(self.names):
                raise ValueError(f"republished names.json has {len(names)} rows, the "
                                 f"programs take {len(self.names)}; re-export")
        staged = [c.to(self.device) for c in fresh]
        with self._buckets.lock:
            for dst, src in zip(self.consts, staged):
                dst.copy_(src)
            self.names = names
            self.__dict__.pop("_row_map", None)

    @property
    def k_max(self) -> int:
        return self.manifest["k_max"]

    @property
    def gallery_size(self) -> int:
        return self.manifest["gallery_size"]

    def row_for(self, name: str) -> int:
        """name -> gallery row, the last duplicate winning (the live
        service's `last_wins_rows`)."""
        if self.names is None:
            raise ValueError("the artifact was exported without gallery_names")
        if "_row_map" not in self.__dict__:
            self._row_map = {n: i for i, n in enumerate(self.names)}
        return self._row_map[name]

    def query(self, token_ids, rows: Sequence[int], k: int = 10
              ) -> tuple[np.ndarray, np.ndarray]:
        return self._buckets((np.asarray(token_ids, np.int32), np.asarray(rows, np.int64)),
                             min(k, self.k_max))


def load_serve_artifact(out_dir: str, *, device: torch.device | str = "cuda",
                        allow_platform_mismatch: bool = False) -> ServeArtifact:
    """Load an artifact onto `device` (the card unless the caller asks for
    the CPU): register the port's ops, read every program, the consts
    and the names, and on the card capture each bucket."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    manifest = _read_manifest(out_dir)
    if manifest["platform"] != device.type and not allow_platform_mismatch:
        raise ValueError(f"artifact exported for {manifest['platform']!r} but this host "
                         f"runs {device.type!r}; re-export on the deploy platform (or pass "
                         "allow_platform_mismatch=True)")
    library.register_all()
    programs = {int(b): torch.export.load(os.path.join(out_dir, name)).module()
                for b, name in manifest["files"].items()}
    return ServeArtifact(out_dir, manifest, programs, device)
