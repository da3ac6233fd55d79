"""Gang ranks of tests/test_torch_parallel.py.

Each function runs on every rank of a gloo gang that
`parallel/mesh.py spawn_cpu_gang` spawns: it gets the rank's mesh and
picklable arguments, and returns picklable results (numpy arrays,
floats). This module imports torch and the port only, so that a spawned
rank never imports JAX.
"""

import os
import zlib

import numpy as np
import torch

from fashionern_aaai2024_tpu_torch.models.composed import ComposedCIRModel
from fashionern_aaai2024_tpu_torch.ops import dropout as TD
from fashionern_aaai2024_tpu_torch.ops import losses as TL
from fashionern_aaai2024_tpu_torch.parallel import mesh as M

PATCH_NUM = 13


def crc_tokenizer(texts, context_length=16):
    """`torch_port_helpers.crc_tokenizer` (that module imports JAX)."""
    out = np.zeros((len(texts), context_length), np.int32)
    for i, t in enumerate(texts):
        ids = [zlib.crc32(w.encode()) % 97 + 1 for w in t.split()][:context_length]
        out[i, :len(ids)] = ids
    return out


def keep_all(shape, keep, generator, device):
    return torch.ones(shape, dtype=torch.bool, device=device)


def load_model(cfg, path: str) -> ComposedCIRModel:
    model = ComposedCIRModel(cfg, patch_num=PATCH_NUM)
    model.load_state_dict(torch.load(path, weights_only=True), strict=True)
    return model


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


# --- collectives and the loss ------------------------------------------------


def loss_rank(mesh, pred: np.ndarray, tar: np.ndarray) -> dict:
    """The global loss on this rank's rows, its gradients, and the mean
    loss over the mesh."""
    p = torch.from_numpy(M.shard_rows(mesh, pred)).requires_grad_()
    t = torch.from_numpy(M.shard_rows(mesh, tar)).requires_grad_()
    loss = TL.batch_based_classification_loss(p, t, negatives="global", mesh=mesh)
    loss.backward()
    mean = M.all_reduce_mean(mesh, loss.detach().clone())
    return {"loss": mean.item(), "dpred": _np(p.grad), "dtar": _np(t.grad)}


def gather_rank(mesh) -> dict:
    """GatherRows forward and gradient with rank-dependent weights."""
    x = (torch.arange(6.0).reshape(3, 2) + 10 * mesh.rank).requires_grad_()
    g = M.GatherRows.apply(x, mesh)
    w = torch.arange(g.numel(), dtype=torch.float32).reshape(g.shape) * (mesh.rank + 1)
    (g * w).sum().backward()
    return {"gathered": _np(g), "grad": _np(x.grad)}


def search_rank(mesh, q: np.ndarray, gal: np.ndarray, k: int) -> tuple:
    from fashionern_aaai2024_tpu_torch.retrieval.engine import sharded_search

    return sharded_search(mesh, q, gal, k=k)


# --- the inference API and the serve program ----------------------------------


def api_rank(mesh, cfg, model_path: str, inputs: dict) -> dict:
    from fashionern_aaai2024_tpu_torch.retrieval.evaluate import InferenceAPI

    model = load_model(cfg, model_path)
    out = {}
    for name, m in (("mesh", mesh), ("one", None)):
        api = InferenceAPI(model, tokenizer=crc_tokenizer, device="cpu", batch_size=4,
                           context_length=16, mesh=m)
        g, tok = api.encode_image(inputs["images"])
        tg, ts = api.encode_text(inputs["ids"], visual_emb=inputs["patches"])
        q = api.query(inputs["feats"], inputs["patches"], tg, ts)
        r = api.refine_gallery(inputs["feats"], inputs["patches"], chunk=3)
        out[name] = {"image": _np(g), "tokens": _np(tok), "text": _np(tg), "seq": _np(ts),
                     "query": _np(q), "refined": _np(r)}
    return out


def gallery_rank(mesh, cfg, model_path: str, items: list) -> dict:
    """`embed_gallery` (prefetch 2, tokens kept) through the mesh API and
    the unsharded one over the same items at batch 4, and the image rows
    each batch's `.place` copied on this rank."""
    from fashionern_aaai2024_tpu_torch.data.loader import Loader
    from fashionern_aaai2024_tpu_torch.retrieval.engine import embed_gallery
    from fashionern_aaai2024_tpu_torch.retrieval.evaluate import InferenceAPI

    model = load_model(cfg, model_path)
    out = {}
    for name, m in (("mesh", mesh), ("one", None)):
        api = InferenceAPI(model, tokenizer=crc_tokenizer, device="cpu", batch_size=4,
                           context_length=16, mesh=m)
        fn = api.gallery_encode_fn()
        placed = []

        def recording(images, patch=None, place=fn.place, placed=placed):
            p = place(images, patch)
            placed.append(_np(p.images))
            return p

        fn.place = recording
        g = embed_gallery(fn, Loader(items, 4, num_workers=0), 4, keep_tokens=True,
                          prefetch=2)
        out[name] = {"names": g.names, "features": _np(g.features),
                     "tokens": _np(g.token_features), "locals": _np(g.local_features),
                     "placed": placed}
    return out


def serve_rank(mesh, cfg, model_path: str, arrays: dict, flags: dict, ids: np.ndarray,
               rows: np.ndarray, k: int) -> dict:
    """Rank 0: the sharded program's answers (and the unsharded
    program's); the other ranks follow rank 0's dispatches."""
    from fashionern_aaai2024_tpu_torch.retrieval.evaluate import InferenceAPI

    api = InferenceAPI(load_model(cfg, model_path), tokenizer=crc_tokenizer, device="cpu",
                       batch_size=8, context_length=16, mesh=mesh, **flags)
    fn = api.build_serve_fn(arrays["gallery"], k_max=8, buckets=(1, 8),
                            ref_features=arrays["ref_f"], ref_patches=arrays["ref_p"])
    if mesh.rank != 0:
        return {"followed": fn.follow()}
    try:
        sharded = [fn(ids[:n], rows[:n], k=k) for n in (1, len(rows))]
    finally:
        fn.close()
    api.mesh = None
    one = api.build_serve_fn(arrays["gallery"], k_max=8, buckets=(1, 8),
                             ref_features=arrays["ref_f"], ref_patches=arrays["ref_p"])
    return {"sharded": sharded, "one": [one(ids[:n], rows[:n], k=k) for n in (1, len(rows))],
            "per": fn.per}


def service_rank(mesh, cfg, model_path: str, batches: list, refs: list, caps: list,
                 ks: list) -> dict:
    """A RetrievalService on every rank; rank 0 answers the queries at each
    k (past the serve program's k_max too), the others follow."""
    from fashionern_aaai2024_tpu_torch.retrieval.evaluate import InferenceAPI
    from fashionern_aaai2024_tpu_torch.retrieval.server import RetrievalService

    api = InferenceAPI(load_model(cfg, model_path), tokenizer=crc_tokenizer, device="cpu",
                       batch_size=8, context_length=16, mesh=mesh)
    service = RetrievalService(api, batches)
    if mesh.rank != 0:
        return {"followed": service._serve_fn.follow()}
    try:
        return {"answers": [service.query(refs, caps, k=k)[0] for k in ks],
                "k_max": service._serve_fn.k_max}
    finally:
        service._serve_fn.close()


# --- the train step ------------------------------------------------------------


def det_forward(model, batch, generator):
    """The train forward with BatchNorm on its running statistics and no
    dropout (JAX's `deterministic=True`)."""
    return model.train_forward(batch["ref_image"], batch["tar_image"], batch["text_ids"],
                               batch["ref_patch"], batch["tar_patch"], None)


def train_rank(mesh, cfg, model_path: str, batch: dict, negatives: str, deterministic: bool,
               shards: int, lr: float, keep: bool) -> dict:
    """One step of `build_train_step` on this rank's rows of `batch` (or,
    with `shards` > 1 on one rank, `multiprocess.py one_process_step`):
    the loss, the ERN gradients, and the ERN state after the step."""
    from fashionern_aaai2024_tpu_torch.parallel.multiprocess import one_process_step
    from fashionern_aaai2024_tpu_torch.train.state import create_train_state
    from fashionern_aaai2024_tpu_torch.train.step import build_train_step

    if keep:
        TD.dropout_mask = keep_all
    model = load_model(cfg, model_path)
    state = create_train_state(model, seed=0)
    forward = det_forward if deterministic else None
    if shards > 1:
        step = one_process_step(model, lambda s: lr, shards, negatives=negatives,
                                forward=forward)
    else:
        step = build_train_step(model, lambda s: lr, negatives=negatives,
                                local_groups=mesh.size, forward=forward, mesh=mesh)
    state, loss = step(state, M.shard_batch(mesh, batch))
    return {"loss": loss.item(),
            "grads": {n: _np(p.grad) for n, p in model.ern.named_parameters()
                      if p.grad is not None},
            "ern": {k: _np(v) for k, v in model.ern.state_dict().items()}}


# --- the Trainer and the CLI ----------------------------------------------------


class SyntheticRelativeDataset:
    """tests/test_torch_train_loop.py's FashionIQ-shaped triplets."""

    CAPTIONS = [("is red", "has longer sleeves"), ("is darker", "more formal"),
                ("with a collar", "is shorter"), ("in blue", "has stripes")]

    def __init__(self, n=24, seed=0, d=24):
        g = np.random.default_rng(seed)
        images = g.random((n, 32, 32, 3), dtype=np.float32)
        patches = g.standard_normal((n, PATCH_NUM, d), dtype=np.float32)
        self.items = [{
            "ref_name": f"img{i}", "tar_name": f"img{(i + 1) % n}",
            "captions": list(self.CAPTIONS[i % len(self.CAPTIONS)]),
            "ref_image": images[i], "tar_image": images[(i + 1) % n],
            "ref_patch": patches[i], "tar_patch": patches[(i + 1) % n],
        } for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def make_trainer(cfg, model_path: str, ckpt_dir: str, mesh=None, **overrides):
    from fashionern_aaai2024_tpu_torch.train.trainer import (
        DatasetPlugin,
        TrainConfig,
        Trainer,
        _fiq_captions,
    )

    base = dict(dataset="fashioniq", clip_model_name="ViT-B-16", batch_size=4,
                num_epochs=1, lr=1e-3, num_workers=0, ckpt_dir=ckpt_dir,
                print_frequency=1, eval_batch_size=4, negatives="global")
    base.update(overrides)
    plugin = DatasetPlugin("synthetic", lambda c: SyntheticRelativeDataset(), _fiq_captions)
    return Trainer(TrainConfig(**base), device="cpu", mesh=mesh,
                   model=load_model(cfg, model_path), train_dataset=SyntheticRelativeDataset(),
                   plugin=plugin, tokenizer=crc_tokenizer)


def trainer_rank(mesh, cfg, model_path: str, ckpt_dir: str, resume_path: str | None) -> dict:
    """A Trainer on the mesh: one epoch (or a resume), its resume
    checkpoint, and what rank 0 logged."""
    log = os.path.join(ckpt_dir, "log.jsonl")
    tr = make_trainer(cfg, model_path, ckpt_dir, mesh, log_path=log, resume_path=resume_path)
    if resume_path:
        restored = tr.maybe_resume()
        return {"restored": restored, "global_step": tr.global_step,
                "ern": {k: _np(v) for k, v in tr.model.ern.state_dict().items()}}
    tr.train()
    path = tr.save_resume_checkpoint(os.path.join(ckpt_dir, "resume"))
    return {"path": path, "global_step": tr.global_step, "steps_per_epoch": tr.steps_per_epoch,
            "loader_len": len(tr.loader),
            "ern": {k: _np(v) for k, v in tr.model.ern.state_dict().items()}}


def cli_rank(mesh, tiny_name: str, tiny_cfg, train_argv: list, eval_argv: list) -> dict:
    """`train` then `eval --data-parallel` of the port's CLI on this rank,
    as under torchrun (WORLD_SIZE set); rank 0's eval output."""
    import contextlib
    import io
    import json

    from fashionern_aaai2024_tpu_torch.cli import main as cli
    from fashionern_aaai2024_tpu_torch.models.clip import config as C

    C._CONFIGS[tiny_name] = tiny_cfg
    os.environ["WORLD_SIZE"] = str(mesh.size)
    cli.main(train_argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(eval_argv)
    lines = [line for line in out.getvalue().splitlines() if line.startswith("{")]
    return {"eval": json.loads(lines[-1]) if lines else None}


def raising_rank(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return mesh.rank


def sleeping_rank(mesh, seconds: float):
    import time

    time.sleep(seconds)
    return mesh.rank
