"""The Trainer: one loop + per-dataset plugins.

JAX counterpart: `fashionern_aaai2024_tpu/train/trainer.py` (`:49-651`),
one device. Recipe parity (BASELINE.md): Adam over the fusion parameters
only, batch size per device, CosineAnnealingLR(T_max =
schedule_epochs · steps_per_epoch) stepped per iteration, validation every
`validation_frequency` epochs, best checkpoint on the dataset's selection
metric, a kill-safe resume that reproduces the uninterrupted run's steps
(data order from the epoch-seeded shuffle, captions from a per-step rng,
dropout from (seed, step), Adam / schedule / BatchNorm from the restored
state).

Differences from the JAX Trainer:
  * `device` in place of `mesh`. A mesh of more than one device, and
    therefore "global" negatives across devices, raise
    `NotImplementedError` (ROADMAP A8); so does any dataset class or
    dataset evaluator the port does not have yet (A9): pass
    `train_dataset` and `validator`.
  * The model carries its weights: pass a `ComposedCIRModel`, or the
    Trainer builds one with seeded random weights
    (`models/composed.py random_init_`), which are not the JAX package's
    flax-initialized ones.
  * `profile_dir` writes a `torch.profiler` chrome trace of steps 2-4 of
    epoch 0 (`trace.json`).
  * The feature cache keeps the encoded globals on the device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import time
from typing import Callable

import numpy as np
import torch

from fashionern_aaai2024_tpu_torch.data.captions import (
    generate_randomized_fiq_caption,
    generate_shoes_caption,
)
from fashionern_aaai2024_tpu_torch.data.loader import Loader
from fashionern_aaai2024_tpu_torch.data.prefetch import prefetch_iter
from fashionern_aaai2024_tpu_torch.models.clip.config import get_clip_config
from fashionern_aaai2024_tpu_torch.models.clip.tokenizer import tokenize
from fashionern_aaai2024_tpu_torch.models.composed import ComposedCIRModel, random_init_
from fashionern_aaai2024_tpu_torch.retrieval.evaluate import InferenceAPI, resolve_device
from fashionern_aaai2024_tpu_torch.train.checkpoint import (
    BestCheckpointer,
    load_meta,
    restore_state,
    save_state,
)
from fashionern_aaai2024_tpu_torch.train.schedule import cosine_annealing_schedule
from fashionern_aaai2024_tpu_torch.train.state import (
    CIRTrainState,
    cast_frozen_clip_bf16,
    create_train_state,
)
from fashionern_aaai2024_tpu_torch.train.step import (
    build_cached_image_train_step,
    build_train_step,
)
from fashionern_aaai2024_tpu_torch.utils.logging import MetricLogger
from fashionern_aaai2024_tpu_torch.utils.meters import AverageMeter


@dataclasses.dataclass
class TrainConfig:
    """Flag names mirror `run/train/train_fiq.py:181-205`; the fields are
    the JAX TrainConfig's, less `data_root` and `target_ratio`, which only
    the dataset classes read (ROADMAP A9)."""

    dataset: str = "fashioniq"            # fashioniq | cirr | shoes | fashion200k
    clip_model_name: str = "RN50x4"
    batch_size: int = 1024                # per device (reference: per rank)
    lr: float = 4e-5
    num_epochs: int = 300
    validation_frequency: int = 3
    print_frequency: int = 100
    ckpt_dir: str = "ckpt"
    seed: int = 42
    patch_num: int = 13
    num_workers: int = 8
    worker_type: str = "thread"           # "thread" | "process" (fork, decode-bound)
    negatives: str = "local"              # "local" = per-device (reference), "global"
    eval_batch_size: int = 32
    schedule_epochs: int = 100            # T_max = schedule_epochs · steps/epoch
    activation: str = "gelu"
    log_path: str | None = None
    max_steps_per_epoch: int | None = None  # debug/bench clamp
    profile_dir: str | None = None          # torch.profiler trace of steps 2-4, epoch 0
    resume_path: str | None = None          # train-state file to resume from
    precision: str = "fp32"                 # "fp32" | "bf16" (frozen CLIP towers only)
    cache_features: bool = False            # pre-encode unique images once; text stays online
    image_dtype: str = "float32"            # "uint8" = raw-pixel feed, normalize on device
    quantize_towers: bool = False           # int8 frozen towers (kernels B5 / B6)
    ckpt_every_steps: int | None = None     # periodic resume checkpoint (kill-safety)
    prefetch_batches: int = 2               # host->device prefetch depth (0 = serial feed)
    tme: bool = False                       # TME text-enhancement module (trains)
    validate_200k: bool = False             # opt-in in-training validation for fashion200k


@dataclasses.dataclass
class DatasetPlugin:
    """What a dataset contributes to the generic loop."""

    name: str
    make_train_dataset: Callable[[TrainConfig], object]
    caption_fn: Callable[[dict, random.Random], list[str]]
    ref_key: str = "ref_name"   # ref id field in train batches (200k: ref_id)
    make_validator: Callable | None = None  # cfg -> (api -> (metric, dict))
    on_epoch: Callable | None = None        # (dataset, epoch) -> None


def _fiq_captions(batch: dict, rng: random.Random) -> list[str]:
    flat = [c for pair in batch["captions"] for c in pair]
    return generate_randomized_fiq_caption(flat, rng)


def _shoes_captions(batch: dict, rng: random.Random) -> list[str]:
    return generate_shoes_caption(batch["caption"])


def _plain_captions(batch: dict, rng: random.Random) -> list[str]:
    return list(batch["caption"])


def _unported_dataset(cfg: TrainConfig):
    raise NotImplementedError(
        f"the {cfg.dataset} dataset class is not ported yet (ROADMAP.md A9): "
        "pass train_dataset")


def _unported_validator(cfg: TrainConfig):
    raise NotImplementedError(
        f"the {cfg.dataset} validation set (its dataset class) is not ported yet "
        "(ROADMAP.md A9): pass validator, e.g. one that runs retrieval/evaluate.py's "
        "evaluator over in-memory loaders")


def _200k_validator(cfg: TrainConfig):
    """Opt-in, as in JAX: the reference never validates 200k in training."""
    return _unported_validator(cfg) if cfg.validate_200k else None


PLUGINS: dict[str, DatasetPlugin] = {
    "fashioniq": DatasetPlugin("fashioniq", _unported_dataset, _fiq_captions,
                               make_validator=_unported_validator),
    "cirr": DatasetPlugin("cirr", _unported_dataset, _plain_captions,
                          make_validator=_unported_validator),
    "shoes": DatasetPlugin("shoes", _unported_dataset, _shoes_captions,
                           make_validator=_unported_validator),
    "fashion200k": DatasetPlugin(
        "fashion200k", _unported_dataset, _plain_captions, ref_key="ref_id",
        make_validator=_200k_validator,
        on_epoch=lambda ds, epoch: getattr(ds, "resample_epoch", lambda: None)()),
}


def _mesh_size(mesh) -> int:
    return int(np.size(getattr(mesh, "devices", mesh)))


class Trainer:
    def __init__(self, cfg: TrainConfig, *, device: torch.device | str = "cuda",
                 mesh=None, model: ComposedCIRModel | None = None, train_dataset=None,
                 validator=None, plugin: DatasetPlugin | None = None, tokenizer=None):
        """Every heavyweight piece is injectable; `tokenizer` defaults to
        the port's CLIP BPE (`models/clip/tokenizer.py tokenize`), which
        raises FileNotFoundError at its first call when no table is found."""
        if mesh is not None and _mesh_size(mesh) > 1:
            raise NotImplementedError(
                "training on a mesh of more than one device is not ported yet "
                "(ROADMAP.md A8)")
        if cfg.precision not in ("fp32", "bf16"):
            raise ValueError(f"precision must be 'fp32' or 'bf16', got {cfg.precision!r}")
        self.cfg = cfg
        if plugin is None and cfg.dataset not in PLUGINS:
            raise ValueError(
                f"unknown dataset {cfg.dataset!r}; expected one of {sorted(PLUGINS)}")
        self.plugin = plugin or PLUGINS[cfg.dataset]
        self.device = resolve_device(device)
        if model is None:
            # the towers are frozen and run under torch.no_grad(), so the
            # forward-only int8 kernels serve the train step too
            clip_cfg = get_clip_config(cfg.clip_model_name, cfg.activation,
                                       quantize_mlp=True if cfg.quantize_towers else None,
                                       tme=cfg.tme)
            model = random_init_(ComposedCIRModel(clip_cfg, patch_num=cfg.patch_num),
                                 torch.Generator().manual_seed(cfg.seed))
        elif model.clip_config.text.tme != cfg.tme:
            raise ValueError(f"TrainConfig(tme={cfg.tme}) with a model built with "
                             f"tme={model.clip_config.text.tme}")
        self.model = model.to(self.device)
        self.clip_cfg = model.clip_config
        self.tokenizer = tokenizer if tokenizer is not None else tokenize

        self.train_dataset = (train_dataset if train_dataset is not None
                              else self.plugin.make_train_dataset(cfg))
        self.loader = Loader(self.train_dataset, cfg.batch_size, shuffle=True, seed=cfg.seed,
                             drop_last=True, num_workers=cfg.num_workers,
                             worker_type=cfg.worker_type)
        self.schedule = cosine_annealing_schedule(
            cfg.lr, cfg.schedule_epochs * max(1, len(self.loader)))
        self.state = create_train_state(self.model, cfg.seed)
        if cfg.precision == "bf16":
            cast_frozen_clip_bf16(self.state)
        # uint8 feed: raw pixels through collate and the H2D copy (4x
        # fewer bytes); CLIP.encode_image normalizes on the device
        if cfg.image_dtype == "uint8":
            self._image_dtype = torch.uint8
        else:
            self._image_dtype = torch.float32 if cfg.precision == "fp32" else torch.bfloat16
        build = build_cached_image_train_step if cfg.cache_features else build_train_step
        self.step_fn = build(self.model, self.schedule, negatives=cfg.negatives,
                             local_groups=1)
        self._feature_cache: dict[str, torch.Tensor] | None = None
        self.validator = (
            validator if validator is not None
            else (self.plugin.make_validator(cfg) if self.plugin.make_validator else None))
        self.best = BestCheckpointer(cfg.ckpt_dir, cfg.dataset)
        self.logger = MetricLogger(cfg.log_path)
        self.global_step = 0
        # steps/epoch maps global_step back to (epoch, step-within-epoch)
        # on resume, so the max_steps clamp is part of it
        self.steps_per_epoch = max(1, len(self.loader))
        if cfg.max_steps_per_epoch is not None:
            self.steps_per_epoch = min(self.steps_per_epoch, cfg.max_steps_per_epoch)
        self._frozen_written: dict[str, str] = {}
        self._clip_from_checkpoint = False
        self._val_api: InferenceAPI | None = None

    def load_clip_checkpoint(self, clip_state_dict: dict) -> None:
        """Swap in fine-tuned CLIP weights (open_clip names), as the
        reference loads `saved_state_dict["CLIP"]`."""
        self.model.clip.load_state_dict(clip_state_dict)
        self._clip_from_checkpoint = True

    # ------------------------------------------------------------------
    def _images(self, a) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(a))
        return t.to(self.device).to(self._image_dtype)

    @torch.no_grad()
    def _encode(self, images) -> torch.Tensor:
        return self.model.encode_image(self._images(images))[0].float()

    def build_feature_cache(self) -> None:
        """Encode every unique train image once with the frozen tower,
        keyed by name; the step then looks the globals up."""
        cache: dict[str, torch.Tensor] = {}
        scan = Loader(self.train_dataset, self.loader.batch_size,
                      num_workers=self.cfg.num_workers, worker_type=self.cfg.worker_type)
        t0 = time.time()
        for batch in scan:
            self._fill_cache(cache, batch)
        self._feature_cache = cache
        self.logger.log(step=self.global_step, cached_images=len(cache),
                        cache_seconds=round(time.time() - t0, 2))

    def _fill_cache(self, cache: dict, batch: dict) -> None:
        for img_key, name_key in (("ref_image", "ref_name"), ("tar_image", "tar_name")):
            names = batch[name_key]
            fresh = [i for i, n in enumerate(names) if n not in cache]
            if fresh:
                feats = self._encode(np.asarray(batch[img_key])[fresh])
                for j, i in enumerate(fresh):
                    cache[names[i]] = feats[j]

    def _device_batch(self, batch: dict, step: int | None = None) -> dict:
        """Tensors of one step on the device. Captions draw from an rng
        of (seed, step), so any step's draws can be rebuilt after a
        resume, with prefetch on or off."""
        if step is None:
            step = self.global_step
        caps = self.plugin.caption_fn(batch, random.Random(f"{self.cfg.seed}:{step}"))
        ids = self.tokenizer(caps, self.clip_cfg.text.context_length)
        out = {
            "text_ids": torch.as_tensor(np.asarray(ids)).long().to(self.device),
            "ref_patch": torch.as_tensor(np.asarray(batch["ref_patch"], np.float32)
                                         ).to(self.device),
            "tar_patch": torch.as_tensor(np.asarray(batch["tar_patch"], np.float32)
                                         ).to(self.device),
        }
        if self._feature_cache is not None:
            cache = self._feature_cache
            # names first seen after the cache pass (fashion200k resampling)
            self._fill_cache(cache, batch)
            out["ref_feats"] = torch.stack([cache[n] for n in batch["ref_name"]])
            out["tar_feats"] = torch.stack([cache[n] for n in batch["tar_name"]])
        else:
            out["ref_image"] = self._images(batch["ref_image"])
            out["tar_image"] = self._images(batch["tar_image"])
        return out

    def train_one_epoch(self, epoch: int, skip_steps: int = 0) -> float:
        """One epoch; `skip_steps` re-enters a partially trained epoch at
        the right batch after a resume (indices skipped, nothing loaded)."""
        cfg = self.cfg
        self.loader.set_epoch(epoch)
        if self.plugin.on_epoch:
            self.plugin.on_epoch(self.train_dataset, epoch)
        loss_meter = AverageMeter("loss")
        t0 = time.time()
        seen = 0
        profiler = None
        pending: list = []
        base_step = self.global_step

        def prepare(j, batch):
            return self._device_batch(batch, step=base_step + j)

        feed = prefetch_iter(self.loader.iter_batches(skip_steps), prepare,
                             depth=cfg.prefetch_batches)
        for i, db in enumerate(feed, start=skip_steps):
            if i >= self.steps_per_epoch:
                break
            if cfg.profile_dir and epoch == 0:
                if i == 2:
                    profiler = torch.profiler.profile(activities=_profiler_activities(
                        self.device))
                    profiler.start()
                elif i == 5 and profiler is not None:
                    self._stop_profile(profiler)
                    profiler = None
            self.state, loss = self.step_fn(self.state, db)
            self.global_step += 1
            if cfg.ckpt_every_steps and self.global_step % cfg.ckpt_every_steps == 0:
                self.save_resume_checkpoint()
            n = db["text_ids"].shape[0]
            seen += n
            # the loss stays on the device until the logging cadence, so
            # the host does not wait for every step
            pending.append((loss, n))
            if i % cfg.print_frequency == 0:
                for lv, ln in pending:
                    loss_meter.update(float(lv), ln)
                pending.clear()
                self.logger.log(step=self.global_step, epoch=epoch, loss=loss_meter.avg,
                                lr=self.schedule(self.global_step),
                                samples_per_sec=seen / max(time.time() - t0, 1e-9))
        if profiler is not None:
            self._stop_profile(profiler)
        for lv, ln in pending:
            loss_meter.update(float(lv), ln)
        return loss_meter.avg

    def _stop_profile(self, profiler: torch.profiler.profile) -> None:
        profiler.stop()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        path = os.path.join(self.cfg.profile_dir, "trace.json")
        profiler.export_chrome_trace(path)
        self.logger.log(step=self.global_step, profile_trace=path)

    def validate(self, epoch: int) -> float | None:
        if self.validator is None:
            return None
        # one InferenceAPI for the run: it holds the model itself, so it
        # sees the current weights
        if self._val_api is None:
            self._val_api = InferenceAPI(
                self.model, tokenizer=self.tokenizer, device=self.device,
                batch_size=self.cfg.eval_batch_size,
                context_length=self.clip_cfg.text.context_length)
        metric, detail = self.validator(self._val_api)
        flat = {k: v for k, v in detail.items() if isinstance(v, (int, float))}
        self.logger.log(step=self.global_step, epoch=epoch, val_metric=metric, **flat)
        # the sidecar lets eval / serve rebuild the frozen towers this
        # fusion stack trained against (random-init CLIP is a function of
        # the seed)
        meta = {"init_seed": self.cfg.seed, "clip_model_name": self.cfg.clip_model_name,
                "tme": self.clip_cfg.text.tme,
                "clip_from_checkpoint": self._clip_from_checkpoint}
        # the best model is the ERN's parameters and BatchNorm buffers, as
        # the reference's state_dict() holds them
        if self.best.update(metric, self.model.ern.state_dict(), meta=meta):
            self.logger.log(step=self.global_step, epoch=epoch,
                            best_metric=self.best.best_metric, checkpoint=self.best.best_path)
        return metric

    def maybe_resume(self) -> bool:
        """Restore a train state saved by `save_resume_checkpoint`; returns
        whether one was restored."""
        if not self.cfg.resume_path:
            return False
        restore_state(self.cfg.resume_path, self.state)
        self.global_step = self.state.step
        meta = load_meta(self.cfg.resume_path)
        if meta is not None:
            self.best.best_metric = float(meta.get("best_metric", float("-inf")))
            if meta.get("clip_from_checkpoint"):
                self._clip_from_checkpoint = True
        self.logger.log(step=self.global_step, resumed_from=self.cfg.resume_path,
                        best_metric=self.best.best_metric)
        return True

    def train(self) -> CIRTrainState:
        """Train to `num_epochs` total epochs, re-entering a resumed run at
        its (epoch, step-within-epoch)."""
        cfg = self.cfg
        self.maybe_resume()
        if cfg.cache_features and self._feature_cache is None:
            self.build_feature_cache()
        start_epoch = self.global_step // self.steps_per_epoch
        skip = self.global_step % self.steps_per_epoch
        for epoch in range(start_epoch, cfg.num_epochs):
            loss = self.train_one_epoch(epoch, skip_steps=skip if epoch == start_epoch else 0)
            self.logger.log(step=self.global_step, epoch=epoch, epoch_loss=loss)
            if self.validator is not None and epoch % cfg.validation_frequency == 0:
                self.validate(epoch)
        return self.state

    def save_resume_checkpoint(self, path: str | None = None) -> str:
        path = path or os.path.join(self.cfg.ckpt_dir, f"{self.cfg.dataset}-resume")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        fingerprint = json.dumps({
            "init_seed": self.cfg.seed, "clip_model_name": self.cfg.clip_model_name,
            "clip_from_checkpoint": self._clip_from_checkpoint}, sort_keys=True)
        save_state(path, self.state, frozen_fingerprint=fingerprint,
                   frozen_written=self._frozen_written)
        # best-checkpoint selection survives the restart too
        meta = {"clip_from_checkpoint": self._clip_from_checkpoint}
        if self.best.best_metric != float("-inf"):
            meta["best_metric"] = self.best.best_metric
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)
        return path


def _profiler_activities(device: torch.device) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts
