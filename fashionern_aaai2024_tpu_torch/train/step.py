"""The train step: frozen-CLIP features -> ERN -> BBC loss -> Adam.

JAX counterpart: `fashionern_aaai2024_tpu/train/step.py`
(`grouped_bbc_loss` `:35`, `build_train_step` `:58`, both its branches;
`build_cached_image_train_step` `:174`; `build_feature_train_step`
`:226`). One step of one rank:

  1. each Adam parameter group's lr is set to `schedule(state.step)`;
  2. a dropout generator is seeded from (seed, step), the counterpart
     of `fold_in(dropout_rng, step)` (`:130`), and on a mesh of more
     than one shard also from the shard's index (`:131-134`);
  3. the forward: the frozen towers under `torch.no_grad()`, then the
     ERN fusion stack in train mode (dropout, BatchNorm batch
     statistics, running statistics updated);
  4. the loss: `batch_based_classification_loss` (kernel B4 forward on
     the card), or `grouped_bbc_loss` (one B4 loss a block) for "local"
     negatives over `local_groups` > 1 blocks;
  5. backward through the fusion stack, one Adam update; the gradients
     stay in `.grad` until the next step.

Data parallel (`mesh`, a `parallel/mesh.py ProcessMesh`; JAX's
`shard_map` branch, `:97-162`): each rank runs the whole program on its
rows, as each JAX shard does. "local" negatives are per shard (the
reference's per-rank DDP semantics); "global" negatives score each
query against every rank's targets (B4 with the positive at column
rank · b + i, the targets all-gathered with JAX's reduce-scatter
gradient). After the backward, ONE flat all-reduce (mean) carries the
ERN gradients, the loss and the BatchNorm running statistics (JAX's
three `pmean`s, `:137-145`), then Adam runs on every rank alike. The
BatchNorms normalize over each shard's own rows, as under `shard_map`
(not `SyncBatchNorm`, which would change the forward).

The state is updated in place; the step returns it with the loss as a
0-d tensor on the device, so nothing synchronizes with the host.

The phases are marked with `torch.profiler.record_function`
("train_step/towers", "train_step/tme" on a TME model,
"train_step/fusion_forward", "train_step/bbc_loss", "train_step/all_reduce" on a
mesh with a process group, "train_step/adam") for a profiler's split of a step; outside a profiler they cost a few
microseconds each. The backward has no span: autograd
runs it on its own thread, outside any span of this one, so a split
counts it as the step's device time less the spans'.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable

import torch
from torch.profiler import record_function

from fashionern_aaai2024_tpu_torch.models.composed import ComposedCIRModel
from fashionern_aaai2024_tpu_torch.models.ern.layers import TorchBatchNorm
from fashionern_aaai2024_tpu_torch.ops.losses import (
    TEMPERATURE,
    batch_based_classification_loss,
)
from fashionern_aaai2024_tpu_torch.parallel.mesh import ProcessMesh, all_reduce_mean
from fashionern_aaai2024_tpu_torch.train.state import CIRTrainState

Forward = Callable[[ComposedCIRModel, dict, torch.Generator],
                   tuple[torch.Tensor, torch.Tensor]]


def grouped_bbc_loss(predicted: torch.Tensor, target: torch.Tensor, groups: int,
                     temperature: float = TEMPERATURE) -> torch.Tensor:
    """Block-diagonal in-batch CE: per-rank negatives of the reference's
    DDP setup (JAX `:35`). Each group of contiguous rows is one B4 loss,
    as on a rank of its own, and the loss is the mean of the groups'
    means (equal groups: JAX's mean over every row)."""
    b = predicted.shape[0]
    if b % groups:
        raise ValueError(f"batch {b} not divisible by {groups} groups")
    r = b // groups
    return torch.stack([
        batch_based_classification_loss(predicted[i * r:(i + 1) * r],
                                        target[i * r:(i + 1) * r], temperature=temperature)
        for i in range(groups)]).mean()


def step_generator(seed: int, step: int, device: torch.device,
                   shard: int | None = None) -> torch.Generator:
    """The dropout generator of one step: a function of (seed, step) only,
    so a resumed run draws the uninterrupted run's masks; on a mesh of
    more than one shard, of (seed, step, shard index), as JAX folds the
    shard's axis index into the step's key."""
    key = f"{seed}:{step}" if shard is None else f"{seed}:{step}:{shard}"
    digest = hashlib.blake2b(key.encode(), digest_size=8).digest()
    return torch.Generator(device=device).manual_seed(int.from_bytes(digest, "little") >> 1)


def _image_forward(model: ComposedCIRModel, batch: dict, generator: torch.Generator):
    return model.train_forward(batch["ref_image"], batch["tar_image"], batch["text_ids"],
                               batch["ref_patch"], batch["tar_patch"], generator)


def _batchnorms(model: ComposedCIRModel) -> list[TorchBatchNorm]:
    return [m for m in model.ern.modules() if isinstance(m, TorchBatchNorm)]


def build_train_step(model: ComposedCIRModel, schedule: Callable[[int], float], *,
                     negatives: str = "local", local_groups: int = 1,
                     temperature: float = TEMPERATURE,
                     forward: Forward | None = None, mesh: ProcessMesh | None = None
                     ) -> Callable[[CIRTrainState, dict], tuple[CIRTrainState, torch.Tensor]]:
    """Returns `step(state, batch) -> (state, loss)` for `state.model is
    model`. `batch` keys (tensors on the model's device, this rank's rows:
    `parallel/mesh.py shard_batch`): ref_image, tar_image, text_ids,
    ref_patch, tar_patch. `forward(model, batch, generator) -> (fusion,
    target)` overrides the default `model.train_forward` (used by the
    cached-feature steps below). `mesh`: data parallel (module
    docstring); the returned loss is the mean over the mesh."""
    if negatives not in ("local", "global"):
        raise ValueError(f"negatives must be 'local' or 'global', got {negatives!r}")
    forward = forward or _image_forward
    collective = mesh is not None and mesh.group is not None
    shards = mesh.size if mesh is not None else 1
    if shards > 1 and negatives == "local" and local_groups not in (1, shards):
        # JAX `:82-93`: the negative groups ARE the shards
        raise ValueError(
            f"negatives='local' with local_groups={local_groups} on a {shards}-shard "
            "mesh: shard_map uses per-shard negatives, so local_groups must equal "
            "the mesh size (or 1).")
    norms = _batchnorms(model) if collective else []

    def loss_fn(fusion: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if negatives == "global":
            return batch_based_classification_loss(fusion, target, temperature=temperature,
                                                   negatives="global", mesh=mesh)
        if shards == 1 and local_groups > 1:
            return grouped_bbc_loss(fusion, target, local_groups, temperature)
        return batch_based_classification_loss(fusion, target, temperature=temperature)

    def reduce_over_mesh(loss: torch.Tensor) -> torch.Tensor:
        """One flat all-reduce (mean) of the gradients, the loss and the
        running statistics; each is written back where it came from."""
        grads = [p.grad for p in model.ern.parameters() if p.grad is not None]
        stats = [b for m in norms for b in (m.running_mean, m.running_var)]
        parts = [*grads, loss.detach().reshape(1), *stats]
        flat = all_reduce_mean(mesh, torch.cat([t.reshape(-1).float() for t in parts]))
        offset = 0
        with torch.no_grad():
            for t in parts:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
        return parts[len(grads)][0]

    def step(state: CIRTrainState, batch: dict) -> tuple[CIRTrainState, torch.Tensor]:
        if state.model is not model:
            raise ValueError("the state holds another model than this step was built for")
        lr = schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        generator = step_generator(state.seed, state.step, state.device,
                                   mesh.rank if shards > 1 else None)
        fusion, target = forward(model, batch, generator)
        with record_function("train_step/bbc_loss"):
            loss = loss_fn(fusion, target)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss = loss.detach()
        if collective:
            with record_function("train_step/all_reduce"):
                loss = reduce_over_mesh(loss)
        with record_function("train_step/adam"):
            state.optimizer.step()
        state.step += 1
        return state, loss

    return step


def _normalized(t: torch.Tensor) -> torch.Tensor:
    return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)


def build_cached_image_train_step(model: ComposedCIRModel, schedule: Callable[[int], float],
                                  **kwargs: Any):
    """Train step on cached raw CLIP image globals with online text
    encoding (`step.py:174`), TME included on a TME model (conditioned on
    ref_patch, `step.py:192-193`). Batch keys: ref_feats, tar_feats
    [B, d]; text_ids [B, L]; ref_patch, tar_patch [B, 13, d]."""

    def forward(mdl: ComposedCIRModel, batch: dict, generator: torch.Generator):
        with torch.no_grad(), record_function("train_step/towers"):
            text_feats, text_seq = mdl.clip.encode_text(batch["text_ids"])
        if mdl.clip_config.text.tme:
            with record_function("train_step/tme"):
                text_feats, text_seq = mdl.enhance_text(batch["text_ids"], text_seq,
                                                        batch["ref_patch"])
        with record_function("train_step/fusion_forward"):
            return mdl.train_features(
                batch["ref_feats"].float(), batch["ref_patch"], text_feats.float(),
                text_seq.float(), _normalized(batch["tar_feats"].float()),
                batch["tar_patch"], generator)

    return build_train_step(model, schedule, forward=forward, **kwargs)


def build_feature_train_step(model: ComposedCIRModel, schedule: Callable[[int], float],
                             **kwargs: Any):
    """Train step over pre-extracted CLIP features, no tower in the step
    (`step.py:226`); TME is bypassed, as in JAX (`step.py:229-236`): the
    text features are taken as given. Batch keys: ref_feats, ref_patch,
    text_feats, text_seq_feats, tar_feats, tar_patch."""

    def forward(mdl: ComposedCIRModel, batch: dict, generator: torch.Generator):
        with record_function("train_step/fusion_forward"):
            return mdl.train_features(
                batch["ref_feats"], batch["ref_patch"], batch["text_feats"],
                batch["text_seq_feats"], _normalized(batch["tar_feats"]),
                batch["tar_patch"], generator)

    return build_train_step(model, schedule, forward=forward, **kwargs)
