"""Checkpointing: the full train state, and the best model on validation.

JAX counterpart: `fashionern_aaai2024_tpu/train/checkpoint.py`
(`:29-185`). The JAX package writes Orbax directories; the port writes
`torch.save` files (state_dicts of tensors, read back with
`weights_only=True`) under the same path names and with the same layout:

  * `save_state` / `restore_state`: the resumable train state. The
    default "split" layout writes the mutable part (step, seed, the ERN
    parameters and BatchNorm buffers, Adam's state) to `path` on every
    call, and the frozen CLIP towers to `path + ".frozen"` once per run;
    `frozen="full"` writes one file with both. `restore_state` reads
    either. The mutable part records whether the model has TME, and a
    restore into a model that differs raises (the ERN trees differ; the
    JAX CLI checks the same flag, `cli/main.py:366-371`).
  * `save_params` / `restore_params`: a state_dict alone (the best
    model: the ERN parameters and buffers, as the reference's
    `state_dict()` holds them, `run/train/train_fiq.py:174-175`).
  * `BestCheckpointer`: best-on-validation save with a `.meta.json`
    sidecar (init seed, CLIP name, whether CLIP came from a checkpoint).

The frozen towers are skipped on later saves only when `frozen_written`,
a dict the caller owns (the Trainer keeps one per run), records that this
run already wrote them under the same fingerprint, so a run that reuses
another run's checkpoint directory never keeps stale towers. JAX keeps
that memo per process (`_frozen_written`, `:52`).
"""

from __future__ import annotations

import json
import os
from typing import Any

import torch

from fashionern_aaai2024_tpu_torch.train.state import CIRTrainState


def _mutable(state: CIRTrainState) -> dict:
    return {"step": state.step, "seed": state.seed,
            "tme": bool(state.model.clip_config.text.tme),
            "ern": state.model.ern.state_dict(),
            "optimizer": state.optimizer.state_dict()}


def _frozen(state: CIRTrainState) -> dict:
    return {"clip": state.model.clip.state_dict()}


def save_state(path: str, state: CIRTrainState, *, frozen: str = "auto",
               frozen_fingerprint: str | None = None,
               frozen_written: dict[str, str] | None = None) -> None:
    """Write the train state (a resume point) to `path`. frozen="auto":
    the split layout, with `path + ".frozen"` rewritten unless
    `frozen_written[path + ".frozen"] == frozen_fingerprint` (with no
    fingerprint, unless the file exists). frozen="full": one file."""
    path = os.path.abspath(path)
    if frozen == "full":
        torch.save({**_mutable(state), **_frozen(state)}, path)
        return
    if frozen != "auto":
        raise ValueError(f"frozen must be 'auto' or 'full', got {frozen!r}")
    fpath = path + ".frozen"
    if frozen_fingerprint is not None:
        skip = frozen_written is not None and frozen_written.get(fpath) == frozen_fingerprint
    else:
        skip = os.path.isfile(fpath)
    if not skip:
        torch.save(_frozen(state), fpath)
        if frozen_fingerprint is not None and frozen_written is not None:
            frozen_written[fpath] = frozen_fingerprint
    torch.save(_mutable(state), path)


def restore_state(path: str, state: CIRTrainState) -> CIRTrainState:
    """Load a saved train state into `state` (its model and optimizer,
    on their device) and return it. Reads the split and the full
    layout."""
    path = os.path.abspath(path)
    device = state.device
    saved = torch.load(path, map_location=device, weights_only=True)
    fpath = path + ".frozen"
    tme = bool(state.model.clip_config.text.tme)
    if "tme" in saved and bool(saved["tme"]) != tme:
        raise ValueError(f"{path}: the checkpoint was trained with tme={bool(saved['tme'])} "
                         f"but the model is built with tme={tme}; build the model with the "
                         "flag the training run used (the ERN parameter trees differ)")
    if "clip" not in saved:
        saved.update(torch.load(fpath, map_location=device, weights_only=True))
    state.model.clip.load_state_dict(saved["clip"])
    state.model.ern.load_state_dict(saved["ern"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    state.seed = int(saved["seed"])
    return state


def save_params(path: str, state_dict: dict) -> None:
    """Best-model save: a state_dict, copied to the host."""
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, os.path.abspath(path))


def restore_params(path: str) -> dict:
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)


class BestCheckpointer:
    """Keeps the best state_dict by the validation metric (`:153-185`):
    the directory is created and the metric starts at -inf."""

    def __init__(self, ckpt_dir: str, name: str):
        self.ckpt_dir = ckpt_dir
        self.name = name
        self.best_metric = float("-inf")
        os.makedirs(ckpt_dir, exist_ok=True)

    @property
    def best_path(self) -> str:
        return os.path.join(self.ckpt_dir, f"{self.name}-best")

    def update(self, metric: float, state_dict: dict, meta: dict | None = None) -> bool:
        """Save `state_dict` if `metric` improves; returns whether it did.
        `meta` goes to `<best_path>.meta.json` with the metric."""
        if metric <= self.best_metric:
            return False
        self.best_metric = metric
        save_params(self.best_path, state_dict)
        if meta is not None:
            with open(self.best_path + ".meta.json", "w") as f:
                json.dump({**meta, "metric": metric}, f)
        return True


def load_meta(path: str) -> dict[str, Any] | None:
    """The `.meta.json` sidecar of a checkpoint path, if there is one."""
    meta_path = path + ".meta.json"
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as f:
        return json.load(f)
