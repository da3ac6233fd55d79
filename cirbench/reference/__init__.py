"""The benchmark's plain reference: fp32 PyTorch, TF32 off, written from
the published models (`clip.py`, `ern.py`, `train.py`) and CLIP's
tokenizer (`bpe.py`). It imports nothing of the program under test, of
the JAX package or of JAX, and takes nothing the program made: it reads
the benchmark's own weights and inputs and works out again what the
program derived from them (the gallery's refined rows, the caption ids,
the trained parameters).

Weights are under open_clip's names for the towers and FashionERN's
(`ern.*`) for the rest (`names`: the drawn state dict holds the towers
under `clip.`). `served_weights` is the model as a configuration serves
it: every weight and buffer rounded to bf16 where the configuration
stores it in bf16 (the towers and TME) or rounds it to bf16 (the ERN's
fp32 weights), then held in fp32. `train_steps` reads the towers as
training stores them (bf16) and trains the rest from the drawn fp32
values.

`precision` is a pair of `ops.Ops`: the products of the parts the
configuration runs in bf16 (the towers, TME when serving), then those of
the parts it runs in fp32. `ops.EXACT` is the reference; `ops.LOWER`,
one step below each, is the control.
"""

from __future__ import annotations

import torch

from cirbench.reference import clip, ern
from cirbench.reference.ops import EXACT, exact_fp32
from cirbench.reference.train import Adam, TrainMode, bbc_loss

SERVE_POLICY = {"towers": "bf16", "tme": "bf16", "ern_weights": "bf16-rounded fp32"}


def names(W: dict) -> dict:
    return {k.removeprefix("clip."): v for k, v in W.items()}


def _bf16(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).float() if v.is_floating_point() else v


def served_weights(W: dict, config: dict) -> dict:
    if config["serve"] != SERVE_POLICY:
        raise ValueError(f"no reference for the serve policy {config['serve']}")
    return {k: _bf16(v) for k, v in names(W).items()}


@torch.no_grad()
def embed(images: torch.Tensor, patches: torch.Tensor, W: dict, config: dict,
          precision=EXACT, block: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 images [N, H, W, 3] and patch features [N, P, d] (any device)
    -> (image-tower globals [N, d], refined gallery rows [N, d]), fp32 on
    the weights' device, in blocks of `block` rows."""
    device = next(iter(W.values())).device
    tower_ops, ern_ops = precision
    globals_, refined = [], []
    with exact_fp32():
        for i in range(0, images.shape[0], block):
            x = clip.normalize_uint8(images[i:i + block].to(device))
            g, _ = clip.image_tower(x, W, config, tower_ops)
            globals_.append(g)
            refined.append(ern.index(g, patches[i:i + block].to(device).float(), W, ern_ops))
    return torch.cat(globals_), torch.cat(refined)


@torch.no_grad()
def query(ids: torch.Tensor, ref_global: torch.Tensor, ref_patches: torch.Tensor, W: dict,
          config: dict, precision=EXACT, block: int = 64) -> torch.Tensor:
    """Caption ids [B, L], the reference items' image-tower globals [B, d]
    and patch features [B, P, d] -> the query rows [B, d] (text tower, TME
    on a TME configuration, DVR), fp32, in blocks of `block` rows."""
    device = next(iter(W.values())).device
    tower_ops, ern_ops = precision
    out = []
    with exact_fp32():
        for i in range(0, ids.shape[0], block):
            t = ids[i:i + block].to(device)
            rp = ref_patches[i:i + block].to(device).float()
            tg, ts = clip.text_tower(t, W, config, tower_ops)
            if config["tme"]:
                tg, ts = ern.enhanced_text(t, ts, rp, W, config["tme_heads"], tower_ops)
            out.append(ern.dvr(rp, ts, ref_global[i:i + block].to(device).float(), tg, W,
                               config["ern"], ern_ops))
    return torch.cat(out)


@torch.no_grad()
def _frozen(batch: dict, W: dict, config: dict, ops, block: int = 128):
    """The frozen towers of a train batch: (reference globals, target
    globals, text globals, text seq)."""
    device = next(iter(W.values())).device
    out = {"ref": [], "tar": [], "tg": [], "ts": []}
    for i in range(0, batch["ids"].shape[0], block):
        for key in ("ref", "tar"):
            x = clip.normalize_uint8(batch[key + "_images"][i:i + block].to(device))
            out[key].append(clip.image_tower(x, W, config, ops)[0])
        tg, ts = clip.text_tower(batch["ids"][i:i + block].to(device), W, config, ops)
        out["tg"].append(tg)
        out["ts"].append(ts)
    return tuple(torch.cat(v) for v in out.values())


def train_steps(batches: list[dict], W: dict, config: dict, seed: int, lr_at,
                precision=EXACT) -> dict:
    """FashionERN's train step (`reference/train.py`) over `batches` in turn
    (each: uint8 `ref_images`, `tar_images`, caption `ids`, `ref_patch`,
    `tar_patch`), from the drawn weights `W`. -> {"losses": [...],
    "grads": the first step's gradients, "params": the trained
    parameters after the last step, "start": them before the first}."""
    W = names(W)
    frozen = {k: _bf16(v) for k, v in W.items() if not k.startswith("ern.")}
    params = {k: v.detach().clone().requires_grad_(v.is_floating_point())
              for k, v in W.items() if k.startswith("ern.")}
    trained = {k: v for k, v in params.items() if k.endswith(("weight", "bias", "_token"))
               and not k.endswith(("running_mean", "running_var"))}
    start = {k: v.detach().clone() for k, v in trained.items()}
    adam = Adam(trained)
    tower_ops, fusion_ops = precision
    heads, ern_cfg = config["tme_heads"], config["ern"]
    losses, first = [], None
    for step, b in enumerate(batches):
        device = next(iter(W.values())).device
        with exact_fp32():
            ref_g, tar_g, tg, ts = _frozen(b, frozen, config, tower_ops)
            Wt = {**frozen, **params}
            ids, rp, tp = (b[k].to(device) for k in ("ids", "ref_patch", "tar_patch"))
            if config["tme"]:
                tg, ts = ern.enhanced_text(ids, ts, rp.float(), Wt, heads, fusion_ops)
            tar = tar_g / torch.linalg.vector_norm(tar_g, dim=-1, keepdim=True)
            mode = TrainMode(seed, step, device)
            q = ern.dvr(rp.float(), ts, ref_g, tg, Wt, ern_cfg, fusion_ops, mode)
            target = ern.index(tar, tp.float(), Wt, fusion_ops, mode)
            loss = bbc_loss(q, target)
            keys = list(trained)
            grads = torch.autograd.grad(loss, [trained[k] for k in keys], allow_unused=True)
        got = {k: g for k, g in zip(keys, grads) if g is not None}
        if first is None:
            first = {k: g.detach().clone() for k, g in got.items()}
        adam.step({k: trained[k] for k in got}, got, lr_at(step))
        losses.append(float(loss.detach()))
    return {"losses": losses, "grads": first, "start": start,
            "params": {k: v.detach() for k, v in trained.items()}}
