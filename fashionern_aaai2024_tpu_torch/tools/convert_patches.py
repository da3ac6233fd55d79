"""Convert reference `.pth` patch-feature dumps to `.npy` / pack form.

JAX counterpart: `fashionern_aaai2024_tpu/tools/convert_patches.py`
(`:19-64`): the same files for the same directory.

The reference stores one `[13, dim]` torch tensor per image
(`utils/extract_patch_features_200k.py:182`) and `torch.load`s one file
per dataset item. This tool rewrites a patch directory into `.npy`
files plus the consolidated memory-mapped pack that
`data/patch_store.py PatchFeatureStore` prefers.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch


def convert_dir(src: str, dst: str | None = None, *, write_pack: bool = True,
                logger=print) -> int:
    dst = dst or src
    os.makedirs(dst, exist_ok=True)
    names: list[str] = []
    feats: list[np.ndarray] = []
    n = 0
    for dirpath, _, files in os.walk(src):
        for fn in sorted(files):
            if not fn.endswith(".pth"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, fn), src)
            name = rel[: -len(".pth")]
            arr = torch.load(os.path.join(dirpath, fn), map_location="cpu",
                             weights_only=False)
            arr = np.asarray(arr.detach().float().numpy(), np.float32)
            out = os.path.join(dst, name + ".npy")
            os.makedirs(os.path.dirname(out), exist_ok=True)
            np.save(out, arr)
            names.append(name)
            feats.append(arr)
            n += 1
            if n % 1000 == 0:
                logger(f"convert_patches: {n} converted")
    if write_pack and names:
        np.save(os.path.join(dst, "pack.npy"), np.stack(feats))
        with open(os.path.join(dst, "pack.names.json"), "w") as f:
            json.dump(names, f)
    return n


def build_pack(src: str, names: Sequence[str] | None = None) -> int:
    """Build the pack from existing `.npy` files."""
    if names is None:
        names = []
        for dirpath, _, files in os.walk(src):
            for fn in sorted(files):
                if fn.endswith(".npy") and fn != "pack.npy":
                    names.append(os.path.relpath(os.path.join(dirpath, fn), src)[:-4])
    feats = np.stack([np.load(os.path.join(src, n + ".npy")) for n in names])
    np.save(os.path.join(src, "pack.npy"), feats.astype(np.float32))
    with open(os.path.join(src, "pack.names.json"), "w") as f:
        json.dump(list(names), f)
    return len(names)
