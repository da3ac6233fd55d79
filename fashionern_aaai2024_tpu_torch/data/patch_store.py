"""Offline patch-feature store.

JAX counterpart: `fashionern_aaai2024_tpu/data/patch_store.py`
(`:25-75`): the same items, bit for bit, for the same files
(tests/test_torch_data.py).

The reference pre-extracts [13, dim] per-image patch features into
per-image `.pth` files and `torch.load`s one file per dataset item
(`dataloader/fashioniq.py:69-70`, `dataloader/shoes.py:31-34`) — a
host-IO antipattern.

This store reads `.npy` files (one per image, produced by
`extract-patches` or by converting `.pth`s with
`tools/convert_patches.py`), optionally falling back to `.pth` via
torch when present, and supports a single consolidated
memory-mapped pack (`pack.npy` + `pack.names.json`) for zero-per-item
file-open overhead.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Sequence

import numpy as np


class PatchFeatureStore:
    def __init__(self, root: str, patch_num: int = 13, feature_dim: int | None = None):
        self.root = root
        self.patch_num = patch_num
        self.feature_dim = feature_dim
        self._pack: np.ndarray | None = None
        self._pack_index: dict[str, int] | None = None
        pack_path = os.path.join(root, "pack.npy")
        names_path = os.path.join(root, "pack.names.json")
        if os.path.exists(pack_path) and os.path.exists(names_path):
            self._pack = np.load(pack_path, mmap_mode="r")
            with open(names_path) as f:
                self._pack_index = {n: i for i, n in enumerate(json.load(f))}

    def get(self, name: str) -> np.ndarray:
        """[patch_num, dim] float32 features for image `name`."""
        if self._pack is not None and name in self._pack_index:
            return np.asarray(self._pack[self._pack_index[name]], np.float32)
        npy = os.path.join(self.root, f"{name}.npy")
        if os.path.exists(npy):
            return np.load(npy).astype(np.float32)
        pth = os.path.join(self.root, f"{name}.pth")
        if os.path.exists(pth):
            import torch  # the reference's .pth format

            return torch.load(pth, map_location="cpu", weights_only=True).float().numpy()
        raise FileNotFoundError(f"no patch features for {name!r} under {self.root}")

    def get_batch(self, names: Sequence[str]) -> np.ndarray:
        """Contiguous [B, patch_num, dim] batch. On the pack path this is
        one threaded native gather (native/fastloader.cpp) instead of a
        per-name Python loop."""
        if self._pack is not None and all(n in self._pack_index for n in names):
            from fashionern_aaai2024_tpu_torch import native

            idx = [self._pack_index[n] for n in names]
            pack = self._pack
            if isinstance(pack, np.memmap) and pack.dtype == np.float32:
                return native.gather_rows(pack, idx)
            return np.ascontiguousarray(np.asarray(pack, np.float32)[idx])
        return np.stack([self.get(n) for n in names])

    @staticmethod
    def write_pack(root: str, names: Iterable[str], features: np.ndarray) -> None:
        """Consolidate into one memory-mappable pack file."""
        names = list(names)
        assert features.shape[0] == len(names)
        os.makedirs(root, exist_ok=True)
        np.save(os.path.join(root, "pack.npy"), features.astype(np.float32))
        with open(os.path.join(root, "pack.names.json"), "w") as f:
            json.dump(names, f)
