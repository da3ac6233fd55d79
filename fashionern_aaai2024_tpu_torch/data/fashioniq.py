"""FashionIQ dataset (reference: `dataloader/fashioniq.py`).

JAX counterpart: `fashionern_aaai2024_tpu/data/fashioniq.py`
(`:27-129`): the same items, bit for bit, for the same files
(tests/test_torch_data.py).

Triplets come from `captions/cap.{dress_type}.{split}.json`
(fields: candidate, target, captions[2]); the gallery from
`image_splits/split.{dress_type}.{split}.json`. Items are dicts (not
positional tuples) and IO failures raise instead of silently yielding
`None` (reference defect §2.9.7) unless `skip_corrupt=True`.

`val_protocol=True` reproduces the VAL-paper gallery: union of triplet
candidates and targets instead of the split list
(`dataloader/fashioniq.py:271-277`).
"""

from __future__ import annotations

import json
import os
from typing import Sequence

from fashionern_aaai2024_tpu_torch.data.patch_store import PatchFeatureStore
from fashionern_aaai2024_tpu_torch.data.transforms import load_and_preprocess

DRESS_TYPES = ("dress", "shirt", "toptee")


class FashionIQDataset:
    def __init__(
        self,
        root: str,
        split: str,
        dress_types: Sequence[str],
        mode: str = "relative",
        dim: int = 288,
        pad_mode: str = "target",
        target_ratio: float = 1.25,
        image_dtype: str = "float32",  # "uint8" = low-bandwidth device-normalize feed
        patch_dir: str = "fashion_local13",
        image_dir: str = "images",
        image_ext: str = ".png",
        val_protocol: bool = False,
        load_images: bool = True,
        skip_corrupt: bool = False,
    ):
        if mode not in ("relative", "classic"):
            raise ValueError("mode should be in ['relative', 'classic']")
        if split not in ("test", "train", "val"):
            raise ValueError("split should be in ['test', 'train', 'val']")
        for dt in dress_types:
            if dt not in DRESS_TYPES:
                raise ValueError(f"dress_type should be in {DRESS_TYPES}")

        self.root = root
        self.split = split
        self.mode = mode
        self.dim = dim
        self.pad_mode = pad_mode
        self.target_ratio = target_ratio
        self.as_uint8 = image_dtype == "uint8"
        self.image_dir = image_dir
        self.image_ext = image_ext
        self.load_images = load_images
        self.skip_corrupt = skip_corrupt
        self.patches = PatchFeatureStore(os.path.join(root, patch_dir))

        self.triplets: list[dict] = []
        for dt in dress_types:
            with open(os.path.join(root, "captions", f"cap.{dt}.{split}.json")) as f:
                self.triplets.extend(json.load(f))

        if val_protocol:
            names: list[str] = []
            for t in self.triplets:
                names.append(t["candidate"])
                if "target" in t:
                    names.append(t["target"])
            # preserve first-seen order, dedup
            self.image_names = list(dict.fromkeys(names))
        else:
            self.image_names = []
            for dt in dress_types:
                with open(
                    os.path.join(root, "image_splits", f"split.{dt}.{split}.json")
                ) as f:
                    self.image_names.extend(json.load(f))

    def _image(self, name: str):
        path = os.path.join(self.root, self.image_dir, name + self.image_ext)
        return load_and_preprocess(path, self.dim, self.pad_mode,
                                   self.target_ratio, as_uint8=self.as_uint8)

    def __getitem__(self, index: int) -> dict:
        try:
            if self.mode == "classic":
                name = self.image_names[index]
                item = {"name": name, "patch": self.patches.get(name)}
                if self.load_images:
                    item["image"] = self._image(name)
                return item

            t = self.triplets[index]
            ref_name = t["candidate"]
            item = {
                "ref_name": ref_name,
                "captions": list(t["captions"]),
                "ref_patch": self.patches.get(ref_name),
            }
            if self.split == "train":
                tar_name = t["target"]
                item.update(
                    tar_name=tar_name,
                    tar_patch=self.patches.get(tar_name),
                )
                if self.load_images:
                    item["ref_image"] = self._image(ref_name)
                    item["tar_image"] = self._image(tar_name)
            elif self.split == "val":
                item["tar_name"] = t["target"]
            else:  # test: no targets published
                if self.load_images:
                    item["ref_image"] = self._image(ref_name)
            return item
        except Exception:
            if self.skip_corrupt:
                return None  # filtered by Loader
            raise

    def __len__(self) -> int:
        return len(self.triplets) if self.mode == "relative" else len(self.image_names)
