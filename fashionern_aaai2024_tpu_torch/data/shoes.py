"""Shoes dataset (reference: `dataloader/shoes.py`).

JAX counterpart: `fashionern_aaai2024_tpu/data/shoes.py`
(`:23-90`): the same items, bit for bit, for the same files
(tests/test_torch_data.py).

`split.{split}.json` (list of image rel-paths) + `triplet.{split}.json`
(ReferenceImageName / ImageName / RelativeCaption). The reference
hardcodes absolute `/mnt/...` roots (`shoes.py:16-17`, defect §2.9.11);
here every path is configurable.
"""

from __future__ import annotations

import json
import os

from fashionern_aaai2024_tpu_torch.data.patch_store import PatchFeatureStore
from fashionern_aaai2024_tpu_torch.data.transforms import load_and_preprocess


def _stem(path: str) -> str:
    return os.path.basename(path).split(".jpg")[0]


class ShoesDataset:
    def __init__(
        self,
        root: str,
        split: str,
        mode: str = "relative",
        dim: int = 288,
        pad_mode: str = "target",
        target_ratio: float = 1.25,
        image_dtype: str = "float32",  # "uint8" = low-bandwidth device-normalize feed
        patch_dir: str = "shoes_local_feature_13",
        load_images: bool = True,
        skip_corrupt: bool = False,
    ):
        self.root = root
        self.split = split
        self.mode = mode
        self.dim = dim
        self.pad_mode = pad_mode
        self.target_ratio = target_ratio
        self.as_uint8 = image_dtype == "uint8"
        self.load_images = load_images
        self.skip_corrupt = skip_corrupt
        self.patches = PatchFeatureStore(os.path.join(root, patch_dir))

        with open(os.path.join(root, f"split.{split}.json")) as f:
            self.image_relpaths = json.load(f)
        self.annotations = []
        if mode == "relative":
            with open(os.path.join(root, f"triplet.{split}.json")) as f:
                self.annotations = json.load(f)

    def _image(self, relpath: str):
        return load_and_preprocess(
            os.path.join(self.root, relpath), self.dim, self.pad_mode,
            self.target_ratio, as_uint8=self.as_uint8)

    def __getitem__(self, index: int) -> dict:
        try:
            if self.mode == "classic":
                rel = self.image_relpaths[index]
                name = _stem(rel)
                item = {"name": name, "patch": self.patches.get(name)}
                if self.load_images:
                    item["image"] = self._image(rel)
                return item

            ann = self.annotations[index]
            ref_name = _stem(ann["ReferenceImageName"])
            tar_name = _stem(ann["ImageName"])
            item = {
                "ref_name": ref_name,
                "tar_name": tar_name,
                "caption": ann["RelativeCaption"],
                "ref_patch": self.patches.get(ref_name),
                "tar_patch": self.patches.get(tar_name),
            }
            if self.split == "train" and self.load_images:
                item["ref_image"] = self._image(ann["ReferenceImageName"])
                item["tar_image"] = self._image(ann["ImageName"])
            return item
        except Exception:
            if self.skip_corrupt:
                return None
            raise

    def __len__(self) -> int:
        return len(self.annotations) if self.mode == "relative" else len(self.image_relpaths)
