"""CIRR dataset (reference: `dataloader/cirr.py`).

JAX counterpart: `fashionern_aaai2024_tpu/data/cirr.py`
(`:18-98`): the same items, bit for bit, for the same files
(tests/test_torch_data.py).

`captions/cap.rc2.{split}.json` triplets (reference, target_hard,
caption, img_set.members, pairid for test1) and
`image_splits/split.rc2.{split}.json` name→relpath map.
"""

from __future__ import annotations

import json
import os

from fashionern_aaai2024_tpu_torch.data.patch_store import PatchFeatureStore
from fashionern_aaai2024_tpu_torch.data.transforms import load_and_preprocess


class CIRRDataset:
    def __init__(
        self,
        root: str,
        split: str,
        mode: str = "relative",
        dim: int = 288,
        pad_mode: str = "target",
        target_ratio: float = 1.25,
        image_dtype: str = "float32",  # "uint8" = low-bandwidth device-normalize feed
        patch_dir: str = "cirr_local_13",
        load_images: bool = True,
        skip_corrupt: bool = False,
    ):
        if split not in ("test1", "train", "val"):
            raise ValueError("split should be in ['test1', 'train', 'val']")
        if mode not in ("relative", "classic"):
            raise ValueError("mode should be in ['relative', 'classic']")
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

        with open(os.path.join(root, "cirr", "captions", f"cap.rc2.{split}.json")) as f:
            self.triplets = json.load(f)
        with open(
            os.path.join(root, "cirr", "image_splits", f"split.rc2.{split}.json")
        ) as f:
            self.name_to_relpath = json.load(f)
        self.image_names = list(self.name_to_relpath.keys())

    def _image(self, name: str):
        path = os.path.join(self.root, self.name_to_relpath[name])
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
            ref_name = t["reference"]
            item = {
                "ref_name": ref_name,
                "caption": t["caption"],
                "group_members": list(t["img_set"]["members"]),
            }
            if self.split == "test1":
                item["pair_id"] = t["pairid"]
                if self.load_images:
                    item["ref_image"] = self._image(ref_name)
                item["ref_patch"] = self.patches.get(ref_name)
                return item

            item["ref_patch"] = self.patches.get(ref_name)
            tar_name = t["target_hard"]
            item["tar_name"] = tar_name
            if self.split == "train":
                item["tar_patch"] = self.patches.get(tar_name)
                if self.load_images:
                    item["ref_image"] = self._image(ref_name)
                    item["tar_image"] = self._image(tar_name)
            return item
        except Exception:
            if self.skip_corrupt:
                return None
            raise

    def __len__(self) -> int:
        return len(self.triplets) if self.mode == "relative" else len(self.image_names)
