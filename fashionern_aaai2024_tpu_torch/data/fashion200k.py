"""Fashion200k datasets (reference: `dataloader/fashion200k_patch.py`).

JAX counterpart: `fashionern_aaai2024_tpu/data/fashion200k.py`
(`:42-247`): the same items, bit for bit, for the same files
(tests/test_torch_data.py).

The training set has no annotated triplets: (reference, target,
"replace X with Y") pairs are *generated* from single-word caption
differences. That generation algorithm defines the training
distribution, so it is ported faithfully
(`caption_index_init_` :140-181, `caption_index_sample_` :183-197,
`generate_random_train_queries_` :199-235) — but with an explicit,
seedable RNG instead of global `random`/`np.random` state.

Label files: `labels/*_{split}_*.txt`, tab-separated
`file_path \t score \t caption`. Patch features live next to images
with `women→local_features` path substitution (`:116-117` — kept, but
overridable via `patch_path_map`).
"""

from __future__ import annotations

import glob
import os
import random
from typing import Callable

import numpy as np

from fashionern_aaai2024_tpu_torch.data.captions import caption_post_process, get_different_word
from fashionern_aaai2024_tpu_torch.data.transforms import load_and_preprocess


def _default_patch_path(img_path: str) -> str:
    return img_path.replace("women", "local_features") + ".pth"


def _load_patch(path: str) -> np.ndarray:
    if os.path.exists(path.removesuffix(".pth") + ".npy"):
        return np.load(path.removesuffix(".pth") + ".npy").astype(np.float32)
    import torch

    return torch.load(path, map_location="cpu", weights_only=True).float().numpy()


class _Fashion200kBase:
    def __init__(
        self,
        root: str,
        split: str,
        dim: int = 288,
        pad_mode: str = "target",
        target_ratio: float = 1.25,
        image_dtype: str = "float32",  # "uint8" = low-bandwidth device-normalize feed
        load_images: bool = True,
        patch_path_map: Callable[[str], str] = _default_patch_path,
    ):
        self.root = root
        self.split = split
        self.dim = dim
        self.pad_mode = pad_mode
        self.target_ratio = target_ratio
        self.as_uint8 = image_dtype == "uint8"
        self.load_images = load_images
        self.patch_path_map = patch_path_map
        self.imgs: list[dict] = []
        label_files = sorted(
            glob.glob(os.path.join(root, "labels", f"*_{split}_*.txt"))
        )
        for label_file in label_files:
            with open(label_file, encoding="utf8") as fd:
                for line in fd:
                    parts = line.rstrip("\n").split("\t")
                    self.imgs.append(
                        {
                            "file_path": parts[0],
                            "captions": [caption_post_process(parts[2])],
                            "modifiable": False,
                        }
                    )

    def _image(self, file_path: str):
        return load_and_preprocess(
            os.path.join(self.root, file_path), self.dim, self.pad_mode,
            self.target_ratio, rgb_first=True, as_uint8=self.as_uint8)

    def _patch(self, file_path: str) -> np.ndarray:
        return _load_patch(self.patch_path_map(os.path.join(self.root, file_path)))


class Fashion200kDataset(_Fashion200kBase):
    """Training set with on-the-fly pair generation."""

    def __init__(self, root: str, split: str = "train", seed: int = 42,
                 n_modifications_per_image: int = 5, **kw):
        super().__init__(root, split, **kw)
        self._rng = random.Random(seed)
        self._nprng = np.random.default_rng(seed)
        self.caption_index_init_()
        self.generate_random_train_queries_(n_modifications_per_image)

    def caption_index_init_(self) -> None:
        caption2id: dict[str, int] = {}
        caption2imgids: dict[str, list[int]] = {}
        for i, img in enumerate(self.imgs):
            for c in img["captions"]:
                if c not in caption2id:
                    caption2id[c] = len(caption2id)
                    caption2imgids[c] = []
                caption2imgids[c].append(i)
        self.caption2imgids = caption2imgids

        parent2children: dict[str, list[str]] = {}
        for c in caption2id:
            for w in c.split():
                p = c.replace(w, "").replace("    ", " ").strip()
                parent2children.setdefault(p, [])
                if c not in parent2children[p]:
                    parent2children[p].append(c)
        self.parent2children_captions = parent2children

        for img in self.imgs:
            img["modifiable"] = False
            img["parent_captions"] = []
        for p, children in parent2children.items():
            if len(children) >= 2:
                for c in children:
                    for imgid in caption2imgids[c]:
                        self.imgs[imgid]["modifiable"] = True
                        self.imgs[imgid]["parent_captions"].append(p)
        self.num_modifiable_imgs = sum(im["modifiable"] for im in self.imgs)

    def caption_index_sample_(self, idx: int):
        while not self.imgs[idx]["modifiable"]:
            idx = int(self._nprng.integers(0, len(self.imgs)))
        img = self.imgs[idx]
        while True:
            p = self._rng.choice(img["parent_captions"])
            c = self._rng.choice(self.parent2children_captions[p])
            if c not in img["captions"]:
                break
        target_idx = self._rng.choice(self.caption2imgids[c])
        source_caption = self.imgs[idx]["captions"][0]
        target_caption = self.imgs[target_idx]["captions"][0]
        _, _, mod_str = get_different_word(source_caption, target_caption)
        return idx, target_idx, source_caption, target_caption, mod_str

    def generate_random_train_queries_(self, n_modifications_per_image: int = 3) -> None:
        pairs: list[tuple[int, int, str]] = []
        visited: set[tuple[int, int]] = set()
        for i, img in enumerate(self.imgs):
            if not img["modifiable"]:
                continue
            for _ in range(n_modifications_per_image):
                idx, tgt, _, _, mod_str = self.caption_index_sample_(i)
                if set(self.imgs[idx]["captions"][0].split(" ")) == set(
                    self.imgs[tgt]["captions"][0].split(" ")
                ):
                    continue
                if (tgt, idx) in visited or (idx, tgt) in visited:
                    continue
                visited.add((tgt, idx))
                pairs.append((idx, tgt, mod_str))
        self._rng.shuffle(pairs)
        self.pairs = pairs

    def resample_epoch(self, n_modifications_per_image: int = 5) -> None:
        """Regenerate the pair set (the reference only samples once per
        run; per-epoch resampling is available as an improvement)."""
        self.generate_random_train_queries_(n_modifications_per_image)

    def __getitem__(self, index: int) -> dict:
        src, tgt, mod_str = self.pairs[index]
        src_img, tgt_img = self.imgs[src], self.imgs[tgt]
        item = {
            "caption": mod_str,
            "ref_id": src_img["captions"][0],
            "tar_id": tgt_img["captions"][0],
            # unique per-image keys (captions are multi-positive ids);
            # used by the trainer's image-feature cache
            "ref_name": src_img["file_path"],
            "tar_name": tgt_img["file_path"],
            "ref_patch": self._patch(src_img["file_path"]),
            "tar_patch": self._patch(tgt_img["file_path"]),
        }
        if self.load_images:
            item["ref_image"] = self._image(src_img["file_path"])
            item["tar_image"] = self._image(tgt_img["file_path"])
        return item

    def __len__(self) -> int:
        return len(self.pairs)


class Fashion200kTestDataset(_Fashion200kBase):
    """Gallery: every test-label image; id = its caption (multi-positive
    retrieval semantics, `run/test/test_200k.py:53-60`)."""

    def __init__(self, root: str, split: str = "test", **kw):
        super().__init__(root, "test" if split == "val" else split, **kw)

    def __getitem__(self, index: int) -> dict:
        img = self.imgs[index]
        item = {
            "name": img["captions"][0],  # caption id, not filename
            "patch": self._patch(img["file_path"]),
        }
        if self.load_images:
            item["image"] = self._image(img["file_path"])
        return item

    def __len__(self) -> int:
        return len(self.imgs)


class Fashion200kTestQueryDataset(_Fashion200kBase):
    """Queries from `test_queries.txt` (ref path, target path per line),
    modifier from the single-word caption diff."""

    def __init__(self, root: str, split: str = "test", **kw):
        super().__init__(root, "test" if split == "val" else split, **kw)
        file2imgid = {img["file_path"]: i for i, img in enumerate(self.imgs)}
        self.queries: list[dict] = []
        with open(os.path.join(root, "test_queries.txt")) as f:
            for line in f:
                if not line.strip():
                    continue
                source_file, target_file = line.split()
                idx, tgt = file2imgid[source_file], file2imgid[target_file]
                sc = self.imgs[idx]["captions"][0]
                tc = self.imgs[tgt]["captions"][0]
                _, _, mod_str = get_different_word(sc, tc)
                self.queries.append(
                    {"source_idx": idx, "ref_id": sc, "tar_id": tc, "caption": mod_str}
                )

    def __getitem__(self, index: int) -> dict:
        q = self.queries[index]
        img = self.imgs[q["source_idx"]]
        item = {
            "ref_id": caption_post_process(q["ref_id"]),
            "tar_id": caption_post_process(q["tar_id"]),
            "caption": q["caption"],
            "ref_patch": self._patch(img["file_path"]),
        }
        if self.load_images:
            item["ref_image"] = self._image(img["file_path"])
        return item

    def __len__(self) -> int:
        return len(self.queries)
