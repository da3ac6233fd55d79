"""Offline 13-crop patch-feature extraction, batched on the port's image tower.

JAX counterpart: `fashionern_aaai2024_tpu/tools/extract_patches.py`
(`:33-180`): the same crops, bit for bit, and the same files. The
reference (`utils/extract_patch_features_200k.py`,
`utils/extract_fashioniq_patch.py`) resizes an image to 360 x 360, cuts a
2 x 2 grid (4 crops) and a 3 x 3 grid (9 crops), preprocesses each crop
with the TargetPad pipeline, encodes each crop one at a time with CLIP
and `torch.save`s a [13, dim] tensor per image. Here the 13 crops of B
images are one [B * 13, d, d, 3] batch through the image tower (the
encoder `cli/main.py` builds runs on the card), and the output is a
`.npy` per image plus the memory-mapped pack (`pack.npy` +
`pack.names.json`) that `data/patch_store.py` reads. The JAX extractor
pads the last batch to keep one compiled program; eager PyTorch runs it
at its own size. Images whose `.npy` exists are skipped.
"""

from __future__ import annotations

import concurrent.futures as futures
import glob
import io
import json
import os
from typing import Callable, Sequence

import numpy as np

from fashionern_aaai2024_tpu_torch.data.transforms import preprocess_image

RESIZE = 360
GRIDS = (2, 3)  # 4 + 9 = 13 crops


def cut_crops(image, grids: Sequence[int] = GRIDS) -> list:
    """Integer-divided grid crops of a PIL image, the reference's geometry
    (`extract_patch_features_200k.py:25-51`)."""
    crops = []
    w, h = image.size
    for g in grids:
        iw, ih = int(w / g), int(h / g)
        for i in range(g):
            for j in range(g):
                crops.append(image.crop((j * iw, i * ih, (j + 1) * iw, (i + 1) * ih)))
    return crops


def image_to_crop_array(path_or_image, dim: int, target_ratio: float = 1.25) -> np.ndarray:
    """One image (a path or a PIL image) -> [13, dim, dim, 3] preprocessed
    crops. A JPEG path takes the native pipeline where its decoder is
    built (decode, board resize, 13 windowed resizes and the normalize in
    one call; the crops are square, so TargetPad is a no-op whenever
    target_ratio > 1); everything else PIL. The two give the same pixels."""
    from PIL import Image

    if isinstance(path_or_image, (str, os.PathLike)):
        with open(path_or_image, "rb") as f:
            data = f.read()
        if target_ratio > 1.0:
            from fashionern_aaai2024_tpu_torch.native import image as native_image

            if native_image.is_jpeg(data) and native_image.has_decoder():
                out = native_image.extract_crops(data, dim, RESIZE)
                if out is not None:
                    return out
        with Image.open(io.BytesIO(data)) as img:
            image = img.convert("RGB").resize((RESIZE, RESIZE), Image.BICUBIC)
    else:
        image = path_or_image.convert("RGB").resize((RESIZE, RESIZE), Image.BICUBIC)
    return np.stack([preprocess_image(c, dim, "target", target_ratio)
                     for c in cut_crops(image)])


class PatchExtractor:
    """`encode_fn`: [N, d, d, 3] float32 crops -> [N, feat] global image
    features (anything `np.asarray` takes); `batch_images` images a call."""

    def __init__(self, encode_fn: Callable, dim: int, batch_images: int = 16,
                 target_ratio: float = 1.25):
        self.encode_fn = encode_fn
        self.dim = dim
        self.batch_images = batch_images
        self.target_ratio = target_ratio
        self.n_crops = sum(g * g for g in GRIDS)

    def extract_batch(self, paths: Sequence) -> np.ndarray:
        """[B, 13, feat] for B <= batch_images images; the crops are cut
        on threads."""
        b = len(paths)
        with futures.ThreadPoolExecutor(min(8, max(1, b))) as pool:
            crops = np.stack(list(pool.map(
                lambda p: image_to_crop_array(p, self.dim, self.target_ratio), paths)))
        flat = crops.reshape(b * self.n_crops, self.dim, self.dim, 3)
        return np.asarray(self.encode_fn(flat)).reshape(b, self.n_crops, -1)

    def run(self, items: Sequence[tuple[str, str]], out_dir: str, *, write_pack: bool = True,
            skip_existing: bool = True, log_every: int = 50, logger=print) -> int:
        """items: (image_path, output_name) pairs. Writes
        `<out_dir>/<name>.npy` [13, feat] per image (and the pack)."""
        os.makedirs(out_dir, exist_ok=True)
        todo = [(p, n) for p, n in items
                if not (skip_existing and os.path.exists(os.path.join(out_dir, n + ".npy")))]
        names, feats_all = [], []
        done = 0
        for i in range(0, len(todo), self.batch_images):
            chunk = todo[i:i + self.batch_images]
            feats = self.extract_batch([p for p, _ in chunk])
            for (_, name), f in zip(chunk, feats):
                out = os.path.join(out_dir, name + ".npy")
                os.makedirs(os.path.dirname(out), exist_ok=True)
                np.save(out, f.astype(np.float32))
                names.append(name)
                feats_all.append(f.astype(np.float32))
            done += len(chunk)
            if log_every and done % log_every < self.batch_images:
                logger(f"extract_patches: {done}/{len(todo)}")
        if write_pack and names:
            write_patch_pack(out_dir, names, np.stack(feats_all))
        return done


def write_patch_pack(out_dir: str, names: Sequence[str], feats: np.ndarray) -> None:
    """The pack that `data/patch_store.py PatchFeatureStore` reads."""
    np.save(os.path.join(out_dir, "pack.npy"), feats.astype(np.float32))
    with open(os.path.join(out_dir, "pack.names.json"), "w") as f:
        json.dump(list(names), f)


def enumerate_fashion200k(root: str, splits=("train", "test")) -> list[tuple[str, str]]:
    """(image_path, output_name) from labels/*_<split>_*.txt; names keep
    the reference's `women/...` relpath (`fashion200k_patch.py:116-117`)."""
    items = []
    seen = set()
    for split in splits:
        for f in sorted(glob.glob(os.path.join(root, "labels", f"*_{split}_*.txt"))):
            with open(f) as fr:
                for line in fr:
                    rel = line.strip().split("\t")[0]
                    if rel and rel not in seen:
                        seen.add(rel)
                        items.append((os.path.join(root, rel), rel))
    return items


def enumerate_image_dir(root: str, image_dir: str = "images",
                        exts=(".png", ".jpg", ".jpeg")) -> list[tuple[str, str]]:
    """FashionIQ / CIRR / Shoes: every image under `<root>/<image_dir>`,
    named by its stem."""
    items = []
    for dirpath, _, files in os.walk(os.path.join(root, image_dir)):
        for fn in sorted(files):
            if fn.lower().endswith(exts):
                items.append((os.path.join(dirpath, fn), os.path.splitext(fn)[0]))
    return items
