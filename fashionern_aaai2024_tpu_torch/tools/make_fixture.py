"""Synthetic on-disk dataset fixtures for all four benchmark layouts.

JAX counterpart: `fashionern_aaai2024_tpu/tools/make_fixture.py`
(`:1-401`): the same tree for the same arguments, file for file
(tests/test_torch_fixture.py); the BPE table is learned by the port
tokenizer's `write_bpe_table`. PIL writes the images.

Writes the EXACT directory structure each dataset class (and therefore
the reference's loaders, `dataloader/*.py`) expects — caption/split
JSONs, Fashion200k label txt + `test_queries.txt`, images, 13-crop patch
`.npy` features (+ pack), and a small valid BPE merges table — so the
full `train` → `eval` plumbing can be driven end-to-end without the
real datasets.

Layouts mirrored:
  fashioniq   — captions/cap.{dt}.{split}.json, image_splits/split.{dt}.
                {split}.json, images/*.png, fashion_local13/*.npy
                (reference `dataloader/fashioniq.py:30-45`)
  cirr        — cirr/captions/cap.rc2.{split}.json, cirr/image_splits/
                split.rc2.{split}.json (name→relpath), cirr_local_13/
                (reference `dataloader/cirr.py:24-40`)
  shoes       — split.{split}.json, triplet.{split}.json (Reference
                ImageName/ImageName/RelativeCaption), attributedata/...,
                shoes_local_feature_13/ (reference `dataloader/shoes.py`)
  fashion200k — labels/*_{split}_*.txt (path\\tscore\\tcaption),
                women/**.jpeg images, local_features/ patch mirror
                (women→local_features substitution), test_queries.txt
                (reference `dataloader/fashion200k_patch.py:10-49,116`)
"""

from __future__ import annotations

import json
import os
import random

import numpy as np

from fashionern_aaai2024_tpu_torch.models.clip.tokenizer import write_bpe_table

_COLORS = ("red", "blue", "black", "white", "green", "yellow")
_STYLES = ("floral", "striped", "plain", "dotted", "lace", "denim")

# learnable mode: visible attributes CLIP's frozen towers separate well,
# so caption→target retrieval on HELD-OUT val triplets is actually
# learnable (the default random fixture has no caption↔image signal by
# construction — fine for plumbing, a ceiling of noise for accuracy)
_ATTR_RGB = {"red": (220, 40, 40), "blue": (40, 70, 220),
             "green": (40, 180, 70), "yellow": (230, 210, 40),
             "purple": (150, 50, 200), "orange": (240, 140, 30)}
_ATTR_PATTERNS = ("striped", "dotted", "plain")


def _write_image(path: str, rng: random.Random, size: int = 64) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    arr = np.asarray(
        [[((rng.randrange(256)), rng.randrange(256), rng.randrange(256))
          for _ in range(size)] for _ in range(size)], np.uint8
    )
    Image.fromarray(arr).save(path)


def _write_attr_image(path: str, rng: random.Random, color: str,
                      pattern: str, size: int = 64) -> None:
    """A mostly-solid `color` image with a visible `pattern` overlay and
    mild pixel noise (so images of one class are distinct but cluster)."""
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    base = np.asarray(_ATTR_RGB[color], np.float32)
    arr = np.tile(base, (size, size, 1))
    if pattern == "striped":
        arr[:, ::8] = (245, 245, 245)
    elif pattern == "dotted":
        arr[3::8, 3::8] = (10, 10, 10)
        arr[3::8, 4::8] = (10, 10, 10)
        arr[4::8, 3::8] = (10, 10, 10)
        arr[4::8, 4::8] = (10, 10, 10)
    noise = np.asarray([[rng.gauss(0.0, 12.0) for _ in range(size)]
                        for _ in range(size)], np.float32)[..., None]
    arr = np.clip(arr + noise, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def _assign_attrs(names: list[str], rng: random.Random) -> dict:
    """name → (color, pattern), round-robin over the class grid so every
    class has gallery members (multiple images per class ⇒ recall@10 can
    reward learned attribute retrieval, not just one-in-N luck)."""
    grid = [(c, p) for c in _ATTR_RGB for p in _ATTR_PATTERNS]
    rng.shuffle(grid)
    return {n: grid[i % len(grid)] for i, n in enumerate(names)}


def _attr_caption(color: str, pattern: str) -> str:
    return f"is {color} with {pattern} pattern"


def _write_patches(dir_: str, names: list[str], dim: int, patch_num: int,
                   seed: int) -> None:
    g = np.random.default_rng(seed)
    os.makedirs(dir_, exist_ok=True)
    rows = []
    for n in names:
        feats = g.standard_normal((patch_num, dim)).astype(np.float32)
        np.save(os.path.join(dir_, f"{n}.npy"), feats)
        rows.append(feats)
    np.save(os.path.join(dir_, "pack.npy"), np.stack(rows))
    with open(os.path.join(dir_, "pack.names.json"), "w") as f:
        json.dump(names, f)


def _caption(rng: random.Random) -> str:
    return (f"is {rng.choice(_COLORS)} with a {rng.choice(_STYLES)} "
            f"pattern and {rng.choice(('long', 'short'))} sleeves")


def make_fashioniq(root: str, n_images: int = 12, n_triplets: int = 6,
                   dim: int = 512, patch_num: int = 13, seed: int = 0,
                   learnable: bool = False) -> None:
    rng = random.Random(seed)
    os.makedirs(os.path.join(root, "captions"), exist_ok=True)
    os.makedirs(os.path.join(root, "image_splits"), exist_ok=True)
    all_names, caps, all_attrs = [], [], {}
    for dt in ("dress", "shirt", "toptee"):
        names = [f"{dt}{i}" for i in range(n_images)]
        all_names.extend(names)
        attrs = _assign_attrs(names, rng) if learnable else {}
        all_attrs.update(attrs)
        for n in names:
            path = os.path.join(root, "images", f"{n}.png")
            if learnable:
                _write_attr_image(path, rng, *attrs[n])
            else:
                _write_image(path, rng)
        for split in ("train", "val"):
            trips = []
            for _ in range(n_triplets):
                a, b = rng.sample(names, 2)
                if learnable:  # the dual captions describe the TARGET
                    color, pattern = attrs[b]
                    captions = [f"is {color}", f"has {pattern} pattern"]
                else:
                    captions = [_caption(rng), _caption(rng)]
                trips.append({"candidate": a, "target": b,
                              "captions": captions})
                caps.extend(captions)
            with open(os.path.join(root, "captions",
                                   f"cap.{dt}.{split}.json"), "w") as f:
                json.dump(trips, f)
            with open(os.path.join(root, "image_splits",
                                   f"split.{dt}.{split}.json"), "w") as f:
                json.dump(names, f)
    _write_patches(os.path.join(root, "fashion_local13"), all_names, dim,
                   patch_num, seed)
    if learnable:
        with open(os.path.join(root, "fixture_attrs.json"), "w") as f:
            json.dump({n: list(a) for n, a in all_attrs.items()}, f)
    write_bpe_table(root, caps)


def make_cirr(root: str, n_images: int = 16, n_triplets: int = 8,
              dim: int = 512, patch_num: int = 13, seed: int = 0,
              learnable: bool = False) -> None:
    rng = random.Random(seed)
    os.makedirs(os.path.join(root, "cirr", "captions"), exist_ok=True)
    os.makedirs(os.path.join(root, "cirr", "image_splits"), exist_ok=True)
    names = [f"cirr{i}" for i in range(n_images)]
    relpath = {n: f"dev/{n}.png" for n in names}
    attrs = _assign_attrs(names, rng) if learnable else {}
    for n in names:
        if learnable:
            _write_attr_image(os.path.join(root, relpath[n]), rng, *attrs[n])
        else:
            _write_image(os.path.join(root, relpath[n]), rng)
    caps = []
    for split in ("train", "val", "test1"):
        trips = []
        for t in range(n_triplets):
            a, b = rng.sample(names, 2)
            # real-CIRR invariant: the 6-member img_set contains the
            # reference and (non-test1) the target exactly once — the
            # evaluator asserts this (reference run/valid/validate_cirr.py:60-61)
            others = rng.sample([n for n in names if n not in (a, b)], 4)
            members = [a, b] + others
            rng.shuffle(members)
            cap = _attr_caption(*attrs[b]) if learnable else _caption(rng)
            trip = {"reference": a, "caption": cap,
                    "img_set": {"members": members}}
            caps.append(trip["caption"])
            if split == "test1":
                trip["pairid"] = t
            else:
                trip["target_hard"] = b
            trips.append(trip)
        with open(os.path.join(root, "cirr", "captions",
                               f"cap.rc2.{split}.json"), "w") as f:
            json.dump(trips, f)
        with open(os.path.join(root, "cirr", "image_splits",
                               f"split.rc2.{split}.json"), "w") as f:
            json.dump(relpath, f)
    _write_patches(os.path.join(root, "cirr_local_13"), names, dim,
                   patch_num, seed)
    if learnable:
        with open(os.path.join(root, "fixture_attrs.json"), "w") as f:
            json.dump({n: list(a) for n, a in attrs.items()}, f)
    write_bpe_table(root, caps)


def make_shoes(root: str, n_images: int = 12, n_triplets: int = 6,
               dim: int = 512, patch_num: int = 13, seed: int = 0,
               learnable: bool = False) -> None:
    rng = random.Random(seed)
    names = [f"shoe{i}" for i in range(n_images)]
    rels = [f"attributedata/{n}.jpg" for n in names]
    attrs = _assign_attrs(names, rng) if learnable else {}
    for n, r in zip(names, rels):
        if learnable:
            _write_attr_image(os.path.join(root, r), rng, *attrs[n])
        else:
            _write_image(os.path.join(root, r), rng)
    caps = []
    for split in ("train", "val"):
        with open(os.path.join(root, f"split.{split}.json"), "w") as f:
            json.dump(rels, f)
        trips = []
        for _ in range(n_triplets):
            i, j = rng.sample(range(n_images), 2)
            cap = (_attr_caption(*attrs[names[j]]) if learnable
                   else _caption(rng))
            trips.append({"ReferenceImageName": rels[i], "ImageName": rels[j],
                          "RelativeCaption": cap})
            caps.append(cap)
        with open(os.path.join(root, f"triplet.{split}.json"), "w") as f:
            json.dump(trips, f)
    _write_patches(os.path.join(root, "shoes_local_feature_13"), names, dim,
                   patch_num, seed)
    if learnable:
        with open(os.path.join(root, "fixture_attrs.json"), "w") as f:
            json.dump({n: list(a) for n, a in attrs.items()}, f)
    write_bpe_table(root, caps)


def make_fashion200k(root: str, n_per_color: int = 3, dim: int = 512,
                     patch_num: int = 13, seed: int = 0,
                     learnable: bool = False,
                     n_queries: int = 8) -> None:
    """Captions differ by exactly one word across groups so the
    pair-generation / word-diff algorithm has real work to do.

    `learnable=True` renders each image with its caption's visible
    (color, pattern) attributes, so the multi-positive test protocol
    (any top-K image sharing the target CAPTION counts,
    `run/test/test_200k.py:53-60`) measures learned attribute retrieval
    rather than noise — the accuracy soak's 200k leg."""
    rng = random.Random(seed)
    os.makedirs(os.path.join(root, "labels"), exist_ok=True)
    if learnable:
        colors = list(_ATTR_RGB)[:4]
        styles = list(_ATTR_PATTERNS[:2])
    else:
        colors, styles = _COLORS[:4], _STYLES[:2]
    entries = {"train": [], "test": []}
    for split in ("train", "test"):
        k = 0
        for color in colors:
            for style in styles:
                for i in range(n_per_color):
                    path = (f"women/dresses/{split}_{color}_{style}_{i}/"
                            f"img_{k}.jpeg")
                    caption = f"{color} {style} dress"
                    entries[split].append((path, caption))
                    k += 1
        with open(os.path.join(root, "labels",
                               f"dress_{split}_detect_all.txt"), "w") as f:
            for path, caption in entries[split]:
                f.write(f"{path}\t0.9\t{caption}\n")
    all_caps = []
    for split, ents in entries.items():
        for path, caption in ents:
            all_caps.append(caption)
            if learnable:
                color, style = caption.split()[:2]
                _write_attr_image(os.path.join(root, path), rng, color, style)
            else:
                _write_image(os.path.join(root, path), rng)
            pdir = os.path.join(
                root, os.path.dirname(path).replace("women", "local_features"))
            os.makedirs(pdir, exist_ok=True)
            feats = np.random.default_rng(
                abs(hash(path)) % (2 ** 31)
            ).standard_normal((patch_num, dim)).astype(np.float32)
            np.save(os.path.join(
                root, path.replace("women", "local_features") + ".npy"), feats)
    # test queries: pairs whose captions differ in one word (rejection-
    # sample so exactly n_queries lines are written, capped for safety)
    test = entries["test"]
    lines = []
    for _ in range(50 * n_queries):
        if len(lines) >= n_queries:
            break
        a, b = rng.sample(test, 2)
        if a[1] != b[1]:
            lines.append(f"{a[0]} {b[0]}")
    with open(os.path.join(root, "test_queries.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    if learnable:
        attrs = {p: c.split()[:2] for p, c in
                 entries["train"] + entries["test"]}
        with open(os.path.join(root, "fixture_attrs.json"), "w") as f:
            json.dump(attrs, f)
    write_bpe_table(root, all_caps)


MAKERS = {
    "fashioniq": make_fashioniq,
    "cirr": make_cirr,
    "shoes": make_shoes,
    "fashion200k": make_fashion200k,
}


def make_fixture(root: str, dataset: str, dim: int = 512,
                 patch_num: int = 13, seed: int = 0,
                 n_images: int | None = None,
                 n_triplets: int | None = None,
                 learnable: bool = False,
                 n_per_color: int | None = None,
                 n_queries: int | None = None) -> str:
    """`n_images`/`n_triplets` scale the per-type universe (fashioniq /
    cirr / shoes makers): the defaults make a seconds-fast plumbing
    fixture; the accuracy soak (`benchmarks/accuracy_soak.py`) uses a
    larger one so recall@K over the gallery is a sharp metric rather
    than a saturating one.

    `learnable=True` (fashioniq/cirr/shoes) draws each image with a
    visible (color, pattern) attribute pair and makes every triplet's
    caption describe its TARGET's attributes, so held-out val queries
    are genuinely learnable — the accuracy soak's generalization mode.
    The name→attrs map is written to fixture_attrs.json."""
    os.makedirs(root, exist_ok=True)
    kw = dict(dim=dim, patch_num=patch_num, seed=seed)
    # dispatch on the maker's actual signature instead of catching
    # TypeError: a TypeError raised INSIDE a maker body must propagate,
    # and flags a maker does not support must be reported, not dropped
    # (fashion200k sizes by n_per_color, not n_images/n_triplets)
    import inspect

    accepted = set(inspect.signature(MAKERS[dataset]).parameters)
    requested = {"n_images": n_images, "n_triplets": n_triplets,
                 "learnable": learnable or None,
                 "n_per_color": n_per_color, "n_queries": n_queries}
    for name, value in requested.items():
        if value is None:
            continue
        if name in accepted:
            kw[name] = value if name != "learnable" else True
        else:
            raise ValueError(
                f"--{name.replace('_', '-')} is not supported by the "
                f"{dataset!r} fixture maker (accepts: {sorted(accepted)})")
    MAKERS[dataset](root, **kw)
    return root
