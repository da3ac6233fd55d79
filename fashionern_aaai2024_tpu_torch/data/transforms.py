"""Image preprocessing: pad -> bicubic resize -> center crop -> normalize.

JAX counterpart: `fashionern_aaai2024_tpu/data/transforms.py`; the same
pixels for the same file, bit for bit. The host geometry is the
reference's (`dataloader/dataset.py:9-87`): `TargetPad` pads only when
the aspect ratio exceeds the target (default 1.25), `SquarePad` always
pads to square; both then resize the shorter side bicubic and center-crop.
The output is NHWC, CLIP-normalized float32 (or the raw uint8 pixels,
which the model normalizes on the device).

PIL is imported inside the functions that use it, so that the port
imports on a machine without Pillow; decoding an image that the native
pipeline does not take (every non-JPEG, and every JPEG where libjpeg is
missing) needs it.

`ROUTES` counts the images `load_and_preprocess` sent down each route
("native", "pil") in this process.
"""

from __future__ import annotations

import io
from collections import Counter

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

ROUTES: Counter = Counter()


def _pad_to(image, hp: int, vp: int):
    from PIL import Image

    if hp == 0 and vp == 0:
        return image
    w, h = image.size
    out = Image.new(image.mode, (w + 2 * hp, h + 2 * vp), 0)
    out.paste(image, (hp, vp))
    return out


def square_pad(image):
    """Zero-pad to square (`dataset.py:9-28`)."""
    w, h = image.size
    max_wh = max(w, h)
    return _pad_to(image, int((max_wh - w) / 2), int((max_wh - h) / 2))


def target_pad(image, target_ratio: float = 1.25):
    """Pad only if the aspect ratio exceeds `target_ratio` (`dataset.py:31-54`)."""
    w, h = image.size
    actual = max(w, h) / min(w, h)
    if actual < target_ratio:
        return image
    scaled_max_wh = max(w, h) / target_ratio
    hp = max(int((scaled_max_wh - w) / 2), 0)
    vp = max(int((scaled_max_wh - h) / 2), 0)
    return _pad_to(image, hp, vp)


def _resize_shorter(image, size: int):
    """torchvision `Resize(size)`: shorter side -> size, aspect kept."""
    from PIL import Image

    w, h = image.size
    if w <= h:
        new_w, new_h = size, max(1, round(h * size / w))
    else:
        new_w, new_h = max(1, round(w * size / h)), size
    return image.resize((new_w, new_h), Image.BICUBIC)


def _center_crop(image, size: int):
    from PIL import Image

    w, h = image.size
    if w < size or h < size:  # torchvision pads when smaller
        out = Image.new("RGB", (max(w, size), max(h, size)), 0)
        out.paste(image.convert("RGB"), ((out.width - w) // 2, (out.height - h) // 2))
        image, (w, h) = out, out.size
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    return image.crop((left, top, left + size, top + size))


def preprocess_image(image, dim: int, pad_mode: str = "target", target_ratio: float = 1.25,
                     normalize: bool = True, as_uint8: bool = False) -> np.ndarray:
    """A PIL image -> float32 [dim, dim, 3] (NHWC). `as_uint8=True`
    returns the raw u8 pixels (the low-bandwidth feed); `normalize=False`
    float32 in [0, 1]."""
    if pad_mode == "target":
        image = target_pad(image, target_ratio)
    elif pad_mode == "square":
        image = square_pad(image)
    elif pad_mode != "none":
        raise ValueError(f"unknown pad_mode {pad_mode!r}")
    image = _resize_shorter(image, dim)
    image = _center_crop(image, dim)
    u8 = np.asarray(image.convert("RGB"), np.uint8)
    if as_uint8:
        return u8
    if normalize:
        from fashionern_aaai2024_tpu_torch import native

        return native.normalize_images(u8)
    return u8.astype(np.float32) / 255.0


def load_and_preprocess(path: str, dim: int, pad_mode: str = "target",
                        target_ratio: float = 1.25, normalize: bool = True,
                        rgb_first: bool = False, as_uint8: bool = False) -> np.ndarray:
    """Decode and preprocess a file -> float32 [dim, dim, 3] (u8 with
    `as_uint8`).

    Gray/RGB JPEGs take the native pipeline (`native/fastimage.cpp`:
    libjpeg decode, Pillow-exact fixed-point bicubic, fused pad / crop /
    normalize) where its decoder is built; everything else (PNG, CMYK
    JPEG, a corrupt tail, no libjpeg) the PIL pipeline above. The two give
    the same pixels. `rgb_first` converts to RGB before the geometry on
    the PIL route (Fashion200k's reference order,
    `fashion200k_patch.py:116`); for the modes the native route takes,
    converting first or last gives the same pixels."""
    with open(path, "rb") as f:
        data = f.read()
    from fashionern_aaai2024_tpu_torch.native import image as native_image

    if native_image.is_jpeg(data) and native_image.has_decoder():
        out = native_image.decode_preprocess(data, dim, pad_mode, target_ratio,
                                             normalize and not as_uint8)
        if out is not None:
            ROUTES["native"] += 1
            if out.dtype == np.uint8 and not as_uint8:
                return out.astype(np.float32) / 255.0  # normalize=False: [0, 1]
            return out
    from PIL import Image

    ROUTES["pil"] += 1
    with Image.open(io.BytesIO(data)) as img:
        if rgb_first:
            img = img.convert("RGB")
        return preprocess_image(img, dim, pad_mode, target_ratio, normalize, as_uint8)


def targetpad_transform(target_ratio: float = 1.25, dim: int = 288):
    """The reference's `targetpad_transform` (`dataset.py:73-87`)."""
    return lambda img: preprocess_image(img, dim, "target", target_ratio)


def squarepad_transform(dim: int = 288):
    """The reference's `squarepad_transform` (`dataset.py:57-70`)."""
    return lambda img: preprocess_image(img, dim, "square")


def normalize_on_device(images, device):
    """CLIP normalization of [B, H, W, 3] images on `device`: uint8 pixels
    as the host feed rounds them (x * (1 / (255 std)) + (-mean / std),
    `native.normalize_images`), float images in [0, 1] as (x - mean) / std
    (`transforms.py:164`). Returns float32."""
    import torch

    images = torch.as_tensor(images).to(device)
    if images.dtype == torch.uint8:
        scale = torch.from_numpy(1.0 / (255.0 * CLIP_STD)).to(device)
        shift = torch.from_numpy(-CLIP_MEAN / CLIP_STD).to(device)
        return images.float() * scale + shift
    mean = torch.from_numpy(CLIP_MEAN).to(device)
    std = torch.from_numpy(CLIP_STD).to(device)
    return (images.float() - mean) / std
