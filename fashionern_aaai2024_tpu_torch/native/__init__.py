"""Host-side native code of the port, and the data-loader core.

JAX counterpart: `fashionern_aaai2024_tpu/native/__init__.py`
(`:93-132`). `fastloader.cpp` is built with `g++` at its first use
(`native/build.py`) and bound through ctypes:

  * `gather_rows(pack, indices)`: [K, ...] rows of a float32 pack as one
    contiguous batch (the patch pack's batch gather);
  * `normalize_images(u8_nhwc)`: the fused CLIP uint8 -> float32
    normalize, x * (1 / (255 std)) + (-mean / std), whose rounding the
    image pipeline's float feed and the device-side uint8 normalize
    (`data/transforms.py normalize_on_device`) share.

Inputs that the JAX binding hands to numpy (a pack that is not C-ordered
float32, a non-uint8 image) go to the same numpy expressions here; where
the JAX binding falls back to numpy because the build failed, this one
raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from fashionern_aaai2024_tpu_torch.native.build import NativeLibrary


def _bind(lib: ctypes.CDLL) -> None:
    lib.gather_rows_f32.restype = ctypes.c_int
    lib.gather_rows_f32.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.normalize_u8_to_f32.restype = None
    lib.normalize_u8_to_f32.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_void_p]


LIBRARY = NativeLibrary(Path(__file__).resolve().with_name("fastloader.cpp"),
                        "libfastloader.so",
                        [("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")], _bind)


def gather_rows(pack: np.ndarray, indices) -> np.ndarray:
    """pack[indices] as one contiguous float32 batch; pack: [N, ...]
    float32, C-ordered (e.g. the patch pack's memory map)."""
    idx = np.ascontiguousarray(np.asarray(indices, np.int64))
    if pack.dtype != np.float32 or not pack.flags["C_CONTIGUOUS"]:
        return np.ascontiguousarray(pack[idx])
    lib = LIBRARY.load()
    row_elems = int(np.prod(pack.shape[1:], dtype=np.int64))
    out = np.empty((idx.shape[0],) + pack.shape[1:], np.float32)
    rc = lib.gather_rows_f32(pack.ctypes.data, pack.shape[0], row_elems, idx.ctypes.data,
                             idx.shape[0], out.ctypes.data)
    if rc != 0:
        raise IndexError(f"gather_rows: index out of range for pack with {pack.shape[0]} rows")
    return out


def normalize_images(u8_nhwc: np.ndarray) -> np.ndarray:
    """CLIP normalization of uint8 NHWC images (any leading shape, a
    trailing channel axis of 3) -> float32. (The constants are imported
    here: the native tokenizer's package must not import `data/`, which a
    serving host of an artifact does without.)"""
    from fashionern_aaai2024_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD

    _MEAN32 = np.asarray(CLIP_MEAN, np.float32)
    _STD32 = np.asarray(CLIP_STD, np.float32)
    arr = np.ascontiguousarray(u8_nhwc)
    if arr.shape[-1] != 3:
        raise ValueError(f"expected trailing channel axis of 3, got {arr.shape}")
    if arr.dtype != np.uint8:
        return ((arr.astype(np.float32) / 255.0) - _MEAN32) / _STD32
    out = np.empty(arr.shape, np.float32)
    LIBRARY.load().normalize_u8_to_f32(arr.ctypes.data, arr.size // 3, _MEAN32.ctypes.data,
                                       _STD32.ctypes.data, out.ctypes.data)
    return out
