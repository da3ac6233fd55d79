"""ctypes binding of the native image pipeline (`fastimage.cpp`).

JAX counterpart: `fashionern_aaai2024_tpu/native/image.py`. Built with
`g++` at first use (`native/build.py`): against the system libjpeg where
`g++` finds `<jpeglib.h>`, else with `-DFE_NO_JPEG`, which leaves the
decoder out and keeps the Pillow-exact bicubic resampler native
(`has_decoder()` says which). The native pipeline and PIL's give the
same pixels (the resampler is a bit-exact reimplementation of Pillow's
fixed-point bicubic), so the route is the JAX package's choice:
gray/RGB JPEGs take the native pipeline where the decoder is built,
everything else PIL (`data/transforms.py load_and_preprocess`).

  * `decode_jpeg(data)`: JPEG bytes -> u8 [H, W, 3] (None: undecodable)
  * `resize_bicubic(u8_hwc, out_w, out_h)`: Pillow-exact bicubic resize
  * `decode_preprocess(data, dim, ...)`: the whole pipeline -> f32/u8
    [dim, dim, 3] (None: the caller takes PIL)
  * `extract_crops(data, dim, resize)`: the 13 patch crops
  * `decode_preprocess_batch(items, ...)`: threaded batch -> (batch,
    statuses)
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from fashionern_aaai2024_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD
from fashionern_aaai2024_tpu_torch.native.build import NativeLibrary, header_found

SOURCE = Path(__file__).resolve().with_name("fastimage.cpp")
PAD_MODES = {"none": 0, "target": 1, "square": 2}

# status codes of fastimage.cpp
OK = 0
DECODE_ERROR = 1
UNSUPPORTED_COLOR = 2
GEOMETRY = 3
NO_DECODER = 5

# -march=native is safe: the library is built on (and cached for) the
# host that runs it; the portable set is the fallback. -ffp-contract=off
# keeps the float math FMA-free, so the normalize and the coefficients
# round as the PIL path does.
_NATIVE = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC", "-pthread",
           "-std=c++17")
_PORTABLE = tuple(f for f in _NATIVE if f != "-march=native")

_lock = threading.Lock()
_library: NativeLibrary | None = None


def _bind(lib: ctypes.CDLL) -> None:
    c_int, c_i64, c_ptr, c_dbl = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_double
    int_p = ctypes.POINTER(ctypes.c_int)
    for name, args in (
            ("fe_has_jpeg", []),
            ("fe_jpeg_dims", [c_ptr, c_i64, int_p, int_p]),
            ("fe_decode_jpeg", [c_ptr, c_i64, c_ptr, c_i64, int_p, int_p]),
            ("fe_resize_bicubic_u8", [c_ptr, c_int, c_int, c_int, c_int, c_int, c_ptr]),
            ("fe_decode_preprocess", [c_ptr, c_i64, c_int, c_int, c_dbl, c_ptr, c_ptr, c_int,
                                      c_ptr]),
            ("fe_extract_crops", [c_ptr, c_i64, c_int, c_int, c_ptr, c_ptr, c_ptr])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = c_int, args
    lib.fe_decode_preprocess_batch.restype = None
    lib.fe_decode_preprocess_batch.argtypes = [
        ctypes.POINTER(c_ptr), c_ptr, c_i64, c_int, c_int, c_dbl, c_ptr, c_ptr, c_int, c_ptr,
        c_ptr]


def library() -> NativeLibrary:
    """The library (its `NativeLibrary`); the flag sets are chosen at the first call
    (whether `g++` finds libjpeg's header)."""
    global _library
    with _lock:
        if _library is None:
            extra = ("-ljpeg",) if header_found("jpeglib.h") else ("-DFE_NO_JPEG",)
            _library = NativeLibrary(SOURCE, "libfastimage.so",
                                     [_NATIVE + extra, _PORTABLE + extra], _bind)
        return _library


def _load() -> ctypes.CDLL:
    return library().load()


def has_decoder() -> bool:
    """Whether the native JPEG decoder is built in (libjpeg was found)."""
    return bool(_load().fe_has_jpeg())


def jpeg_route() -> str:
    """The route a gray/RGB JPEG takes: "native" or "pil" (no libjpeg).
    Every other image takes "pil"."""
    return "native" if has_decoder() else "pil"


_MEAN32 = np.asarray(CLIP_MEAN, np.float32)
_STD32 = np.asarray(CLIP_STD, np.float32)


def is_jpeg(data: bytes) -> bool:
    return len(data) > 3 and data[:2] == b"\xff\xd8"


def decode_jpeg(data: bytes) -> np.ndarray | None:
    """JPEG bytes -> u8 [H, W, 3], or None when undecodable, unsupported
    or the decoder is not built in."""
    lib = _load()
    if not is_jpeg(data):
        return None
    buf = np.frombuffer(data, np.uint8)
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    if lib.fe_jpeg_dims(buf.ctypes.data, buf.size, ctypes.byref(w), ctypes.byref(h)) != OK:
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.fe_decode_jpeg(buf.ctypes.data, buf.size, out.ctypes.data, out.size,
                            ctypes.byref(w), ctypes.byref(h))
    return out if rc == OK else None


def resize_bicubic(src: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Pillow-exact bicubic resize of u8 [H, W] or [H, W, C]."""
    lib = _load()
    arr = np.ascontiguousarray(src, np.uint8)
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[:, :, None]
    out = np.empty((out_h, out_w, arr.shape[2]), np.uint8)
    rc = lib.fe_resize_bicubic_u8(arr.ctypes.data, arr.shape[0], arr.shape[1], arr.shape[2],
                                  out_w, out_h, out.ctypes.data)
    if rc != OK:
        raise ValueError(f"resize failed with status {rc}")
    return out[:, :, 0] if squeeze else out


def decode_preprocess(data: bytes, dim: int, pad_mode: str = "target",
                      target_ratio: float = 1.25, normalize: bool = True) -> np.ndarray | None:
    """The whole pipeline for one JPEG; None: the caller takes PIL."""
    lib = _load()
    if not is_jpeg(data):
        return None
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((dim, dim, 3), np.float32 if normalize else np.uint8)
    rc = lib.fe_decode_preprocess(buf.ctypes.data, buf.size, dim, PAD_MODES[pad_mode],
                                  target_ratio, _MEAN32.ctypes.data, _STD32.ctypes.data,
                                  int(normalize), out.ctypes.data)
    return out if rc == OK else None


def extract_crops(data: bytes, dim: int, resize: int = 360) -> np.ndarray | None:
    """One JPEG -> [13, dim, dim, 3] CLIP-normalized crops (the patch
    extraction's geometry: a resize x resize board, its 2 x 2 and 3 x 3
    grids, each crop bicubic to dim x dim). None: the caller takes PIL."""
    lib = _load()
    if not is_jpeg(data):
        return None
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((13, dim, dim, 3), np.float32)
    rc = lib.fe_extract_crops(buf.ctypes.data, buf.size, resize, dim, _MEAN32.ctypes.data,
                              _STD32.ctypes.data, out.ctypes.data)
    return out if rc == OK else None


def decode_preprocess_batch(items: list[bytes], dim: int, pad_mode: str = "target",
                            target_ratio: float = 1.25, normalize: bool = True
                            ) -> tuple[np.ndarray, np.ndarray]:
    """Threaded batch: (batch [N, dim, dim, 3], statuses [N] int64; 0 =
    ok, a nonzero slot is zero-filled and needs the caller's PIL path)."""
    lib = _load()
    n = len(items)
    batch = np.empty((n, dim, dim, 3), np.float32 if normalize else np.uint8)
    statuses = np.full((n,), DECODE_ERROR, np.int64)
    if n == 0:
        return batch, statuses
    bufs = [np.frombuffer(b, np.uint8) if is_jpeg(b) else None for b in items]
    ptrs = (ctypes.c_void_p * n)()
    lens = np.zeros((n,), np.int64)
    zero = np.zeros((1,), np.uint8)  # a non-JPEG item: 0 bytes -> a decode error
    for i, b in enumerate(bufs):
        ptrs[i] = (b if b is not None else zero).ctypes.data
        lens[i] = 0 if b is None else b.size
    lib.fe_decode_preprocess_batch(ptrs, lens.ctypes.data, n, dim, PAD_MODES[pad_mode],
                                   target_ratio, _MEAN32.ctypes.data, _STD32.ctypes.data,
                                   int(normalize), batch.ctypes.data, statuses.ctypes.data)
    return batch, statuses
