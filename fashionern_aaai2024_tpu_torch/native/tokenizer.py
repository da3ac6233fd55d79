"""ctypes binding of the native CLIP BPE tokenizer core (`fasttokenizer.cpp`).

JAX counterpart: `fashionern_aaai2024_tpu/native/tokenizer.py`. The C
core encodes printable-ASCII texts (every caption of the four
benchmarks) exactly as `models/clip/tokenizer.py SimpleTokenizer.encode`
does and flags every other text (HTML entities, non-ASCII bytes,
special-token literals); `SimpleTokenizer` re-encodes the flagged rows
in Python, so the ids are always the Python path's.

Build: `g++` at first use (`native/build.py`). Where the JAX binding
quietly stays in Python when the build fails, this one raises with the
compiler's output: the port has one tokenizer path.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from fashionern_aaai2024_tpu_torch.native.build import NativeLibrary

SOURCE = Path(__file__).resolve().with_name("fasttokenizer.cpp")
FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
FT_OK = 0


def _bind(lib: ctypes.CDLL) -> None:
    lib.ft_create.restype = ctypes.c_void_p
    lib.ft_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.ft_destroy.argtypes = [ctypes.c_void_p]
    for name in ("ft_sot", "ft_eot"):
        getattr(lib, name).restype = ctypes.c_int32
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.ft_encode_batch.restype = None
    lib.ft_encode_batch.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
                                    ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
                                    ctypes.c_void_p]


LIBRARY = NativeLibrary(SOURCE, "libfasttokenizer.so", [FLAGS], _bind)


def load() -> ctypes.CDLL:
    """The built core (built at the first call of the process)."""
    return LIBRARY.load()


class NativeBPE:
    """A handle on the C core for one merges table.

    `encode_batch(texts, context_length)` -> (ids int32 [B, L], fallback
    bool [B]): rows flagged True must be encoded by the Python path."""

    def __init__(self, merges):
        self._lib = load()
        blob = "\n".join(f"{a} {b}" for a, b in merges).encode("utf-8")
        self._h = self._lib.ft_create(blob, len(blob))

    def __del__(self):
        h, lib = getattr(self, "_h", None), getattr(self, "_lib", None)
        if h and lib is not None:
            lib.ft_destroy(h)

    @property
    def sot_token(self) -> int:
        return int(self._lib.ft_sot(self._h))

    @property
    def eot_token(self) -> int:
        return int(self._lib.ft_eot(self._h))

    def encode_batch(self, texts, context_length: int) -> tuple[np.ndarray, np.ndarray]:
        encoded = [t.encode("utf-8") for t in texts]
        offsets = np.zeros(len(texts) + 1, np.int64)
        np.cumsum([len(e) for e in encoded], out=offsets[1:])
        out = np.zeros((len(texts), context_length), np.int32)
        rc = np.zeros(len(texts), np.int8)
        self._lib.ft_encode_batch(self._h, b"".join(encoded), offsets.ctypes.data, len(texts),
                                  out.ctypes.data, context_length, rc.ctypes.data)
        return out, rc != FT_OK
