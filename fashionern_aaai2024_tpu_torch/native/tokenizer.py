"""ctypes binding of the native CLIP BPE tokenizer core (`fasttokenizer.cpp`).

JAX counterpart: `fashionern_aaai2024_tpu/native/tokenizer.py`. The C
core encodes printable-ASCII texts (every caption of the four
benchmarks) exactly as `models/clip/tokenizer.py SimpleTokenizer.encode`
does and flags every other text (HTML entities, non-ASCII bytes,
special-token literals); `SimpleTokenizer` re-encodes the flagged rows
in Python, so the ids are always the Python path's.

Build: `g++` at first use into `build/native/<hash>/` at the root of the
checkout, keyed by a hash of the source and the flags. Where the JAX
binding quietly stays in Python when the build fails, this one raises
with the compiler's output: the port has one tokenizer path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("fasttokenizer.cpp")
BUILD_ROOT = SOURCE.parent.parent.parent / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
_LIB_NAME = "libfasttokenizer.so"
FT_OK = 0

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / _LIB_NAME


def _build(target: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native tokenizer cannot be built")
    target.parent.mkdir(parents=True, exist_ok=True)
    # build beside the target, then rename: a concurrent loader never sees
    # a half-written library
    fd, tmp = tempfile.mkstemp(dir=target.parent, suffix=".so")
    os.close(fd)
    try:
        done = subprocess.run([cxx, *FLAGS, str(SOURCE), "-o", tmp], capture_output=True,
                              text=True)
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed ({done.returncode}) building {SOURCE}:\n"
                               f"{done.stdout}\n{done.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> ctypes.CDLL:
    """The built core (built at the first call of the process)."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.is_file():
                _build(path)
            lib = ctypes.CDLL(str(path))
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
            _lib = lib
        return _lib


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
