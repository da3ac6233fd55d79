"""Build and load the port's host-side C++ libraries.

Each library is one source file, compiled with `g++` at its first load
into `build/native/<hash>/` at the root of the checkout, keyed by a hash
of the source, the files it includes (`includes`) and the flags, so an
edit or another flag set builds anew and a later process loads the
cached file. Where the JAX package's
bindings quietly stay in Python when a build fails, these raise with the
compiler's output: the port has one path for each of them.
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
from typing import Callable, Sequence

BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "native"


def _cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the port's native libraries cannot be built")
    return cxx


def header_found(header: str) -> bool:
    """Whether `g++` finds `#include <header>` (a preprocessor run)."""
    done = subprocess.run([_cxx(), "-E", "-x", "c++", "-", "-o", os.devnull],
                          input=f"#include <{header}>\n", capture_output=True, text=True)
    return done.returncode == 0


class NativeLibrary:
    """One source, built with the first of `flag_sets` that compiles
    (later sets are fallbacks, e.g. without `-march=native`), loaded once
    a process; `bind(lib)` declares the entry points' signatures;
    `includes` are the sources that `source` includes."""

    def __init__(self, source: Path, name: str, flag_sets: Sequence[Sequence[str]],
                 bind: Callable[[ctypes.CDLL], None], includes: Sequence[Path] = ()):
        self.source = source
        self.includes = tuple(includes)
        self.name = name
        self.flag_sets = [tuple(f) for f in flag_sets]
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self.flags: tuple[str, ...] | None = None

    def library_path(self, flags: Sequence[str]) -> Path:
        h = hashlib.sha256(" ".join(flags).encode())
        for path in (self.source, *self.includes):
            h.update(path.read_bytes())
        return BUILD_ROOT / h.hexdigest()[:16] / self.name

    def _build(self, target: Path, flags: Sequence[str]) -> str | None:
        """Compile into `target`; the compiler's output when it fails."""
        target.parent.mkdir(parents=True, exist_ok=True)
        # build beside the target, then rename: a concurrent loader never
        # sees a half-written library
        fd, tmp = tempfile.mkstemp(dir=target.parent, suffix=".so")
        os.close(fd)
        try:
            compile_flags = [f for f in flags if not f.startswith("-l")]
            libs = [f for f in flags if f.startswith("-l")]
            done = subprocess.run([_cxx(), *compile_flags, str(self.source), "-o", tmp, *libs],
                                  capture_output=True, text=True)
            if done.returncode != 0:
                return f"g++ failed ({done.returncode}):\n{done.stdout}\n{done.stderr}"
            os.replace(tmp, target)
            return None
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def load(self) -> ctypes.CDLL:
        """The built library (built at the first call of the process)."""
        with self._lock:
            if self._lib is None:
                errors = []
                for flags in self.flag_sets:
                    path = self.library_path(flags)
                    if not path.is_file():
                        err = self._build(path, flags)
                        if err is not None:
                            errors.append(f"{' '.join(flags)}: {err}")
                            continue
                    lib = ctypes.CDLL(str(path))
                    self._bind(lib)
                    self._lib, self.flags = lib, flags
                    break
                else:
                    raise RuntimeError(f"building {self.source} failed:\n" + "\n".join(errors))
            return self._lib
