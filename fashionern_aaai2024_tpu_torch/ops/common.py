"""The port's kernel library: build at first use, bind, launch, check.

JAX counterpart: `fashionern_aaai2024_tpu/ops/common.py`, which chose
between a Pallas kernel and its XLA formula by backend. Here the choice
is made by the tensor: a CPU tensor takes the plain PyTorch version, a
CUDA tensor launches the hand-written kernel or raises. Nothing falls
back, and no environment variable changes the choice.

The CUDA sources live in `fashionern_aaai2024_tpu_torch/csrc/`. At the
first launch they are compiled with `nvcc` for `sm_90a` into one shared
library with a plain C interface, under `build/torch_kernels/<hash>/`
at the root of the checkout, keyed by a hash of the sources and flags,
and loaded with `ctypes`. Every C entry point launches on the caller's
stream and returns the `cudaError_t` of the launch; `launch` raises on
anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE / "csrc"
BUILD_ROOT = _PACKAGE.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC",
)
_LIB_NAME = "libfern_kernels.so"

# The C interface: name -> argument types. Pointers and the stream are
# c_void_p (a bare int would be cut to 32 bits); every function returns
# the cudaError_t of its launch as an int.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, gamma, beta, y, rows, width, eps, dtype, device, stream
    "fern_layernorm": (_P, _P, _P, _P, _I, _I, _F, _I, _I, _P),
    # a, bt, bias, res, c, m, n, k, act, dtype, device, stream
    "fern_gemm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # qkv, out, batch, seq, heads, causal, scale, dtype, device, stream
    "fern_attention": (_P, _P, _I, _I, _I, _I, _F, _I, _I, _P),
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ACT_CODES = {None: 0, "quick_gelu": 1, "gelu": 2}


def _sources(csrc_dir: Path) -> list[Path]:
    return sorted(p for p in csrc_dir.iterdir() if p.suffix in (".cu", ".cuh"))


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found (not on PATH, not at /usr/local/cuda/bin/nvcc): "
        "the port's CUDA kernels cannot be built")


class KernelLibrary:
    """Compiles `csrc/*.cu` once per source hash and binds the C API.

    `load()` is idempotent; `build_seconds` is the compile time of the
    build this process ran (0.0 when the library was already built)."""

    def __init__(self, csrc_dir: Path = CSRC_DIR, build_root: Path = BUILD_ROOT):
        self.csrc_dir = csrc_dir
        self.build_root = build_root
        self.build_seconds = 0.0
        self._lib: ctypes.CDLL | None = None

    def source_hash(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in _sources(self.csrc_dir):
            h.update(path.name.encode())
            h.update(path.read_bytes())
        return h.hexdigest()[:16]

    def library_path(self) -> Path:
        return self.build_root / self.source_hash() / _LIB_NAME

    def _build(self, target: Path) -> None:
        nvcc = _find_nvcc()
        target.parent.mkdir(parents=True, exist_ok=True)
        cu = [str(p) for p in _sources(self.csrc_dir) if p.suffix == ".cu"]
        # build beside the target, then rename: a concurrent loader never
        # sees a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(self.csrc_dir), "-o", tmp, *cu]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        self.build_seconds = time.perf_counter() - t0
        os.replace(tmp, target)

    def load(self) -> ctypes.CDLL:
        if self._lib is not None:
            return self._lib
        path = self.library_path()
        if not path.is_file():
            self._build(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self._lib = lib
        return lib


LIBRARY = KernelLibrary()


def launch(name: str, *args) -> None:
    """Call one C entry point of the library and raise on a CUDA error."""
    err = getattr(LIBRARY.load(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda_operands(name: str, *tensors: torch.Tensor) -> None:
    """Every operand on one CUDA device, contiguous, in a dtype the
    kernels take (fp32 or bf16), all of one dtype."""
    first = tensors[0]
    if first.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {first.dtype} not supported "
                        "(the kernels take float32 or bfloat16)")
    for t in tensors:
        if t.device != first.device:
            raise ValueError(f"{name}: operands on {t.device} and {first.device}")
        if t.dtype != first.dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {first.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} "
                             "is not contiguous")


def is_cuda(t: torch.Tensor) -> bool:
    """Dispatch rule of every op in the port: CUDA tensors launch the
    kernel, CPU tensors take the plain version, anything else raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics, output in
    x.dtype — `ops/layernorm.py:37 _layer_norm_ref`. Plain PyTorch: the
    towers' ln_pre / ln_post / ln_final and the BERT LNs ran on XLA on
    the TPU, as here."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype)


def launch_layer_norm(x2: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      eps: float) -> torch.Tensor:
    """LN kernel on a contiguous [rows, W] CUDA tensor (a piece of B1/B2)."""
    rows, width = x2.shape
    y = torch.empty_like(x2)
    launch("fern_layernorm", x2.data_ptr(), weight.data_ptr(), bias.data_ptr(),
           y.data_ptr(), rows, width, eps, DTYPE_CODES[x2.dtype],
           x2.device.index, stream_of(x2))
    return y


def launch_gemm(a: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                residual: torch.Tensor | None = None,
                activation: str | None = None) -> torch.Tensor:
    """GEMM kernel: [res +] cast(act(a @ weight.T + bias)).

    a [M, K]; weight [N, K] (torch Linear layout); bias [N]; residual
    [M, N]. K and N must be multiples of 8 (16-byte vector loads and
    stores)."""
    m, k = a.shape
    n = weight.shape[0]
    if weight.shape[1] != k:
        raise ValueError(f"gemm: a {tuple(a.shape)} vs weight {tuple(weight.shape)}")
    if k % 8 or n % 8:
        raise ValueError(f"gemm: K={k} and N={n} must be multiples of 8")
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"gemm: bias {tuple(bias.shape)} for N={n}")
    if residual is not None and residual.shape != (m, n):
        raise ValueError(f"gemm: residual {tuple(residual.shape)} for ({m}, {n})")
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    launch("fern_gemm", a.data_ptr(), weight.data_ptr(),
           None if bias is None else bias.data_ptr(),
           None if residual is None else residual.data_ptr(),
           c.data_ptr(), m, n, k, ACT_CODES[activation], DTYPE_CODES[a.dtype],
           a.device.index, stream_of(a))
    return c
