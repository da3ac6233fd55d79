"""The port's kernel library: build at first use, bind, launch, check.

JAX counterpart: `fashionern_aaai2024_tpu/ops/common.py`, which chose
between a Pallas kernel and its XLA formula by backend. Here the choice
is made by the tensor: a CPU tensor takes the plain PyTorch version, a
CUDA tensor launches the hand-written kernel or raises. Nothing falls
back, and no environment variable changes the choice.

The CUDA sources live in `fashionern_aaai2024_tpu_torch/csrc/`. At the
first launch each `.cu` file is compiled with `nvcc` for `sm_90a`, all
of them at once in parallel processes, and the objects are linked into
one shared library with a plain C interface, under
`build/torch_kernels/<hash>/` at the root of the checkout, keyed by a
hash of the sources and flags, and loaded with `ctypes`. Every C entry point launches on the caller's
stream and returns the `cudaError_t` of the launch; `launch` raises on
anything but 0.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE / "csrc"
BUILD_ROOT = _PACKAGE.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-Xcompiler", "-fPIC",
)
_LIB_NAME = "libfern_kernels.so"

# The C interface: name -> argument types. Pointers and the stream are
# c_void_p (a bare int would be cut to 32 bits); every function returns
# the cudaError_t of its launch as an int.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, gamma, beta, y, rows, width, eps, dtype, device, stream
    "fern_layernorm": (_P, _P, _P, _P, _I, _I, _F, _I, _I, _P),
    # a, bt, bias, res, c, m, n, k, ldc, act, dtype, tile, device, stream
    "fern_gemm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # q, k, v, bias, out, batch, sq, sk, heads, head_dim, q_ld, kv_ld, causal,
    # scale, dtype, out_dtype, images_per_block, device, stream
    "fern_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I,
                       _I, _P),
    # q, k, v, out, batch, sq, sk, heads, head_dim, q_ld, kv_ld, scale, dtype,
    # device, stream
    "fern_attention_wide": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P),
    # q, k, v, bias, out, batch, sq, sk, heads, head_dim, q_ld, kv_ld, group,
    # split_rows, scale, dtype, device, stream
    "fern_attention_grouped": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                               _I, _I, _P),
    # a0, b0, bias0, a1, b1, bias1, res, c, problems, m, n, k, ldc, act,
    # k_per, tile, fold, device, stream
    "fern_gemm_tf32": (*(_P,) * 8, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # h, hp, splits, bh, wo, bo, text, image, out, m, d, hd, dtype, device, stream
    "fern_combiner_gate": (_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, gamma, beta, q, scale, rows, width, eps, dtype, device, stream
    "fern_ln_quant": (_P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _P),
    # x, q, scale, rows, width, groups, device, stream
    "fern_quant_groups": (_P, _P, _P, _I, _I, _I, _I, _P),
    # a, bt, a_scale, a_scale_stride, b_scale, bias, res, c, m, n, k, groups,
    # act, dtype, out_f32, tile, device, stream
    "fern_qgemm": (_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # pred, tar, row, part_m, part_l, diag, B, d, temp, splits,
    # tiles_per_split, N, offset, device, stream
    "fern_bbc_rowloss": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _I, _I, _P),
    # x, ln1_w, ln1_b, in_w, in_b, out_w, out_b, ln2_w, ln2_b, fc_w, fc_b,
    # proj_w, proj_b, workspace, barrier, out, batch, seq, width, ffn, heads,
    # causal, scale, eps, act, dtype, device, stream
    "fern_block": (*(_P,) * 16, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _I, _P),
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ACT_CODES = {None: 0, "quick_gelu": 1, "gelu": 2, "relu": 3}


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


def _run_all(cmds: list[list[str]]) -> None:
    """Start every command at once, wait for all, raise on any failure."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs = [p.communicate() for p in procs]
    failed = [(cmd, p.returncode, out, err)
              for cmd, p, (out, err) in zip(cmds, procs, outs) if p.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}\n{err}"
                                     for cmd, rc, out, err in failed))


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
        cu = [p for p in _sources(self.csrc_dir) if p.suffix == ".cu"]
        # build beside the target, then rename: a concurrent loader never
        # sees a half-written library
        work = Path(tempfile.mkdtemp(dir=target.parent))
        t0 = time.perf_counter()
        try:
            objs = [work / f"{p.stem}.o" for p in cu]
            _run_all([[nvcc, *NVCC_FLAGS, "-I", str(self.csrc_dir), "-c", "-o", str(o),
                       str(p)] for p, o in zip(cu, objs)])
            lib = work / _LIB_NAME
            _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *map(str, objs)]])
            os.replace(lib, target)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        self.build_seconds = time.perf_counter() - t0

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

# name -> the library's C entry point with its argtypes, bound once by
# the first launch of the process (`_bind`): a launch is a dict lookup
# and the ctypes call, with no `LIBRARY.load()` or CDLL lookup.
_ENTRY: dict[str, ctypes._CFuncPtr] = {}


def _bind() -> dict[str, ctypes._CFuncPtr]:
    lib = LIBRARY.load()
    _ENTRY.update((name, getattr(lib, name)) for name in _SIGNATURES)
    return _ENTRY


def launch(name: str, *args) -> None:
    """Call one C entry point of the library and raise on a CUDA error."""
    err = (_ENTRY or _bind())[name](*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    record = getattr(_RECORD, "log", None)
    if record is not None:
        record.entries[name] += 1


# what this thread launches while it records (`recording`): the capture
# of a CUDA graph (`ops/graphs.py`)
_RECORD = threading.local()


class Record:
    """The launches one thread made while it recorded: C entry point ->
    calls (`entries`), kernel wrapper -> counted calls (`wrappers`)."""

    def __init__(self):
        self.entries: collections.Counter = collections.Counter()
        self.wrappers: collections.Counter = collections.Counter()


@contextlib.contextmanager
def recording():
    """Record this thread's launches until the context ends. Launches of
    other threads are not recorded."""
    record = Record()
    _RECORD.log = record
    try:
        yield record
    finally:
        _RECORD.log = None


def count(wrapper) -> None:
    """A kernel wrapper launched its kernels: add one to its `launches`
    (each wrapper calls this once, where it launches), and record the
    call on a recording thread."""
    wrapper.launches += 1
    record = getattr(_RECORD, "log", None)
    if record is not None:
        record.wrappers[wrapper] += 1


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current stream of t's CUDA device, read
    without building a `torch.cuda.Stream`."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


@functools.lru_cache(maxsize=None)
def sm_count(device: int) -> int:
    """Streaming multiprocessors of a CUDA device, read once."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_no_grad(name: str, *tensors: torch.Tensor | None) -> None:
    """Raise when grad mode is on and an operand requires grad.

    A kernel launched through `ctypes` writes into a tensor that autograd
    never sees: its result has no `grad_fn`, and a gradient would be
    dropped without a word. The launches themselves are forward-only, so
    every launch path runs this check (most through
    `check_cuda_operands`).

    Entries that differentiate take a `torch.autograd.Function` whose
    forward is the launch (grad mode off inside it, so the check passes)
    and whose backward is autograd of the plain version (`plain_vjp`), as
    the JAX package's custom VJPs differentiate their XLA twins: B1
    `attention_subblock`, B2 `mlp_subblock`, B3
    `packed_qkv_self_attention`, B7 `fused_qkv_self_attention`, B8
    `packed_kv_cross_attention` (both routes), B9 `multi_head_attention`,
    B10 `transformer_block`, B11 `layer_norm` and B4 through
    `ops/losses.py BBCMeanLoss`. These still refuse an operand that
    requires grad, because the JAX package gives them no VJP either: B5
    and B6 (the int8 tier, `int8_mlp_subblock`,
    `int8_attention_subblock`), the row-level B4 `bbc_rowloss`, B12
    `combiner_apply` and X1-X4 (`ops/attn_experiment.py`). Run those
    under `torch.no_grad()`, as the frozen towers and the eval
    combiners do."""
    if not torch.is_grad_enabled():
        return
    for t in tensors:
        if t is not None and t.requires_grad:
            _raise_requires_grad(name, t)


def _raise_requires_grad(name: str, t: torch.Tensor) -> None:
    raise RuntimeError(
        f"{name}: an operand of shape {tuple(t.shape)} requires grad, but the "
        "CUDA kernel has no backward; run it under torch.no_grad() or "
        "detach the operand")


def wants_grad(*tensors: torch.Tensor | None) -> bool:
    """Autograd has to reach one of `tensors`: grad mode is on and one of
    them requires grad. A differentiable kernel entry then launches
    through its autograd Function; otherwise it launches straight away."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in tensors)


def plain_vjp(ctx, g: torch.Tensor, plain) -> tuple:
    """The backward of a kernel's autograd Function: autograd of the
    kernel's plain version, recomputed from the inputs the forward saved,
    as the JAX package's `_*_diff_bwd` take `jax.vjp` of a kernel's XLA
    twin. `plain` maps the saved tensors (in `save_for_backward`'s order,
    which must be the order of the Function's first inputs) to the
    output. Returns one gradient per input of the Function: None where
    `ctx.needs_input_grad` is false, for a None input and for every
    input past the saved tensors (the non-tensor arguments)."""
    saved = [None if t is None else t.detach().requires_grad_(need)
             for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    wanted = [t for t in saved if t is not None and t.requires_grad]
    with torch.enable_grad():
        out = plain(*saved)
    grads = iter(torch.autograd.grad(out, wanted, g))
    return (*(next(grads) if t is not None and t.requires_grad else None for t in saved),
            *(None,) * (len(ctx.needs_input_grad) - len(saved)))


def check_int8_operands(name: str, device: torch.device, *pairs: torch.Tensor) -> None:
    """int8 weights and their fp32 scales, given as (values, scales)
    pairs: on `device`, contiguous, of those two dtypes."""
    check_no_grad(name, *pairs)
    for i, t in enumerate(pairs):
        want = torch.int8 if i % 2 == 0 else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name}: operand {i} is {t.dtype}, expected {want}")
        if t.device != device:
            raise ValueError(f"{name}: operands on {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} is not contiguous")


def check_cuda_operands(name: str, *tensors: torch.Tensor) -> int:
    """Every operand on one CUDA device, contiguous, in a dtype the
    kernels take (fp32 or bf16), all of one dtype, and none that needs
    a gradient (`check_no_grad`): one pass over cheap attributes.
    Returns the device index."""
    first = tensors[0]
    dtype, device = first.dtype, first.get_device()
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} not supported "
                        "(the kernels take float32 or bfloat16)")
    grad = torch.is_grad_enabled()
    for t in tensors:
        if grad and t.requires_grad:
            _raise_requires_grad(name, t)
        if t.get_device() != device:
            raise ValueError(f"{name}: operands on {t.device} and {first.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} "
                             "is not contiguous")
    return device


def is_cuda(t: torch.Tensor) -> bool:
    """Dispatch rule of every op in the port: CUDA tensors launch the
    kernel, CPU tensors take the plain version, anything else raises."""
    if t.is_cuda:
        return True
    if t.is_cpu:
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def launch_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      eps: float) -> torch.Tensor:
    """LN kernel over the rows of a contiguous [..., W] CUDA tensor
    (kernel B11, and a piece of B1/B2), as one flat [rows, W] buffer: no
    view is taken. Its callers have passed `check_cuda_operands`."""
    width = x.shape[-1]
    y = torch.empty_like(x)
    launch("fern_layernorm", x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
           y.data_ptr(), x.numel() // width if width else 0, width, eps,
           DTYPE_CODES[x.dtype], x.get_device(), stream_of(x))
    return y


def launch_gemm(a: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                residual: torch.Tensor | None = None, activation: str | None = None,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """GEMM kernel: [res +] cast(act(a @ weight.T + bias)).

    a [M, K]; weight [N, K] (torch Linear layout); bias [N]; residual
    [M, N]. bf16 runs `csrc/gemm.cu` (bf16 warpgroup MMA), fp32
    `csrc/gemm_tf32.cu` (3xTF32 warpgroup MMA, fp32 accuracy), both fed
    by TMA. K and N must be multiples of 8 (16-byte vector stores, and
    TMA's 16-byte row strides), and `a` and `weight` must start on a
    16-byte boundary (TMA's rule for a base address). `out`: an [M, N]
    view with unit column stride and a row stride that is a multiple of
    8, 16-byte aligned (a column slice of a wider buffer, as kernel B12's
    concat halves), written in place of a new tensor. Its callers have
    passed `check_cuda_operands`."""
    return _gemm(a, weight, bias, residual, activation, out, tile=0)


# The fp32 GEMM's tile widths (csrc/gemm_tf32.cu), each with the time of
# its 128-row tile against a 128-wide one's: a K tile's wgmmas and split
# of B shrink with the width, its A split and ring step do not (read by
# `ab_attention.py` on an H100 at 77-6,304 rows: 64 wide 0.59-0.64, 32
# wide 0.41-0.48 a wave).
_F32_TILE_ROWS, _F32_K_TILE = 128, 32
_F32_TILES = ((128, 1.0), (64, 0.6), (32, 0.45))


@functools.lru_cache(maxsize=4096)
def f32_tile(m: int, n: int, sms: int) -> int:
    """Output tile width of the fp32 GEMM [m, k] x [n, k]^T on a card of
    `sms` SMs (one block an SM): the width whose waves of tiles, each at
    its relative cost (`_F32_TILES`), take least time, the wider on a tie.
    Small M fills more SMs with narrow tiles (B7's b = 1: 91 rows, 60
    blocks 32 wide against 15 blocks 128 wide); large M keeps 128."""
    rows = -(-m // _F32_TILE_ROWS)

    def waves_time(tile: tuple[int, float]) -> float:
        bn, cost = tile
        return -(-(rows * -(-n // bn)) // sms) * cost

    return min(_F32_TILES, key=waves_time)[0]


def _gemm(a: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
          residual: torch.Tensor | None, activation: str | None, out: torch.Tensor | None,
          tile: int) -> torch.Tensor:
    """`launch_gemm` with the tile width: 0 for the rule (bf16: the
    kernel's `pick_tile`; fp32: `f32_tile`), or one to force (bf16: 128
    or 256; fp32: 32, 64 or 128), for the timings that set the rules."""
    m, k = a.shape
    n, kw = weight.shape
    if kw != k:
        raise ValueError(f"gemm: a {tuple(a.shape)} vs weight {tuple(weight.shape)}")
    if k % 8 or n % 8:
        raise ValueError(f"gemm: K={k} and N={n} must be multiples of 8")
    a_ptr, w_ptr = a.data_ptr(), weight.data_ptr()
    for name, t, ptr in (("a", a, a_ptr), ("weight", weight, w_ptr)):
        if ptr % 16:
            raise ValueError(f"gemm: {name} {tuple(t.shape)} starts at an address that is "
                             "not a multiple of 16 bytes")
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"gemm: bias {tuple(bias.shape)} for N={n}")
    if residual is not None and residual.shape != (m, n):
        raise ValueError(f"gemm: residual {tuple(residual.shape)} for ({m}, {n})")
    if out is None:
        out = torch.empty((m, n), dtype=a.dtype, device=a.device)
        ldc = n
    else:
        ldc = out.stride(0)
        if (out.shape != (m, n) or out.dtype != a.dtype or out.get_device() != a.get_device()
                or out.stride(1) != 1 or ldc % 8 or out.data_ptr() % 16):
            raise ValueError(f"gemm: out {out.dtype} {tuple(out.shape)} at strides "
                             f"{out.stride()} for ({m}, {n}) {a.dtype}")
    bias_ptr = None if bias is None else bias.data_ptr()
    res_ptr = None if residual is None else residual.data_ptr()
    device = a.get_device()
    if a.dtype == torch.float32:
        launch("fern_gemm_tf32", a_ptr, w_ptr, bias_ptr, None, None, None, res_ptr,
               out.data_ptr(), 1, m, n, k, ldc, ACT_CODES[activation],
               max(_F32_K_TILE, -(-k // _F32_K_TILE) * _F32_K_TILE),
               tile or f32_tile(m, n, sm_count(device)), 1, device, stream_of(a))
    else:
        launch("fern_gemm", a_ptr, w_ptr, bias_ptr, res_ptr, out.data_ptr(), m, n, k, ldc,
               ACT_CODES[activation], DTYPE_CODES[a.dtype], tile, device, stream_of(a))
    return out


def launch_ln_quant(x2: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """LN + row-int8 kernel on a contiguous [rows, W] CUDA tensor (the
    prologue of B5 and B6) -> (int8 [rows, W], fp32 scales [rows, 1])."""
    rows, width = x2.shape
    q = torch.empty((rows, width), dtype=torch.int8, device=x2.device)
    scale = torch.empty((rows, 1), dtype=torch.float32, device=x2.device)
    launch("fern_ln_quant", x2.data_ptr(), weight.data_ptr(), bias.data_ptr(), q.data_ptr(),
           scale.data_ptr(), rows, width, eps, DTYPE_CODES[x2.dtype], x2.get_device(),
           stream_of(x2))
    return q, scale


def launch_quant_groups(x: torch.Tensor, groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-int8 kernel on a contiguous fp32 [rows, F] CUDA tensor, one
    scale per row and per group of F / groups columns -> (int8 [rows, F],
    fp32 scales [rows, groups])."""
    rows, width = x.shape
    if x.dtype != torch.float32 or width % groups:
        raise ValueError(f"quant_groups: {x.dtype} [{rows}, {width}] in {groups} groups")
    q = torch.empty((rows, width), dtype=torch.int8, device=x.device)
    scale = torch.empty((rows, groups), dtype=torch.float32, device=x.device)
    launch("fern_quant_groups", x.data_ptr(), q.data_ptr(), scale.data_ptr(), rows, width,
           groups, x.get_device(), stream_of(x))
    return q, scale


# The int8 GEMM's tiles (csrc/qgemm.cu), two blocks an SM: width -> time
# of a wave of its tiles against a wave of 128-wide ones, read on an H100
# at B5's and B6's one-group products (`ab_attention.py --int8`, each width
# forced: 0.54-0.70 at M = 6,304 and 25,216). Several K groups (B5's
# c_proj) take the 64-wide tile, the one whose instance holds the fp32
# accumulator.
_INT8_TILE_ROWS, _INT8_BLOCKS_PER_SM = 128, 2
_INT8_TILES = ((128, 1.0), (64, 0.6))
_INT8_GROUPED_TILE = 64


@functools.lru_cache(maxsize=4096)
def int8_tile(m: int, n: int, sms: int) -> int:
    """Output tile width of the one-group int8 GEMM [m, k] x [n, k]^T on a
    card of `sms` SMs: the width whose waves of tiles (two blocks an SM),
    each at its relative cost (`_INT8_TILES`), take least time, the wider
    on a tie. Narrow tiles fill the SMs where wide ones leave a wave
    mostly empty (ViT's out-projection at B = 32: 300 tiles 128 wide, 1.14
    waves)."""
    rows = -(-m // _INT8_TILE_ROWS)

    def waves_time(tile: tuple[int, float]) -> float:
        bn, cost = tile
        return -(-(rows * -(-n // bn)) // (sms * _INT8_BLOCKS_PER_SM)) * cost

    return min(_INT8_TILES, key=waves_time)[0]


def launch_qgemm(a: torch.Tensor, a_scale: torch.Tensor, weight: torch.Tensor,
                 w_scale: torch.Tensor, *, groups: int = 1, bias: torch.Tensor | None = None,
                 residual: torch.Tensor | None = None, activation: str | None = None,
                 out_dtype: torch.dtype, tile: int = 0) -> torch.Tensor:
    """int8 GEMM kernel with its rescaling epilogue, one launch:

        [res +] cast(act(sum_g float(a_g . weight_g.T) * a_scale[:, g] * w_scale + bias))

    a int8 [M, K]; weight int8 [N, K] (torch layout) with w_scale fp32
    [N]; a_scale fp32 [M, groups]. `groups` > 1 splits K into that many
    equal groups of whole 128-column K tiles, group g rescaled by
    a_scale[:, g], the groups' fp32 sums added in group order (B5's
    c_proj over its hidden groups). bias and residual in `out_dtype` or,
    for an fp32 output, in the activations' dtype (`bias.dtype`). `tile`:
    0 for the rule (`int8_tile`; 64 with several groups), or 64 / 128 to
    force a width (128 with one group only). Raises on what the kernel
    cannot take: K not a multiple of 16, an operand that is not contiguous
    or does not start on a 16-byte boundary (TMA), groups that are not
    whole K tiles. Its callers have checked the operands' devices and
    dtypes."""
    m, k = a.shape
    n = weight.shape[0]
    if weight.shape[1] != k or k % 16 or k <= 0:
        raise ValueError(f"qgemm: a {tuple(a.shape)}, weight {tuple(weight.shape)} "
                         "(K a multiple of 16 only)")
    if groups < 1 or k % groups or (groups > 1 and (k // groups) % 128):
        raise ValueError(f"qgemm: {groups} groups of K={k} (whole 128-column K tiles only)")
    if a_scale.shape != (m, groups) or a_scale.stride(1) != 1:
        raise ValueError(f"qgemm: a_scale {tuple(a_scale.shape)} for {m} rows, {groups} groups")
    for name, t in (("a", a), ("weight", weight)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"qgemm: {name} {tuple(t.shape)} is not contiguous from an "
                             "address that is a multiple of 16 bytes")
    io = bias if bias is not None else residual
    io_dtype = io.dtype if io is not None else out_dtype
    if out_dtype != torch.float32 and out_dtype != io_dtype:
        raise TypeError(f"qgemm: output {out_dtype} with bias/residual {io_dtype}")
    if residual is not None and (out_dtype != residual.dtype or residual.shape != (m, n)):
        raise ValueError(f"qgemm: residual {residual.dtype} {tuple(residual.shape)}")
    if tile not in (0, 64, 128) or (tile == 128 and groups > 1):
        raise ValueError(f"qgemm: tile {tile} with {groups} groups")
    device = a.get_device()
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    launch("fern_qgemm", a.data_ptr(), weight.data_ptr(), a_scale.data_ptr(),
           a_scale.stride(0), w_scale.data_ptr(), None if bias is None else bias.data_ptr(),
           None if residual is None else residual.data_ptr(), c.data_ptr(), m, n, k, groups,
           ACT_CODES[activation], DTYPE_CODES[io_dtype], int(out_dtype == torch.float32),
           tile or (_INT8_GROUPED_TILE if groups > 1 else int8_tile(m, n, sm_count(device))),
           device, stream_of(a))
    return c
