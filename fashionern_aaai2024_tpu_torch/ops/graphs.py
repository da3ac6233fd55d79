"""CUDA graphs of the port's programs, with their kernels' launch counts.

A captured program runs as one `torch.cuda.CUDAGraph` replay: one host
call where the eager program makes dozens of launches (each 10-16 µs of
host time, `PERF.md`). The serve program (`retrieval/evaluate.py
build_serve_fn`) and a loaded serve artifact (`retrieval/artifact.py`)
are captured this way, one graph per batch bucket (`BucketedCall`); it
replaces the JAX package's one jitted dispatch per request.

Launch counts. Each kernel wrapper adds one to its `fn.launches` where it
launches its kernels (`common.count`); under capture that code runs once,
at capture, and never at a replay. `CapturedCall` records what its own
thread launched during the capture (`common.recording`: the wrappers'
counts and the calls of each C entry point), takes the wrappers' counts
back (a capture launches nothing), and adds them again at every replay.
Launches that other threads make meanwhile are neither recorded nor
taken back. The recorded launches are checked against the graph itself:
its kernel nodes, read through libcuda (`graph_kernel_names`), must be
the port kernels that the recorded C calls launch, one node for each,
else the capture raises. So each replay adds the counts of kernels that
the graph holds.

B10's grid-barrier word: each capture gets a word of its own, allocated
before the capture (`ops/block.py graph_barrier`).

A failed capture raises; nothing falls back to eager launches.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import re
import threading
from collections.abc import Mapping
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from fashionern_aaai2024_tpu_torch.ops import block, common

# the port's CUDA kernels (`csrc/`) -> the C entry point that launches
# them; a call of an entry point launches one of its kernels, except
# fern_bbc_rowloss, which launches both of its (`NODES_PER_CALL`)
KERNEL_ENTRY = {
    "attention_mma_kernel": "fern_attention",
    "attention_tf32_kernel": "fern_attention",
    "grouped_attention_mma_kernel": "fern_attention_grouped",
    "grouped_attention_tf32_kernel": "fern_attention_grouped",
    "bbc_partial_kernel": "fern_bbc_rowloss",
    "bbc_combine_kernel": "fern_bbc_rowloss",
    "block_kernel": "fern_block",
    "combiner_gate_kernel": "fern_combiner_gate",
    "gemm_bf16_kernel": "fern_gemm",
    "gemm_tf32_kernel": "fern_gemm_tf32",
    "layernorm_kernel": "fern_layernorm",
    "ln_quant_kernel": "fern_ln_quant",
    "qgemm_kernel": "fern_qgemm",
    "wide_tf32_attention_kernel": "fern_attention_wide",
    "wide_mma_attention_kernel": "fern_attention_wide",
    "quant_groups_kernel": "fern_quant_groups",
}
NODES_PER_CALL = {"fern_bbc_rowloss": 2}

_KERNEL_NODE, _CHILD_GRAPH_NODE = 0, 4   # CUgraphNodeType
# one capture at a time: captures share the serve program's memory pool
_CAPTURE_LOCK = threading.Lock()


def port_kernel(name: str) -> str | None:
    """The port kernel that a kernel's name names, mangled (as libcuda
    gives it: `_ZN4fern12block_kernel...`) or demangled (as the profiler
    gives it: `void fern::block_kernel<...>(...)`); None for any other
    kernel (cuBLAS, PyTorch's own)."""
    for kernel in KERNEL_ENTRY:
        if (re.search(rf"(?<!\d){len(kernel)}{kernel}", name)
                or re.search(rf"(?<!\w){kernel}(?!\w)", name)):
            return kernel
    return None


def check_graph_launches(entries: collections.Counter,
                         kernel_names: Iterable[str]) -> collections.Counter:
    """The graph's port kernel nodes, by kernel, after checking them
    against the C entry calls that its capture made (`entries`): for each
    entry point, its calls times the kernels a call launches. Raises on
    any difference."""
    nodes = collections.Counter(k for k in map(port_kernel, kernel_names) if k)
    got = collections.Counter()
    for kernel, n in nodes.items():
        got[KERNEL_ENTRY[kernel]] += n
    want = collections.Counter({e: n * NODES_PER_CALL.get(e, 1)
                                for e, n in entries.items() if n})
    if got != want:
        raise RuntimeError(f"the captured graph holds the port kernel nodes {dict(nodes)} "
                           f"(by entry point {dict(got)}), but its capture launched "
                           f"{dict(want)}")
    return nodes


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 (`cuda.h`)."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


@functools.lru_cache(maxsize=None)
def _libcuda() -> ctypes.CDLL:
    return ctypes.CDLL("libcuda.so.1")


def _call(name: str, *args) -> None:
    rc = getattr(_libcuda(), name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: libcuda error {rc}")


def graph_kernel_names(graph: int) -> list[str]:
    """The function name of every kernel node of a CUDA graph (a raw
    `cudaGraph_t`), child graphs included, as libcuda gives them."""
    count = ctypes.c_size_t(0)
    _call("cuGraphGetNodes", ctypes.c_void_p(graph), None, ctypes.byref(count))
    nodes = (ctypes.c_void_p * count.value)()
    _call("cuGraphGetNodes", ctypes.c_void_p(graph), nodes, ctypes.byref(count))
    names = []
    for node in map(ctypes.c_void_p, nodes[:count.value]):
        kind = ctypes.c_int(-1)
        _call("cuGraphNodeGetType", node, ctypes.byref(kind))
        if kind.value == _KERNEL_NODE:
            params, name = _KernelNodeParams(), ctypes.c_char_p()
            _call("cuGraphKernelNodeGetParams_v2", node, ctypes.byref(params))
            if params.func:
                _call("cuFuncGetName", ctypes.byref(name), ctypes.c_void_p(params.func))
            else:
                _call("cuKernelGetName", ctypes.byref(name), ctypes.c_void_p(params.kern))
            names.append(name.value.decode())
        elif kind.value == _CHILD_GRAPH_NODE:
            child = ctypes.c_void_p()
            _call("cuGraphChildGraphNodeGetGraph", node, ctypes.byref(child))
            names += graph_kernel_names(child.value)
    return names


class CapturedCall:
    """`fn()` captured into one CUDA graph on the current device.

    `fn` reads static input tensors and returns its outputs; the caller
    writes new inputs into those tensors in place and calls `replay()`,
    after which `outputs` hold the results. Before the capture `fn` runs
    once eagerly on a side stream (it builds what is built at first use:
    the kernel library, cuBLAS handles, cached int8 weights, B10's
    occupancy), and that run launches and counts its kernels as any
    eager call does. The capture runs in the thread-local error mode, so
    other threads may go on using the card meanwhile. `launches` (wrapper
    -> calls) and `kernel_nodes` (port kernel -> nodes) are what one
    replay runs. Captures that share `pool` share memory: replay them one
    at a time, on one stream."""

    def __init__(self, fn: Callable, pool=None):
        device = torch.device("cuda", torch.cuda.current_device())
        with _CAPTURE_LOCK:
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream(device).wait_stream(side)
            self.barrier_word = torch.zeros(1, dtype=torch.int32, device=device)
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            with common.recording() as record:
                try:
                    with (block.graph_barrier(self.barrier_word),
                          torch.cuda.graph(self.graph, pool=pool,
                                           capture_error_mode="thread_local")):
                        self.outputs = fn()
                finally:
                    for wrapper, n in record.wrappers.items():
                        wrapper.launches -= n
            self.kernel_nodes = check_graph_launches(
                record.entries, graph_kernel_names(self.graph.raw_cuda_graph()))
            self.graph.instantiate()
        self.launches = dict(record.wrappers)

    def replay(self) -> None:
        self.graph.replay()
        for wrapper, n in self.launches.items():
            wrapper.launches += n


class _Bucket:
    """One bucket of a `BucketedCall`: its static inputs, its outputs, and
    on the card its graph."""

    def __init__(self, fn: Callable, inputs: tuple[torch.Tensor, ...],
                 device: torch.device, pool):
        self.inputs = inputs
        call = lambda: fn(*inputs)  # noqa: E731
        if device.type == "cuda":
            with torch.cuda.device(device):
                self.graph = CapturedCall(call, pool)
            self.outputs = self.graph.outputs
            self.run = self.graph.replay
        else:
            self.graph = None
            self.outputs = None

            def run():
                self.outputs = call()
            self.run = run


class BucketedCall(Mapping):
    """`fn(*inputs)` at a few batch sizes over static inputs: the request
    path of the serve program and of a loaded serve artifact. A mapping
    of bucket size -> bucket (`inputs`, `outputs`, `run()`, `graph`).

    `make_inputs(b)` makes one bucket's static input tensors on `device`,
    each with b rows. A call of n rows runs at the smallest bucket >= n:
    each host input is zero padded to b rows and copied into the bucket's
    static tensor, the bucket runs once, and `[:n, :k]` of each output
    comes back to the host. On the card each bucket is one
    `CapturedCall`, all in one memory pool, captured here, so no capture
    runs once it serves; on the CPU `fn` runs eagerly. Calls hold `lock`:
    the static tensors serve one request at a time, and a caller that
    writes other tensors `fn` reads (weights, gallery rows) holds it too.

    `on_dispatch(b, n, bucket)` runs under the lock after the inputs are
    copied in and before the bucket runs (the sharded serve program
    broadcasts them to its other ranks there)."""

    def __init__(self, fn: Callable, make_inputs: Callable[[int], tuple],
                 sizes: Iterable[int], device: torch.device,
                 on_dispatch: Callable[[int, int, "_Bucket"], None] | None = None):
        self.sizes = tuple(sorted(sizes))
        self.lock = threading.Lock()
        self.on_dispatch = on_dispatch
        pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
        self._buckets = {b: _Bucket(fn, make_inputs(b), device, pool) for b in self.sizes}

    def __getitem__(self, b: int) -> _Bucket:
        return self._buckets[b]

    def __iter__(self):
        return iter(self._buckets)

    def __len__(self) -> int:
        return len(self._buckets)

    def __call__(self, inputs: Sequence, k: int) -> tuple[np.ndarray, ...]:
        """`inputs`: host arrays or tensors of n rows each, in the order of
        a bucket's static inputs."""
        xs = [torch.as_tensor(x).detach().cpu() for x in inputs]
        n = int(xs[0].shape[0])
        b = next((x for x in self.sizes if x >= n), None)
        if b is None:
            raise ValueError(f"batch {n} exceeds the largest compile bucket "
                             f"{self.sizes[-1]}; split the request")
        bucket = self._buckets[b]
        padded = []
        for x, static in zip(xs, bucket.inputs, strict=True):
            host = torch.zeros(static.shape, dtype=static.dtype)
            host[:n] = x
            padded.append(host)
        with self.lock:
            for static, host in zip(bucket.inputs, padded):
                static.copy_(host)
            if self.on_dispatch is not None:
                self.on_dispatch(b, n, bucket)
            bucket.run()
            return tuple(o[:n, :k].cpu().numpy() for o in bucket.outputs)
