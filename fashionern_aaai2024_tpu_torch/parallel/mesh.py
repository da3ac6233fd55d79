"""The data-parallel mesh of the port: a `torch.distributed` process group.

JAX counterpart: `fashionern_aaai2024_tpu/parallel/mesh.py`. There one
controller drives N devices through a `jax.sharding.Mesh` with one `data`
axis, and `shard_map` programs reduce with `psum` / `pmean` /
`all_gather`. PyTorch runs one process per device, so here a mesh is a
process group with the same single data axis: each rank holds one device
and runs the whole per-shard program (the kernels included), as each
shard does under `shard_map`; the collectives sit where JAX put them
(`train/step.py`, `ops/losses.py`, `retrieval/engine.py`,
`retrieval/evaluate.py`).

  * `initialize_distributed` starts the group: NCCL when the device is
    CUDA, gloo on the CPU, from `torchrun`'s environment (`MASTER_ADDR`,
    `MASTER_PORT`, `RANK`, `WORLD_SIZE`, `LOCAL_RANK`) or explicit
    arguments; with neither, a group of one rank on a free local port.
    Every group has a finite timeout, so that a rank out of step fails the
    run instead of hanging it. A failed NCCL init raises; nothing switches
    to gloo or to one device.
  * `ProcessMesh`: the group, this rank, the group's size and this rank's
    device. `group=None` is the mesh of a single process with no group
    (`create_mesh()` before any group exists): every collective is then
    the identity, as on a one-device JAX mesh.
  * `shard_batch` takes this rank's contiguous rows of a global batch and
    puts them on the device (JAX's `device_put` onto the data sharding).
  * `all_reduce_mean`, `all_gather_rows`, `GatherRows` (an all-gather with
    the gradient of JAX's tiled `all_gather`: a reduce-scatter of the
    sum), `broadcast`: the collectives of the data-parallel programs.
  * `spawn_cpu_gang(n, fn, *args)` (the counterpart of `cpu_mesh_env`):
    `n` spawned processes, each with a gloo group over a `FileStore`, run
    `fn(mesh, *args)`; every rank is killed if one fails or the gang
    outlives its timeout.

The card's machine holds one H100, and NCCL refuses two ranks on one
GPU: there NCCL runs at world size 1 (README, ROADMAP "Ground facts").
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import queue
import shutil
import socket
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
DEFAULT_TIMEOUT = 600.0   # seconds a collective may wait for its peers


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """One data axis over the ranks of `group` (None: one process, no
    group, collectives are identities)."""

    group: Any
    rank: int
    size: int
    device: torch.device

    @property
    def backend(self) -> str | None:
        return None if self.group is None else dist.get_backend(self.group)

    def barrier(self) -> None:
        if self.group is not None:
            if self.backend == "nccl":
                dist.barrier(self.group, device_ids=[self.device.index])
            else:
                dist.barrier(self.group)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _default_device(device: torch.device | str | None, local_rank: int) -> torch.device:
    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA requested but not available (pass device='cpu' "
                               "for a mesh on the CPU)")
        index = torch.device(device).index if device is not None else None
        return torch.device("cuda", local_rank if index is None else index)
    return torch.device(device)


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *,
                           device: torch.device | str | None = None,
                           timeout: float = DEFAULT_TIMEOUT) -> ProcessMesh:
    """Start this process's group (JAX `mesh.py:91`) and return the mesh
    over all of its ranks. Each argument falls back to `torchrun`'s
    environment (`MASTER_ADDR:MASTER_PORT`, `WORLD_SIZE`, `RANK`); with no
    address there either, a one-rank group on a free local port. The
    device is `cuda:LOCAL_RANK` unless `device` says otherwise; NCCL on
    CUDA, gloo on the CPU. Already initialized: the mesh over the
    existing group."""
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    local_rank = int(env.get("LOCAL_RANK", process_id))
    dev = _default_device(device, local_rank)
    if dist.is_initialized():
        return create_mesh(device=dev)
    if coordinator_address is None:
        if num_processes != 1:
            raise ValueError(f"{num_processes} processes need a coordinator address "
                             "(MASTER_ADDR / MASTER_PORT, as torchrun sets them)")
        coordinator_address = f"localhost:{_free_port()}"
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            rank=process_id, world_size=num_processes,
                            timeout=timedelta(seconds=timeout), **kwargs)
    return create_mesh(device=dev)


def create_mesh(num_devices: int = -1, device: torch.device | str | None = None
                ) -> ProcessMesh:
    """The 1-D data mesh (JAX `mesh.py:48`): all ranks of the default group
    (`num_devices=-1`) or its first `num_devices` (a subgroup; ranks past
    it get no mesh and raise). Without a group: the one-process mesh on
    `device`, by default the card (which raises without CUDA; a CPU mesh
    is asked for with device="cpu")."""
    if not dist.is_initialized():
        if num_devices not in (-1, 1):
            raise ValueError(f"requested {num_devices} devices, have 1 (no process group: "
                             "call initialize_distributed first)")
        index = torch.cuda.current_device() if torch.cuda.is_available() else 0
        return ProcessMesh(None, 0, 1, _default_device(device, index))
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if num_devices == -1 else num_devices
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        raise ValueError(f"rank {rank} is outside the {n}-rank mesh")
    return ProcessMesh(group, rank, n, torch.device(device))


def destroy(mesh: ProcessMesh) -> None:
    """Tear the default group down (the mesh's subgroups with it)."""
    if mesh.group is not None and dist.is_initialized():
        dist.destroy_process_group()


def local_batch_size(global_batch: int, mesh: ProcessMesh) -> int:
    """JAX `mesh.py:84`: the rows of one rank; raises when they differ."""
    n = mesh.size
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by mesh size {n}")
    return global_batch // n


def shard_rows(mesh: ProcessMesh, x):
    """This rank's contiguous rows of `x` (array, tensor or list)."""
    b = local_batch_size(len(x), mesh)
    return x[mesh.rank * b:(mesh.rank + 1) * b]


def shard_batch(mesh: ProcessMesh, batch: dict) -> dict:
    """JAX `mesh.py:62`: each value of a global batch cut to this rank's
    contiguous rows; arrays and tensors go to the mesh's device (int32
    ids as int64, the port's token type), lists stay on the host."""
    out = {}
    for key, value in batch.items():
        rows = shard_rows(mesh, value)
        if isinstance(rows, (np.ndarray, torch.Tensor)):
            t = torch.as_tensor(np.asarray(rows) if isinstance(rows, np.ndarray) else rows)
            if t.dtype == torch.int32:
                t = t.long()
            rows = t.to(mesh.device)
        out[key] = rows
    return out


# ---------------------------------------------------------------- collectives


def all_reduce_mean(mesh: ProcessMesh, t: torch.Tensor) -> torch.Tensor:
    """`pmean`, in place: the sum over the ranks divided by their count
    (the same two steps on every backend)."""
    if mesh.group is not None:
        dist.all_reduce(t, group=mesh.group)
        t.div_(mesh.size)
    return t


def all_reduce_sum(mesh: ProcessMesh, t: torch.Tensor) -> torch.Tensor:
    """`psum`, in place."""
    if mesh.group is not None:
        dist.all_reduce(t, group=mesh.group)
    return t


def all_gather_rows(mesh: ProcessMesh, x: torch.Tensor) -> torch.Tensor:
    """JAX's tiled `all_gather` over axis 0: [size * b, ...], rank r's rows
    at r * b. NCCL: one `all_gather_into_tensor` (one kernel, capturable);
    gloo: the list form."""
    if mesh.group is None:
        return x
    x = x.contiguous()
    if mesh.backend == "nccl":
        out = x.new_empty((mesh.size * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=mesh.group)
        return out
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


def all_gather_cols(mesh: ProcessMesh, x: torch.Tensor) -> torch.Tensor:
    """The tiled `all_gather` over axis 1 of a [q, c] tensor: [q, size * c]."""
    if mesh.group is None:
        return x
    g = all_gather_rows(mesh, x.t().contiguous())     # [size * c, q]
    return g.t().contiguous()


class GatherRows(torch.autograd.Function):
    """`all_gather_rows` with the transpose of JAX's tiled `all_gather` as
    its gradient: rank r's rows receive the sum, over every rank, of the
    gradient at rows r * b: (r + 1) * b (a reduce-scatter of the sum; on
    gloo, which lacks it, an all-reduce of the whole gradient and this
    rank's slice, the same sum)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
        ctx.mesh = mesh
        return all_gather_rows(mesh, x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        mesh = ctx.mesh
        if mesh.group is None:
            return g, None
        g = g.contiguous()
        b = g.shape[0] // mesh.size
        if mesh.backend == "nccl":
            out = g.new_empty((b, *g.shape[1:]))
            dist.reduce_scatter_tensor(out, g, group=mesh.group)
            return out, None
        g = g.clone()
        dist.all_reduce(g, group=mesh.group)
        return g[mesh.rank * b:(mesh.rank + 1) * b], None


def broadcast(mesh: ProcessMesh, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank `src`'s `t` into every rank's `t`, in place."""
    if mesh.group is not None:
        dist.broadcast(t, src=dist.get_global_rank(mesh.group, src), group=mesh.group)
    return t


# ------------------------------------------------------------- the CPU gangs


def _gang_rank(rank: int, n: int, store: str, timeout: float, device: str,
               fn: Callable, args: tuple, results) -> None:
    try:
        torch.set_num_threads(1)    # n ranks share the host's cores
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device).index or 0)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=n, timeout=timedelta(seconds=timeout))
        try:
            out = fn(ProcessMesh(dist.group.WORLD, rank, n, torch.device(device)), *args)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def spawn_cpu_gang(n: int, fn: Callable, *args, timeout: float = 300.0,
                   store_dir: str | None = None, device: str = "cpu") -> list:
    """Run `fn(mesh, *args)` on `n` spawned ranks of one gloo group on the
    CPU (the port's `cpu_mesh_env`): a `FileStore` in `store_dir` (a fresh
    temporary directory by default), so gangs never share a port. `fn`
    and `args` are pickled by import path and value. Returns the ranks'
    results in rank order; a rank that raises, dies or is still running
    after `timeout` seconds fails the gang: every rank is killed and a
    RuntimeError carries the first traceback. `device="cuda"` gives every
    rank the mesh device cuda:0 with the same gloo group (gloo takes CUDA
    tensors: `chip_smoke.py`'s two ranks on the one card)."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    own = store_dir is None
    store_dir = tempfile.mkdtemp(prefix="gang-") if own else store_dir
    store = os.path.join(store_dir, f"store-{os.getpid()}-{time.monotonic_ns()}")
    procs = [ctx.Process(target=_gang_rank,
                         args=(r, n, store, timeout, device, fn, args, results),
                         daemon=True)
             for r in range(n)]
    out: dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < n:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a gang rank died (exit codes {dead})") from None
                if time.monotonic() > deadline:
                    raise RuntimeError(f"the {n}-rank gang outlived its {timeout} s "
                                       "timeout") from None
                continue
            if not ok:
                raise RuntimeError(f"gang rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
        results.close()
        if own:
            shutil.rmtree(store_dir, ignore_errors=True)
    return [out[r] for r in range(n)]
