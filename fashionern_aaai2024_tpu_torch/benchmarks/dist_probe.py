"""What `torch.distributed` offers on this card: the facts the data-parallel
path (`parallel/mesh.py`) is built on.

Run on the card: `python -m fashionern_aaai2024_tpu_torch.benchmarks.dist_probe`.
Prints one JSON object:

  * `nccl_version`: `torch.cuda.nccl.version()`;
  * `nccl_world1_capture`: an NCCL group of world size 1 in this process,
    one eager warm-up collective, then `all_gather_into_tensor` and
    `all_reduce` recorded into a CUDA graph and replayed on new inputs:
    whether the capture succeeded, how many kernel nodes the graph holds
    and whether the replay gave the eager result;
  * `gloo_cuda`: two processes that share the card, each with a gloo
    group, run `all_gather`, `all_reduce` and `broadcast` on CUDA
    tensors: which of them each rank accepted and got right.

Every process group is destroyed before the probe exits.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import socket
import tempfile
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def nccl_world1_capture() -> dict:
    from fashionern_aaai2024_tpu_torch.ops.graphs import graph_kernel_names

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1, timeout=timedelta(seconds=120),
                            device_id=dev)
    out: dict = {}
    try:
        x = torch.arange(8, dtype=torch.float32, device=dev)
        gathered = torch.empty(8, device=dev)
        dist.all_reduce(x)                        # eager warm-up
        torch.cuda.synchronize()

        def body():
            dist.all_gather_into_tensor(gathered, x)
            y = gathered * 2
            dist.all_reduce(y)
            return y

        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with torch.cuda.graph(graph):
                y = body()
            names = graph_kernel_names(graph.raw_cuda_graph())
            graph.instantiate()
            out["captured"] = True
            out["kernel_nodes"] = len(names)
            out["nccl_nodes"] = sum("nccl" in n.lower() for n in names)
        except RuntimeError as e:
            out["captured"] = False
            out["error"] = str(e).splitlines()[0][:300]
            return out
        x.copy_(torch.arange(8, dtype=torch.float32, device=dev) * 3 + 1)
        graph.replay()
        torch.cuda.synchronize()
        want = (torch.arange(8, dtype=torch.float32, device=dev) * 3 + 1) * 2
        out["replay_correct"] = bool(torch.equal(y, want))
    finally:
        dist.destroy_process_group()
    return out


def _gloo_rank(rank: int, store: str, q) -> None:
    res: dict = {}
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=2, timeout=timedelta(seconds=60))
        dev = torch.device("cuda", 0)
        x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank
        base = torch.arange(4.0)

        def all_gather():
            parts = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(parts, x)
            return torch.cat(parts).cpu(), torch.cat([base, base + 10])

        def all_reduce():
            y = x.clone()
            dist.all_reduce(y)
            return y.cpu(), base * 2 + 10

        def broadcast():
            y = x.clone()
            dist.broadcast(y, 0)
            return y.cpu(), base

        for fn in (all_gather, all_reduce, broadcast):
            try:
                got, want = fn()
                res[fn.__name__] = "ok" if torch.equal(got, want) else "wrong result"
            except RuntimeError as e:
                res[fn.__name__] = f"refused: {str(e).splitlines()[0][:200]}"
        dist.destroy_process_group()
    except Exception:  # reported to the parent, which prints it
        res["error"] = traceback.format_exc()[-600:]
    q.put((rank, res))


def gloo_cuda(timeout: float = 120.0) -> dict:
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as td:
        procs = [ctx.Process(target=_gloo_rank, args=(r, os.path.join(td, "store"), q))
                 for r in range(2)]
        for p in procs:
            p.start()
        out = {}
        try:
            for _ in procs:
                rank, res = q.get(timeout=timeout)
                out[f"rank{rank}"] = res
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("dist_probe: needs a CUDA device")
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0),
                      "nccl_version": ".".join(map(str, torch.cuda.nccl.version())),
                      "nccl_world1_capture": nccl_world1_capture(),
                      "gloo_cuda": gloo_cuda()}))


if __name__ == "__main__":
    main()
