"""One run of one cell: set-up, the measured window, the check.

`execute` is the run without the command line's look for a card: the
tests drive it on the CPU at a fixture's size. `run.py` is the command.

A run, in order:
  1. the cell's configuration, traffic mix and limits, found by name
     (`spec.py`); the traffic's driver (`drivers/<driver>.py`) builds the
     program from the seed and warms up the shapes the traffic uses:
     `setup_s` counts from the process's start to the window's;
  2. the window: `--seconds` of the traffic. With `--trace 0` it gives
     the cell's end-to-end metrics. With `--trace 1` a profiler covers a
     bounded slice at its start and the rest runs unprofiled; the
     per-layer readers (`metrics/<name>.py`) take their metrics from
     both;
  3. the device's memory peak is read, the program is freed, and the
     plain reference (`reference/`) works out again what the window's
     outputs should be: each compared number has its limit
     (`limits/<workload>.json`), and `correct` holds when every number is
     within its limit and no call failed.
The result is one JSON line; the numbers compared come last in it and,
each beside its limit, as the last lines on standard error.
"""

from __future__ import annotations

import dataclasses
import gc
import subprocess
import sys
import time

import torch

from cirbench.spec import Spec
from cirbench.trace import TraceSummary

FORBIDDEN = ("jax", "jaxlib", "flax", "fashionern_aaai2024_tpu")


@dataclasses.dataclass
class Context:
    spec: Spec
    cell: dict
    config: dict
    traffic: dict
    seed: int
    device: torch.device
    control: str | None = None          # a control in the program's place


@dataclasses.dataclass
class Window:
    """What a driver's window gives the harness."""
    metrics: dict[str, float]           # end-to-end metric -> value
    attempted: int
    failed: int


@dataclasses.dataclass
class Traced:
    """What a per-layer reader reads: the profiled slice's summary (None
    off the card), the units of work in the slice (`units`), and the
    unprofiled rest of the window (`rates`)."""
    summary: TraceSummary | None
    config: dict
    units: dict[str, float]
    rates: dict[str, float]


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's (compared whole, not as a prefix)."""
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN)


def device_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                                "--format=csv,noheader", f"--id={device.index or 0}"],
                               capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device),
            "power_limit": limit}


def execute(workload: str, seed: int, seconds: float, trace: bool,
            device: torch.device | str = "cuda", spec: Spec | None = None,
            control: str | None = None, t_start: float | None = None) -> dict:
    """One run of `workload`; returns the result (the checks under
    "checks") without printing it."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = spec or Spec()
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    cell = spec.cell(workload)
    ctx = Context(spec, cell, spec.config(cell), spec.traffic(cell), seed, device, control)
    limits = spec.limits(cell)
    driver = spec.driver(ctx.traffic).Driver(ctx)

    driver.setup()
    synchronize(device)
    setup_s = time.perf_counter() - t_start
    if trace:
        window, traced = driver.traced_window(seconds)
    else:
        window, traced = driver.window(seconds), None
    synchronize(device)
    info = device_info(device)          # the memory peak before the check allocates
    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = driver.check()

    if trace:
        metrics = {}
        for m in spec.per_layer(cell):
            value = spec.reader(m).read(traced)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if traced.summary is not None:
            info["busy_s"] = traced.summary.busy_s
            info["window_s"] = traced.summary.window_s
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for m in spec.end_to_end(cell):
            if m["name"] in window.metrics:
                metrics[m["name"]] = {"value": window.metrics[m["name"]], "unit": m["unit"]}
    bounded = {name: {"value": value, "limit": limits["limits"][name]}
               for name, value in checks.items()}
    correct = (window.failed == 0 and bool(bounded)
               and all(c["value"] <= c["limit"] for c in bounded.values()))
    result = {"correct": correct, "attempted": window.attempted, "failed": window.failed,
              "metrics": metrics, "device": info}
    if trace and traced.summary is not None:
        result["breakdown"] = {"device_ops": [list(o) for o in traced.summary.top_ops],
                               "idle_gaps": [list(g) for g in traced.summary.idle_gaps]}
    result["checks"] = bounded
    return result
