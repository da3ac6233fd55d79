"""The profiled slice of a `--trace 1` run, reduced to what the per-layer
readers and the result's `breakdown` need.

`torch.profiler` (CPU and CUDA activities) covers a bounded slice of the
window, so that the trace stays small; the harness marks the slice with
the span `cirbench/slice` and its own spans around each call into the
program. From the trace:
  * `busy_s`: the union of the device's activity (kernels, copies,
    memsets; not the annotations) inside the slice, `window_s` the
    slice's length, both in the trace's clock;
  * `device_s`: the device time of every operation (a CUDA graph's
    replayed kernels included);
  * `top_ops`: device time by operation name, the ten largest;
  * `idle_gaps`: the ten longest intervals with no device activity, each
    named by the innermost span the host was in when it began;
  * `layer_s[name]`: the device time of the work that ran on the compute
    stream between the marks (`Marks`) that open and close a layer of that
    name, and `layer_count[name]` how often it was opened; the work
    inside no layer is under `OUTSIDE`. None when the marks cannot be read.

Layers are split by marks in stream order, not by the host's spans: the
port launches most of its kernels through ctypes, and the profiler does
not hand those kernels to the span they were launched in. A mark is a
tiny kernel (`torch.cuda._sleep(0)`, ATen's `spin_kernel`) launched on
the current stream as the host enters or leaves a layer; on one stream
the device runs the kernels in the order they were launched, so every
kernel between a layer's two marks is that layer's, whatever launched it.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses

import torch

SLICE = "cirbench/slice"
MARK_KERNEL = "spin_kernel"
OUTSIDE = "outside"


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_s: float
    top_ops: list[tuple[str, float]]
    idle_gaps: list[tuple[str, float]]
    layer_s: dict[str, float] | None = None
    layer_count: dict[str, int] | None = None


class Marks:
    """The host's side of the layer marks: while `on`, each `layer(name)`
    launches a mark kernel on the current stream as it opens and closes,
    and records them in order. Off the card, or while off, it launches
    and records nothing."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.on = False
        self.labels: list[tuple[str, bool]] = []     # (layer, opens) per mark

    def _mark(self, name: str, opens: bool) -> None:
        torch.cuda._sleep(0)
        self.labels.append((name, opens))

    @contextlib.contextmanager
    def layer(self, name: str):
        if not (self.on and self.cuda):
            yield
            return
        self._mark(name, True)
        try:
            yield
        finally:
            self._mark(name, False)


def profiler(device: torch.device) -> torch.profiler.profile:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _is_device(e) -> bool:
    return (e.device_type != torch.autograd.DeviceType.CPU
            and not getattr(e, "is_user_annotation", False))


def _is_span(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CPU and (
        getattr(e, "is_user_annotation", False) or "/" in e.name)


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def split_layers(device: list[tuple], labels: list[tuple[str, bool]]
                 ) -> tuple[dict[str, float], dict[str, int]] | None:
    """(device s, times opened) by layer, from the slice's device events
    (start, end, name, stream) and the marks' labels in launch order. None
    when the trace does not hold one mark kernel per label on one stream."""
    marks = sorted((e for e in device if MARK_KERNEL in e[2]), key=lambda e: e[0])
    if not labels or len(marks) != len(labels) or len({e[3] for e in marks}) != 1:
        return None
    stream = marks[0][3]
    starts = [e[0] for e in marks]
    open_after: list[str] = []          # the innermost open layer after each mark
    stack: list[str] = []
    count: dict[str, int] = {}
    for name, opens in labels:
        if opens:
            stack.append(name)
            count[name] = count.get(name, 0) + 1
        elif stack and stack[-1] == name:
            stack.pop()
        else:
            return None
        open_after.append(stack[-1] if stack else OUTSIDE)
    seconds = {name: 0.0 for name in count} | {OUTSIDE: 0.0}
    for a, b, name, s in device:
        if s != stream or MARK_KERNEL in name:
            continue
        i = bisect.bisect_right(starts, a) - 1
        seconds[open_after[i] if i >= 0 else OUTSIDE] += (b - a) * 1e-6
    return seconds, count


def summarize(prof: torch.profiler.profile, marks: Marks | None = None) -> TraceSummary | None:
    """None when the slice's span is missing or no device activity was traced."""
    events = list(prof.events())
    slices = [e for e in events if e.name == SLICE and e.device_type == torch.autograd.DeviceType.CPU]
    if not slices:
        return None
    lo = min(e.time_range.start for e in slices)
    hi = max(e.time_range.end for e in slices)
    device = [(max(e.time_range.start, lo), min(e.time_range.end, hi), e.name,
               getattr(e, "device_resource_id", None))
              for e in events if _is_device(e)]
    device = [d for d in device if d[1] > d[0]]
    if not device:
        return None
    busy = _union([(a, b) for a, b, *_ in device])
    by_name: dict[str, float] = {}
    for a, b, n, _ in device:
        by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-6
    spans = [e for e in events if _is_span(e) and e.name != SLICE]
    layers = split_layers(device, marks.labels) if marks is not None else None
    edges = [(lo, lo)] + busy + [(hi, hi)]
    longest = sorted(((start - end, end) for (_, end), (start, _) in zip(edges[:-1], edges[1:])
                      if start > end), reverse=True)[:10]
    gaps = []
    for length, end in longest:
        host = [e for e in spans if e.time_range.start <= end < e.time_range.end]
        inner = min(host, key=lambda e: e.time_range.end - e.time_range.start, default=None)
        gaps.append((inner.name if inner is not None else "outside any span", length * 1e-6))
    return TraceSummary(
        window_s=(hi - lo) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        device_s=sum(by_name.values()),
        top_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        idle_gaps=gaps,
        **({} if layers is None else {"layer_s": layers[0], "layer_count": layers[1]}))
