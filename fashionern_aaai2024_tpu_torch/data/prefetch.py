"""Host→device prefetch: double-buffered background transfer pipeline.

A copy of `fashionern_aaai2024_tpu/data/prefetch.py`, kept in the port
so that it imports nothing of the JAX package; unlike it, closing the
iterator joins the worker thread.

The reference hides H2D behind compute with CUDA streams
(`run/train/train_fiq.py:111-114`, `.to(device, non_blocking=True)` on
a side stream). Here a background thread walks the loader, prepares each
batch (tokenize, `tensor.to(device)`) `depth` batches ahead of the
consumer, so

  host decode (loader)  |  tokenize + H2D copy  |  device compute

pipeline instead of serialize.

Numerics are unchanged: prefetch reorders *when* work happens, never
*what* is computed (train-step captions stay keyed by their step id,
see `Trainer._device_batch`), so resume-continuation parity holds with
prefetch on or off (tests/test_train.py).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator


class _Stop:
    pass


_SENTINEL = _Stop()


def prefetch_iter(
    iterable: Iterable,
    fn: Callable | None = None,
    depth: int = 2,
) -> Iterator:
    """Yield `fn(index, item)` for each item, computed up to `depth`
    items ahead on a background thread.

    `fn` typically tokenizes and copies a loader batch to the device; `None`
    passes items through (pure read-ahead). Exceptions in the worker
    surface in the consumer at the failing item's position. If the
    consumer abandons the iterator early (break / GC), the worker is
    unblocked and exits — it never deadlocks on a full queue. Closing
    the iterator (or its end, or a relayed exception) joins the worker,
    so no thread outlives its consumer; the join waits at most for the
    item the worker is preparing.
    """
    if depth <= 0:
        it = iter(iterable)
        if fn is None:
            yield from it
        else:
            for i, item in enumerate(it):
                yield fn(i, item)
        return

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        try:
            for i, item in enumerate(iterable):
                out = item if fn is None else fn(i, item)
                while not stop.is_set():
                    try:
                        q.put(out, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            while not stop.is_set():
                try:
                    q.put(e, timeout=0.1)
                    return
                except queue.Full:
                    continue
            return
        while not stop.is_set():
            try:
                q.put(_SENTINEL, timeout=0.1)
                return
            except queue.Full:
                continue

    t = threading.Thread(target=worker, daemon=True, name="device-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        if t is not threading.current_thread():  # a finalizer may run on the worker
            t.join()
