"""Host-side batched loader with per-process sharding and prefetch.

A copy of `fashionern_aaai2024_tpu/data/loader.py`, kept in the port so
that it imports nothing of the JAX package; the two must give the same
batches for the same seed (tests/test_torch_train_loop.py).

Replaces the reference's `DataLoader(num_workers=4, pin_memory=True)` +
`DistributedSampler` pair (`run/train/train_fiq.py:62-74`). Each process
iterates its own shard (rank/world), batches into numpy arrays (strings
stay Python lists), and a worker pool prefetches ahead of the device so
decode/`.npy` IO overlaps with device compute. The epoch-seeded shuffle
(`seed + epoch`), `drop_last` and `iter_batches(skip)` are what make a
resumed run re-enter an epoch at the right batch.

Two worker types:
  * "thread" (default): zero-copy hand-off, but PIL JPEG/PNG decode
    holds the GIL for significant stretches, capping scaling;
  * "process": fork-based workers (the reference DataLoader's model) —
    the dataset is inherited by fork (never pickled), items return via
    pickle. Use for decode-bound datasets at large batch sizes.
"""

from __future__ import annotations

import concurrent.futures as futures
import multiprocessing
import threading
from typing import Any, Iterator, Sequence

import numpy as np

# Fork-inherited dataset handle: set in the parent immediately before
# the pool forks, so workers read it as a plain global and no dataset
# pickling ever happens (PatchFeatureStore mmaps stay mmaps).
# ProcessPoolExecutor forks workers lazily, so the global must stay set
# (and unchanged) for the whole iteration — _PROCESS_LOADER_LOCK makes
# that safe by allowing only ONE process-type Loader iteration at a
# time; a second concurrent one raises instead of silently handing
# late-forked workers the wrong dataset.
_WORKER_DATASET = None
_PROCESS_LOADER_LOCK = threading.Lock()


def _worker_get(i: int):
    return _WORKER_DATASET[i]


def default_collate(items: Sequence[dict]) -> dict:
    """Dict-of-stacked-arrays collate. None items (skip_corrupt datasets)
    are dropped, mirroring the reference collate_fn (`utils/utils.py:22-29`)."""
    items = [it for it in items if it is not None]
    if not items:
        return {}
    out: dict[str, Any] = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals  # strings / lists of strings
    return out


class Loader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 42,
        rank: int = 0,
        world_size: int = 1,
        drop_last: bool = False,
        num_workers: int = 8,
        collate=default_collate,
        worker_type: str = "thread",
    ):
        if worker_type not in ("thread", "process"):
            raise ValueError("worker_type must be 'thread' or 'process'")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.collate = collate
        self.worker_type = worker_type
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """DistributedSampler-style epoch-dependent shuffling."""
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        # pad so every rank sees the same number of samples (DistributedSampler semantics)
        if self.world_size > 1:
            per_rank = -(-n // self.world_size)
            padded = np.concatenate([idx, idx[: per_rank * self.world_size - n]])
            idx = padded[self.rank :: self.world_size]
        return idx

    def __len__(self) -> int:
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        return self.iter_batches(0)

    def iter_batches(self, start_batch: int = 0) -> Iterator[dict]:
        """Iterate this epoch's batches starting at `start_batch`.

        The skipped prefix is dropped at the INDEX level — no decode, no
        worker submission — which makes mid-epoch resume O(1): the
        trainer reconstructs (epoch, step-within-epoch) from the saved
        global step and re-enters the epoch's deterministic order
        (`_indices` is a pure function of seed+epoch) at the right batch.
        """
        idx = self._indices()
        batches = [
            idx[i : i + self.batch_size] for i in range(0, len(idx), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        batches = batches[start_batch:]

        if self.num_workers <= 0:
            for b in batches:
                yield self.collate([self.dataset[int(i)] for i in b])
            return

        # Per-ITEM futures, two batches ahead: decodes of a batch run on
        # all workers concurrently (a whole-batch task would serialize
        # its items on one thread — measured 1.0x scaling at any worker
        # count; per-item gives near-linear scaling for decode-bound
        # datasets).
        holds_lock = False
        if self.worker_type == "process":
            global _WORKER_DATASET
            if not _PROCESS_LOADER_LOCK.acquire(blocking=False):
                raise RuntimeError(
                    "another process-type Loader is mid-iteration; "
                    "late-forked workers would inherit its dataset. "
                    "Exhaust/close it first, or use worker_type='thread'."
                )
            holds_lock = True
            _WORKER_DATASET = self.dataset  # inherited by fork below
            # (workers fork lazily on submit, so the global stays set —
            # and the lock held — until pool shutdown in finally)
            try:
                pool = futures.ProcessPoolExecutor(
                    self.num_workers,
                    mp_context=multiprocessing.get_context("fork"),
                )
            except BaseException:
                _WORKER_DATASET = None
                _PROCESS_LOADER_LOCK.release()
                raise
            get = _worker_get
        else:
            pool = futures.ThreadPoolExecutor(self.num_workers)
            get = self.dataset.__getitem__
        try:
            depth = 2

            def submit(b):
                return [pool.submit(get, int(i)) for i in b]

            pending = [submit(b) for b in batches[:depth]]
            for i, _ in enumerate(batches):
                if i + depth < len(batches):
                    pending.append(submit(batches[i + depth]))
                yield self.collate([f.result() for f in pending[i]])
                # release the consumed batch's futures — holding every
                # completed future pins the whole epoch's decoded items
                # in memory
                pending[i] = None
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
            if holds_lock:
                _WORKER_DATASET = None
                _PROCESS_LOADER_LOCK.release()
