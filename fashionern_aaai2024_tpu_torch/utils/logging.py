"""Structured metric logging.

A copy of `fashionern_aaai2024_tpu/utils/logging.py`, kept in the port so
that it imports nothing of the JAX package.

The reference logs via bare rank-0 `print` every 100 steps
(`run/train/train_fiq.py:142-146`). Here: stdout + append-only JSONL so
runs are machine-readable (recall tables, throughput, loss curves).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Any, IO


class MetricLogger:
    def __init__(self, jsonl_path: str | Path | None = None, stream: IO | None = None):
        self._file = open(jsonl_path, "a") if jsonl_path else None
        self._stream = stream if stream is not None else sys.stdout
        self._t0 = time.time()

    def log(self, step: int | None = None, **metrics: Any) -> None:
        record = {"t": round(time.time() - self._t0, 3)}
        if step is not None:
            record["step"] = step
        record.update(
            {k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v)
             for k, v in metrics.items()}
        )
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        parts = " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in record.items()
        )
        print(parts, file=self._stream)

    def close(self) -> None:
        if self._file:
            self._file.close()
