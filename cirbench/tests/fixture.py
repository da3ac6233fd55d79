"""A copy of the benchmark with CPU-sized cells added from
`fixtures/` as a later change would add them: new files, new entries in
`BENCHMARK.json`, and each new cell's name added to the metrics it
reports. No file of the copy that was there before is edited."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from cirbench.spec import BENCH_DIR, ROOT

FIXTURES = Path(__file__).resolve().parent / "fixtures"
REPORTS = {"embed": ("embed_img_per_s",), "query": ("query_ms_p50", "query_ms_p99"),
           "train": ("train_samples_per_s",)}


def fixture_root(tmp: Path) -> Path:
    root = Path(tmp) / "checkout"
    shutil.copytree(BENCH_DIR, root / BENCH_DIR.name,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = {p: p.read_bytes() for p in (root / BENCH_DIR.name).rglob("*") if p.is_file()}
    shutil.copytree(FIXTURES / "cirbench", root / BENCH_DIR.name, dirs_exist_ok=True)
    if any(p.read_bytes() != data for p, data in before.items()):
        raise AssertionError("a fixture overwrote a file of the benchmark")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = json.loads((FIXTURES / "cells.json").read_text())
    bench["configs"] += cells["configs"]
    bench["workloads"] += cells["workloads"]
    for cell in cells["workloads"]:
        traffic = json.loads((root / BENCH_DIR.name / "traffic" / f"{cell['traffic']}.json")
                             .read_text())
        moves = REPORTS[traffic["driver"]]
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and (m["name"] in moves or m.get("moves") in moves):
                m["workloads"].append(cell["name"])
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
