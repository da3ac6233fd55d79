"""`BENCHMARK.json` and the files it names, found by name.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell sits in a file of its own under the benchmark's folder,
found from the names in `BENCHMARK.json`:
  * a configuration: the `file` its entry names (`configs/<name>.json`);
  * a traffic mix: `traffic/<traffic>.json`, the parameters of one window,
    whose "driver" names the general generator that reads it,
    `drivers/<driver>.py`;
  * a per-layer metric: `metrics/<metric name>.py`, whose `read(traced)`
    returns the metric's value or None where it finds nothing to read;
    where there is no such file, `metrics/<the name up to its first
    dot>.py`, the reader that metrics split by cell share
    (`idle_share.embed` and `idle_share.query` read by `idle_share.py`);
  * a cell's correctness limits: `limits/<workload name>.json`.
A new configuration, mix, metric or cell is new files and new entries,
never an edit of a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


class Spec:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / BENCH_DIR.name
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        entry = next(c for c in self.bench["configs"] if c["name"] == cell["config"])
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, cell: dict) -> dict:
        return json.loads((self.dir / "traffic" / f"{cell['traffic']}.json").read_text())

    def limits(self, cell: dict) -> dict:
        return json.loads((self.dir / "limits" / f"{cell['name']}.json").read_text())

    def driver(self, traffic: dict) -> ModuleType:
        return _load(self.dir / "drivers" / f"{traffic['driver']}.py")

    def reader(self, metric: dict) -> ModuleType:
        own = self.dir / "metrics" / f"{metric['name']}.py"
        shared = self.dir / "metrics" / f"{metric['name'].split('.')[0]}.py"
        return _load(own if own.is_file() else shared)

    def end_to_end(self, cell: dict) -> list[dict]:
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or cell["name"] in m["workloads"]]

    def per_layer(self, cell: dict) -> list[dict]:
        reported = {m["name"] for m in self.end_to_end(cell)}

        def applies(m: dict) -> bool:
            return cell["name"] in m["workloads"] if "workloads" in m else m["moves"] in reported
        return [m for m in self.bench["per_layer"] if applies(m)]


def _load(path: Path) -> ModuleType:
    """A module of the benchmark by its file (names may hold dots)."""
    key = f"cirbench_file.{path.parent.name}.{path.stem}"
    if key in sys.modules and getattr(sys.modules[key], "__file__", None) == str(path):
        return sys.modules[key]
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module
