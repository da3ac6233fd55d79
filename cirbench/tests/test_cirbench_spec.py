"""`BENCHMARK.json` against the benchmark's contract, its files found by
name, cells added from fixtures, and the runs that must refuse."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

from cirbench.spec import BENCH_DIR, ROOT, Spec
from cirbench.tests.fixture import fixture_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_names_and_units_follow_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == [BENCH_DIR.name] and BENCH["command"][1].startswith(BENCH_DIR.name)
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_its_files_by_name(cell):
    spec = Spec()
    w = spec.cell(cell)
    assert w["chips"] == 1 and len(w["why"]) <= 200
    config = spec.config(w)
    assert config["name"] == w["config"] and config["reduced"] == []
    traffic = spec.traffic(w)
    assert hasattr(spec.driver(traffic), "Driver")
    assert spec.limits(w)["limits"]
    e2e = {m["name"] for m in spec.end_to_end(w)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = spec.per_layer(w)
    assert layers
    for m in layers:
        assert m["moves"] in e2e and callable(spec.reader(m).read)


def test_a_cell_added_from_fixtures_needs_no_edit(tmp_path):
    root = fixture_root(tmp_path)
    spec = Spec(root)
    for name in ("tiny-vit.embed", "tiny-rn.embed", "tiny-vit.query"):
        w = spec.cell(name)
        assert spec.config(w)["name"] == w["config"]
        assert spec.driver(spec.traffic(w)).Driver
        assert spec.limits(w)["limits"] and spec.per_layer(w)
    for path in (BENCH_DIR).rglob("*"):
        if path.is_file() and "tests" not in path.parts and "__pycache__" not in path.parts:
            copy = root / path.relative_to(ROOT)
            assert copy.read_bytes() == path.read_bytes(), path


def _modules_after(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sys.modules))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return {m.split(".")[0] for m in out.stdout.split()}


def test_the_harness_imports_nothing_of_jax_or_the_jax_package():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from cirbench.spec import Spec\nfrom cirbench import harness, program\n"
            "s = Spec()\n"
            "for w in s.bench['workloads']:\n"
            "    c = s.cell(w['name']); s.driver(s.traffic(c))\n"
            "    [s.reader(m) for m in s.per_layer(c)]\n"
            "import fashionern_aaai2024_tpu_torch.retrieval.server, "
            "fashionern_aaai2024_tpu_torch.retrieval.evaluate\n")
    top = _modules_after(code)
    assert not top & {"jax", "jaxlib", "flax", "fashionern_aaai2024_tpu"}
    assert "fashionern_aaai2024_tpu_torch" in top


def test_the_reference_imports_nothing_of_the_port():
    top = _modules_after("import sys; sys.path.insert(0, '.')\n"
                         "import cirbench.reference, cirbench.reference.ops, "
                         "cirbench.captions, cirbench.flops, cirbench.peaks\n")
    assert not top & {"jax", "jaxlib", "flax", "fashionern_aaai2024_tpu",
                      "fashionern_aaai2024_tpu_torch"}


def test_a_run_without_a_card_fails_and_prints_no_result():
    run = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), "--workload",
                          BENCH["workloads"][0]["name"], "--seed", "3000000019", "--seconds",
                          "1", "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert run.returncode != 0
    assert "{" not in run.stdout


def test_a_run_finds_loaded_jax_modules_by_whole_name():
    from cirbench import harness

    sys.modules["fashionern_aaai2024_tpu.fake"] = sys.modules["json"]
    try:
        assert "fashionern_aaai2024_tpu.fake" in harness.forbidden_modules()
    finally:
        del sys.modules["fashionern_aaai2024_tpu.fake"]
    assert not [m for m in harness.forbidden_modules() if m.startswith("fashionern_aaai2024_tpu_torch")]
