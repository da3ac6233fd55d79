"""Each cell's control comes out not correct: the reference one precision
step below the configuration (bf16 parts on fp8 operands, fp32 parts on
bf16), in the program's place. At each cell's own size on the card
(marked `cuda`, three seeds, under a minute a seed), and at the
fixture sizes on the CPU."""

from __future__ import annotations

import json

import pytest
import torch

from cirbench import harness
from cirbench.spec import Spec
from cirbench.tests.fixture import fixture_root

BENCH = Spec().bench
CONTROLS = [(w, Spec().limits(w)["control"]) for w in BENCH["workloads"]]
FIXTURE_CONTROLS = [("tiny-vit.embed", "reference_lower"), ("tiny-rn.embed", "reference_lower"),
                    ("tiny-vit.query", "reference_lower"), ("tiny-vit.train", "reference_lower")]


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return Spec(fixture_root(tmp_path_factory.mktemp("controls")))


@pytest.mark.parametrize("cell,control", FIXTURE_CONTROLS)
def test_the_control_fails_at_the_fixture_size(spec, cell, control):
    result = harness.execute(cell, 2**31 + 5, 0.5, False, device="cpu", spec=spec,
                             control=control)
    assert not result["correct"], json.dumps(result["checks"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control at the cell's own size runs on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell,control", [(w["name"], c) for w, c in CONTROLS])
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 202, 2**31 + 303])
def test_the_control_fails_at_the_cell_size(card, cell, control, seed):
    result = harness.execute(cell, seed, 2.0, False, device=card, control=control)
    assert not result["correct"], json.dumps(result["checks"])
