"""Whole runs of the fixture cells on the CPU (the harness's look for a card
skipped), sound and with the timed path broken underneath: `correct` has
to hold on the sound run and come out false under each fault the cell
can have."""

from __future__ import annotations

import pytest
import torch

from cirbench import harness
from cirbench.spec import Spec
from cirbench.tests.fixture import fixture_root

SEED = 2**31 + 77


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return Spec(fixture_root(tmp_path_factory.mktemp("faults")))


def run(spec: Spec, cell: str) -> dict:
    return harness.execute(cell, SEED, 0.5, False, device="cpu", spec=spec)


@pytest.mark.parametrize("cell", ["tiny-vit.embed", "tiny-rn.embed", "tiny-vit.query",
                                  "tiny-vit.train"])
def test_a_sound_run_is_correct(spec, cell):
    result = run(spec, cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0


def altered_row(self, *args, **kwargs):
    out = ORIGINAL["refine_gallery"](self, *args, **kwargs).clone()
    out[0] = out[1]
    return out


def half_batch(self, images):
    g, tokens = ORIGINAL["encode_image"](self, images[: (len(images) + 1) // 2])
    reps = -(-len(images) // len(g))
    return g.repeat(reps, 1)[:len(images)], tokens.repeat(reps, 1, 1)[:len(images)]


def altered_answer(self, *args, **kwargs):
    scores, rows = ORIGINAL["__call__"](self, *args, **kwargs)
    rows = rows.copy()
    rows[:, 0] = (rows[:, 0] + 1) % self.n_valid()
    return scores, rows


def altered_token(self, captions):
    ids = ORIGINAL["tokenize"](self, captions).copy()
    ids[:, 1] = ids[:, 2]
    return ids


def unchanged_state(self, closure=None):
    return None


def half_batch_loss(predicted, target, **kwargs):
    half = predicted.shape[0] // 2
    return ORIGINAL["batch_based_classification_loss"](predicted[:half], target[:half], **kwargs)


def altered_train_token(self, texts, context_length=77):
    ids = ORIGINAL["SimpleTokenizer.__call__"](self, texts, context_length).copy()
    ids[:, 1] = ids[:, 2]
    return ids


def _originals():
    from fashionern_aaai2024_tpu_torch.retrieval.evaluate import InferenceAPI, ServeFn
    from fashionern_aaai2024_tpu_torch.tokenizer import SimpleTokenizer
    from fashionern_aaai2024_tpu_torch.train import step

    return {"refine_gallery": (InferenceAPI, InferenceAPI.refine_gallery),
            "encode_image": (InferenceAPI, InferenceAPI.encode_image),
            "__call__": (ServeFn, ServeFn.__call__),
            "tokenize": (InferenceAPI, InferenceAPI.tokenize),
            "step": (torch.optim.Adam, torch.optim.Adam.step),
            "batch_based_classification_loss": (step, step.batch_based_classification_loss),
            "SimpleTokenizer.__call__": (SimpleTokenizer, SimpleTokenizer.__call__)}


ORIGINAL: dict = {}
FAULTS = [("tiny-vit.embed", "refine_gallery", altered_row),
          ("tiny-vit.embed", "encode_image", half_batch),
          ("tiny-rn.embed", "refine_gallery", altered_row),
          ("tiny-rn.embed", "encode_image", half_batch),
          ("tiny-vit.query", "__call__", altered_answer),
          ("tiny-vit.query", "tokenize", altered_token),
          ("tiny-vit.train", "step", unchanged_state),
          ("tiny-vit.train", "batch_based_classification_loss", half_batch_loss),
          ("tiny-vit.train", "SimpleTokenizer.__call__", altered_train_token)]


@pytest.mark.parametrize("cell,target,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, _, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(spec, monkeypatch, cell, target, fault):
    owner, original = _originals()[target]
    ORIGINAL[target] = original
    monkeypatch.setattr(owner, target.split(".")[-1], fault)
    result = run(spec, cell)
    assert not result["correct"], result["checks"]
