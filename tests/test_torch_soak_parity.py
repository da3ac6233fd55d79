"""The port's Trainer against the JAX package's, on the accuracy soak's
fixtures (ROADMAP C16): one init, every dropout unit kept.

Soak legs C (CIRR) and E (FashionIQ with TME) of the port trailed the
JAX legs. This holds the two train paths together where those legs
differ from leg B: both packages' `Trainer`s, built from one JAX init
(carried into the port by `models/convert.py`), train a few epochs with
`--cache-features` on the fixture that `make-fixture --learnable` writes
for the leg, with `jax.random.bernoulli` and the port's
`ops/dropout.py dropout_mask` patched to keep every unit (the two
libraries draw different masks from one seed). Held:

  * every step's loss at rtol 2e-4 (`tests/test_e2e_parity.py:147`'s
    end-to-end tolerance: fp32 through the same formulas in another
    summation order, compounded by Adam over the steps);
  * the top-k gallery ids of every validation query, before training and
    after every epoch, equal (captured from each package's
    `retrieval/evaluate.py _search_ids`), and so the validation metrics.

So the train path matches the reference. Both Trainers also run from
their own seeded inits with nothing carried over (the port's
`models/composed.py jax_init_`, JAX's `Trainer._init_variables`), and
that init, which the soak's legs start from, is held to flax's own here
too (`tests/test_torch_init.py` holds it at every structure).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionern_aaai2024_tpu.models.clip import config as jax_config
from fashionern_aaai2024_tpu.parallel.mesh import create_mesh
from fashionern_aaai2024_tpu.retrieval import engine as JEngine
from fashionern_aaai2024_tpu.train import trainer as JT
from fashionern_aaai2024_tpu_torch.models.clip import config as torch_config
from fashionern_aaai2024_tpu_torch.ops import dropout as TD
from fashionern_aaai2024_tpu_torch.retrieval import engine as TEngine
from fashionern_aaai2024_tpu_torch.tools.make_fixture import make_fixture
from fashionern_aaai2024_tpu_torch.train import trainer as TT
from torch_port_helpers import D, crc_tokenizer, jax_model_and_variables, port_model, small_config

torch.set_num_threads(2)

LOSS_RTOL = 2e-4
NAME = "soak-parity"


def _config(module, tme: bool):
    cfg = dataclasses.replace(small_config(module), name=NAME)
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, tme=True)) if tme else cfg


def _recording(trainer, losses: list):
    inner = trainer.step_fn

    def step(state, batch):
        state, loss = inner(state, batch)
        losses.append(float(loss))
        return state, loss
    trainer.step_fn = step


def _trainers_agree(tmp_path, monkeypatch, dataset: str, tme: bool, own_init: bool):
    """Both Trainers on the leg's fixture with every unit kept: from one
    JAX init carried into the port, or (`own_init`) each from its own
    seeded default init."""
    monkeypatch.setitem(jax_config._CONFIGS, NAME, _config(jax_config, False))
    monkeypatch.setitem(torch_config._CONFIGS, NAME, _config(torch_config, False))
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None, *a, **k:
                        jnp.ones(() if shape is None else shape, bool))
    monkeypatch.setattr(TD, "dropout_mask", lambda shape, keep, generator, device:
                        torch.ones(shape, dtype=torch.bool, device=device))
    ranks = {"jax": [], "port": []}
    for tag, module in (("jax", JEngine), ("port", TEngine)):
        inner = module.RetrievalIndex.topk_ids

        def topk_ids(self, idx, inner=inner, tag=tag):
            ids = inner(self, idx)
            ranks[tag].append(np.asarray(ids))
            return ids
        monkeypatch.setattr(module.RetrievalIndex, "topk_ids", topk_ids)

    root = make_fixture(str(tmp_path / "fx"), dataset, dim=D, n_images=16, n_triplets=32,
                        learnable=True)
    if own_init:
        jm = variables = tm = None
    else:
        jm, variables = jax_model_and_variables(_config(jax_config, tme))
        tm = port_model(_config(torch_config, tme), variables)
    common = dict(dataset=dataset, data_root=root, clip_model_name=NAME,
                  activation="quick_gelu", batch_size=8, num_epochs=2, lr=1e-3,
                  validation_frequency=1, print_frequency=1000, num_workers=0, seed=7,
                  eval_batch_size=8, cache_features=True, tme=tme)
    jtr = JT.Trainer(JT.TrainConfig(ckpt_dir=str(tmp_path / "jck"), **common),
                     mesh=create_mesh(1), model=jm, variables=variables, tokenizer=crc_tokenizer)
    ttr = TT.Trainer(TT.TrainConfig(ckpt_dir=str(tmp_path / "tck"), **common),
                     device="cpu", model=tm, tokenizer=crc_tokenizer)
    losses = {"jax": [], "port": []}
    metrics = {"jax": [], "port": []}
    for tag, tr in (("jax", jtr), ("port", ttr)):
        _recording(tr, losses[tag])
        validator = tr.validator

        def validate(api, validator=validator, tag=tag):
            metric, detail = validator(api)
            metrics[tag].append((metric, detail))
            return metric, detail
        tr.validator = validate
        tr.validate(-1)
    untrained = {tag: list(r) for tag, r in ranks.items()}
    jtr.train()
    ttr.train()

    assert len(losses["port"]) == len(losses["jax"]) == 2 * ttr.steps_per_epoch > 0
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=LOSS_RTOL)
    # the untrained evals rank every gallery item alike (one search per
    # dress type on FashionIQ)
    assert len(untrained["port"]) == len(untrained["jax"]) == (3 if dataset == "fashioniq" else 1)
    for got, want in zip(untrained["port"], untrained["jax"]):
        np.testing.assert_array_equal(got, want)
    # then the validation after each epoch: every recall of every split
    assert len(metrics["port"]) == len(metrics["jax"]) == 3
    assert metrics["port"] == metrics["jax"]


@pytest.mark.parametrize("dataset,tme", [("cirr", False), ("fashioniq", True)],
                         ids=["leg_C_cirr", "leg_E_fashioniq_tme"])
def test_trainers_agree_from_one_init_with_every_unit_kept(tmp_path, monkeypatch, dataset,
                                                           tme):
    _trainers_agree(tmp_path, monkeypatch, dataset, tme, own_init=False)


def test_trainers_agree_from_their_own_seeded_inits(tmp_path, monkeypatch):
    """Leg C's Trainers, each building its own default init from the run's
    seed (7, the soak's): nothing is carried between the packages."""
    _trainers_agree(tmp_path, monkeypatch, "cirr", False, own_init=True)


def test_flax_init_draws_the_jax_init():
    """The JAX package's whole seeded init (`ComposedCIRModel.init` itself)
    against the port's draw of it (`models/composed.py jax_init_`, the
    soak's and the Trainer's default), at the small TME config: the same
    tensors, each value within 4 float32 ulps of its own."""
    import jax_init_recipe

    from fashionern_aaai2024_tpu_torch.models import convert
    from fashionern_aaai2024_tpu_torch.models.composed import ComposedCIRModel, jax_init_

    jcfg, tcfg = _config(jax_config, True), _config(torch_config, True)
    want = convert.state_dict_from_variables(
        jax.tree_util.tree_map(np.asarray, jax_init_recipe.jax_init(jcfg, 7)), tcfg)
    got = jax_init_(ComposedCIRModel(tcfg), 7).state_dict()
    assert sorted(got) == sorted(want)
    assert any(k.startswith("ern.TME.") for k in got)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        w, g = w.numpy(), got[k].numpy()
        assert g.shape == w.shape, k
        assert (np.abs(g - w) <= 4 * np.spacing(np.abs(w))).all(), k
