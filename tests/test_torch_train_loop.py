"""The port's Trainer, checkpoints and host-side data modules, on the CPU.

The Trainer end to end (the port's counterpart of tests/test_train.py
`TestTrainerEndToEnd` and `TestResume`): an in-memory FashionIQ-shaped
dataset, validation each epoch, the best checkpoint with its
`.meta.json`, a killed-then-resumed run that reproduces the uninterrupted
run's per-step losses and final weights exactly, and a checkpoint round
trip. The data modules (`Loader`, the caption randomizers,
`prefetch_iter`) and `retrieval/metrics.py` against the JAX package's
copies, which they must equal.
"""

import dataclasses
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from fashionern_aaai2024_tpu.data import captions as JC
from fashionern_aaai2024_tpu.data.loader import Loader as JaxLoader
from fashionern_aaai2024_tpu.data.prefetch import prefetch_iter as jax_prefetch
from fashionern_aaai2024_tpu.retrieval import metrics as JMet
from fashionern_aaai2024_tpu_torch.data import captions as TC
from fashionern_aaai2024_tpu_torch.data.loader import Loader
from fashionern_aaai2024_tpu_torch.data.prefetch import prefetch_iter
from fashionern_aaai2024_tpu_torch.models.clip import config as torch_config
from fashionern_aaai2024_tpu_torch.models.composed import ComposedCIRModel, random_init_
from fashionern_aaai2024_tpu_torch.retrieval import metrics as TMet
from fashionern_aaai2024_tpu_torch.train import checkpoint as ckpt
from fashionern_aaai2024_tpu_torch.train.state import create_train_state
from fashionern_aaai2024_tpu_torch.train.trainer import (
    DatasetPlugin,
    TrainConfig,
    Trainer,
    _fiq_captions,
)
from fashionern_aaai2024_tpu_torch.utils.logging import MetricLogger
from fashionern_aaai2024_tpu_torch.utils.meters import AverageMeter
from torch_port_helpers import CTX, D, PATCH_NUM, crc_tokenizer, small_config

torch.set_num_threads(2)

CAPTIONS = [("is red", "has longer sleeves"), ("is darker", "more formal"),
            ("with a collar", "is shorter"), ("in blue", "has stripes")]


class SyntheticRelativeDataset:
    """FashionIQ-shaped triplets over a small universe of random images."""

    def __init__(self, n=24, seed=0):
        g = np.random.default_rng(seed)
        images = g.random((n, 32, 32, 3), dtype=np.float32)
        patches = g.standard_normal((n, PATCH_NUM, D), dtype=np.float32)
        self.items = [{
            "ref_name": f"img{i}", "tar_name": f"img{(i + 1) % n}",
            "captions": list(CAPTIONS[i % len(CAPTIONS)]),
            "ref_image": images[i], "tar_image": images[(i + 1) % n],
            "ref_patch": patches[i], "tar_patch": patches[(i + 1) % n],
        } for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _model(seed=0, tme=False):
    cfg = small_config(torch_config)
    if tme:
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, tme=True))
    return random_init_(ComposedCIRModel(cfg), torch.Generator().manual_seed(seed))


def _trainer(tmp_path, *, record_losses=None, validator=None, model_seed=0, **overrides):
    base = dict(dataset="fashioniq", clip_model_name="ViT-B-16", batch_size=4,
                num_epochs=1, lr=1e-3, num_workers=0, ckpt_dir=str(tmp_path / "ckpt"),
                print_frequency=1000, eval_batch_size=4)
    base.update(overrides)
    plugin = DatasetPlugin("synthetic", lambda c: SyntheticRelativeDataset(), _fiq_captions)
    tr = Trainer(TrainConfig(**base), device="cpu",
                 model=_model(model_seed, tme=base.get("tme", False)),
                 train_dataset=SyntheticRelativeDataset(), validator=validator,
                 plugin=plugin, tokenizer=crc_tokenizer)
    if record_losses is not None:
        inner = tr.step_fn

        def recording_step(state, batch):
            state, loss = inner(state, batch)
            record_losses.append(loss.item())
            return state, loss

        tr.step_fn = recording_step
    return tr


def test_two_epochs_with_validation(tmp_path):
    calls = []

    def validator(api):
        calls.append(1)
        g = np.random.default_rng(0)
        q = api.query(g.standard_normal((3, D)).astype(np.float32),
                      g.standard_normal((3, PATCH_NUM, D)).astype(np.float32),
                      g.standard_normal((3, D)).astype(np.float32),
                      g.standard_normal((3, CTX, D)).astype(np.float32))
        assert q.shape == (3, D) and torch.isfinite(q).all()
        return float(len(calls)), {"recall_at10": 1.0}

    tr = _trainer(tmp_path, num_epochs=2, validation_frequency=1, validator=validator,
                  log_path=str(tmp_path / "log.jsonl"))
    state = tr.train()
    assert state.step == 2 * tr.steps_per_epoch == 12
    assert len(calls) == 2
    assert tr.best.best_metric == 2.0
    assert os.path.exists(tr.best.best_path)
    with open(tr.best.best_path + ".meta.json") as f:
        meta = json.load(f)
    assert meta == {"init_seed": 42, "clip_model_name": "ViT-B-16", "tme": False,
                    "clip_from_checkpoint": False, "metric": 2.0}
    best = ckpt.restore_params(tr.best.best_path)
    for k, v in tr.model.ern.state_dict().items():
        assert torch.equal(best[k], v), k
    logged = [json.loads(line) for line in open(tmp_path / "log.jsonl")]
    assert [r["val_metric"] for r in logged if "val_metric" in r] == [1.0, 2.0]
    assert all(np.isfinite(r["epoch_loss"]) for r in logged if "epoch_loss" in r)


def test_resume_continuation_parity(tmp_path):
    """A run killed mid-epoch and resumed from its checkpoint gives the
    uninterrupted run's per-step losses and final weights bit for bit:
    data order (epoch-seeded shuffle, `iter_batches(skip)`), captions
    (per-step rng), dropout (per-step generator) and Adam / schedule /
    BatchNorm (restored state) together."""

    class Kill(Exception):
        pass

    control_losses: list = []
    control = _trainer(tmp_path, num_epochs=2, seed=7, record_losses=control_losses,
                       ckpt_dir=str(tmp_path / "c"))
    control.train()
    total, spe = control.global_step, control.steps_per_epoch
    kill_at = spe + spe // 2 + 1
    assert 0 < kill_at < total

    first: list = []
    tr = _trainer(tmp_path, num_epochs=2, seed=7, record_losses=first,
                  ckpt_dir=str(tmp_path / "a"))
    inner = tr.step_fn

    def killing_step(state, batch):
        if tr.global_step >= kill_at:
            raise Kill
        return inner(state, batch)

    tr.step_fn = killing_step
    with pytest.raises(Kill):
        tr.train()
    path = tr.save_resume_checkpoint()

    second: list = []
    tr2 = _trainer(tmp_path, num_epochs=2, seed=7, record_losses=second,
                   ckpt_dir=str(tmp_path / "b"), resume_path=path, model_seed=99)
    state2 = tr2.train()
    assert state2.step == total
    assert first + second == control_losses
    for k, v in control.model.state_dict().items():
        assert torch.equal(state2.model.state_dict()[k], v), k


def test_checkpoint_round_trip_restores_the_state_exactly(tmp_path):
    tr = _trainer(tmp_path, num_epochs=1)
    tr.train()
    tr.best.best_metric = 0.75
    path = tr.save_resume_checkpoint()
    assert os.path.isfile(path) and os.path.isfile(path + ".frozen")
    fresh = _trainer(tmp_path, num_epochs=1, resume_path=path, model_seed=5)
    assert fresh.maybe_resume()
    assert fresh.global_step == fresh.state.step == tr.state.step
    assert fresh.best.best_metric == 0.75
    for k, v in tr.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    a, b = tr.state.optimizer.state_dict(), fresh.state.optimizer.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i, st in a["state"].items():
        for key, t in st.items():
            assert torch.equal(b["state"][i][key], t), (i, key)


def test_frozen_towers_written_once_per_fingerprint(tmp_path):
    state = create_train_state(_model(), seed=0)
    path = str(tmp_path / "s")
    written: dict = {}
    ckpt.save_state(path, state, frozen_fingerprint="seed=0", frozen_written=written)
    assert written == {os.path.abspath(path) + ".frozen": "seed=0"}
    os.utime(path + ".frozen", ns=(0, 0))
    ckpt.save_state(path, state, frozen_fingerprint="seed=0", frozen_written=written)
    assert os.stat(path + ".frozen").st_mtime_ns == 0        # skipped
    ckpt.save_state(path, state, frozen_fingerprint="seed=1", frozen_written=written)
    assert os.stat(path + ".frozen").st_mtime_ns != 0        # rewritten
    full = str(tmp_path / "full")
    ckpt.save_state(full, state, frozen="full")
    assert not os.path.exists(full + ".frozen")
    other = create_train_state(_model(seed=3), seed=1)
    ckpt.restore_state(full, other)
    for k, v in state.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k


def test_best_checkpointer(tmp_path):
    bc = ckpt.BestCheckpointer(str(tmp_path / "ckpt"), "fiq")
    assert bc.update(10.0, {"w": torch.ones(2, 2)})
    assert not bc.update(9.0, {"w": torch.zeros(2, 2)})
    assert bc.update(11.0, {"w": 2 * torch.ones(2, 2)}, meta={"init_seed": 1})
    assert torch.equal(ckpt.restore_params(bc.best_path)["w"], 2 * torch.ones(2, 2))
    assert ckpt.load_meta(bc.best_path) == {"init_seed": 1, "metric": 11.0}


@pytest.mark.parametrize("cache_features", [False, True])
def test_trainer_trains_with_tme(tmp_path, cache_features):
    """`TrainConfig(tme=True)` trains: TME's parameters move (the
    out-projection included), CLIP does not, the losses are finite, and
    the best checkpoint's sidecar records tme. A model built without TME
    is refused."""
    losses = []
    tr = _trainer(tmp_path, record_losses=losses, tme=True, cache_features=cache_features,
                  validator=lambda api: (1.0, {}))
    tme_before = {n: p.detach().clone() for n, p in tr.model.ern.TME.named_parameters()}
    clip_before = {k: v.clone() for k, v in tr.model.clip.state_dict().items()}
    tr.train()
    assert len(losses) == tr.steps_per_epoch and np.all(np.isfinite(losses))
    for n, p in tr.model.ern.TME.named_parameters():
        assert not torch.equal(p.detach(), tme_before[n]), n
    for k, v in tr.model.clip.state_dict().items():
        assert torch.equal(v, clip_before[k]), k
    assert ckpt.load_meta(tr.best.best_path)["tme"] is True
    with pytest.raises(ValueError, match="tme"):
        Trainer(TrainConfig(tme=True, num_workers=0, ckpt_dir=str(tmp_path)), device="cpu",
                model=_model(), train_dataset=SyntheticRelativeDataset(),
                plugin=DatasetPlugin("s", lambda c: None, _fiq_captions),
                tokenizer=crc_tokenizer)


def test_trainer_raises_on_a_mesh_and_on_missing_datasets(tmp_path):
    class Mesh:
        devices = np.empty((2, 4), object)

    cfg = TrainConfig(dataset="fashioniq", num_workers=0, ckpt_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="A8"):
        Trainer(cfg, device="cpu", mesh=Mesh(), model=_model(), tokenizer=crc_tokenizer)
    with pytest.raises(NotImplementedError, match="dataset class.*A9"):
        Trainer(cfg, device="cpu", model=_model(), tokenizer=crc_tokenizer)
    with pytest.raises(NotImplementedError, match="evaluator"):
        Trainer(cfg, device="cpu", model=_model(), tokenizer=crc_tokenizer,
                train_dataset=SyntheticRelativeDataset())
    # a one-device mesh is the default path
    Trainer(cfg, device="cpu", mesh=[torch.device("cpu")], model=_model(),
            tokenizer=crc_tokenizer, train_dataset=SyntheticRelativeDataset(),
            plugin=DatasetPlugin("s", lambda c: None, _fiq_captions))


def test_cached_features_match_the_image_step(tmp_path):
    """`cache_features` encodes each unique image once; the steps then
    see the same globals as the image step computes."""
    a, b = [], []
    _trainer(tmp_path, record_losses=a).train()
    tr = _trainer(tmp_path, record_losses=b, cache_features=True)
    tr.train()
    assert len(tr._feature_cache) == 24
    np.testing.assert_allclose(b, a, rtol=1e-5)


# --- the data modules against the JAX package's copies -----------------


@pytest.mark.parametrize("skip", [0, 2])
@pytest.mark.parametrize("epoch", [0, 3])
def test_loader_matches_jax(epoch, skip):
    ds = SyntheticRelativeDataset(n=23)
    want = JaxLoader(ds, 4, shuffle=True, seed=5, drop_last=True, num_workers=0)
    got = Loader(ds, 4, shuffle=True, seed=5, drop_last=True, num_workers=2)
    want.set_epoch(epoch)
    got.set_epoch(epoch)
    assert len(got) == len(want) == 5
    pairs = list(zip(got.iter_batches(skip), want.iter_batches(skip), strict=True))
    assert len(pairs) == 5 - skip
    for g, w in pairs:
        assert g["ref_name"] == w["ref_name"] and g["captions"] == w["captions"]
        np.testing.assert_array_equal(g["ref_image"], w["ref_image"])


def test_caption_randomizers_match_jax():
    flat = [c for pair in CAPTIONS * 5 for c in pair]
    for seed in range(5):
        assert (TC.generate_randomized_fiq_caption(flat, random.Random(f"7:{seed}"))
                == JC.generate_randomized_fiq_caption(flat, random.Random(f"7:{seed}")))
    assert TC.generate_shoes_caption(flat) == JC.generate_shoes_caption(flat)


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_iter_matches_jax(depth):
    fn = lambda i, x: (i, x * 2)
    assert list(prefetch_iter(range(9), fn, depth=depth)) == list(
        jax_prefetch(range(9), fn, depth=depth))

    def failing():
        yield 1
        raise KeyError("boom")

    with pytest.raises(KeyError):
        list(prefetch_iter(failing(), None, depth=depth))


def test_metrics_match_jax():
    g = np.random.default_rng(0)
    ks = (1, 5, 10, 50)
    # distinct ids (one positive) and ids drawn with repeats (multi-positive)
    for topk in (np.stack([g.permutation(60)[:55] for _ in range(20)]),
                 g.integers(0, 60, (20, 55))):
        target = g.integers(0, 60, 20)
        got = TMet.recall_at_k(topk, target, ks)
        assert got == JMet.recall_at_k(topk, target, ks)
        assert got[50] == 100.0 * np.mean((topk[:, :50] == target[:, None]).any(axis=1))


def test_meter_and_logger(tmp_path):
    m = AverageMeter("loss")
    m.update(torch.tensor(2.0), 3)
    m.update(4.0, 1)
    assert m.avg == 2.5
    lines = []

    class Sink:
        def write(self, s):
            lines.append(s)

        def flush(self):
            pass

    log = MetricLogger(tmp_path / "m.jsonl", stream=Sink())
    log.log(step=3, loss=torch.tensor(1.5), name="x")
    log.close()
    rec = json.loads(open(tmp_path / "m.jsonl").read())
    assert rec["step"] == 3 and rec["loss"] == 1.5 and rec["name"] == "x"
    assert "loss=1.5000" in "".join(lines)


def test_port_imports_nothing_of_jax_optax_or_orbax():
    """Every module of the port, the train path included, imports with
    jax, flax, optax, orbax and the JAX package made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'orbax.checkpoint',\n"
        "             'fashionern_aaai2024_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import fashionern_aaai2024_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(' '.join(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    for name in ("train.trainer", "train.step", "train.checkpoint", "ops.losses",
                 "data.loader", "retrieval.metrics", "utils.logging"):
        assert f"fashionern_aaai2024_tpu_torch.{name}" in mods


def test_profile_dir_writes_a_trace_of_steps_two_to_four(tmp_path):
    tr = _trainer(tmp_path, profile_dir=str(tmp_path / "prof"))
    tr.train()
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"train_step/towers", "train_step/bbc_loss", "train_step/adam"} <= names
