"""The port's seeded init (`models/init.py`, `models/composed.py
jax_init_`) against the JAX package's own: `ComposedCIRModel.init` under
`PRNGKey(seed)`, as its Trainer, CLI and multiprocess demo call it
(`tests/jax_init_recipe.py jax_init`, which records the key flax hands
each initializer).

Held, for the structures of ViT-B-16 and RN50x4, each with and without
TME (every layer, head and module, at small widths), at seeds 0, 7, 42
and 2^31 - 1:
  * the table (`flax_variables`) lists every variable of flax's tree,
    with its shape and initializer, and each parameter's key equals
    flax's, word for word;
  * every value of `jax_init_` equals flax's: zeros, ones and constants
    exactly, random draws within 4 float32 ulps
    (`tests/test_torch_soak_parity.py`'s rule);
and the entry points that draw it: the port's `Trainer` without a
model (JAX `Trainer._init_variables`), `cli.load_model_variables` (JAX's
own) and the multiprocess demo (JAX `multiprocess.py:146`, `PRNGKey(0)`).
"""

import dataclasses
import hashlib
import types

import jax
import numpy as np
import pytest
import torch
from flax.core import scope as flax_scope

import jax_init_recipe
from fashionern_aaai2024_tpu.cli.main import load_model_variables as jax_load_model_variables
from fashionern_aaai2024_tpu.models.clip import config as jax_config
from fashionern_aaai2024_tpu.models.composed import ComposedCIRModel as JaxModel
from fashionern_aaai2024_tpu.train import trainer as JT
from fashionern_aaai2024_tpu_torch.cli import main as cli
from fashionern_aaai2024_tpu_torch.models import convert
from fashionern_aaai2024_tpu_torch.models import init as I
from fashionern_aaai2024_tpu_torch.models.clip import config as torch_config
from fashionern_aaai2024_tpu_torch.models.composed import ComposedCIRModel, jax_init_
from fashionern_aaai2024_tpu_torch.parallel import multiprocess as MP
from fashionern_aaai2024_tpu_torch.parallel.mesh import create_mesh
from fashionern_aaai2024_tpu_torch.train import trainer as TT
from torch_port_helpers import PATCH_NUM, crc_tokenizer, tiny_config

torch.set_num_threads(2)

SEEDS = (0, 7, 42, 2 ** 31 - 1)
STRUCTURES = (("ViT-B-16", False), ("ViT-B-16", True), ("RN50x4", False), ("RN50x4", True))
FEATURE_DIM = 16     # the joint width: 2 a head in the ERN's 8-head attentions
PER_HEAD = 4         # the towers' width a head


def structure(module, name: str, tme: bool):
    """`name`'s configuration in `module` (either package's config) with
    every layer, head and module kept and small widths: PER_HEAD a head
    in each tower, the joint width FEATURE_DIM, a vocabulary of 100, two
    patches a side (ViT) or a 32-pixel image (the ResNet's five halvings
    to one position)."""
    cfg = module.get_clip_config(name, tme=True if tme else None)
    v = cfg.vision
    if v.kind == "vit":
        vision = dataclasses.replace(v, image_size=2 * v.patch_size, width=PER_HEAD * v.heads,
                                     embed_dim=FEATURE_DIM)
    else:   # the attention pool's width is 32 x the base width
        vision = dataclasses.replace(v, image_size=32, width=PER_HEAD * v.heads // 32,
                                     embed_dim=FEATURE_DIM)
    text = dataclasses.replace(cfg.text, vocab_size=100, width=PER_HEAD * cfg.text.heads,
                               embed_dim=FEATURE_DIM)
    return dataclasses.replace(cfg, vision=vision, text=text)


def flat(tree) -> dict:
    return {"/".join(str(k.key) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


def assert_values_match(got: dict, want: dict) -> None:
    """Every value of `got` against flax's `want` (flat trees of one set of
    paths): zeros, ones and constants exactly, draws within 4 float32
    ulps."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32, k
        if not (w - w.flat[0]).any():      # zeros, ones, a constant
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert (np.abs(g - w) <= 4 * np.spacing(np.abs(w))).all(), k


def assert_state_matches(model, variables, cfg) -> None:
    """The port model's state_dict against flax's `variables` carried onto
    the port's names by `models/convert.py` (BatchNorm step counters
    aside)."""
    expected = convert.state_dict_from_variables(
        jax.tree_util.tree_map(np.asarray, variables), cfg)
    got = model.state_dict()
    assert sorted(got) == sorted(expected)
    floats = [k for k in expected if not k.endswith("num_batches_tracked")]
    assert_values_match({k: got[k].cpu().numpy() for k in floats},
                        {k: expected[k].numpy() for k in floats})


@pytest.fixture(scope="module")
def flax_inits():
    """(structure, seed) -> (flax's record, flax's variables), each made
    once."""
    cache = {}

    def get(name, tme, seed):
        if (name, tme, seed) not in cache:
            record: list = []
            variables = jax_init_recipe.jax_init(structure(jax_config, name, tme), seed,
                                                 PATCH_NUM, record)
            cache[name, tme, seed] = record, jax.tree_util.tree_map(np.asarray, variables)
        return cache[name, tme, seed]
    return get


CASES = [pytest.param(name, tme, seed, id=f"{name}{'-tme' if tme else ''}-seed{seed}")
         for name, tme in STRUCTURES for seed in SEEDS]


@pytest.mark.parametrize("name,tme,seed", CASES)
def test_every_key_is_flax_key(flax_inits, name, tme, seed):
    record, variables = flax_inits(name, tme, seed)
    variables = flat(variables)
    with torch.device("meta"):
        model = ComposedCIRModel(structure(torch_config, name, tme), patch_num=PATCH_NUM)
    table = model.flax_variables()
    params = {"/".join(v.path): v for v in table if v.collection == "params"}
    assert len(params) == len(record) > 0
    for path, init_fn, key, shape in record:
        v = params[path]
        assert list(I.variable_key(seed, v)) == key, path
        assert list(v.shape) == shape, path
        assert v.init == jax_init_recipe.init_spec(init_fn), path
    # the batch statistics too: every variable of flax's tree is listed
    assert sorted(f"{v.collection}/{'/'.join(v.path)}" for v in table) == sorted(variables)
    assert any(p.startswith("ern/TME/") for p in params) == tme


@pytest.mark.parametrize("name,tme,seed", CASES)
def test_every_value_is_flax_value(flax_inits, name, tme, seed):
    _, tree = flax_inits(name, tme, seed)
    cfg = structure(torch_config, name, tme)
    model = jax_init_(ComposedCIRModel(cfg, patch_num=PATCH_NUM), seed)
    got = flat(I.variables(model.flax_variables(), seed, "cpu"))
    assert_values_match(got, flat(tree))
    # and the model holds them, in the port's names and layouts
    assert_state_matches(model, tree, cfg)


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 - 1, 2 ** 32 - 1, 2 ** 32 + 5, -1, -5])
def test_prng_key_and_fold_in_are_jax(seed):
    key = I.prng_key(seed)
    assert list(key) == [int(w) for w in np.asarray(jax.random.key_data(
        jax.random.PRNGKey(seed)))]
    for data in (0, 1, 0x9E3779B9, 0xFFFFFFFF):
        want = jax.random.key_data(jax.random.fold_in(jax.random.PRNGKey(seed), data))
        assert list(I.fold_in(key, data)) == [int(w) for w in np.asarray(want)]


@pytest.mark.parametrize("suffix", [("clip", 1), ("ern", "DVR", "mr", 2),
                                    ("a" * 70, 255, 256, 65536)])
def test_path_hash_is_flax_fold_in_static(suffix):
    rng = jax.random.PRNGKey(3)
    want = jax.random.key_data(flax_scope._fold_in_static(rng, suffix))
    assert list(I.fold_in(I.prng_key(3), I.path_hash(suffix))) == [
        int(w) for w in np.asarray(want)]
    digest = hashlib.sha1(b"".join(x.encode() if isinstance(x, str) else
                                   x.to_bytes((x.bit_length() + 7) // 8, "big")
                                   for x in suffix)).digest()
    assert I.path_hash(suffix) == int.from_bytes(digest[:4], "big")


@pytest.mark.parametrize("spec,shape", [
    (I.normal(0.02), (3, 1000)), (I.LECUN_NORMAL, (64, 96)), (I.XAVIER_UNIFORM, (96, 32)),
    (I.variance_scaling(2.0, "fan_out", "normal"), (5, 5, 8, 16)),
    (I.dense_general_kernel(I.LECUN_NORMAL, 1, 2), (24, 4, 6)),
    (I.dense_general_kernel(I.LECUN_NORMAL, 2, 1), (4, 6, 24))])
def test_initializers_draw_jax_values_across_chunks(monkeypatch, spec, shape):
    """Each initializer kind against JAX's own, with chunks of 1,000
    values so that draws cross chunk boundaries."""
    monkeypatch.setattr(I, "CHUNK", 1000)
    key = jax.random.PRNGKey(11)
    words = tuple(int(w) for w in np.asarray(jax.random.key_data(key)))
    inits = jax.nn.initializers
    if spec["kind"] == "normal":
        fn = inits.normal(spec["stddev"])
    elif spec["kind"] == "variance_scaling":
        fn = inits.variance_scaling(spec["scale"], spec["mode"], spec["distribution"])
    else:
        na, nf = spec["n_axis"], spec["n_features"]
        fn = (lambda k, s: inits.lecun_normal()(
            k, (int(np.prod(s[:na])), int(np.prod(s[-nf:])))).reshape(s))
    want = np.asarray(fn(key, shape))
    got = I.initialize(spec, words, shape, "cpu").numpy()
    assert_values_match({"x": got}, {"x": want})


@pytest.mark.parametrize("spec,shape", [
    (I.ZEROS, (7, 5)), (I.ONES, (40,)), (I.constant(2.65926), (1,)),
    (I.normal(0.02), (3, 1000)), (I.XAVIER_UNIFORM, (96, 32)),
    (I.dense_general_kernel(I.LECUN_NORMAL, 2, 1), (4, 6, 24)),
    (I.dense_general_bias(I.ZEROS, 2), (4, 6))])
def test_flat_values_are_the_draw_at_any_range(monkeypatch, spec, shape):
    """`flat_values` on a range of flat indices equals that range of the
    whole chunked draw, bit for bit."""
    monkeypatch.setattr(I, "CHUNK", 1000)
    key = (5, 77)
    whole = I.initialize(spec, key, shape, "cpu").reshape(-1)
    n = whole.numel()
    for start, stop in {(0, n), (0, min(n, 3)), (max(0, n - 1001), n), (n // 3, n // 2)}:
        assert torch.equal(I.flat_values(spec, key, shape, start, stop, "cpu"),
                           whole[start:stop])


def _stub_trainer(jcfg, **cfg) -> types.SimpleNamespace:
    return types.SimpleNamespace(cfg=JT.TrainConfig(**cfg), clip_cfg=jcfg,
                                 model=JaxModel(jcfg, patch_num=cfg["patch_num"]))


@pytest.mark.parametrize("seed", [0, 7])
def test_trainer_without_a_model_draws_the_jax_trainer_init(monkeypatch, tmp_path, seed):
    """The port's Trainer without a model against JAX
    `Trainer._init_variables` on the same config (a tiny registered one)."""
    name = "init-tiny"
    monkeypatch.setitem(jax_config._CONFIGS, name,
                        dataclasses.replace(tiny_config(jax_config), name=name))
    monkeypatch.setitem(torch_config._CONFIGS, name,
                        dataclasses.replace(tiny_config(torch_config), name=name))
    common = dict(dataset="fashioniq", clip_model_name=name, batch_size=2, seed=seed,
                  patch_num=PATCH_NUM, activation="gelu", ckpt_dir=str(tmp_path))
    want = JT.Trainer._init_variables(_stub_trainer(jax_config.get_clip_config(name), **common))
    trainer = TT.Trainer(TT.TrainConfig(**common), device="cpu",
                         train_dataset=[{}] * 2, validator=lambda api: (0.0, {}),
                         tokenizer=crc_tokenizer)
    assert_state_matches(trainer.model, want, trainer.clip_cfg)


@pytest.mark.parametrize("seed", [None, 3])
def test_cli_load_model_variables_is_the_jax_cli(seed):
    """`cli.load_model_variables` with no checkpoint against the JAX
    CLI's (seed None: the default, 42)."""
    _, want = jax_load_model_variables(tiny_config(jax_config), None, None, PATCH_NUM,
                                       seed=seed)
    cfg = tiny_config(torch_config)
    model = cli.load_model_variables(cfg, None, None, PATCH_NUM, seed=seed, device="cpu")
    assert_state_matches(model, want, cfg)


def test_multiprocess_demo_draws_the_jax_demo_init():
    """The demo program's model against the JAX demo's init
    (`PRNGKey(0)` on its `demo_config`, `multiprocess.py:146-148`)."""
    from fashionern_aaai2024_tpu.parallel import multiprocess as JMP

    program = MP.DemoProgram(create_mesh(device="cpu"))
    assert_state_matches(program.model, jax_init_recipe.jax_init(JMP.demo_config(), 0),
                         program.cfg)
