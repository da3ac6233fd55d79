"""The comparison zoo's seeded init in the port (`models/zoo/__init__.py
jax_init_`, `seeded_zoo_model`, each zoo module's `flax_variables`)
against the JAX package's own: `get_zoo_model(name, **kw).init(
jax.random.PRNGKey(seed), *inputs)`, with the key flax hands each
initializer recorded by wrapping `flax.core.scope.Scope.param`.

Held for every name of the registry at `tests/test_torch_zoo.py`'s small
widths (D = 16; CompoDiff at dim 32, depth 2, 4 heads of 16) and inputs,
at seeds 0, 7, 42 and 2^31 - 1:
  * the table lists every variable of flax's tree, with its shape and
    initializer, and each parameter's key equals flax's word for word;
  * every value of the draw equals flax's: zeros, ones and constants
    exactly, random draws within 4 float32 ulps
    (`tests/test_torch_init.py`'s rule), and the seeded model holds them
    under the port's names;
  * the JAX module's `apply` under its own init equals the port's
    forward after `jax_init_`, at `tests/test_torch_zoo.py`'s tolerances
    (fp32 atol 2e-5; AMC's second layer 5e-5; CompoDiff 2e-4, guided call
    too).
VTF: flax draws `text_mlp_shared` apart from `text_mlp`, and the port
holds one `text_mlp` (ROADMAP C28). Its gates are softmaxes over one
logit, so the JAX module under its own (unshared) init gives the port's
outputs, in eval and in train mode (every dropout keeping everything on
both sides), and gradients: zero on every gate MLP.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_zoo_init.py -q
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import scope as flax_scope

import jax_init_recipe
from fashionern_aaai2024_tpu.models import zoo as JZ
from fashionern_aaai2024_tpu_torch.models import convert as C
from fashionern_aaai2024_tpu_torch.models import init as I
from fashionern_aaai2024_tpu_torch.models import zoo as TZ
from fashionern_aaai2024_tpu_torch.ops import dropout as TD
from test_torch_init import assert_values_match, flat
from test_torch_zoo import ATOL, D, _compodiff_args, _inputs

torch.set_num_threads(2)

SEEDS = (0, 7, 42, 2 ** 31 - 1)
COMPODIFF = dict(dim=32, depth=2, dim_head=16, heads=4, text_cond_dim=48, mask_hw=8)
COMPODIFF_ATOL, AMC_L1_ATOL = 2e-4, 5e-5
# registry name -> (the JAX constructor's keywords, the port's)
COMBINER = dict(clip_feature_dim=D, projection_dim=4 * D, hidden_dim=8 * D)
KWARGS = {
    "clip4cir_combiner": (COMBINER, COMBINER),
    "vtf": (COMBINER, COMBINER),
    "attention_pooling": (dict(emb_dim=D, emb_num=7),) * 2,
    "cala": (dict(embedding_dim=D),) * 2,
    "artemis": (dict(clip_feature_dim=D),) * 2,
    "dqu_cir": (dict(hidden_dim=24), dict(clip_feature_dim=D, hidden_dim=24)),
    "amc": (dict(embed_size=D, hid_router=8),) * 2,
    "amc_ensemble": (dict(embed_size=D),) * 2,
    "compodiff": (COMPODIFF, COMPODIFF),
}
VTF_GATES = ("image_mlp", "text_mlp", "text_mlp_shared")


def inputs(name: str, seed: int) -> list:
    rng = np.random.default_rng(seed)
    if name == "compodiff":
        return [*_compodiff_args(rng), rng.standard_normal((2, 7, 48)).astype(np.float32)]
    return _inputs(name, rng)


def init_args(name: str, x: list) -> list:
    """The arguments of the JAX module's `init` call (CompoDiff's
    unconditional text is for the guided call only)."""
    return x[:5] if name == "compodiff" else x


def spec_of(init_fn, value) -> dict:
    """`jax_init_recipe.init_spec`, and a constant for a lambda that makes
    one (ARTEMIS's `temperature`)."""
    try:
        return jax_init_recipe.init_spec(init_fn)
    except ValueError:
        value = np.asarray(value)
        assert (value == value.flat[0]).all(), init_fn
        return I.constant(value.flat[0])


def flax_init(name: str, seed: int, record: list | None = None) -> dict:
    """`JZ.get_zoo_model(name, **kw).init(PRNGKey(seed), *inputs)`; with
    `record`, each parameter's (path, initializer, key words, shape) is
    appended as flax creates it."""
    orig = flax_scope.Scope.param

    def param(self, pname, init_fn, *args, **kwargs):
        def traced(key, *a, **k):
            value = init_fn(key, *a, **k)
            if not isinstance(key, jax.core.Tracer):   # not flax's shape re-check
                record.append(("/".join(self.path + (pname,)), spec_of(init_fn, value),
                               [int(w) for w in np.asarray(jax.random.key_data(key))],
                               list(np.shape(value))))
            return value
        return orig(self, pname, traced if record is not None else init_fn, *args, **kwargs)

    module = JZ.get_zoo_model(name, **KWARGS[name][0])
    flax_scope.Scope.param = param
    try:
        variables = module.init(jax.random.PRNGKey(seed), *init_args(name, inputs(name, seed)))
    finally:
        flax_scope.Scope.param = orig
    return jax.tree_util.tree_map(np.asarray, variables)


@pytest.fixture(scope="module")
def flax_inits():
    """(name, seed) -> (flax's record, flax's variables), each made once."""
    cache = {}

    def get(name, seed):
        if (name, seed) not in cache:
            record: list = []
            cache[name, seed] = record, flax_init(name, seed, record)
        return cache[name, seed]
    return get


def port_model(name: str, seed: int):
    return TZ.seeded_zoo_model(name, seed, "cpu", **KWARGS[name][1]).eval()


def one_text_mlp(variables: dict) -> dict:
    """VTF's flax variables with `text_mlp_shared` replaced by `text_mlp`,
    as `jax_init_` drops that draw."""
    p = dict(variables["params"])
    for i in (0, 3):
        p[f"text_mlp_shared_{i}"] = p[f"text_mlp_{i}"]
    return {**variables, "params": p}


CASES = [pytest.param(name, seed, id=f"{name}-seed{seed}") for name in KWARGS for seed in SEEDS]


def test_every_registry_name_is_held():
    assert sorted(KWARGS) == sorted(TZ._ZOO) == sorted(JZ._ZOO)


@pytest.mark.parametrize("name,seed", CASES)
def test_every_key_is_flax_key(flax_inits, name, seed):
    record, variables = flax_inits(name, seed)
    with torch.device("meta"):
        model = TZ.get_zoo_model(name, **KWARGS[name][1])
    table = model.flax_variables()
    params = {"/".join(v.path): v for v in table}
    assert len(params) == len(table) == len(record) > 0
    for path, spec, key, shape in record:
        v = params[path]
        assert list(I.variable_key(seed, v)) == key, path
        assert list(v.shape) == shape, path
        assert v.init == spec, path
    assert sorted(f"{v.collection}/{'/'.join(v.path)}" for v in table) == sorted(flat(variables))


@pytest.mark.parametrize("name,seed", CASES)
def test_every_value_is_flax_value(flax_inits, name, seed):
    _, variables = flax_inits(name, seed)
    model = port_model(name, seed)
    assert_values_match(flat(I.variables(model.flax_variables(), seed, "cpu")), flat(variables))
    # and the model holds them, in the port's names and layouts
    if name == "vtf":
        variables = one_text_mlp(variables)
    expected = C.ZOO_STATE_DICTS[name](variables)
    got = model.state_dict()
    assert sorted(got) == sorted(expected)
    assert_values_match({k: v.numpy() for k, v in got.items()},
                        {k: v.numpy() for k, v in expected.items()})


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("name,seed", CASES)
def test_forward_is_the_jax_forward(flax_inits, name, seed):
    """The JAX module under its own init (VTF's unshared) against the port
    after `jax_init_`, on the same inputs."""
    _, variables = flax_inits(name, seed)
    jm = JZ.get_zoo_model(name, **KWARGS[name][0])
    tm = port_model(name, seed)
    x = inputs(name, seed)
    tx = [torch.from_numpy(a) for a in x]
    with torch.no_grad():
        if name == "amc":
            got, want = tm(*tx), jm.apply(variables, *x)
            for i, (g, w) in enumerate(zip(got, want)):
                _close(g, w, atol=AMC_L1_ATOL if i % 2 else ATOL)
        elif name == "artemis":
            for broadcast in (False, True):
                _close(tm(*tx, broadcast=broadcast), jm.apply(variables, *x, broadcast=broadcast))
        elif name == "compodiff":
            _close(tm(*tx[:5]), jm.apply(variables, *x[:5]), atol=COMPODIFF_ATOL)
            _close(tm.forward_with_cond_scale(*tx, cond_scale=(1.5, 7.5)),
                   jm.apply(variables, *x, (1.5, 7.5), method=jm.forward_with_cond_scale),
                   atol=COMPODIFF_ATOL)
        else:
            _close(tm(*tx), jm.apply(variables, *x))


def _keep_all_jax(key, p=0.5, shape=None, *args, **kwargs):
    return jnp.ones(() if shape is None else shape, bool)


def _keep_all_torch(shape, keep, generator, device):
    return torch.ones(shape, dtype=torch.bool, device=device)


@pytest.mark.parametrize("seed", SEEDS)
def test_vtf_train_mode_reads_no_shared_draw(flax_inits, monkeypatch, seed):
    """VTF in train mode, every dropout keeping everything (scaled by 2) on
    both sides: JAX under its own unshared init against the port after
    `jax_init_`, the output and every parameter's gradient of <out, up>;
    the gate MLPs' gradients are zero on both sides, `text_mlp_shared`'s
    among them."""
    monkeypatch.setattr(jax.random, "bernoulli", _keep_all_jax)
    monkeypatch.setattr(TD, "dropout_mask", _keep_all_torch)
    _, variables = flax_inits("vtf", seed)
    jm = JZ.get_zoo_model("vtf", **KWARGS["vtf"][0])
    x = inputs("vtf", seed)
    up = np.random.default_rng(seed + 1).standard_normal((x[0].shape[0], 2 * D)).astype(
        np.float32)

    def jax_loss(params):
        out = jm.apply({"params": params}, *x, deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(seed)})
        return jnp.sum(out * up), out

    (_, want), grads = jax.value_and_grad(jax_loss, has_aux=True)(variables["params"])
    grads = jax.tree_util.tree_map(np.asarray, grads)
    for gate in VTF_GATES:
        for i in (0, 3):
            for leaf in grads[f"{gate}_{i}"].values():
                assert not leaf.any(), gate

    tm = port_model("vtf", seed).train()
    out = tm(*(torch.from_numpy(a) for a in x), generator=torch.Generator().manual_seed(seed))
    _close(out, want)
    (out * torch.from_numpy(up)).sum().backward()
    want_grads = C.vtf_state_dict({"params": grads})
    for k, p in tm.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        _close(got, want_grads[k], atol=ATOL)
