"""The port's train path against the JAX package's, on the CPU in fp32.

Same weights (carried by the weight bridge), same numpy inputs, and
all-keep dropout on both sides: `jax.random` and `torch.Generator` draw
different masks from one seed, so the JAX side has `jax.random.bernoulli`
patched to return all-True before the step is traced (flax's Dropout and
`_mha_ref` both call it) and the port has `ops.dropout.dropout_mask`
patched the same way. The 1 / (1 - rate) scaling still applies on both
sides, so the comparison covers it. The port's real masks are tested
apart.

Tolerances and why:
  * losses at rtol 1e-5: fp32 through the same formulas in another
    summation order;
  * step-1 ERN gradients at rtol 1e-4 and an atol of 1e-4 times the
    tensor's largest element: each element is a sum over the batch and
    the network of terms of the tensor's magnitude (the temperature of
    100 makes them large), so the summation-order error scales with that
    magnitude, not with the element's own;
  * ERN parameters after 3 steps at atol 0.25 · lr: Adam divides each
    gradient by its own running RMS, so a gradient component that is
    small against its rounding error moves by up to one lr per step in
    whatever direction the rounding gave it. Some parameters have an
    exact gradient of zero by a symmetry of the model (`ZERO_GRAD`):
    there both sides' gradients are rounding noise (checked as such), and
    the parameters are held to Adam's bound, 2 · steps · lr;
  * BatchNorm running statistics at atol 1e-5 (averages of fp32
    activations), except the running means behind a zero-gradient bias,
    which carry that bias: at steps · lr;
  * schedules at rtol 1e-6 (JAX evaluates them in fp32).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fashionern_aaai2024_tpu.models.clip import config as jax_config
from fashionern_aaai2024_tpu.models.ern import fusion as jax_fusion
from fashionern_aaai2024_tpu.ops.losses import batch_based_classification_loss as jax_bbc
from fashionern_aaai2024_tpu.train import schedule as JSched
from fashionern_aaai2024_tpu.train import step as JStep
from fashionern_aaai2024_tpu.train.state import create_train_state as jax_create_state
from fashionern_aaai2024_tpu_torch.models import convert
from fashionern_aaai2024_tpu_torch.models.clip import config as torch_config
from fashionern_aaai2024_tpu_torch.models.ern import fusion as torch_fusion
from fashionern_aaai2024_tpu_torch.ops import dropout as TD
from fashionern_aaai2024_tpu_torch.train import schedule as TSched
from fashionern_aaai2024_tpu_torch.train import step as TStep
from fashionern_aaai2024_tpu_torch.train.state import (
    create_train_state,
    trainable_param_count,
)
from torch_port_helpers import (
    CTX,
    D,
    PATCH_NUM,
    jax_model_and_variables,
    port_model,
    small_config,
)

torch.set_num_threads(2)

LR = 1e-3
GRAD_ATOL = 1e-4
T_MAX = 40
STEPS = 3
B = 8


def _keep_all_jax(key, p=0.5, shape=None, *args, **kwargs):
    return jnp.ones(() if shape is None else shape, bool)


def _keep_all_torch(shape, keep, generator, device):
    return torch.ones(shape, dtype=torch.bool, device=device)


def _batches(kind: str, n: int = STEPS, b: int = B, seed: int = 0) -> list[dict]:
    g = np.random.default_rng(seed)
    f = np.float32
    out = []
    for _ in range(n):
        batch = {"ref_patch": g.standard_normal((b, PATCH_NUM, D)).astype(f),
                 "tar_patch": g.standard_normal((b, PATCH_NUM, D)).astype(f)}
        if kind == "image":
            batch["ref_image"] = g.random((b, 32, 32, 3), dtype=f)
            batch["tar_image"] = g.random((b, 32, 32, 3), dtype=f)
        else:
            batch["ref_feats"] = g.standard_normal((b, D)).astype(f)
            batch["tar_feats"] = g.standard_normal((b, D)).astype(f)
        if kind == "features":
            batch["text_feats"] = g.standard_normal((b, D)).astype(f)
            batch["text_seq_feats"] = g.standard_normal((b, CTX, D)).astype(f)
        else:
            batch["text_ids"] = g.integers(1, 100, (b, CTX)).astype(np.int32)
        out.append(batch)
    return out


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


JAX_BUILDERS = {"image": JStep.build_train_step,
                "cached": JStep.build_cached_image_train_step,
                "features": JStep.build_feature_train_step}
PORT_BUILDERS = {"image": TStep.build_train_step,
                 "cached": TStep.build_cached_image_train_step,
                 "features": TStep.build_feature_train_step}


def _jax_run(kind: str):
    jm, variables = jax_model_and_variables(small_config(jax_config))
    opt = optax.adam(JSched.cosine_annealing_schedule(LR, T_MAX))
    state = jax_create_state(variables, opt, jax.random.PRNGKey(0))
    step = JAX_BUILDERS[kind](jm, opt, negatives="local", local_groups=1, donate=False)
    states, losses = [state], []
    for batch in _batches(kind):
        state, loss = step(state, batch)
        states.append(state)
        losses.append(float(loss))
    return jm, variables, states, losses


def _port_run(kind: str, variables):
    model = port_model(small_config(torch_config), variables)
    state = create_train_state(model, seed=0)
    step = PORT_BUILDERS[kind](model, TSched.cosine_annealing_schedule(LR, T_MAX))
    clip_before = {k: v.clone() for k, v in model.clip.state_dict().items()}
    losses, grads = [], None
    for batch in _batches(kind):
        state, loss = step(state, _torch_batch(batch))
        losses.append(loss.item())
        if grads is None:
            grads = {n: p.grad.clone() for n, p in model.ern.named_parameters()
                     if p.grad is not None}
    return state, losses, grads, clip_before


@functools.cache
def _runs(kind: str) -> dict:
    """Both trajectories of one step builder, 3 steps each."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", _keep_all_jax)
        mp.setattr(TD, "dropout_mask", _keep_all_torch)
        jm, variables, jstates, jlosses = _jax_run(kind)
        state, losses, grads, clip_before = _port_run(kind, variables)
    return dict(kind=kind, jm=jm, variables=variables, jstates=jstates, jlosses=jlosses,
                state=state, losses=losses, grads=grads, clip_before=clip_before)


@pytest.fixture(params=["image", "cached", "features"])
def runs(request):
    return _runs(request.param)


@pytest.fixture
def image_runs():
    return _runs("image")


def _ern_sd(jstate) -> dict:
    return convert.ern_state_dict(jstate.ern_params, jstate.batch_stats["ern"])


# Parameters whose exact gradient is zero: biases that shift every score
# of a softmax alike (BERT's and MR's key biases, VisualSR's scorer bias),
# and the Linear biases ahead of a train-mode BatchNorm over the batch
# axis, whose batch mean removes them.
ZERO_GRAD = ("attention.self.key.bias", "embedding_common.bias", "embedding_global.0.bias")


def _zero_grad_mask(name: str, shape) -> np.ndarray:
    mask = np.zeros(shape, bool)
    if name.endswith(ZERO_GRAD):
        mask[...] = True
    elif name.endswith("MR_component.in_proj_bias"):
        d = shape[0] // 3
        mask[d:2 * d] = True          # the key third of the packed bias
    return mask


def test_step_losses_match_jax(runs):
    np.testing.assert_allclose(runs["losses"], runs["jlosses"], rtol=1e-5, atol=0)


def test_first_step_gradients_match_jax(image_runs):
    """The JAX gradients of step 1, taken from the same loss function the
    JAX step differentiates (model.apply in train mode, then BBC)."""
    runs = image_runs
    jm, v0 = runs["jm"], runs["jstates"][0]
    batch = _batches("image")[0]

    def loss_of(ern_params):
        variables = {"params": {"clip": v0.clip_params, "ern": ern_params},
                     "batch_stats": v0.batch_stats}
        (fusion, target), _ = jm.apply(
            variables, batch["ref_image"], batch["tar_image"], batch["text_ids"],
            batch["ref_patch"], batch["tar_patch"], deterministic=False,
            method=jm.train_forward, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_bbc(fusion, target)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", _keep_all_jax)
        jgrads = jax.grad(loss_of)(v0.ern_params)
    want = convert.ern_state_dict(jgrads, v0.batch_stats["ern"])
    got = runs["grads"]
    scale = max(np.abs(want[n].numpy()).max() for n in got)
    names = [n for n, _ in runs["state"].model.ern.named_parameters()]
    # the pooler feeds no output of the DVR tower (the reference keeps
    # only the last hidden state): JAX gives it zero gradient, torch none
    assert sorted(set(names) - set(got)) == [
        "DVR.transformer_layer.bert_encoder.bert_model.pooler.dense.bias",
        "DVR.transformer_layer.bert_encoder.bert_model.pooler.dense.weight"]
    for name in names:
        w = want[name].numpy()
        if name not in got:
            assert not w.any(), name
            continue
        g = got[name].numpy()
        noise = _zero_grad_mask(name, w.shape)
        assert np.abs(g[noise]).max(initial=0) < 1e-6 * scale, name
        assert np.abs(w[noise]).max(initial=0) < 1e-6 * scale, name
        np.testing.assert_allclose(g[~noise], w[~noise], atol=GRAD_ATOL * np.abs(w).max(),
                                   rtol=1e-4, err_msg=name)


def test_params_after_three_steps_match_jax(runs):
    _assert_params_close(runs["state"].model.ern.state_dict(), _ern_sd(runs["jstates"][-1]),
                         runs["state"].model, STEPS)


def _assert_params_close(got: dict, want: dict, model, steps: int) -> None:
    for name, _ in model.ern.named_parameters():
        g, w = got[name].numpy(), want[name].numpy()
        noise = _zero_grad_mask(name, w.shape)
        np.testing.assert_allclose(g[~noise], w[~noise], atol=0.25 * LR, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(g[noise], w[noise], atol=2 * steps * LR, rtol=0,
                                   err_msg=name)


def test_batchnorm_stats_after_three_steps_match_jax(runs):
    want = _ern_sd(runs["jstates"][-1])
    got = runs["state"].model.ern.state_dict()
    keys = [k for k in got if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 8
    for k in keys:
        behind_zero_grad_bias = k.endswith("embedding_global.1.running_mean")
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=STEPS * LR if behind_zero_grad_bias else 1e-5,
                                   rtol=0, err_msg=k)
        assert not np.array_equal(got[k].numpy(), _ern_sd(runs["jstates"][0])[k].numpy())


def test_clip_unchanged_and_ern_moved(runs):
    model = runs["state"].model
    for k, v in model.clip.state_dict().items():
        assert torch.equal(v, runs["clip_before"][k]), k
    assert all(not p.requires_grad for p in model.clip.parameters())
    start = _ern_sd(runs["jstates"][0])
    moved = [n for n, p in model.ern.named_parameters()
             if not np.array_equal(p.detach().numpy(), start[n].numpy())]
    assert len(moved) == len(list(model.ern.parameters())) - 2  # all but the pooler
    assert runs["state"].step == STEPS


def test_bridge_carries_a_jax_train_state(image_runs):
    """Two JAX steps, carried across, then one more step on each side."""
    runs = image_runs
    jstate2 = runs["jstates"][2]
    model = port_model(small_config(torch_config), runs["variables"])
    state = create_train_state(model, seed=0)
    convert.load_jax_train_state(state, jstate2, small_config(torch_config))
    assert state.step == 2
    adam = jstate2.opt_state[0]
    mu = convert.ern_state_dict(adam.mu, jstate2.batch_stats["ern"])
    for i, (name, p) in enumerate(model.ern.named_parameters()):
        st = state.optimizer.state[p]
        assert st["step"].item() == 2
        np.testing.assert_array_equal(st["exp_avg"].numpy(), mu[name].numpy())
    step = TStep.build_train_step(model, TSched.cosine_annealing_schedule(LR, T_MAX))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TD, "dropout_mask", _keep_all_torch)
        _, loss = step(state, _torch_batch(_batches("image")[2]))
    np.testing.assert_allclose(loss.item(), runs["jlosses"][2], rtol=1e-5)
    _assert_params_close(model.ern.state_dict(), _ern_sd(runs["jstates"][3]), model, 1)


def test_trainable_param_count_matches_jax(image_runs):
    from fashionern_aaai2024_tpu.train.state import trainable_param_count as jax_count

    assert trainable_param_count(image_runs["state"]) == jax_count(image_runs["jstates"][0])


# --- pieces -------------------------------------------------------------


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_grouped_bbc_loss_matches_jax(groups):
    g = np.random.default_rng(groups)
    p = g.standard_normal((16, D)).astype(np.float32) * 0.2
    t = g.standard_normal((16, D)).astype(np.float32) * 0.2
    want = JStep.grouped_bbc_loss(jnp.asarray(p), jnp.asarray(t), groups)
    got = TStep.grouped_bbc_loss(torch.from_numpy(p), torch.from_numpy(t), groups)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    with pytest.raises(ValueError):
        TStep.grouped_bbc_loss(torch.from_numpy(p), torch.from_numpy(t), 3)


@pytest.mark.parametrize("name,args", [
    ("cosine", (4e-5, 100)), ("cosine", (1e-3, 37, 1e-5)),
    ("warmup", (4e-5, 20, 300)), ("warmup", (1e-3, 0, 100, 1.5))])
def test_schedules_match_jax(name, args):
    fn = {"cosine": "cosine_annealing_schedule", "warmup": "warmup_cosine_schedule"}[name]
    jax_s, port_s = getattr(JSched, fn)(*args), getattr(TSched, fn)(*args)
    steps = np.arange(300)
    want = np.asarray(jax.vmap(jax_s)(jnp.asarray(steps)), np.float64)
    got = np.asarray([port_s(int(s)) for s in steps])
    np.testing.assert_allclose(got, want, atol=1e-6 * args[0], rtol=1e-6)


def _visual_sr_pair(seed=0):
    """A JAX VisualSR with its init stats replaced by non-trivial ones,
    and the port's VisualSR with the same weights and stats."""
    jmod = jax_fusion.VisualSR(D, num_region=PATCH_NUM)
    g = np.random.default_rng(seed)
    x = g.standard_normal((6, PATCH_NUM, D)).astype(np.float32) * 2 + 0.5
    v = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(seed), x))
    v = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * g.standard_normal(a.shape)).astype(np.float32), v)
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    sd = convert._visual_sr(v["params"], v["batch_stats"], "m")
    tmod = torch_fusion.VisualSR(D, num_region=PATCH_NUM)
    tmod.load_state_dict({k[2:]: t for k, t in sd.items()})
    return jmod, v, tmod, x


def test_batchnorm_train_stats_match_flax():
    """Both BatchNorms of VisualSR after one train-mode forward: the
    local one over axes (0, 2) of [B, 13, d] (n = B·d per patch), the
    global one over axis 0 of [B, d]; biased variance, momentum 0.1."""
    jmod, v, tmod, x = _visual_sr_pair()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", _keep_all_jax)
        mp.setattr(TD, "dropout_mask", _keep_all_torch)
        want, mutated = jmod.apply(v, x, deterministic=False, mutable=["batch_stats"],
                                   rngs={"dropout": jax.random.PRNGKey(1)})
        got = tmod(torch.from_numpy(x), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=0)
    stats = mutated["batch_stats"]
    for jname, tname in (("local_bn", "embedding_local.1"),
                         ("global_bn", "embedding_global.1")):
        bn = tmod.get_submodule(tname)
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(stats[jname]["bn"]["mean"]), atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(stats[jname]["bn"]["var"]), atol=1e-6)
        assert bn.num_batches_tracked.item() == 1
    # the biased batch variance, not torch.nn.BatchNorm1d's unbiased one
    lin = tmod.embedding_global[0]
    with torch.no_grad():
        h = lin(torch.from_numpy(x).mean(dim=1))
    start = v["batch_stats"]["global_bn"]["bn"]["var"]
    np.testing.assert_allclose(tmod.embedding_global[1].running_var.numpy(),
                               0.9 * start + 0.1 * h.var(dim=0, unbiased=False).numpy(),
                               atol=1e-6)


def test_batchnorm_eval_matches_flax():
    jmod, v, tmod, x = _visual_sr_pair(seed=1)
    want = jmod.apply(v, x, deterministic=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_masks(rate):
    """The port's real masks: keep fraction within 1% of 1 - p over 1e5
    draws, kept values scaled by exactly 1 / (1 - p), the rest 0, and
    the same generator seed giving the same mask."""
    x = torch.rand(100_000) + 0.5
    y = TD.dropout(x, rate, torch.Generator().manual_seed(3))
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.01
    assert torch.equal(y[kept], x[kept] / (1 - rate))
    assert torch.equal(TD.dropout(x, rate, torch.Generator().manual_seed(3)), y)
    assert not torch.equal(TD.dropout(x, rate, torch.Generator().manual_seed(4)), y)
    assert TD.dropout(x, rate, None) is x


def test_step_generator_depends_on_seed_and_step_only():
    a = torch.rand(8, generator=TStep.step_generator(7, 3, torch.device("cpu")))
    b = torch.rand(8, generator=TStep.step_generator(7, 3, torch.device("cpu")))
    c = torch.rand(8, generator=TStep.step_generator(7, 4, torch.device("cpu")))
    d = torch.rand(8, generator=TStep.step_generator(8, 3, torch.device("cpu")))
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)


def test_mha_dropout_matches_mha_ref_keep_all():
    from fashionern_aaai2024_tpu.ops.attention import _mha_ref
    from fashionern_aaai2024_tpu_torch.ops.attention import multi_head_attention

    g = np.random.default_rng(5)
    q, k, v = (g.standard_normal((2, 8, 11, 8)).astype(np.float32) for _ in range(3))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", _keep_all_jax)
        mp.setattr(TD, "dropout_mask", _keep_all_torch)
        want = _mha_ref(*(jnp.asarray(a) for a in (q, k, v)), None, 8 ** -0.5,
                        0.1, jax.random.PRNGKey(0))
        got = multi_head_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                   dropout_rate=0.1, generator=torch.Generator())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
