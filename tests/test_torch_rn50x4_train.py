"""The RN50x4 tiers of the train path, the int8 tier and TME, against the
JAX package on the CPU (ROADMAP A4b), at `resnet_config` size: the
modified ResNet (one bottleneck a stage) with its attention pool.

  * RN50x4 through the train step: the frozen ResNet keeps its running
    statistics in train mode (`models/clip/resnet.py FrozenBatchNorm2d`)
    on both sides, and 3 fp32 steps (all-keep dropout, one init through
    the bridge) agree with JAX's: the losses at rtol 2e-5 (the module
    tolerance; the steps' fp32 sums in another order), the ERN
    parameters at atol 0.25 lr (`tests/test_torch_train.py`'s Adam
    bound: every element within 2 steps lr, at most 1e-4 of them beyond
    0.25 lr). Under the bf16 train
    policy (`train/state.py cast_frozen_clip_bf16`, which like JAX's
    `state.py:63-79` also casts the ResNet's BatchNorm statistics) the
    towers hold bf16 and a step's loss agrees with JAX's bf16 step at
    rtol 2e-2 (bf16 towers: each side rounds its own convolution sums).
  * The int8 text tower at RN50x4's width W = 640 (10 heads of 64:
    kernel B6's branch; B5's hidden in `pick_splits(2560)` = 2 groups of
    1,280, a group width no earlier path ran): encode_text and the DVR
    query against JAX's quantized towers, fp32 tolerance up to one
    flipped int8 code (`tests/test_torch_int8.py`).
  * TME at RN50x4's d = 640 (8 heads of 80, B9's head-dim-80 route): the
    module against JAX's, and 2 train steps of a TME model at d = 640
    whose losses agree at rtol 2e-5 and whose TME parameters (moved by
    `MHAFunction`'s backward) agree in units of lr as above.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fashionern_aaai2024_tpu.models.clip import config as jax_config
from fashionern_aaai2024_tpu.models.ern.tme import TMEModule as JaxTME
from fashionern_aaai2024_tpu.models import composed as jax_composed
from fashionern_aaai2024_tpu.models.clip import transformer as JTransformer
from fashionern_aaai2024_tpu.ops import mlp as JMlp
from fashionern_aaai2024_tpu.ops import qmlp as JQ
from fashionern_aaai2024_tpu.train import schedule as JSched
from fashionern_aaai2024_tpu.train import state as JState
from fashionern_aaai2024_tpu.train import step as JStep
from fashionern_aaai2024_tpu_torch.models import convert
from fashionern_aaai2024_tpu_torch.models.clip import config as torch_config
from fashionern_aaai2024_tpu_torch.models.clip.resnet import FrozenBatchNorm2d
from fashionern_aaai2024_tpu_torch.models.ern.tme import TMEModule
from fashionern_aaai2024_tpu_torch.ops import dropout as TD
from fashionern_aaai2024_tpu_torch.ops import qmlp as TQ
from fashionern_aaai2024_tpu_torch.train import schedule as TSched
from fashionern_aaai2024_tpu_torch.train import step as TStep
from fashionern_aaai2024_tpu_torch.train.state import cast_frozen_clip_bf16, create_train_state
from test_torch_int8 import F32_TOL, _b5, _mlp_inputs, assert_close_up_to_flips
from test_torch_tme import _with_tme_weights
from test_torch_train import _zero_grad_mask
from torch_port_helpers import (
    CTX,
    D,
    PATCH_NUM,
    crc_tokenizer,
    jax_model_and_variables,
    port_model,
    resnet_config,
    to_np,
)

torch.set_num_threads(2)

LR = 1e-3
T_MAX = 40
B = 8
W = 640          # RN50x4's text width and joint dim


def _keep_all_jax(key, p=0.5, shape=None, *args, **kwargs):
    return jnp.ones(() if shape is None else shape, bool)


def _keep_all_torch(shape, keep, generator, device):
    return torch.ones(shape, dtype=torch.bool, device=device)


@pytest.fixture
def keep_all(monkeypatch):
    monkeypatch.setattr(jax.random, "bernoulli", _keep_all_jax)
    monkeypatch.setattr(TD, "dropout_mask", _keep_all_torch)


def _wide(module, *, tme=False, quantize=False):
    """`resnet_config` with RN50x4's text tower width (640, 10 heads of 64)
    and joint dim 640; TME and the int8 blocks on request."""
    cfg = resnet_config(module)
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, embed_dim=W),
                              text=dataclasses.replace(cfg.text, width=W, heads=10,
                                                       embed_dim=W, tme=tme))
    return dataclasses.replace(cfg, quantize_mlp=True) if quantize else cfg


def _wide_models(**kw):
    """Both models of `_wide(**kw)` from one JAX init (patches of width W)."""
    cfg = _wide(jax_config, **kw)
    jm = jax_composed.ComposedCIRModel(cfg, patch_num=PATCH_NUM)
    rng = jax.random.PRNGKey(0)
    z = np.zeros
    variables = jm.init({"params": rng, "dropout": rng}, z((2, 64, 64, 3), np.float32),
                        z((2, 64, 64, 3), np.float32), z((2, CTX), np.int32),
                        z((2, PATCH_NUM, W), np.float32), z((2, PATCH_NUM, W), np.float32),
                        deterministic=False, method=jm.train_forward)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    if kw.get("tme"):
        variables = _with_tme_weights(variables)
    return jm, variables, port_model(_wide(torch_config, **kw), variables)


def _batches(d: int, n: int, seed: int = 0) -> list[dict]:
    g = np.random.default_rng(seed)
    f = np.float32
    return [{"ref_image": g.random((B, 64, 64, 3), dtype=f),
             "tar_image": g.random((B, 64, 64, 3), dtype=f),
             "text_ids": g.integers(1, 100, (B, CTX)).astype(np.int32),
             "ref_patch": g.standard_normal((B, PATCH_NUM, d)).astype(f),
             "tar_patch": g.standard_normal((B, PATCH_NUM, d)).astype(f)}
            for _ in range(n)]


def _torch_batch(batch: dict, dtype=torch.float32) -> dict:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        out[k] = t.long() if v.dtype == np.int32 else (t.to(dtype) if "image" in k else t)
    return out


def _run_both(jm, variables, model, batches, bf16=False):
    """The JAX and the port train steps over `batches` from one init."""
    opt = optax.adam(JSched.cosine_annealing_schedule(LR, T_MAX))
    jstate = JState.create_train_state(variables, opt, jax.random.PRNGKey(0))
    state = create_train_state(model, seed=0)
    if bf16:
        jstate = JState.cast_frozen_clip_bf16(jstate)
        cast_frozen_clip_bf16(state)
    jstep = JStep.build_train_step(jm, opt, negatives="local", local_groups=1, donate=False)
    step = TStep.build_train_step(model, TSched.cosine_annealing_schedule(LR, T_MAX))
    jlosses, losses = [], []
    for batch in batches:
        jb = dict(batch)
        if bf16:
            jb["ref_image"] = jnp.asarray(batch["ref_image"], jnp.bfloat16)
            jb["tar_image"] = jnp.asarray(batch["tar_image"], jnp.bfloat16)
        jstate, jloss = jstep(jstate, jb)
        jlosses.append(float(jloss))
        state, loss = step(state, _torch_batch(batch, torch.bfloat16 if bf16 else torch.float32))
        losses.append(loss.item())
    return jstate, state, jlosses, losses


def _ern_params_close(state, jstate, steps, names=None):
    """The ERN parameters (those under `names`) in units of lr, as
    `tests/test_torch_tme.py` holds them: Adam moves an element whose
    gradient is small against its fp32 rounding by up to one lr a step in
    whatever direction the rounding gave it, so every element is held to
    2 * steps * lr, and at most 1e-4 of those whose exact gradient is not
    zero (`tests/test_torch_train.py ZERO_GRAD`) may sit beyond 0.25 * lr."""
    want = convert.ern_state_dict(jstate.ern_params, jstate.batch_stats["ern"])
    beyond, total = 0, 0
    for name, p in state.model.ern.named_parameters():
        if names is not None and not name.startswith(names):
            continue
        g, w = p.detach().numpy(), want[name].numpy()
        np.testing.assert_allclose(g, w, atol=2 * steps * LR, rtol=0, err_msg=name)
        err = np.abs(g - w)[~_zero_grad_mask(name, w.shape)]
        beyond += int((err > 0.25 * LR).sum())
        total += err.size
    assert beyond <= 1e-4 * total, (beyond, total)


def test_rn50x4_train_steps_match_jax(keep_all):
    jm, variables = jax_model_and_variables(resnet_config(jax_config))
    model = port_model(resnet_config(torch_config), variables)
    stats = {k: v.clone() for k, v in model.clip.visual.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    assert len(stats) > 0
    jstate, state, jlosses, losses = _run_both(jm, variables, model, _batches(D, 3))
    np.testing.assert_allclose(losses, jlosses, rtol=2e-5, atol=0)
    _ern_params_close(state, jstate, 3)
    # the frozen ResNet's BatchNorm keeps its running statistics in train mode
    for k, v in model.clip.visual.state_dict().items():
        if k in stats:
            assert torch.equal(v, stats[k]), k
    jvis = jax.tree_util.tree_leaves(jstate.batch_stats["clip"])
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: bool(np.array_equal(np.asarray(a), np.asarray(b))),
        jstate.batch_stats["clip"], variables["batch_stats"]["clip"]))
    assert jvis


def test_rn50x4_bf16_train_policy_matches_jax(keep_all):
    """`cast_frozen_clip_bf16`: every tower tensor of the ResNet, its
    BatchNorm statistics included, in bf16 (JAX casts `batch_stats["clip"]`
    too); the ERN, Adam and the loss stay fp32; a step agrees with JAX's."""
    jm, variables = jax_model_and_variables(resnet_config(jax_config))
    model = port_model(resnet_config(torch_config), variables)
    jstate, state, jlosses, losses = _run_both(jm, variables, model, _batches(D, 2),
                                               bf16=True)
    bns = [m for m in model.clip.visual.modules() if isinstance(m, FrozenBatchNorm2d)]
    assert bns and all(m.running_mean.dtype == m.running_var.dtype == m.weight.dtype
                       == torch.bfloat16 for m in bns)
    assert all(p.dtype == torch.float32 for p in model.ern.parameters())
    assert all(np.asarray(a).dtype == jnp.bfloat16
               for a in jax.tree_util.tree_leaves(jstate.batch_stats["clip"]))
    assert np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses, jlosses, rtol=2e-2, atol=0)


def test_pick_splits_at_rn50x4_width():
    """RN50x4's MLP hidden (2,560) quantizes in 2 groups of 1,280, as the
    Pallas kernel's rule gives it."""
    assert TQ.pick_splits(4 * W) == JMlp._pick_splits(4 * W) == 2
    assert TQ.hidden_groups(4 * W, "quick_gelu") == 2


@pytest.mark.parametrize("b", [1, 3])
def test_int8_mlp_at_rn50x4_width_matches_the_pallas_kernel(b):
    """B5's plain version at W = 640, F = 2,560 (2 hidden groups of 1,280)
    against the JAX Pallas kernel in interpret mode."""
    got, kernel, _ = _b5(_mlp_inputs(b, CTX, W, 4 * W, seed=b), "fp32", "quick_gelu")
    assert_close_up_to_flips(got, kernel, rows=1, step=1e-2)


def test_int8_text_tower_and_query_at_rn50x4_width_match_jax(monkeypatch):
    """The JAX tower with its int8 sub-blocks forced onto the Pallas
    kernels (interpret mode), which the port follows (ROADMAP C5: off the
    TPU JAX runs `_qmlp_ref`, which quantizes the hidden in whole rows
    where the kernel takes 2 groups at this width)."""
    for name in ("int8_mlp_subblock", "int8_attention_subblock"):
        monkeypatch.setattr(JTransformer, name, functools.partial(
            getattr(JQ, name), force_pallas=True, interpret=True))
    jm, variables, model = _wide_models(quantize=True)
    g = np.random.default_rng(7)
    ids = crc_tokenizer(["make it red", "longer sleeves and darker", "in blue"])
    ref = g.standard_normal((3, W)).astype(np.float32)
    patch = g.standard_normal((3, PATCH_NUM, W)).astype(np.float32)
    jtg, jts = jm.apply(variables, jnp.asarray(ids), method=jm.encode_text)
    jq = jm.apply(variables, jnp.asarray(ref), jnp.asarray(patch), jtg, jts, method=jm.query)
    with torch.no_grad():
        tg, ts = model.encode_text(torch.from_numpy(ids).long())
        q = model.query(torch.from_numpy(ref), torch.from_numpy(patch), tg, ts)
    assert_close_up_to_flips(to_np(tg), np.asarray(jtg), rows=1, step=2e-2)
    assert_close_up_to_flips(to_np(ts), np.asarray(jts), rows=1, step=2e-2)
    assert_close_up_to_flips(to_np(q), np.asarray(jq), rows=1, step=2e-2)


def test_tme_module_at_rn50x4_dim_matches_jax():
    g = np.random.default_rng(3)
    text = g.standard_normal((3, CTX, W)).astype(np.float32)
    vis = g.standard_normal((3, PATCH_NUM, W)).astype(np.float32)
    jm = JaxTME(W)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(3), text, vis))
    v = {"params": _with_tme_weights({"params": {"ern": {"TME": v["params"]}}}, 3)
         ["params"]["ern"]["TME"]}
    tm = TMEModule(W)
    assert tm.cross_attn.heads == 8 and W // tm.cross_attn.heads == 80
    tm.load_state_dict({k[2:]: t for k, t in convert._tme(v["params"], "m").items()})
    want = np.asarray(jm.apply(v, text, vis))
    with torch.no_grad():
        got = tm(torch.from_numpy(text), torch.from_numpy(vis))
    np.testing.assert_allclose(to_np(got), want, **F32_TOL)


def test_tme_train_steps_at_rn50x4_dim_match_jax(keep_all):
    jm, variables, model = _wide_models(tme=True)
    tme_before = {n: p.detach().clone() for n, p in model.ern.TME.named_parameters()}
    jstate, state, jlosses, losses = _run_both(jm, variables, model, _batches(W, 2))
    np.testing.assert_allclose(losses, jlosses, rtol=2e-5, atol=0)
    _ern_params_close(state, jstate, 2, names="TME.")
    assert all(not torch.equal(p.detach(), tme_before[n])
               for n, p in model.ern.TME.named_parameters())
