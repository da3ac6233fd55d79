"""The TME path of the port (`tme=True`) against the JAX package's, on
the CPU.

TME (`models/ern/tme.py`) conditions the frozen text tower's token
features on the reference patches: a LayerNorm (kernel B11), a
cross-attention of 8 heads (kernel B9, `multi_head_attention`) and a
residual. JAX zero-initializes its out-projection, so every JAX model
here gets seeded nonzero TME weights first (`_with_tme_weights`): with
the zero init TME would be the identity and the tests would hold
nothing.

Covered: the module at 2e-5 in fp32; flax's LayerNorm eps (1e-6) and
variance; dtype promotion under the train policy (bf16 token features,
fp32 parameters: fp32 output from bf16-rounded patches, at 2e-5) and the
bf16 serve policy (all bf16: B9 keeps fp32 scores where flax rounds them,
ROADMAP C8, so held by cosine); `encode_text` with and without
`visual_emb`; the serve slice (`InferenceAPI` + `RetrievalService`)
against the JAX service at 2e-4 with identical names; 3 train steps of
the image and cached-image step builders against JAX's with all-keep
dropout (losses at rtol 1e-5, the step-1 TME gradients, parameters in
units of lr, with the tolerances of tests/test_torch_train.py); the
feature step bypassing TME; the bridge of TME parameters and Adam
moments, exact; and checkpoints that refuse a model whose `tme` differs.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fashionern_aaai2024_tpu.data.loader import Loader
from fashionern_aaai2024_tpu.models.clip import config as jax_config
from fashionern_aaai2024_tpu.models.ern.tme import TMEModule as JaxTME
from fashionern_aaai2024_tpu.ops.losses import batch_based_classification_loss as jax_bbc
from fashionern_aaai2024_tpu.retrieval import evaluate as JE
from fashionern_aaai2024_tpu.retrieval.server import RetrievalService as JaxService
from fashionern_aaai2024_tpu.train import schedule as JSched
from fashionern_aaai2024_tpu.train import step as JStep
from fashionern_aaai2024_tpu.train.state import create_train_state as jax_create_state
from fashionern_aaai2024_tpu_torch.models import convert
from fashionern_aaai2024_tpu_torch.models.clip import config as torch_config
from fashionern_aaai2024_tpu_torch.models.composed import (
    ComposedCIRModel,
    apply_precision,
    random_init_,
)
from fashionern_aaai2024_tpu_torch.models.ern.tme import TME_LN_EPS, TMEModule
from fashionern_aaai2024_tpu_torch.ops import dropout as TD
from fashionern_aaai2024_tpu_torch.ops.layernorm import layer_norm
from fashionern_aaai2024_tpu_torch.retrieval.evaluate import InferenceAPI
from fashionern_aaai2024_tpu_torch.retrieval.server import RetrievalService
from fashionern_aaai2024_tpu_torch.train import checkpoint as ckpt
from fashionern_aaai2024_tpu_torch.train import schedule as TSched
from fashionern_aaai2024_tpu_torch.train import step as TStep
from fashionern_aaai2024_tpu_torch.train.state import create_train_state
from torch_port_helpers import (
    CTX,
    D,
    PATCH_NUM,
    crc_tokenizer,
    jax_model_and_variables,
    port_model,
    small_config,
    tiny_config,
)

torch.set_num_threads(2)

LR = 1e-3
T_MAX = 40
STEPS = 3
B = 8
# bf16 TME (serve policy) against flax's bf16 TME: per-row cosine of the
# enhanced token features. Both round every projection and the output to
# bf16 (about 3 significant digits); B9 keeps fp32 scores where flax
# rounds the scaled query and the scores to bf16 (ROADMAP C8). Read on
# these inputs: min 0.9999867 (each side against JAX's fp32 TME: JAX
# 0.9999856, the port 0.9999916), so 1 - cos is held to 7x the reading.
BF16_COSINE_MIN = 0.9999


def _tme_config(module, cfg_fn=small_config):
    cfg = cfg_fn(module)
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, tme=True))


def _with_tme_weights(variables: dict, seed: int = 5) -> dict:
    """JAX variables with every TME leaf drawn anew: kernels at std
    d^-0.5 (the port's seeded init), biases at 0.1, the LN scale around
    1. The out kernel becomes nonzero."""
    g = np.random.default_rng(seed)
    d = variables["params"]["ern"]["TME"]["ln"]["scale"].shape[0]

    def draw(path, a):
        name = jax.tree_util.keystr(path)
        std = d ** -0.5 if "kernel" in name else 0.1
        base = 1.0 if "scale" in name else 0.0
        return (base + std * g.standard_normal(a.shape)).astype(np.float32)

    variables["params"]["ern"]["TME"] = jax.tree_util.tree_map_with_path(
        draw, variables["params"]["ern"]["TME"])
    return variables


def _both_tme_models(cfg_fn=small_config, seed: int = 0):
    jm, variables = jax_model_and_variables(_tme_config(jax_config, cfg_fn), seed)
    variables = _with_tme_weights(variables)
    return jm, variables, port_model(_tme_config(torch_config, cfg_fn), variables)


def _module_pair(d: int, seed: int):
    g = np.random.default_rng(seed)
    text = g.standard_normal((3, CTX, d)).astype(np.float32)
    vis = g.standard_normal((3, PATCH_NUM, d)).astype(np.float32)
    jm = JaxTME(d)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed), text, vis))
    v = _with_tme_weights({"params": {"ern": {"TME": v["params"]}}}, seed)
    v = {"params": v["params"]["ern"]["TME"]}
    tm = TMEModule(d)
    tm.load_state_dict({k[2:]: t for k, t in convert._tme(v["params"], "m").items()})
    return jm, v, tm, text, vis


def _cos_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


# --- the module -----------------------------------------------------------


@pytest.mark.parametrize("d", [24, 128, 160])
def test_tme_module_matches_jax(d):
    """d = 128 and 160 give B9's head dims, 16 and 20 here at 8 heads
    (64 and 80 at ViT-B-16's d = 512 and RN50x4's 640)."""
    jm, v, tm, text, vis = _module_pair(d, seed=d)
    assert np.abs(v["params"]["cross_attn"]["out"]["kernel"]).max() > 0
    want = np.asarray(jm.apply(v, text, vis))
    with torch.no_grad():
        got = tm(torch.from_numpy(text), torch.from_numpy(vis))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    assert np.abs(want - text).max() > 0.1          # TME is not the identity here


def test_tme_parameter_names():
    tm = TMEModule(24)
    assert sorted(k for k in tm.state_dict()) == sorted(
        [f"{m}.{p}" for m in ("visual_proj", "ln", "cross_attn.query", "cross_attn.key",
                              "cross_attn.value", "cross_attn.out")
         for p in ("weight", "bias")])


def test_layer_norm_follows_flax_eps_and_variance():
    """flax's LayerNorm takes eps 1e-6 (the port's TME LN passes
    TME_LN_EPS to kernel B11) and the variance as E[x^2] - E[x]^2; B11
    takes the mean of squared deviations. On token-feature-like rows
    (mean small against the spread) both agree at 2e-5 even where eps
    matters (a row of std 3e-3: eps 1e-5 would be off by 0.5); they part
    only where the mean dwarfs the spread, which E[x^2] - E[x]^2 loses
    to cancellation."""
    import flax.linen as nn

    g = np.random.default_rng(3)
    d = 64
    scale, bias = (1 + 0.1 * g.standard_normal(d)).astype(np.float32), \
        (0.1 * g.standard_normal(d)).astype(np.float32)
    v = {"params": {"scale": scale, "bias": bias}}
    rows = np.concatenate([g.standard_normal((4, d)),
                           0.003 * g.standard_normal((2, d)) + 0.001]).astype(np.float32)
    want = np.asarray(nn.LayerNorm().apply(v, rows))
    ts = [torch.from_numpy(a) for a in (rows, scale, bias)]
    np.testing.assert_allclose(layer_norm(*ts, TME_LN_EPS).numpy(), want, atol=2e-5, rtol=0)
    assert TME_LN_EPS == 1e-6
    assert np.abs(layer_norm(*ts, 1e-5).numpy() - want).max() > 0.1
    far = (0.003 * g.standard_normal((2, d)) + 5.0).astype(np.float32)
    flax_far = np.asarray(nn.LayerNorm().apply(v, far))
    port_far = layer_norm(torch.from_numpy(far), *ts[1:], TME_LN_EPS).numpy()
    assert np.abs(port_far - flax_far).max() > 2e-5


def test_train_policy_promotes_to_fp32_from_bf16_rounded_patches():
    """Training feeds bf16 token features (bf16 towers) to fp32 TME
    parameters: flax promotes to fp32 after rounding the patches to bf16
    (`tme.py:44-45`); so does the port, at 2e-5. A control without the
    rounding differs by far more."""
    jm, v, tm, text, vis = _module_pair(64, seed=7)
    text16 = jnp.asarray(text, jnp.bfloat16)
    want = jm.apply(v, text16, vis)
    assert want.dtype == jnp.float32
    with torch.no_grad():
        got = tm(torch.from_numpy(text).to(torch.bfloat16), torch.from_numpy(vis))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    unrounded = np.asarray(jm.apply(v, np.asarray(text16, np.float32), vis))
    assert np.abs(unrounded - np.asarray(want)).max() > 1e-3


def test_serve_policy_runs_tme_in_bf16():
    """Under `--precision bf16` JAX casts every ERN leaf to bf16 and the
    text tower gives bf16 token features, so TME runs wholly in bf16;
    `apply_precision` stores the port's TME in bf16 to match. B9 keeps
    fp32 scores there (ROADMAP C8): held by cosine."""
    jm, v, tm, text, vis = _module_pair(64, seed=8)
    v16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), v)
    want = jm.apply(v16, jnp.asarray(text, jnp.bfloat16), vis)
    assert want.dtype == jnp.bfloat16
    tm = tm.to(torch.bfloat16)
    with torch.no_grad():
        got = tm(torch.from_numpy(text).to(torch.bfloat16), torch.from_numpy(vis))
    assert got.dtype == torch.bfloat16
    cos = _cos_rows(got.float().numpy(), np.asarray(want, np.float32))
    assert cos.min() >= BF16_COSINE_MIN, cos.min()

    model = random_init_(ComposedCIRModel(_tme_config(torch_config)),
                         torch.Generator().manual_seed(0))
    apply_precision(model, "bf16")
    assert {p.dtype for p in model.ern.TME.parameters()} == {torch.bfloat16}
    assert {p.dtype for n, p in model.ern.named_parameters()
            if not n.startswith("TME.")} == {torch.float32}


# --- the composed model and the API ----------------------------------------


def test_tme_configs_build():
    cfg = torch_config.get_clip_config("ViT-B-16", tme=True)
    assert cfg.text.tme and not torch_config.get_clip_config("ViT-B-16").text.tme
    assert torch_config.get_clip_config("RN50x4", tme=True).text.tme
    model = ComposedCIRModel(_tme_config(torch_config))
    assert isinstance(model.ern.TME, TMEModule)
    assert not hasattr(ComposedCIRModel(small_config(torch_config)).ern, "TME")


@pytest.fixture(scope="module")
def tme_models():
    return _both_tme_models()


def test_encode_text_needs_visual_emb_on_a_tme_model(tme_models):
    _, _, tm = tme_models
    ids = torch.from_numpy(crc_tokenizer(["make it red"])).long()
    with pytest.raises(ValueError, match="visual_emb"):
        tm.encode_text(ids)
    api = InferenceAPI(tm, tokenizer=crc_tokenizer, device="cpu", context_length=CTX)
    with pytest.raises(ValueError, match="visual_emb"):
        api.encode_text(ids.numpy())
    vanilla = InferenceAPI(random_init_(ComposedCIRModel(small_config(torch_config)),
                                        torch.Generator().manual_seed(0)),
                           tokenizer=crc_tokenizer, device="cpu", context_length=CTX)
    g1, s1 = vanilla.encode_text(ids.numpy())
    g2, s2 = vanilla.encode_text(ids.numpy(), visual_emb=np.ones((1, PATCH_NUM, D)))
    assert torch.equal(g1, g2) and torch.equal(s1, s2)


def test_encode_text_matches_jax_api(tme_models):
    jm, variables, tm = tme_models
    ids = crc_tokenizer(["make it red", "longer sleeves and darker", "in blue"])
    vis = np.random.default_rng(4).standard_normal((3, PATCH_NUM, D)).astype(np.float32)
    jax_api = JE.InferenceAPI(jm, variables, batch_size=8, context_length=CTX,
                              tokenizer=crc_tokenizer)
    wg, ws = jax_api.encode_text(ids, visual_emb=vis)
    api = InferenceAPI(tm, tokenizer=crc_tokenizer, device="cpu", batch_size=2,
                       context_length=CTX)
    g, s = api.encode_text(ids, visual_emb=vis)
    np.testing.assert_allclose(s.numpy(), ws, atol=2e-5, rtol=0)
    np.testing.assert_allclose(g.numpy(), wg, atol=2e-5, rtol=0)
    plain_g, plain_s = tm.clip.encode_text(torch.from_numpy(ids).long())
    assert np.abs(s.numpy() - plain_s.detach().numpy()).max() > 0.1


# --- the serve slice --------------------------------------------------------

QUERIES = [("img3", "make it red"), ("img0", "longer sleeves"), ("img5", "in blue"),
           ("img11", "more formal and darker")]


def _items(n=12, seed=1):
    g = np.random.default_rng(seed)
    return [{"name": f"img{i}", "image": g.random((32, 32, 3), dtype=np.float32),
             "patch": g.standard_normal((PATCH_NUM, D)).astype(np.float32)}
            for i in range(n)]


@pytest.fixture(scope="module")
def services():
    jm, variables, tm = _both_tme_models(tiny_config)
    jax_api = JE.InferenceAPI(jm, variables, batch_size=8, context_length=CTX,
                              tokenizer=crc_tokenizer)
    jax_service = JaxService(jax_api, Loader(_items(), 8, num_workers=0), warmup=False)
    api = InferenceAPI(tm, tokenizer=crc_tokenizer, device="cpu", batch_size=8,
                       context_length=CTX)
    return jax_service, RetrievalService(api, Loader(_items(), 8, num_workers=0))


def _check(jax_results, port_results):
    assert len(jax_results) == len(port_results)
    for jr, pr in zip(jax_results, port_results):
        assert [r["name"] for r in pr] == [r["name"] for r in jr]
        np.testing.assert_allclose([r["score"] for r in pr], [r["score"] for r in jr],
                                   atol=2e-4, rtol=0)


@pytest.mark.parametrize("q", range(len(QUERIES)))
def test_tme_single_query_matches_jax_service(services, q):
    jax_service, port_service = services
    ref, caption = QUERIES[q]
    want, _ = jax_service.query([ref], [caption], k=10)
    got, _ = port_service.query([ref], [caption], k=10)
    _check(want, got)


def test_tme_batch_query_matches_jax_service(services):
    jax_service, port_service = services
    refs, caps = zip(*QUERIES)
    want, _ = jax_service.query(list(refs), list(caps), k=12)
    got, _ = port_service.query(list(refs), list(caps), k=12)
    _check(want, got)


def test_tme_changes_the_ranking_inputs(services):
    """The service conditions the text on the request rows' patches: the
    same caption against two references gives two text features."""
    _, port_service = services
    api = port_service.api
    ids = api.tokenize(["make it red", "make it red"])
    patches = port_service.gallery.local_features[torch.tensor([0, 5])]
    g, _ = api.encode_text(ids, visual_emb=patches)
    assert not torch.allclose(g[0], g[1], atol=1e-3)


# --- training ---------------------------------------------------------------


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


@functools.cache
def _runs(kind: str) -> dict:
    """3 steps of one step builder on each side, from the same TME
    weights, all-keep dropout on both."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", _keep_all_jax)
        mp.setattr(TD, "dropout_mask", _keep_all_torch)
        jm, variables, model = _both_tme_models(seed=1)
        opt = optax.adam(JSched.cosine_annealing_schedule(LR, T_MAX))
        jstate = jax_create_state(variables, opt, jax.random.PRNGKey(0))
        jstep = JAX_BUILDERS[kind](jm, opt, negatives="local", local_groups=1, donate=False)
        state = create_train_state(model, seed=0)
        step = PORT_BUILDERS[kind](model, TSched.cosine_annealing_schedule(LR, T_MAX))
        jstates, jlosses, losses, grads = [jstate], [], [], None
        for batch in _batches(kind):
            jstate, jloss = jstep(jstate, batch)
            jstates.append(jstate)
            jlosses.append(float(jloss))
            state, loss = step(state, _torch_batch(batch))
            losses.append(loss.item())
            if grads is None:
                grads = {n: p.grad.clone() for n, p in model.ern.named_parameters()
                         if p.grad is not None}
    return dict(jm=jm, variables=variables, jstates=jstates, jlosses=jlosses, state=state,
                losses=losses, grads=grads)


def _ern_sd(jstate) -> dict:
    return convert.ern_state_dict(jstate.ern_params, jstate.batch_stats["ern"])


# exact zero gradients (see tests/test_torch_train.py ZERO_GRAD), and
# TME's key bias, which shifts every score of its softmax alike
ZERO_GRAD = ("attention.self.key.bias", "embedding_common.bias", "embedding_global.0.bias",
             "TME.cross_attn.key.bias")


def _zero_grad_mask(name: str, shape) -> np.ndarray:
    mask = np.zeros(shape, bool)
    if name.endswith(ZERO_GRAD):
        mask[...] = True
    elif name.endswith("MR_component.in_proj_bias"):
        d = shape[0] // 3
        mask[d:2 * d] = True
    return mask


@pytest.mark.parametrize("kind", ["image", "cached"])
def test_tme_step_losses_match_jax(kind):
    runs = _runs(kind)
    np.testing.assert_allclose(runs["losses"], runs["jlosses"], rtol=1e-5, atol=0)


@pytest.mark.parametrize("kind", ["image", "cached"])
def test_tme_params_after_three_steps_match_jax(kind):
    """Every ERN parameter, TME's included, in units of lr; and TME
    moved. Adam divides each gradient by its own running RMS, so an
    element whose gradient is small against its fp32 rounding error moves
    by up to one lr a step in whatever direction the rounding gave it:
    every element is held to that bound, 2 * steps * lr, TME's at
    0.25 * lr, and at most 1e-4 of the other elements may sit beyond
    0.25 * lr (one of 4.95e5 did, in the BERT's intermediate layer of
    the cached run). The exact-zero gradients (`ZERO_GRAD`) are all noise."""
    runs = _runs(kind)
    model = runs["state"].model
    got, want = model.ern.state_dict(), _ern_sd(runs["jstates"][-1])
    start = _ern_sd(runs["jstates"][0])
    beyond, total = 0, 0
    for name, _ in model.ern.named_parameters():
        g, w = got[name].numpy(), want[name].numpy()
        noise = _zero_grad_mask(name, w.shape)
        np.testing.assert_allclose(g, w, atol=2 * STEPS * LR, rtol=0, err_msg=name)
        err = np.abs(g - w)[~noise]
        if name.startswith("TME."):
            assert err.max(initial=0) <= 0.25 * LR, name
            assert not np.array_equal(g, start[name].numpy()), name
        beyond += int((err > 0.25 * LR).sum())
        total += err.size
    assert beyond <= 1e-4 * total, (beyond, total)


def test_tme_first_step_gradients_match_jax():
    """The step-1 TME gradients of the image step against `jax.grad` of
    the loss the JAX step differentiates (tolerances of
    tests/test_torch_train.py)."""
    runs = _runs("image")
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
    tme = [n for n in want if n.startswith("TME.")]
    assert len(tme) == 12 and all(n in got for n in tme)
    scale = max(np.abs(want[n].numpy()).max() for n in got)
    for name in tme:
        w, g = want[name].numpy(), got[name].numpy()
        noise = _zero_grad_mask(name, w.shape)
        assert np.abs(g[noise]).max(initial=0) < 1e-6 * scale, name
        if not noise.all():
            assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g[~noise], w[~noise], atol=1e-4 * np.abs(w).max(),
                                   rtol=1e-4, err_msg=name)


def test_feature_step_bypasses_tme():
    """`build_feature_train_step` takes the text features as given, as
    JAX's does: TME gets no gradient and does not move."""
    _, _, model = _both_tme_models(seed=2)
    before = {n: p.detach().clone() for n, p in model.ern.TME.named_parameters()}
    state = create_train_state(model, seed=0)
    step = TStep.build_feature_train_step(model, TSched.cosine_annealing_schedule(LR, T_MAX))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TD, "dropout_mask", _keep_all_torch)
        step(state, _torch_batch(_batches("features", n=1)[0]))
    for n, p in model.ern.TME.named_parameters():
        assert p.grad is None and torch.equal(p.detach(), before[n]), n


# --- the bridge and checkpoints ----------------------------------------------


def test_bridge_carries_tme_params_and_moments_exactly():
    """After two JAX steps: the TME leaves and their Adam moments land in
    the port's names, each equal to the JAX array in the torch layout
    (Dense kernels transposed, DenseGeneral [d, H, Dh] / [H, Dh, d]
    kernels flattened over (H, Dh) then transposed, [H, Dh] biases
    flattened)."""
    runs = _runs("image")
    jstate = runs["jstates"][2]
    _, _, model = _both_tme_models(seed=1)
    state = create_train_state(model, seed=0)
    convert.load_jax_train_state(state, jstate, _tme_config(torch_config))
    adam = jstate.opt_state[0]

    def torch_layout(tree) -> dict:
        t = tree["TME"]
        out = {"visual_proj.weight": np.asarray(t["visual_proj"]["kernel"]).T,
               "visual_proj.bias": np.asarray(t["visual_proj"]["bias"]),
               "ln.weight": np.asarray(t["ln"]["scale"]), "ln.bias": np.asarray(t["ln"]["bias"])}
        for name in ("query", "key", "value", "out"):
            k = np.asarray(t["cross_attn"][name]["kernel"])
            k = k.reshape(-1, k.shape[-1]) if name == "out" else k.reshape(k.shape[0], -1)
            out[f"cross_attn.{name}.weight"] = k.T
            out[f"cross_attn.{name}.bias"] = np.asarray(t["cross_attn"][name]["bias"]).ravel()
        return out

    params, mu, nu = (torch_layout(tree) for tree in (jstate.ern_params, adam.mu, adam.nu))
    for name, p in model.ern.TME.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), params[name])
        st = state.optimizer.state[p]
        assert st["step"].item() == 2
        np.testing.assert_array_equal(st["exp_avg"].numpy(), mu[name])
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), nu[name])
    assert len(params) == len(list(model.ern.TME.parameters())) == 12


def test_checkpoint_refuses_a_model_with_another_tme(tmp_path):
    tme_model = random_init_(ComposedCIRModel(_tme_config(torch_config)),
                             torch.Generator().manual_seed(0))
    vanilla = random_init_(ComposedCIRModel(small_config(torch_config)),
                           torch.Generator().manual_seed(0))
    for saved, other in ((tme_model, vanilla), (vanilla, tme_model)):
        path = str(tmp_path / f"s{int(saved.clip_config.text.tme)}")
        ckpt.save_state(path, create_train_state(saved, seed=0))
        with pytest.raises(ValueError, match="tme="):
            ckpt.restore_state(path, create_train_state(other, seed=0))
    same = random_init_(ComposedCIRModel(_tme_config(torch_config)),
                        torch.Generator().manual_seed(3))
    state = ckpt.restore_state(str(tmp_path / "s1"), create_train_state(same, seed=0))
    for k, v in tme_model.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k
