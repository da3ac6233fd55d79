"""The port's comparison zoo (`fashionern_aaai2024_tpu_torch/models/zoo/`)
against the JAX zoo, on the CPU, and B8's wide route (the kernel CaLa's
single heads take on the card) through a fake card.

Each JAX module is initialized (`Module.init`), its variables are carried
into the port module by `models/convert.py`, and both run the same
seeded numpy inputs in fp32: atol 2e-5 (the two frameworks sum in other
orders), AMC's second routing layer 5e-5 (as `tests/test_zoo.py` holds
the JAX module to the reference: two layers of LayerNorms and 8-head
attention compound the first layer's error), CompoDiff end to end 2e-4
(depth 2, cosine-sim attention at scale 16 turns score errors of 1e-6
into probability errors ~16x larger, through four DALLE2 LayerNorms a
layer). Each converter for a module that JAX converts from torch is the
exact inverse of the JAX converter: its output fed back through it gives
the JAX variables bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionern_aaai2024_tpu.models import zoo as JZ
from fashionern_aaai2024_tpu.models.zoo import compodiff as JCD
from fashionern_aaai2024_tpu.models.zoo.dqu_cir import ranking_nce_loss as jax_nce
from fashionern_aaai2024_tpu_torch.models import convert as C
from fashionern_aaai2024_tpu_torch.models import zoo as TZ
from fashionern_aaai2024_tpu_torch.models.zoo import compodiff as TCD
from fashionern_aaai2024_tpu_torch.models.zoo.dqu_cir import ranking_nce_loss
from fashionern_aaai2024_tpu_torch.ops import attention as A
from fashionern_aaai2024_tpu_torch.ops import common
from fashionern_aaai2024_tpu_torch.ops import dropout as TD

D = 16  # clip feature dim (the combiner heads take 2*D concatenated features)
ATOL = 2e-5


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


def _port(torch_module, variables, to_state_dict):
    torch_module.load_state_dict(to_state_dict(variables), strict=True)
    return torch_module.eval()


def _tree(variables):
    """A flax subtree's variables -> the port's names (`models/convert.py`)."""
    return C._zoo_tree(variables["params"])


def _shared_text_mlp(variables):
    """VTF's variables as `vtf_from_torch` builds them: `text_mlp_shared`
    a copy of `text_mlp` (flax's init draws the two apart)."""
    p = dict(variables["params"])
    for i in (0, 3):
        p[f"text_mlp_shared_{i}"] = p[f"text_mlp_{i}"]
    return {"params": p}


def _inputs(name, rng):
    if name in ("clip4cir_combiner", "vtf"):
        return [_np(rng, 6, 2 * D), _np(rng, 6, 2 * D)]
    if name == "attention_pooling":
        return [_np(rng, 4, 7, D)]
    if name == "cala":
        return [_np(rng, 3, 5, D), _np(rng, 3, 5, D)]
    if name in ("artemis", "dqu_cir"):
        return [_np(rng, 4, D) for _ in range(3 if name == "artemis" else 2)]
    return [_np(rng, 2, 6, D), _np(rng, 2, D), _np(rng, 2, 9, D), _np(rng, 2, D)]   # AMC


# name -> (JAX module, port module, JAX from_torch or None)
MODULES = {
    "clip4cir_combiner": (lambda: JZ.Clip4CirCombiner(D, 4 * D, 8 * D),
                          lambda: TZ.Clip4CirCombiner(D, 4 * D, 8 * D), JZ.combiner_from_torch),
    "vtf": (lambda: JZ.VTFModule(D, 4 * D, 8 * D), lambda: TZ.VTFModule(D, 4 * D, 8 * D),
            JZ.vtf_from_torch),
    "attention_pooling": (lambda: JZ.AttentionPooling(emb_dim=D, emb_num=7),
                          lambda: TZ.AttentionPooling(D, 7), JZ.attention_pooling_from_torch),
    "cala": (lambda: JZ.TwinAttentionCompositor(D), lambda: TZ.TwinAttentionCompositor(D),
             JZ.cala_from_torch),
    "artemis": (lambda: JZ.Artemis(D), lambda: TZ.Artemis(D), JZ.artemis_from_torch),
    "dqu_cir": (lambda: JZ.DQUCIRHead(hidden_dim=24), lambda: TZ.DQUCIRHead(D, hidden_dim=24),
                JZ.dqu_cir_from_torch),
    "amc": (lambda: JZ.AMCInteractionModule(embed_size=D, hid_router=8),
            lambda: TZ.AMCInteractionModule(D, 8), JZ.amc_interaction_from_torch),
    "amc_ensemble": (lambda: JZ.AMCEnsemble(embed_size=D), lambda: TZ.AMCEnsemble(D), None),
}


def _both(name, seed=0):
    jax_ctor, torch_ctor, _ = MODULES[name]
    rng = np.random.default_rng(seed)
    x = _inputs(name, rng)
    jm = jax_ctor()
    variables = jm.init(jax.random.PRNGKey(seed), *x)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    if name == "vtf":
        variables = _shared_text_mlp(variables)
    tm = _port(torch_ctor(), variables, C.ZOO_STATE_DICTS[name])
    return jm, variables, tm, x


@pytest.mark.parametrize("name", [n for n in MODULES if n != "amc"])
def test_zoo_module_matches_jax(name):
    jm, variables, tm, x = _both(name)
    with torch.no_grad():
        got = tm(*_t(*x))
    _close(got, jm.apply(variables, *x))


def test_amc_interaction_matches_jax():
    """Both routing layers' embeddings and path probabilities; the second
    layer at 5e-5."""
    jm, variables, tm, x = _both("amc", seed=1)
    with torch.no_grad():
        g1, g2, q1, q2 = tm(*_t(*x))
    w1, w2, p1, p2 = jm.apply(variables, *x)
    _close(q1, p1)
    _close(g1, w1)
    _close(q2, p2, atol=5e-5)
    _close(g2, w2, atol=5e-5)


@pytest.mark.parametrize("width", [D, 64])
def test_amc_router_layer_norm_matches_flax(width):
    """The Router's affine LayerNorm (`mlp.1`, flax's `nn.LayerNorm`) and
    the cells' affine-free one (`_torch_layer_norm`) on standard-normal
    rows, at 2e-5."""
    import flax.linen as fnn

    from fashionern_aaai2024_tpu.models.zoo.amc import _torch_layer_norm as jax_ln
    from fashionern_aaai2024_tpu_torch.models.zoo.amc import _torch_layer_norm

    rng = np.random.default_rng(2)
    x = _np(rng, 64, width) * 3.0 + 1.0
    scale, bias = 1.0 + 0.1 * _np(rng, width), 0.1 * _np(rng, width)
    want = fnn.LayerNorm(epsilon=1e-5).apply({"params": {"scale": scale, "bias": bias}}, x)
    ln = torch.nn.LayerNorm(width, eps=1e-5)
    ln.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        _close(ln(torch.from_numpy(x)), want)
    _close(_torch_layer_norm(torch.from_numpy(x)), jax_ln(x))


@pytest.mark.parametrize("broadcast", [False, True])
def test_artemis_scores_match_jax(broadcast):
    jm, variables, tm, x = _both("artemis", seed=3)
    with torch.no_grad():
        got = tm(*_t(*x), broadcast=broadcast)
    _close(got, jm.apply(variables, *x, broadcast=broadcast))
    assert tm.temperature.shape == (1,)


def test_ranking_nce_loss_matches_jax():
    rng = np.random.default_rng(4)
    q, t = _np(rng, 5, D), _np(rng, 5, D)
    got = ranking_nce_loss(*_t(q, t), 10.0)
    assert got.item() == pytest.approx(float(jax_nce(q, t, 10.0)), rel=1e-5)


@pytest.mark.parametrize("name", [n for n, (_, _, back) in MODULES.items() if back])
def test_converter_is_the_exact_inverse_of_jax(name):
    """Port state_dict -> the JAX `*_from_torch` -> the JAX variables,
    every leaf bit for bit, and the state_dict fills the port module."""
    _, variables, tm, _ = _both(name)
    back = MODULES[name][2](C.ZOO_STATE_DICTS[name](variables))
    want = variables["params"]
    assert jax.tree_util.tree_structure(back["params"]) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(back["params"]), jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert set(C.ZOO_STATE_DICTS[name](variables)) == set(tm.state_dict())


def test_vtf_refuses_an_unshared_text_mlp():
    _, variables, _, _ = _both("vtf")
    p = dict(variables["params"])
    p["text_mlp_shared_3"] = {k: v + 1.0 for k, v in p["text_mlp_shared_3"].items()}
    with pytest.raises(ValueError, match="text_mlp_shared_3 differs"):
        C.vtf_state_dict({"params": p})


def test_registry_names_and_error():
    assert sorted(TZ._ZOO) == sorted(JZ._ZOO)
    m = TZ.get_zoo_model("clip4cir_combiner", clip_feature_dim=D, projection_dim=4 * D,
                         hidden_dim=8 * D)
    assert isinstance(m, TZ.Clip4CirCombiner)
    with pytest.raises(ValueError) as got:
        TZ.get_zoo_model("bogus")
    with pytest.raises(ValueError) as want:
        JZ.get_zoo_model("bogus")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["clip4cir_combiner", "vtf", "dqu_cir"])
def test_train_mode_drops_out_from_the_callers_generator(monkeypatch, name):
    """In train mode every mask is drawn at keep 0.5 from the generator the
    caller passed (the masks cannot match flax's); the same seed gives the
    same output, and eval draws nothing."""
    _, _, tm, x = _both(name)
    seen = []
    real = TD.dropout_mask

    def spy(shape, keep, generator, device):
        seen.append((keep, generator))
        return real(shape, keep, generator, device)

    monkeypatch.setattr(TD, "dropout_mask", spy)
    with torch.no_grad():
        tm(*_t(*x))
        assert not seen
        gen = torch.Generator().manual_seed(5)
        a = tm(*_t(*x), generator=gen)
        assert seen and all(keep == 0.5 and g is gen for keep, g in seen)
        b = tm(*_t(*x), generator=torch.Generator().manual_seed(5))
        c = tm(*_t(*x), generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)


# --- CompoDiff ---------------------------------------------------------------


def test_rel_pos_buckets_equal_jax_for_every_distance():
    rel = np.arange(-256, 257)[None, :]
    want = np.asarray(JCD._rel_pos_bucket(jnp.asarray(rel)))
    got = TCD.rel_pos_bucket(torch.from_numpy(rel)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dh", [16, 64])
def test_rotary_matches_jax(dh):
    rng = np.random.default_rng(6)
    t = _np(rng, 2, 3, 11, dh)
    rot = min(32, dh)
    _close(TCD.rotate_queries_or_keys(torch.from_numpy(t), rot),
           JCD.rotate_queries_or_keys(jnp.asarray(t), rot))


@pytest.mark.parametrize("stable", [False, True])
def test_dalle_layer_norm_matches_jax(stable):
    rng = np.random.default_rng(7)
    x = _np(rng, 3, 5, 32) + 2.0
    jm = JCD.DalleLayerNorm(32, stable=stable)
    v = {"params": {"g": 1.0 + 0.1 * _np(rng, 32)}}
    tm = _port(TCD.DalleLayerNorm(32, stable=stable), v, _tree)
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), jm.apply(v, x))


def test_sinusoidal_embedding_and_mlp_match_jax():
    t = np.array([0.0, 3.0, 11.0, 999.0], np.float32)
    _close(TCD.sinusoidal_pos_emb(torch.from_numpy(t), 32),
           JCD.SinusoidalPosEmb(32).apply({}, t))
    rng = np.random.default_rng(8)
    x = _np(rng, 4, 20)
    jm = JCD.MLP(20, 12, depth=3)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), x))
    tm = _port(TCD.MLP(20, 12, depth=3), v,
               lambda v: C._zoo_tree(v["params"], {"in": "proj_in", "out": "proj_out"}))
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), jm.apply(v, x))


def _attention_case(kind, rng):
    if kind == "self":
        jm = JCD.CompoDiffSelfAttention(32, dim_head=16, heads=4, causal=True)
        tm = TCD.CompoDiffSelfAttention(32, dim_head=16, heads=4, causal=True)
        x = _np(rng, 2, 6, 32)
        bias = _np(rng, 1, 4, 6, 7)
        mask = np.ones((2, 6), bool)
        mask[1, 4:] = False
        return jm, tm, (x,), dict(attn_bias=bias, mask=mask)
    jm = JCD.CompoDiffCrossAttention(32, context_dim=24, dim_head=16, heads=4)
    tm = TCD.CompoDiffCrossAttention(32, context_dim=24, dim_head=16, heads=4)
    mask = np.ones((2, 9), bool)
    mask[0, 5:] = False
    return jm, tm, (_np(rng, 2, 6, 32), _np(rng, 2, 9, 24)), dict(mask=mask)


@pytest.mark.parametrize("kind", ["self", "cross"])
def test_compodiff_attention_matches_jax(kind):
    """A null slot, a padding mask (`finfo.min` after the null column),
    the causal mask and the relative-position bias (self)."""
    rng = np.random.default_rng(9)
    jm, tm, args, kw = _attention_case(kind, rng)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1), *args, **kw))
    tm = _port(tm, v, _tree)
    with torch.no_grad():
        got = tm(*_t(*args), **{k: torch.from_numpy(a) for k, a in kw.items()})
    _close(got, jm.apply(v, *args, **kw), atol=1e-4)


def _compodiff_args(rng, b=2):
    return (_np(rng, b, 1, 32), _np(rng, b, 5, 32), _np(rng, b, 7, 48), _np(rng, b, 8, 8),
            np.array([3.0, 11.0][:b], np.float32))


@pytest.mark.parametrize("depth,heads", [(1, 2), (2, 4)])
def test_compodiff_network_matches_jax(depth, heads):
    """End to end at dim 32, dh 16, text 7 x 48, mask 8 x 8, and with
    classifier-free guidance (the triple batch) at 2e-4."""
    rng = np.random.default_rng(10 + depth)
    args = _compodiff_args(rng)
    uc = _np(rng, 2, 7, 48)
    jm = JCD.CompoDiffNetwork(dim=32, depth=depth, dim_head=16, heads=heads,
                              text_cond_dim=48, mask_hw=8)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(depth), *args))
    tm = _port(TZ.CompoDiffNetwork(32, depth=depth, dim_head=16, heads=heads,
                                   text_cond_dim=48, mask_hw=8), v, C.compodiff_state_dict)
    with torch.no_grad():
        _close(tm(*_t(*args)), jm.apply(v, *args), atol=2e-4)
        got = tm.forward_with_cond_scale(*_t(*args, uc), cond_scale=(1.5, 7.5))
        plain = tm.forward_with_cond_scale(*_t(*args, uc), cond_scale=1.0)
    _close(got, jm.apply(v, *args, uc, (1.5, 7.5), method=jm.forward_with_cond_scale),
           atol=2e-4)
    assert torch.equal(plain, tm(*_t(*args)))


# --- B8's wide route: CaLa's kernel -----------------------------------------


@pytest.fixture
def fake_card(monkeypatch):
    """Every tensor counts as a CUDA tensor, and every launch is recorded
    (name, arguments) instead of run."""
    calls = []
    monkeypatch.setattr(common, "is_cuda", lambda t: True)
    monkeypatch.setattr(common, "stream_of", lambda t: 0)
    monkeypatch.setattr(common, "launch", lambda name, *args: calls.append((name, args)))
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,w,heads", [(4, 13, 13, 512, 1), (2, 13, 13, 640, 1),
                                              (2, 32, 32, 256, 1), (3, 5, 5, 16, 1),
                                              (2, 7, 256, 192, 2), (1, 3, 4, 1024, 1)])
def test_wide_head_dims_launch_the_wide_kernel(fake_card, dtype, b, sq, sk, w, heads):
    """B8 at a head dim the core does not take: one `fern_attention_wide`
    launch on q and the two halves of kv, counted by B8 and by the wide
    route."""
    q, kv = torch.zeros((b, sq, w), dtype=dtype), torch.zeros((b, sk, 2 * w), dtype=dtype)
    n8, nw = A.packed_kv_cross_attention.launches, A.wide_cross_attention.launches
    out = A.packed_kv_cross_attention(q, kv, heads)
    (name, args), = fake_card
    dh = w // heads
    assert name == "fern_attention_wide"
    assert args[:3] == (q.data_ptr(), kv.data_ptr(), kv.data_ptr() + kv.element_size() * w)
    assert args[3] == out.data_ptr() and out.shape == (b, sq, w) and out.dtype == dtype
    assert args[4:11] == (b, sq, sk, heads, dh, w, 2 * w)
    assert args[11] == pytest.approx(dh ** -0.5) and args[12] == common.DTYPE_CODES[dtype]
    assert A.packed_kv_cross_attention.launches == n8 + 1
    assert A.wide_cross_attention.launches == nw + 1


@pytest.mark.parametrize("sk,w,heads", [(82, 2560, 40), (13, 640, 8), (256, 512, 8)])
def test_core_head_dims_stay_on_the_core(fake_card, sk, w, heads):
    """Head dims 64 and 80 at Sk <= 256 (the RN50x4 pool, the MR) launch the
    attention core exactly as before the wide route; the wide count stays."""
    q, kv = torch.zeros((2, 3, w)), torch.zeros((2, sk, 2 * w))
    nw = A.wide_cross_attention.launches
    A.packed_kv_cross_attention(q, kv, heads)
    (name, args), = fake_card
    assert name == "fern_attention" and args[8:10] == (heads, w // heads)
    assert A.wide_cross_attention.launches == nw


@pytest.mark.parametrize("sk,w,heads", [(13, 2048, 1), (300, 512, 1), (300, 512, 8),
                                        (13, 30, 4)])
def test_wide_route_raises_outside_its_limits(fake_card, sk, w, heads):
    q, kv = torch.zeros((2, 3, w)), torch.zeros((2, sk, 2 * w))
    with pytest.raises(ValueError, match="up to 1024 at S <= 256"):
        A.packed_kv_cross_attention(q, kv, heads)
    assert not fake_card


def test_cala_runs_b8_wide_on_the_card(fake_card, monkeypatch):
    """CaLa's eight attentions are eight B8 calls on the wide route (the
    launches only: the fake card runs nothing)."""
    monkeypatch.setattr(A, "wide_cross_attention",
                        lambda q, kv, heads, scale: (fake_card.append(("wide", ())),
                                                     q.new_zeros(q.shape))[1])
    m = TZ.TwinAttentionCompositor(D).eval()
    with torch.no_grad():
        m(torch.zeros(2, 5, D), torch.zeros(2, 5, D))
    assert [n for n, _ in fake_card] == ["wide"] * 8
