"""Gradients through kernels B1, B2, B3, B7 and B8 (the port's autograd
Functions) against the JAX package's custom VJPs, on the CPU.

Each kernel entry of the port differentiates as the JAX kernel does: the
forward is the kernel, the backward autograd of its plain version,
recomputed (`ops/common.py plain_vjp`), where JAX takes `jax.vjp` of the
kernel's XLA twin (`_packed_diff`, `_packed_cross_diff`, `_qkv_fused_diff`,
`_subblock_diff`, `_mlp_diff`). Every case runs the port two ways:

  * "function": the wrapper on a fake card (`common.is_cuda` true), so
    that it routes to its autograd Function, with the Function's launch
    replaced by the plain version (the card's kernel cannot run here);
  * "plain": the CPU path, which autograd differentiates through the
    plain version.

The JAX side is `jax.vjp` through the custom-VJP entry with the Pallas
forward in interpret mode, as the JAX package's own tests run it; B8 at
a wide head dim (one head of 96 or 128, which JAX never sends to Pallas)
takes `jax.vjp` of `_packed_cross_ref`, the formula JAX differentiates
there. The same seeded numpy inputs and upstream gradient feed both
sides; partial `requires_grad` (only x, only the weights, only the
shared attention bias) gives None where no gradient was asked for.

Tolerance: fp32 at atol 2e-5 (the module tolerance of the parity
suites), on outputs and on every gradient; the upstream gradient is drawn
at std 0.1 so that each gradient element stays near 1 or below.

CaLa (`models/zoo/cala.py`), the model this slice lets train on the card:
its output at 2e-5 (a module), the registry's bbc loss on top and every
parameter gradient at 2e-4 (end to end) against `jax.value_and_grad` of
JAX's CaLa on the same weights (`cala_from_torch`); then one Adam step
each side (torch.optim.Adam, optax.adam; lr 1e-2, so that a wrong step
shows): parameters equal at 2e-4, except where the gradient is within
its tolerance of zero (the key third of each in_proj bias has an exact
gradient of 0: softmax ignores a per-row constant), where Adam turns
rounding noise into a step of either sign and the parameters are held
to Adam's bound, 2 lr.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from fashionern_aaai2024_tpu.models import zoo as JZ
from fashionern_aaai2024_tpu.ops import attention as JA
from fashionern_aaai2024_tpu.ops import extra_losses as JX
from fashionern_aaai2024_tpu.ops import mlp as JM
from fashionern_aaai2024_tpu_torch.models import zoo as TZ
from fashionern_aaai2024_tpu_torch.ops import attention as TA
from fashionern_aaai2024_tpu_torch.ops import common
from fashionern_aaai2024_tpu_torch.ops import extra_losses as TX
from fashionern_aaai2024_tpu_torch.ops import losses as TL
from fashionern_aaai2024_tpu_torch.ops import mlp as TM

torch.set_num_threads(2)

ATOL = 2e-5
END_TO_END = 2e-4
PATHS = ["function", "plain"]
F32 = np.float32


def _normal(g, shape, scale=1.0, offset=0.0):
    return (offset + scale * g.standard_normal(shape)).astype(F32)


@pytest.fixture
def card(monkeypatch):
    """A fake card: every tensor counts as a CUDA tensor, and each launch
    of the five Functions runs the plain version instead (recorded)."""
    ran = []

    def plain(name, fn):
        def run(*args):
            ran.append(name)
            return fn(*args)
        return run

    monkeypatch.setattr(common, "is_cuda", lambda t: True)
    monkeypatch.setattr(TA, "_launch_packed", plain("B3", lambda qkv, bias, heads, causal, scale,
                                                     _gb: TA.packed_qkv_self_attention_plain(
        qkv, heads, causal=causal, scale=scale, attn_bias=bias)))
    monkeypatch.setattr(TA, "_launch_cross", plain("B8", lambda q, kv, heads, scale, _core: (
        TA.packed_kv_cross_attention_plain(q, kv, heads, scale=scale))))
    monkeypatch.setattr(TA, "_launch_fused_qkv", plain("B7", lambda x, w, b, bias, heads, causal,
                                                        scale: TA.fused_qkv_self_attention_plain(
        x, w, b, heads, causal=causal, scale=scale, attn_bias=bias)))
    monkeypatch.setattr(TA, "_launch_subblock", plain("B1", lambda *t: TA.attention_subblock_plain(
        *t[:7], t[8], causal=t[9], scale=t[10], eps=t[11], attn_bias=t[7])))
    monkeypatch.setattr(TM, "_launch_mlp", plain("B2", lambda *t: TM.mlp_subblock_plain(
        *t[:7], activation=t[7], eps=t[8])))
    monkeypatch.setattr(TL, "bbc_rowloss", plain("B4", TL.bbc_rowloss_plain))
    return ran


def _port_grads(path, request, fn, arrays, needs, up, function):
    """Run `fn` on torch copies of `arrays` (requires_grad where `needs`)
    on `path`; return the output and each input's gradient (None where
    none was asked for). On the function path the output's grad_fn must
    be `function`'s."""
    if path == "function":
        request.getfixturevalue("card")
    ts = [None if a is None else torch.from_numpy(a.copy()).requires_grad_(n)
          for a, n in zip(arrays, needs)]
    out = fn(*ts)
    if path == "function":
        assert type(out.grad_fn).__name__ == f"{function.__name__}Backward"
    (out * torch.from_numpy(up)).sum().backward()
    return out, [None if t is None else t.grad for t in ts]


def _check(out, grads, want_out, want_grads, needs, atol=ATOL):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=0, atol=atol)
    for got, want, need in zip(grads, want_grads, needs):
        if not need:
            assert got is None
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


def _jax_vjp(fn, arrays, up):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in arrays))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(up))]


# --- B3: packed-qkv self-attention ---------------------------------------

# (head dim, mask, which inputs require grad): no mask, causal, and an
# arbitrary shared bias
B3_CASES = [(64, "none", "x"), (80, "none", "x"), (64, "causal", "x"), (80, "causal", "x"),
            (64, "bias", "x"), (64, "bias", "bias"), (80, "bias", "all")]


@functools.lru_cache(maxsize=None)
def _b3_case(dh, mask):
    g = np.random.default_rng(100 + dh + len(mask))
    s, w = 9, 2 * dh
    qkv = _normal(g, (2, s, 3 * w))
    bias = _normal(g, (s, s), 2.0) if mask == "bias" else None
    up = _normal(g, (2, s, w), 0.1)
    jbias = {"none": np.zeros((s, s), F32), "bias": bias,
             "causal": np.where(np.tril(np.ones((s, s), bool)), 0.0, JA._NEG_INF).astype(F32)}
    want = _jax_vjp(lambda a, b: JA._packed_diff(a, b, dh ** -0.5, 2, 1, True),
                    (qkv, jbias[mask]), up)
    return qkv, bias, up, want


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("dh,mask,needs", B3_CASES)
def test_b3_gradients_match_jax_vjp(request, path, dh, mask, needs):
    qkv, bias, up, (want, want_grads) = _b3_case(dh, mask)
    need = (needs in ("x", "all"), needs in ("bias", "all"))
    out, grads = _port_grads(path, request, lambda t, b: TA.packed_qkv_self_attention(
        t, 2, causal=mask == "causal", attn_bias=b), (qkv, bias), need, up,
        TA.PackedQKVFunction)
    _check(out, grads, want, want_grads, need)


# --- B8: cross-attention over packed kv ----------------------------------

# (head dim, heads, Sq, Sk, which inputs require grad): the core's head
# dims at one query row (the RN50x4 pool) and at many (the MR), and the
# wide route's one head of 96 and 128
B8_CASES = [(64, 2, 1, 13, "all"), (64, 2, 7, 13, "q"), (80, 2, 1, 82, "kv"),
            (80, 2, 9, 13, "all"), (96, 1, 5, 5, "all"), (128, 1, 1, 13, "q"),
            (128, 1, 13, 13, "kv")]


@functools.lru_cache(maxsize=None)
def _b8_case(dh, heads, sq, sk):
    g = np.random.default_rng(200 + dh + sq + sk)
    w = heads * dh
    q, kv, up = _normal(g, (3, sq, w)), _normal(g, (3, sk, 2 * w)), _normal(g, (3, sq, w), 0.1)
    zeros = jnp.zeros((sq, sk), jnp.float32)
    if dh in (64, 80):
        fn = lambda a, b: JA._packed_cross_diff(a, b, zeros, dh ** -0.5, heads, 1, True)  # noqa: E731
    else:
        fn = lambda a, b: JA._packed_cross_ref(a, b, zeros, dh ** -0.5, heads)  # noqa: E731
    return q, kv, up, _jax_vjp(fn, (q, kv), up)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("dh,heads,sq,sk,needs", B8_CASES)
def test_b8_gradients_match_jax_vjp(request, path, dh, heads, sq, sk, needs):
    q, kv, up, (want, want_grads) = _b8_case(dh, heads, sq, sk)
    need = (needs in ("q", "all"), needs in ("kv", "all"))
    out, grads = _port_grads(path, request, lambda a, b: TA.packed_kv_cross_attention(
        a, b, heads), (q, kv), need, up, TA.PackedCrossFunction)
    _check(out, grads, want, want_grads, need)


# --- B7: QKV projection + self-attention ---------------------------------

# (head dim, shared bias, which inputs require grad)
B7_CASES = [(64, False, "x"), (80, False, "weights"), (64, True, "bias"), (80, True, "all")]


@functools.lru_cache(maxsize=None)
def _b7_case(dh, with_bias):
    g = np.random.default_rng(300 + dh + with_bias)
    s, w = 11, 2 * dh
    x, wq, bq = _normal(g, (2, s, w)), _normal(g, (w, 3 * w), 0.05), _normal(g, (3 * w,), 0.05)
    bias = _normal(g, (s, s), 2.0) if with_bias else None
    up = _normal(g, (2, s, w), 0.1)
    jbias = bias if with_bias else np.zeros((s, s), F32)
    out, (gx, gw, gb, gbias) = _jax_vjp(
        lambda a, w_, b_, m_: JA._qkv_fused_diff(a, w_, b_, m_, dh ** -0.5, 2, True),
        (x, wq, bq, jbias), up)
    # the port takes the torch layout, [3W, W]
    return (x, wq.T.copy(), bq, bias), up, (out, [gx, gw.T, gb, gbias])


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("dh,with_bias,needs", B7_CASES)
def test_b7_gradients_match_jax_vjp(request, path, dh, with_bias, needs):
    arrays, up, (want, want_grads) = _b7_case(dh, with_bias)
    need = (needs in ("x", "all"), needs in ("weights", "all"), needs in ("weights", "all"),
            with_bias and needs in ("bias", "all"))
    out, grads = _port_grads(path, request, lambda x, w, b, m: TA.fused_qkv_self_attention(
        x, w, b, 2, attn_bias=m), arrays, need, up, TA.FusedQKVFunction)
    _check(out, grads, want, want_grads, need)


# --- B1: the attention sub-block -----------------------------------------

# (head dim, causal, shared bias, which inputs require grad)
B1_CASES = [(64, False, False, "x"), (64, True, False, "weights"), (80, False, True, "bias"),
            (64, False, True, "all"), (80, True, False, "all")]


@functools.lru_cache(maxsize=None)
def _b1_case(dh, causal, with_bias):
    g = np.random.default_rng(400 + dh + 2 * causal + with_bias)
    s, w = 17, 2 * dh
    arrays = (_normal(g, (2, s, w)), _normal(g, (w,), 0.1, 1.0), _normal(g, (w,), 0.1),
              _normal(g, (w, 3 * w), 0.05), _normal(g, (3 * w,), 0.05),
              _normal(g, (w, w), 0.05), _normal(g, (w,), 0.05))
    bias = _normal(g, (s, s), 2.0) if with_bias else None
    up = _normal(g, (2, s, w), 0.1)
    jbias = np.zeros((s, s), F32) if bias is None else bias
    if causal:
        jbias = np.where(np.tril(np.ones((s, s), bool)), jbias, JA._NEG_INF).astype(F32)
    out, grads = _jax_vjp(lambda *a: JA._subblock_diff(*a, dh ** -0.5, 2, 1e-5, True),
                          (*arrays, jbias), up)
    port = (*arrays[:3], arrays[3].T.copy(), arrays[4], arrays[5].T.copy(), arrays[6], bias)
    return port, up, (out, [*grads[:3], grads[3].T, grads[4], grads[5].T, *grads[6:]])


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("dh,causal,with_bias,needs", B1_CASES)
def test_b1_gradients_match_jax_vjp(request, path, dh, causal, with_bias, needs):
    arrays, up, (want, want_grads) = _b1_case(dh, causal, with_bias)
    weights = needs in ("weights", "all")
    need = (needs in ("x", "all"), *(weights,) * 6, with_bias and needs in ("bias", "all"))
    out, grads = _port_grads(path, request, lambda *t: TA.attention_subblock(
        *t[:7], 2, causal=causal, attn_bias=t[7]), arrays, need, up, TA.SubblockFunction)
    _check(out, grads, want, want_grads, need)


# --- B2: the MLP sub-block -----------------------------------------------

B2_CASES = [("quick_gelu", "x"), ("quick_gelu", "weights"), ("quick_gelu", "all"),
            ("gelu", "x"), ("gelu", "all")]


@functools.lru_cache(maxsize=None)
def _b2_case(activation):
    g = np.random.default_rng(500 + len(activation))
    b, s, w, f = 2, 17, 128, 512
    arrays = (_normal(g, (b, s, w)), _normal(g, (w,), 0.1, 1.0), _normal(g, (w,), 0.1),
              _normal(g, (w, f), 0.05), _normal(g, (f,), 0.05), _normal(g, (f, w), 0.05),
              _normal(g, (w,), 0.05))
    up = _normal(g, (b, s, w), 0.1)
    out, grads = _jax_vjp(lambda *a: JM._mlp_diff(
        *a, activation, 1e-5, JM._pick_splits(f), JM._pick_gb(b, s, w, f), True), arrays, up)
    port = (*arrays[:3], arrays[3].T.copy(), arrays[4], arrays[5].T.copy(), arrays[6])
    return port, up, (out, [*grads[:3], grads[3].T, grads[4], grads[5].T, grads[6]])


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("activation,needs", B2_CASES)
def test_b2_gradients_match_jax_vjp(request, path, activation, needs):
    arrays, up, (want, want_grads) = _b2_case(activation)
    weights = needs in ("weights", "all")
    need = (needs in ("x", "all"), *(weights,) * 6)
    out, grads = _port_grads(path, request, lambda *t: TM.mlp_subblock(
        *t, activation=activation), arrays, need, up, TM.MLPFunction)
    _check(out, grads, want, want_grads, need)


# --- grad-free calls launch what they launched before the Functions ------


@pytest.fixture
def recording_card(monkeypatch):
    """Every tensor counts as a CUDA tensor of a 132-SM card, and every
    launch is recorded by its entry name instead of run."""
    names = []
    monkeypatch.setattr(common, "is_cuda", lambda t: True)
    monkeypatch.setattr(common, "stream_of", lambda t: 0)
    monkeypatch.setattr(common, "sm_count", lambda device: 132)
    monkeypatch.setattr(common, "launch", lambda name, *args: names.append(name))
    return names


def _entry_calls():
    """name -> (wrapper, a call of it on fp32 operands, its launches in
    order): B1 at head dim 64 with a bias, B2, B3, B7, B8 on the core and
    on the wide route."""
    g = torch.Generator().manual_seed(0)

    def t(*shape):
        return torch.randn(shape, generator=g)

    w, s = 128, 9
    sub = (t(2, s, w), t(w), t(w), t(3 * w, w), t(3 * w), t(w, w), t(w))
    mlp = (t(2, s, w), t(w), t(w), t(4 * w, w), t(4 * w), t(w, 4 * w), t(w))
    qkv, bias = t(2, s, 3 * w), t(s, s)
    q, kv, qw, kvw = t(2, 1, w), t(2, 13, 2 * w), t(2, 5, 96), t(2, 5, 192)
    gemm, core, ln = "fern_gemm_tf32", "fern_attention", "fern_layernorm"
    return {
        "B1": (TA.attention_subblock, sub + (bias,), lambda *a: TA.attention_subblock(
            *a[:7], 2, attn_bias=a[7]), [ln, gemm, core, gemm]),
        "B2": (TM.mlp_subblock, mlp, lambda *a: TM.mlp_subblock(*a), [ln, gemm, gemm]),
        "B3": (TA.packed_qkv_self_attention, (qkv, bias),
               lambda a, b: TA.packed_qkv_self_attention(a, 2, attn_bias=b), [core]),
        "B7": (TA.fused_qkv_self_attention, (sub[0], sub[3], sub[4], bias),
               lambda *a: TA.fused_qkv_self_attention(*a[:3], 2, attn_bias=a[3]), [gemm, core]),
        "B8": (TA.packed_kv_cross_attention, (q, kv),
               lambda a, b: TA.packed_kv_cross_attention(a, b, 2), [core]),
        "B8 wide": (TA.packed_kv_cross_attention, (qw, kvw),
                    lambda a, b: TA.packed_kv_cross_attention(a, b, 1),
                    ["fern_attention_wide"]),
    }


@pytest.mark.parametrize("name", ["B1", "B2", "B3", "B7", "B8", "B8 wide"])
def test_grad_free_calls_launch_as_the_function_does(recording_card, name):
    """On a card, a call without gradients (no_grad, or no operand that
    requires grad) launches straight away: the same entries, in the same
    order, as the autograd Function's forward, with the same count; only
    the call that needs a gradient gets the Function's grad_fn."""
    wrapper, args, call, want = _entry_calls()[name]
    runs = {}
    for mode in ("no_grad", "detached", "grad"):
        operands = [a.clone().requires_grad_(mode != "detached") for a in args]
        before = (wrapper.launches, TA.packed_qkv_self_attention.launches)
        with torch.set_grad_enabled(mode != "no_grad"):
            out = call(*operands)
        counts = (wrapper.launches - before[0],
                  TA.packed_qkv_self_attention.launches - before[1])
        runs[mode] = (list(recording_card), counts, out.grad_fn)
        recording_card.clear()
    # B1 counts one B3 launch (its core) on every route: inside its
    # Function, grad mode is off, so that launch takes no Function of its own
    want_counts = (1, 1) if name in ("B1", "B3") else (1, 0)
    for mode in ("no_grad", "detached"):
        assert runs[mode][:2] == (want, want_counts) and runs[mode][2] is None
    assert runs["grad"][:2] == (want, want_counts)
    assert type(runs["grad"][2]).__name__.endswith("FunctionBackward")


@pytest.mark.parametrize("name", ["X2", "X3", "X4"])
def test_experiment_adapters_still_refuse_operands_that_require_grad(recording_card, name):
    """X2-X4 run B3, B7 and B1, which now differentiate; the JAX
    experiment's kernels have no VJP, so the adapters keep refusing an
    operand that requires grad on the card, and launch nothing."""
    from fashionern_aaai2024_tpu_torch.ops import attn_experiment as XA

    x = torch.zeros(2, 9, 128, requires_grad=True)
    w, z = torch.zeros(384, 128), torch.zeros(384)
    calls = {"X2": lambda: XA.mha_packed(torch.zeros(2, 9, 384, requires_grad=True), None,
                                         0.125, 1),
             "X3": lambda: XA.qkvattn(x, w, z, None, 0.125),
             "X4": lambda: XA.attnblock(x, z[:128], z[:128], w, z, torch.zeros(128, 128),
                                        z[:128], None, 0.125)}
    with pytest.raises(RuntimeError, match="requires grad"):
        calls[name]()
    assert not recording_card
    with torch.no_grad():
        calls[name]()
    assert recording_card


def test_shape_checks_raise_before_a_function_is_built(recording_card):
    """B8's shape checks (kv's shape, the routes' limits) and B1, B2, B7's
    weight checks raise as before, with operands that require grad, and
    launch nothing."""
    q = torch.zeros(2, 3, 2048, requires_grad=True)
    with pytest.raises(ValueError, match="up to 1024 at S <= 256"):
        TA.packed_kv_cross_attention(q, torch.zeros(2, 13, 4096), 1)
    with pytest.raises(ValueError, match="kv must be"):
        TA.packed_kv_cross_attention(q, torch.zeros(2, 13, 2048), 1)
    x = torch.zeros(2, 9, 128, requires_grad=True)
    z = torch.zeros(128)
    with pytest.raises(ValueError, match="for width 128"):
        TA.fused_qkv_self_attention(x, torch.zeros(128, 128), torch.zeros(384), 2)
    with pytest.raises(ValueError, match="for width 128"):
        TA.attention_subblock(x, z, z, torch.zeros(128, 128), z, torch.zeros(128, 128), z, 2)
    with pytest.raises(ValueError, match="for width 128"):
        TM.mlp_subblock(x, z, z, torch.zeros(512, 128), torch.zeros(512),
                        torch.zeros(512, 128), z)
    assert not recording_card


# --- CaLa trained: the registry's bbc on top, one Adam step --------------

CALA_D, CALA_B, CALA_S, CALA_LR = 32, 4, 5, 1e-2


def _jax_cala_loss(module, params, ref, tar, target):
    out = module.apply(params, ref, tar)
    pred = out / jnp.maximum(jnp.linalg.norm(out, axis=-1, keepdims=True), 1e-12)
    tgt = target / jnp.maximum(jnp.linalg.norm(target, axis=-1, keepdims=True), 1e-12)
    return JX.get_loss("bbc").fn(pred, tgt), out


@pytest.mark.parametrize("path", PATHS)
def test_cala_trains_as_jax_does(request, path):
    g = np.random.default_rng(600)
    ref, tar = _normal(g, (CALA_B, CALA_S, CALA_D)), _normal(g, (CALA_B, CALA_S, CALA_D))
    target = _normal(g, (CALA_B, CALA_D))
    torch.manual_seed(601)
    model = TZ.TwinAttentionCompositor(CALA_D)
    with torch.no_grad():       # every parameter nonzero, the biases too
        for p in model.parameters():
            p.copy_(torch.from_numpy(_normal(g, tuple(p.shape), 0.2)))
    names = [n for n, _ in model.named_parameters()]
    jm = JZ.TwinAttentionCompositor(CALA_D)
    # copies: `cala_from_torch` keeps numpy views of the torch parameters,
    # which the torch optimizer updates in place
    jparams = JZ.cala_from_torch({n: t.clone() for n, t in model.state_dict().items()})
    (jloss, jout), jgrads = jax.value_and_grad(
        lambda p: _jax_cala_loss(jm, p, ref, tar, target), has_aux=True)(jparams)

    if path == "function":
        ran = request.getfixturevalue("card")
    out = model(torch.from_numpy(ref), torch.from_numpy(tar))
    if path == "function":
        assert ran == ["B8"] * 8
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=ATOL)
    loss = TX.get_loss("bbc").fn(F.normalize(out, dim=-1),
                                 F.normalize(torch.from_numpy(target), dim=-1))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=0, atol=END_TO_END)
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    want = _flat(jgrads["params"])
    assert sorted(grads) == sorted(want) == sorted(names)
    for n in names:
        np.testing.assert_allclose(grads[n], want[n], rtol=0, atol=END_TO_END, err_msg=n)

    before = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    torch.optim.Adam(model.parameters(), lr=CALA_LR).step()
    opt = optax.adam(CALA_LR)
    updates, _ = opt.update(jgrads, opt.init(jparams), jparams)
    jafter = _flat(optax.apply_updates(jparams, updates)["params"])
    for n, p in model.named_parameters():
        got = p.detach().numpy()
        sign_free = np.abs(want[n]) <= END_TO_END
        np.testing.assert_allclose(got[~sign_free], jafter[n][~sign_free], rtol=0,
                                   atol=END_TO_END, err_msg=n)
        assert np.all(np.abs(got - before[n])[sign_free] <= 2 * CALA_LR), n
    # the key bias's gradient is exactly zero: rounding noise on both sides
    for n in names:
        if n.endswith("in_proj_bias"):
            np.testing.assert_allclose(grads[n][CALA_D:2 * CALA_D], 0.0, atol=1e-5, err_msg=n)


def _flat(params: dict) -> dict:
    """JAX CaLa parameters as the port's state-dict names (the inverse of
    `cala_from_torch`, whose out_proj kernel is the transposed weight)."""
    out = {}
    for attn, p in params.items():
        out[f"{attn}.in_proj_weight"] = np.asarray(p["in_proj_weight"])
        out[f"{attn}.in_proj_bias"] = np.asarray(p["in_proj_bias"])
        out[f"{attn}.out_proj.weight"] = np.asarray(p["out_proj"]["kernel"]).T
        out[f"{attn}.out_proj.bias"] = np.asarray(p["out_proj"]["bias"])
    return out
