"""Kernel B10 (`ops/block.py transformer_block`, the whole pre-LN block)
of the port, on the CPU, against the JAX package.

The port's plain version (the CPU path) against the JAX Pallas kernel
run as `tests/test_ops.py` runs it (`force_pallas=True, interpret=True`),
causal and not, `quick_gelu` and `gelu`, 2 heads of 64, B = 4, S = 10 and
77; `BlockFunction`'s backward (its launch replaced by the plain forward)
against `jax.grad` through `_block_diff`'s custom VJP; the small-config
text tower (every block through `transformer_block`) against JAX's
through the weight bridge. Weights are drawn in the JAX layout from a
numpy seed and transposed to the torch layout.

Tolerances: fp32 atol 3e-5, as `tests/test_ops.py` holds the Pallas
kernel against `_block_ref` (two LNs and four fp32 products summed in
another order); gradients at atol 3e-5, rtol 1e-4, as there; the tower
at the module tolerance, 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionern_aaai2024_tpu.ops import block as JB
from fashionern_aaai2024_tpu_torch.models.clip import transformer as TT
from fashionern_aaai2024_tpu_torch.ops import block as TB
from torch_port_helpers import CTX, both_models, small_config, to_np

torch.set_num_threads(2)


def _jax_inputs(b=4, s=10, heads=2, dh=64, seed=11):
    """`tests/test_ops.py TestTransformerBlockKernel._inputs`: JAX layout
    (w_qkv [W, 3W], w_out [W, W], w_fc [W, F], w_proj [F, W])."""
    g = np.random.default_rng(seed)
    w = heads * dh
    f = 4 * w
    mk = lambda *sh: (g.standard_normal(sh) * 0.05).astype(np.float32)  # noqa: E731
    return (g.standard_normal((b, s, w)).astype(np.float32),
            mk(w) + 1, mk(w), mk(w, 3 * w), mk(3 * w), mk(w, w), mk(w),
            mk(w) + 1, mk(w), mk(w, f), mk(f), mk(f, w), mk(w))


def _torch_layout(args):
    """The 13 tensors with every matrix transposed to the torch layout."""
    return [torch.from_numpy(np.ascontiguousarray(a.T if a.ndim == 2 else a)) for a in args]


@pytest.mark.parametrize("s", [10, 77])
@pytest.mark.parametrize("activation", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("causal", [False, True])
def test_transformer_block_matches_pallas(causal, activation, s):
    args = _jax_inputs(s=s)
    want = JB.transformer_block(*map(jnp.asarray, args), 2, causal=causal,
                                activation=activation, force_pallas=True, interpret=True)
    n0 = TB.transformer_block.launches
    got = TB.transformer_block(*_torch_layout(args), 2, causal=causal, activation=activation)
    assert TB.transformer_block.launches == n0  # the CPU runs the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_block_function_backward_matches_jax(monkeypatch, causal):
    """The CUDA path's autograd Function, its launch replaced by the plain
    forward: its backward (autograd of the recomputed plain composition)
    gives the gradients of all 13 tensors that `_block_diff`'s custom VJP
    gives (`tests/test_ops.py:724-745`)."""
    def plain_launch(*a):
        tensors, (heads, causal_, activation, scale, eps) = a[:13], a[13:]
        return TB.transformer_block_plain(*tensors, heads, causal=causal_,
                                          activation=activation, scale=scale, eps=eps)

    monkeypatch.setattr(TB, "_launch_block", plain_launch)
    args = _jax_inputs(b=2, s=6)

    def loss(*a):
        o = JB.transformer_block(*a, 2, causal=causal, force_pallas=True, interpret=True)
        return jnp.sum(jnp.tanh(o))

    want = jax.grad(loss, argnums=tuple(range(13)))(*map(jnp.asarray, args))
    ts = [t.requires_grad_() for t in _torch_layout(args)]
    out = TB.BlockFunction.apply(*ts, 2, causal, "quick_gelu", None, 1e-5)
    torch.tanh(out).sum().backward()
    for t, w, a in zip(ts, want, args):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w.T if a.ndim == 2 else w, atol=3e-5,
                                   rtol=1e-4)


def test_block_function_skips_what_needs_no_gradient(monkeypatch):
    """Only the operands that require grad get one; the rest are None."""
    monkeypatch.setattr(TB, "_launch_block", lambda *a: TB.transformer_block_plain(
        *a[:13], a[13], causal=a[14], activation=a[15], scale=a[16], eps=a[17]))
    ts = _torch_layout(_jax_inputs(b=1, s=5))
    ts[0].requires_grad_()
    ts[9].requires_grad_()
    TB.BlockFunction.apply(*ts, 2, True, "gelu", None, 1e-5).sum().backward()
    assert [i for i, t in enumerate(ts) if t.grad is not None] == [0, 9]


def test_dispatch_rule():
    """The query text towers at b = 1 and 32 (77 and 2,464 rows) take
    B10; the ViT-B-16 trunk at B = 32 and the train path's text tower take
    B1 + B2."""
    assert TB.use_block_kernel(77) and TB.use_block_kernel(32 * 77)
    assert not TB.use_block_kernel(32 * 197) and not TB.use_block_kernel(1024 * 77)


def test_block_wrapper_rejects_what_the_kernel_does_not_take():
    """The shape checks run before any launch (CUDA or not)."""
    ts = _torch_layout(_jax_inputs(b=1, s=5, heads=2, dh=64))
    with pytest.raises(ValueError, match="head dim"):
        TB._launch_block(*ts, 4, True, "gelu", None, 1e-5)
    long_x = torch.zeros(1, 300, 128)
    with pytest.raises(ValueError, match="S=300"):
        TB._launch_block(long_x, *ts[1:], 2, True, "gelu", None, 1e-5)
    with pytest.raises(ValueError, match="c_proj weight"):
        TB._launch_block(*ts[:9], ts[9][:-8], *ts[10:], 2, True, "gelu", None, 1e-5)
    with pytest.raises(ValueError, match="activation"):
        TB._launch_block(*ts, 2, True, "relu", None, 1e-5)


@pytest.fixture(scope="module")
def models():
    return both_models(small_config)


def test_text_tower_matches_jax_through_the_block(models, monkeypatch):
    """The small config's text tower (W = 128, 2 heads of 64, causal): its
    two blocks go through `transformer_block`, and the tower matches
    JAX's (whose blocks go through JAX's `transformer_block`)."""
    jm, v, tm = models
    calls = []

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return TB.transformer_block(*a, **kw)

    monkeypatch.setattr(TT, "transformer_block", spy)
    g = np.random.default_rng(5)
    ids = g.integers(1, 90, (3, CTX)).astype(np.int32)
    ids[:, -3] = 99  # EOT: the argmax row
    jg, js = jm.apply(v, ids, method=jm.encode_text)
    with torch.no_grad():
        tg, ts = tm.encode_text(torch.from_numpy(ids))
    assert len(calls) == 2
    np.testing.assert_allclose(to_np(tg), np.asarray(jg), atol=2e-5, rtol=0)
    np.testing.assert_allclose(to_np(ts), np.asarray(js), atol=2e-5, rtol=0)
