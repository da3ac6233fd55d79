"""The port's hand-written Hopper kernels against their plain versions,
on the card.

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: fp32 at atol 2e-5 (the port's module tolerance; the kernel
and the plain version sum in different orders); bf16 at atol = rtol =
2e-2 (bf16 keeps about three significant digits, and one rounding step
flipped by a different summation order moves a value by one ulp).
Weights are drawn at std 0.02, the CLIP / BERT init scale, which keeps
the projections below 2 in magnitude: a one-ulp flip there (<= 2^-7)
then stays inside atol even where `x + proj` cancels to a small result.

B4 (`bbc_rowloss`): row losses at atol 5e-4, rtol 1e-5 (the temperature
of 100 turns the fp32 ordering error of a d = 512 dot product, about
1e-6, into about 1e-4 on a score); gradients through the autograd
Function against the plain version's autograd at rtol 1e-4 and an atol
of 5e-5 times the largest gradient element (the fp32 rounding of scores
near 75 reaches the softmax as a relative error of about 1e-5).
"""

import numpy as np
import pytest
import torch

from fashionern_aaai2024_tpu_torch.ops import attention as A
from fashionern_aaai2024_tpu_torch.ops import losses as L
from fashionern_aaai2024_tpu_torch.ops import mlp as M

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=0.0),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}

# (batch, seq, width, heads, causal): ViT-B-16 and text-tower shapes
SHAPES = [(4, 197, 768, 12, False), (4, 77, 512, 8, True), (1, 77, 512, 8, True)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(g, shape, scale, dtype, device, offset=0.0):
    a = offset + scale * g.standard_normal(shape)
    return torch.tensor(a, dtype=torch.float32).to(dtype).to(device)


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,w,heads,causal", SHAPES)
def test_packed_attention_kernel_matches_plain(device, dtype, b, s, w, heads, causal):
    g = np.random.default_rng(0)
    qkv = _t(g, (b, s, 3 * w), 1.0, dtype, device)
    n0 = A.packed_qkv_self_attention.launches
    got = A.packed_qkv_self_attention(qkv, heads, causal=causal)
    torch.cuda.synchronize()
    assert A.packed_qkv_self_attention.launches == n0 + 1
    _close(got, A.packed_qkv_self_attention_plain(qkv, heads, causal=causal), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,w,heads,causal", SHAPES)
def test_attention_subblock_kernel_matches_plain(device, dtype, b, s, w, heads, causal):
    g = np.random.default_rng(1)
    args = (_t(g, (b, s, w), 1.0, dtype, device),
            _t(g, (w,), 0.1, dtype, device, 1.0), _t(g, (w,), 0.1, dtype, device),
            _t(g, (3 * w, w), 0.02, dtype, device), _t(g, (3 * w,), 0.02, dtype, device),
            _t(g, (w, w), 0.02, dtype, device), _t(g, (w,), 0.02, dtype, device))
    n0 = A.attention_subblock.launches
    got = A.attention_subblock(*args, heads, causal=causal)
    torch.cuda.synchronize()
    assert A.attention_subblock.launches == n0 + 1
    _close(got, A.attention_subblock_plain(*args, heads, causal=causal), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("b,s,w", [(4, 197, 768), (1, 77, 512)])
def test_mlp_subblock_kernel_matches_plain(device, dtype, activation, b, s, w):
    g = np.random.default_rng(2)
    f = 4 * w
    args = (_t(g, (b, s, w), 1.0, dtype, device),
            _t(g, (w,), 0.1, dtype, device, 1.0), _t(g, (w,), 0.1, dtype, device),
            _t(g, (f, w), 0.02, dtype, device), _t(g, (f,), 0.02, dtype, device),
            _t(g, (w, f), 0.02, dtype, device), _t(g, (w,), 0.02, dtype, device))
    n0 = M.mlp_subblock.launches
    got = M.mlp_subblock(*args, activation=activation)
    torch.cuda.synchronize()
    assert M.mlp_subblock.launches == n0 + 1
    _close(got, M.mlp_subblock_plain(*args, activation=activation), dtype)


def test_kernels_reject_what_they_do_not_take(device):
    qkv = torch.zeros((2, 300, 3 * 128), device=device)
    with pytest.raises(ValueError, match="S=300"):
        A.packed_qkv_self_attention(qkv, 2)
    with pytest.raises(ValueError, match="head dim"):
        A.packed_qkv_self_attention(torch.zeros((2, 10, 3 * 96), device=device), 3)
    with pytest.raises(TypeError, match="float16"):
        A.packed_qkv_self_attention(torch.zeros((2, 10, 384), device=device,
                                                dtype=torch.float16), 2)


def _bbc_inputs(b, d, device, seed=3):
    """Unit rows around one shared direction (scores near 75, row losses
    of a few units), as in tests/test_torch_ops.py."""
    g = np.random.default_rng(seed)
    c = g.standard_normal(d)
    n1, n2 = (g.standard_normal((b, d)) / np.sqrt(d) for _ in range(2))
    pred, tar = c / np.linalg.norm(c) + 0.6 * n1, c / np.linalg.norm(c) + 0.6 * n2 + 0.1 * n1
    unit = lambda a: torch.tensor(a / np.linalg.norm(a, axis=1, keepdims=True),
                                  dtype=torch.float32, device=device)
    return unit(pred), unit(tar)


@pytest.mark.parametrize("d", [24, 512, 640])
@pytest.mark.parametrize("b", [1, 13, 128, 200, 1024])
def test_bbc_rowloss_kernel_matches_plain(device, b, d):
    pred, tar = _bbc_inputs(b, d, device)
    n0 = L.bbc_rowloss.launches
    got = L.bbc_rowloss(pred, tar)
    torch.cuda.synchronize()
    assert L.bbc_rowloss.launches == n0 + 1
    torch.testing.assert_close(got, L.bbc_rowloss_plain(pred, tar), atol=5e-4, rtol=1e-5)


@pytest.mark.parametrize("b,d", [(13, 24), (200, 512), (1024, 512)])
def test_bbc_autograd_matches_plain_autograd(device, b, d):
    pred, tar = _bbc_inputs(b, d, device, seed=4)
    p1, t1 = pred.clone().requires_grad_(), tar.clone().requires_grad_()
    loss = L.batch_based_classification_loss(p1, t1)
    loss.backward()
    p2, t2 = pred.clone().requires_grad_(), tar.clone().requires_grad_()
    want = L.bbc_rowloss_plain(p2, t2).mean()
    want.backward()
    torch.testing.assert_close(loss, want, atol=5e-4, rtol=1e-5)
    for got, want in ((p1.grad, p2.grad), (t1.grad, t2.grad)):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=5e-5 * want.abs().max().item())


def test_cuda_wrappers_refuse_operands_that_require_grad(device):
    """A ctypes launch returns a tensor with no grad_fn: a gradient would
    be dropped, so the wrappers raise instead."""
    w = 128
    x = torch.randn(2, 9, w, device=device, requires_grad=True)
    ln = torch.ones(w, device=device)
    zeros = torch.zeros(w, device=device)
    with pytest.raises(RuntimeError, match="requires grad"):
        A.attention_subblock(x, ln, zeros, torch.zeros(3 * w, w, device=device),
                             torch.zeros(3 * w, device=device),
                             torch.zeros(w, w, device=device), zeros, 2)
    with pytest.raises(RuntimeError, match="requires grad"):
        M.mlp_subblock(x, ln, zeros, torch.zeros(4 * w, w, device=device),
                       torch.zeros(4 * w, device=device),
                       torch.zeros(w, 4 * w, device=device), zeros)
    with pytest.raises(RuntimeError, match="requires grad"):
        A.packed_qkv_self_attention(torch.randn(2, 9, 3 * w, device=device,
                                                requires_grad=True), 2)
    with pytest.raises(RuntimeError, match="requires grad"):
        L.bbc_rowloss(x[0], x[0])
    with torch.no_grad():
        A.packed_qkv_self_attention(torch.randn(2, 9, 3 * w, device=device,
                                                requires_grad=True), 2)
