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
"""

import numpy as np
import pytest
import torch

from fashionern_aaai2024_tpu_torch.ops import attention as A
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
