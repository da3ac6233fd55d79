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

B5 and B6 (`int8_mlp_subblock`, `int8_attention_subblock`): the
kernels and the plain versions quantize the same values, but the LN's
mean and variance, quick_gelu and the attention sum in another order, so
a value on a rounding boundary can land on the other side and flip one
int8 code by one step. The LN + quantize kernel alone is held to that:
codes equal except at most 0.1% flipped, each by exactly one. A flipped
code moves the outputs that depend on it by about one quantization step
of a product (activation scale, an absmax near 4 over 127, times weights
drawn at std 0.02, largest near 0.1): in fp32 at most INT8_STEP = 1.2e-2
beyond the float tolerance above (6.3e-3 read at ViT B=4 on an H100); in
bf16 the bf16 tolerance holds it (INT8_STEP = 0). One flip in a key or
value token moves every query row of its image a little, so in fp32 a
large share of the elements can sit off 2e-5 (30% of the rows at ViT
B=4); the mean error is held instead, per dtype, between the largest
reading of these tests (fp32 1.2e-5, bf16 2.5e-6) and the smallest of a
control that rounds the activations to bf16 before quantizing (fp32
1.3e-4, bf16 1.4e-4): INT8_MEAN = 4e-5 in fp32 and 3e-5 in bf16, the
limits `chip_smoke.py` holds the serve shapes to.

B7 (`fused_qkv_self_attention`), B8 (`packed_kv_cross_attention`) and
B11 (`layer_norm`) at the tolerances above, at head dim 64 and 80; B11's
autograd Function against the plain version's autograd at rtol 1e-5 and
an atol of 1e-5 times the largest gradient element (two fp32 reductions
in another order). The small RN50x4-shaped ResNet tower (tests/test_clip.py
RN_SMALL), card against CPU in fp32 with TF32 off, at atol 1e-4: cuDNN
and the CPU's convolutions sum in other orders through 14 convolutions.

B9 (`multi_head_attention`) at the tolerances above, at TME's shapes
(77 text tokens against 13 patches, 8 heads of 64 and 80) read through
head views of [B, S, H*Dh] rows and from contiguous [B, H, S, Dh], with a
causal + arbitrary bias where Sq != Sk, and at 256 keys; through the
grouped kernel (csrc/attention_grouped.cu) at head dims 96 and 128 and at
300, 512 and 1024 keys; its autograd
Function against the plain version's autograd at rtol 1e-4 and an atol
of 1e-5 times the largest gradient element. B12 (`combiner_apply`) at
d = 512 and 640 and M = 1, 33, 128 and 1024 (fp32: 8, 8, 5 and 1 K
slices of the hidden product at d = 512, 7, 7, 4 and 1 at 640), at the
tolerances above.

The attention experiment's X1-X4 (`ops/attn_experiment.py`) at its own
shapes at batch 2 to 4, at the tolerances above: X1 (the grouped kernel)
on every row and lane of the padded output, a row whose keys all carry
the -1e30 bias included, at G of 1 and 8; X2 at gb of 1, 2 and 4; a G or
gb that does not divide its count raises.

The bf16 attention kernels run 16-row warp tiles over 16-key tiles on
the tensor cores, staged by 16-byte (else 4-byte or element) copies: B3,
B8, B9 and B6's core at the tiles' ragged edges (1, 15, 16, 17, 63, 65
and 197 rows and keys) in every layout, causal, with an arbitrary or a
-inf left-padding bias and two images a block; misaligned head views;
the grouped kernel at 1-1024 keys with 16-byte (head dims 128, 96) and
4-byte (34, 126) staging; B10 bit for bit against B1 + B2 at b = 1 and
32; all at the bf16 tolerance above. One test reads the library's SASS
(`cuobjdump -sass`): every bf16 instance of the core and the grouped
kernel issues HMMA and LDGSTS.

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
from fashionern_aaai2024_tpu_torch.ops import combiner as Cb
from fashionern_aaai2024_tpu_torch.ops import common
from fashionern_aaai2024_tpu_torch.ops import layernorm as LN
from fashionern_aaai2024_tpu_torch.ops import losses as L
from fashionern_aaai2024_tpu_torch.ops import mlp as M
from fashionern_aaai2024_tpu_torch.ops import qmlp as Q
from fashionern_aaai2024_tpu_torch.ops.qmatmul import quantize_rowwise

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


# (batch, sq, sk, heads, head dim): the RN50x4 attention pool, the DVR
# MR cross-attention at d = 640 and 512, the largest key count
CROSS_SHAPES = [(4, 1, 82, 40, 64), (4, 77, 13, 8, 80), (4, 77, 13, 8, 64), (2, 5, 256, 2, 80)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,heads,dh", CROSS_SHAPES)
def test_cross_attention_kernel_matches_plain(device, dtype, b, sq, sk, heads, dh):
    g = np.random.default_rng(10)
    w = heads * dh
    q, kv = _t(g, (b, sq, w), 1.0, dtype, device), _t(g, (b, sk, 2 * w), 1.0, dtype, device)
    n0 = A.packed_kv_cross_attention.launches
    got = A.packed_kv_cross_attention(q, kv, heads)
    torch.cuda.synchronize()
    assert A.packed_kv_cross_attention.launches == n0 + 1
    _close(got, A.packed_kv_cross_attention_plain(q, kv, heads), dtype)


# (batch, seq, heads, head dim, causal): the DVR BERT at d = 640 and 512,
# a short sequence, and a causal case of the core at head dim 80
QKV_SHAPES = [(4, 91, 8, 80, False), (4, 91, 8, 64, False), (2, 11, 2, 80, False),
              (2, 77, 2, 80, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,heads,dh,causal", QKV_SHAPES)
def test_fused_qkv_kernel_matches_plain(device, dtype, b, s, heads, dh, causal):
    g = np.random.default_rng(11)
    w = heads * dh
    args = (_t(g, (b, s, w), 1.0, dtype, device), _t(g, (3 * w, w), 0.02, dtype, device),
            _t(g, (3 * w,), 0.02, dtype, device))
    n0 = A.fused_qkv_self_attention.launches
    got = A.fused_qkv_self_attention(*args, heads, causal=causal)
    torch.cuda.synchronize()
    assert A.fused_qkv_self_attention.launches == n0 + 1
    _close(got, A.fused_qkv_self_attention_plain(*args, heads, causal=causal), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,w,eps", [(32 * 77, 640, 1e-5), (4 * 91, 640, 1e-12),
                                        (4 * 197, 768, 1e-5), (37, 128, 1e-5)])
def test_layer_norm_kernel_matches_plain(device, dtype, rows, w, eps):
    g = np.random.default_rng(12)
    x = _t(g, (rows, w), 1.0, dtype, device, offset=2.0)
    ln_w, ln_b = _t(g, (w,), 0.1, dtype, device, 1.0), _t(g, (w,), 0.1, dtype, device)
    n0 = LN.layer_norm.launches
    got = LN.layer_norm(x, ln_w, ln_b, eps)
    torch.cuda.synchronize()
    assert LN.layer_norm.launches == n0 + 1
    _close(got, LN.layer_norm_plain(x, ln_w, ln_b, eps), dtype)


def test_layer_norm_autograd_matches_plain_autograd(device):
    g = np.random.default_rng(13)
    w = 640
    x0 = _t(g, (2, 91, w), 1.0, torch.float32, device)
    ln0 = (_t(g, (w,), 0.1, torch.float32, device, 1.0), _t(g, (w,), 0.1, torch.float32, device))
    up = _t(g, (2, 91, w), 1.0, torch.float32, device)
    ours = [t.clone().requires_grad_() for t in (x0, *ln0)]
    plain = [t.clone().requires_grad_() for t in (x0, *ln0)]
    (LN.layer_norm(*ours, 1e-12) * up).sum().backward()
    (LN.layer_norm_plain(*plain, 1e-12) * up).sum().backward()
    for a, b in zip(ours, plain):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5,
                                   atol=1e-5 * b.grad.abs().max().item())


def test_b7_b8_refuse_operands_that_require_grad(device):
    w = 160
    x = torch.randn(2, 9, w, device=device, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        A.fused_qkv_self_attention(x, torch.zeros(3 * w, w, device=device),
                                   torch.zeros(3 * w, device=device), 2)
    with pytest.raises(RuntimeError, match="requires grad"):
        A.packed_kv_cross_attention(x, torch.zeros(2, 13, 2 * w, device=device), 2)
    with pytest.raises(ValueError, match="head dim"):
        A.packed_kv_cross_attention(torch.zeros(2, 9, 96, device=device),
                                    torch.zeros(2, 13, 192, device=device), 2)
    with pytest.raises(ValueError, match="S=300"):
        A.packed_kv_cross_attention(torch.zeros(2, 9, w, device=device),
                                    torch.zeros(2, 300, 2 * w, device=device), 2)
    with torch.no_grad():
        A.packed_kv_cross_attention(x, torch.zeros(2, 13, 2 * w, device=device), 2)


def test_small_resnet_tower_card_matches_cpu(device):
    from fashionern_aaai2024_tpu_torch.models.clip.config import CLIPConfig, TextConfig, \
        VisionConfig
    from fashionern_aaai2024_tpu_torch.models.composed import ComposedCIRModel, random_init_

    cfg = CLIPConfig(name="rn-small", vision=VisionConfig(kind="resnet", image_size=64,
                                                          embed_dim=24, width=16,
                                                          layers=(1, 1, 1, 1), heads=8),
                     text=TextConfig(vocab_size=100, context_length=16, width=32, heads=4,
                                     layers=2, embed_dim=24))
    cpu = random_init_(ComposedCIRModel(cfg), torch.Generator().manual_seed(0)).eval()
    images = torch.tensor(np.random.default_rng(14).standard_normal((3, 64, 64, 3)),
                          dtype=torch.float32)
    with torch.no_grad():
        want = cpu.encode_image(images)
        card = cpu.to(device)
        n0 = A.packed_kv_cross_attention.launches
        got = card.encode_image(images.to(device))
        torch.cuda.synchronize()
    assert A.packed_kv_cross_attention.launches == n0 + 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4)


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


# --- B5 and B6: the int8 sub-blocks -------------------------------------

INT8_SHAPES = [(2, 9, 128, 2, False)] + SHAPES
INT8_STEP = {torch.float32: 1.2e-2, torch.bfloat16: 0.0}
INT8_MEAN = {torch.float32: 4e-5, torch.bfloat16: 3e-5}


def _close_up_to_flips(got, want, dtype):
    """TOL[dtype] + INT8_STEP[dtype] on every element, mean error <=
    INT8_MEAN[dtype]."""
    err = (got.float() - want.float()).abs()
    limit = TOL[dtype]["atol"] + TOL[dtype]["rtol"] * want.float().abs() + INT8_STEP[dtype]
    assert (err <= limit).all(), err.max().item()
    assert err.mean().item() <= INT8_MEAN[dtype], err.mean().item()


def _int8_weight(g, out_f, in_f, device, dtype):
    q, s = quantize_rowwise(_t(g, (out_f, in_f), 0.02, dtype, device))
    return q, s.reshape(-1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,w", [(2, 9, 128), (4, 197, 768), (1, 77, 512)])
def test_ln_quant_kernel_matches_plain(device, dtype, b, s, w):
    g = np.random.default_rng(5)
    x = _t(g, (b * s, w), 1.0, dtype, device)
    ln_w, ln_b = _t(g, (w,), 0.1, dtype, device, 1.0), _t(g, (w,), 0.1, dtype, device)
    q, scale = common.launch_ln_quant(x, ln_w, ln_b, 1e-5)
    want_q, want_scale = Q.ln_quantize(x, ln_w, ln_b, 1e-5)
    torch.cuda.synchronize()
    torch.testing.assert_close(scale, want_scale, atol=0.0, rtol=1e-6)
    diff = (q.int() - want_q.int()).abs()
    assert diff.max().item() <= 1
    assert diff.float().mean().item() <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,w,heads,causal", INT8_SHAPES)
def test_int8_mlp_kernel_matches_plain(device, dtype, b, s, w, heads, causal):
    g = np.random.default_rng(6)
    f = 4 * w
    args = (_t(g, (b, s, w), 1.0, dtype, device),
            _t(g, (w,), 0.1, dtype, device, 1.0), _t(g, (w,), 0.1, dtype, device),
            *_int8_weight(g, f, w, device, dtype), _t(g, (f,), 0.02, dtype, device),
            *_int8_weight(g, w, f, device, dtype), _t(g, (w,), 0.02, dtype, device))
    n0 = Q.int8_mlp_subblock.launches
    got = Q.int8_mlp_subblock(*args, activation="quick_gelu")
    torch.cuda.synchronize()
    assert Q.int8_mlp_subblock.launches == n0 + 1
    _close_up_to_flips(got, Q.int8_mlp_subblock_plain(*args, activation="quick_gelu"), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,w,heads,causal", INT8_SHAPES)
def test_int8_attention_kernel_matches_plain(device, dtype, b, s, w, heads, causal):
    g = np.random.default_rng(7)
    args = (_t(g, (b, s, w), 1.0, dtype, device),
            _t(g, (w,), 0.1, dtype, device, 1.0), _t(g, (w,), 0.1, dtype, device),
            *_int8_weight(g, 3 * w, w, device, dtype), _t(g, (3 * w,), 0.02, dtype, device),
            *_int8_weight(g, w, w, device, dtype), _t(g, (w,), 0.02, dtype, device))
    n0 = Q.int8_attention_subblock.launches
    got = Q.int8_attention_subblock(*args, heads, causal=causal)
    torch.cuda.synchronize()
    assert Q.int8_attention_subblock.launches == n0 + 1
    _close_up_to_flips(got, Q.int8_attention_subblock_plain(*args, heads, causal=causal),
                       dtype)


def test_int8_wrappers_refuse_operands_that_require_grad(device):
    w = 128
    g = np.random.default_rng(8)
    x = torch.randn(2, 9, w, device=device, requires_grad=True)
    ln, zeros = torch.ones(w, device=device), torch.zeros(w, device=device)
    fc, proj = _int8_weight(g, 4 * w, w, device, torch.float32), _int8_weight(
        g, w, 4 * w, device, torch.float32)
    with pytest.raises(RuntimeError, match="requires grad"):
        Q.int8_mlp_subblock(x, ln, zeros, *fc, torch.zeros(4 * w, device=device), *proj, zeros)
    qkv, out = _int8_weight(g, 3 * w, w, device, torch.float32), _int8_weight(
        g, w, w, device, torch.float32)
    with pytest.raises(RuntimeError, match="requires grad"):
        Q.int8_attention_subblock(x, ln, zeros, *qkv, torch.zeros(3 * w, device=device), *out,
                                  zeros, 2)
    with torch.no_grad():
        Q.int8_attention_subblock(x, ln, zeros, *qkv, torch.zeros(3 * w, device=device), *out,
                                  zeros, 2)


# --- B9 and B12 ----------------------------------------------------------

# (batch, heads, sq, sk, head dim, layout, causal, bias): TME at d = 512
# and 640 on head views of the projections, the same as contiguous
# [B, H, S, Dh], a causal + biased case with Sq != Sk, the largest key
# count; bias "-inf": -inf on the keys before a row's index, 0 from it on
# and on the last key (left padding as PyTorch code often writes it: a
# lane's first keys are masked before it meets a finite one), on both
# kernels
MHA_SHAPES = [(4, 8, 77, 13, 64, "rows", False, False), (4, 8, 77, 13, 80, "rows", False, False),
              (2, 8, 77, 13, 64, "contiguous", False, False),
              (2, 2, 13, 9, 80, "rows", True, True), (2, 2, 5, 256, 64, "contiguous", False, True),
              # the grouped kernel: head dim 128 or 96, or more than 256 keys
              (2, 4, 77, 300, 128, "rows", False, True),
              (2, 2, 64, 512, 64, "contiguous", True, False),
              (1, 2, 9, 1024, 96, "rows", False, True), (2, 2, 33, 33, 128, "rows", True, False),
              (2, 4, 40, 300, 128, "rows", False, "-inf"),
              (2, 4, 77, 13, 64, "rows", False, "-inf"), (2, 2, 64, 512, 96, "rows", False, "-inf")]


def _mha_operands(g, b, h, sq, sk, dh, layout, dtype, device):
    def one(s):
        t = _t(g, (b, s, h * dh), 1.0, dtype, device).view(b, s, h, dh).transpose(1, 2)
        return t.contiguous() if layout == "contiguous" else t
    return one(sq), one(sk), one(sk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,sq,sk,dh,layout,causal,with_bias", MHA_SHAPES)
def test_mha_kernel_matches_plain(device, dtype, b, h, sq, sk, dh, layout, causal, with_bias):
    g = np.random.default_rng(20)
    q, k, v = _mha_operands(g, b, h, sq, sk, dh, layout, dtype, device)
    bias = _t(g, (sq, sk), 2.0, torch.float32, device) if with_bias else None
    if with_bias == "-inf":
        keep = torch.ones((sq, sk), dtype=torch.bool, device=device).triu()
        keep[:, -1] = True
        bias = torch.zeros((sq, sk), device=device).masked_fill(~keep, float("-inf"))
    n0 = A.multi_head_attention.launches
    got = A.multi_head_attention(q, k, v, causal=causal, bias=bias)
    torch.cuda.synchronize()
    assert A.multi_head_attention.launches == n0 + 1
    assert got.shape == (b, h, sq, dh) and torch.isfinite(got.float()).all()
    want = A.mha_plain(q, k, v, A.shared_bias(causal, bias, sq, sk, device))
    _close(got, want, dtype)


def test_mha_autograd_matches_plain_autograd(device):
    g = np.random.default_rng(21)
    q0, k0, v0 = _mha_operands(g, 4, 8, 77, 13, 64, "rows", torch.float32, device)
    up = _t(g, (4, 8, 77, 64), 1.0, torch.float32, device)
    ours = [t.detach().clone().requires_grad_() for t in (q0, k0, v0)]
    plain = [t.detach().clone().requires_grad_() for t in (q0, k0, v0)]
    n0 = A.multi_head_attention.launches
    (A.multi_head_attention(*ours) * up).sum().backward()
    assert A.multi_head_attention.launches == n0 + 1
    (A.mha_plain(*plain) * up).sum().backward()
    for a, b in zip(ours, plain):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4,
                                   atol=1e-5 * b.grad.abs().max().item())


def test_mha_kernel_rejects_what_it_does_not_take(device):
    for dh in (160, 127):
        z = torch.zeros(2, 2, 9, dh, device=device)
        with pytest.raises(ValueError, match="head dim"):
            A.multi_head_attention(z, z, z)
    q = torch.zeros(2, 2, 9, 64, device=device)
    kv = torch.zeros(2, 2, 300, 64, device=device)
    with pytest.raises(ValueError, match="bias"):
        A.multi_head_attention(q, kv, kv, bias=torch.zeros(9, 299, device=device))
    with pytest.raises(RuntimeError, match="requires grad"):
        A._launch_mha(q.requires_grad_(), kv[:, :, :9], kv[:, :, :9], None, 0.125)


def _combiner(d, dtype, device, seed):
    from fashionern_aaai2024_tpu_torch.models.ern.fusion import CombinerSimple

    gen = torch.Generator().manual_seed(seed)
    m = CombinerSimple(d)
    with torch.no_grad():
        for name, p in m.named_parameters():
            std = 0.02 if name.endswith("bias") else p.shape[1] ** -0.5
            p.copy_(torch.randn(p.shape, generator=gen) * std)
    return m.to(device, dtype).eval()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [512, 640])
@pytest.mark.parametrize("m", [1, 33, 128, 1024])
def test_combiner_kernel_matches_plain(device, dtype, d, m):
    g = np.random.default_rng(22)
    module = _combiner(d, dtype, device, seed=d)
    img, txt = _t(g, (m, d), 1.0, dtype, device), _t(g, (m, d), 1.0, dtype, device)
    n0 = Cb.combiner_apply.launches
    with torch.no_grad():
        got = module(img, txt)
        torch.cuda.synchronize()
        assert Cb.combiner_apply.launches == n0 + 1
        _close(got, Cb.combiner_apply_plain(img, txt, module), dtype)


def test_combiner_kernel_rejects_what_it_does_not_take(device):
    module = _combiner(512, torch.float32, device, seed=1)
    x = torch.randn(4, 512, device=device)
    with pytest.raises(RuntimeError, match="requires grad"):
        Cb.combiner_apply(x, x, module)
    with torch.no_grad():
        with pytest.raises(TypeError, match="mixed dtypes"):
            Cb.combiner_apply(x.bfloat16(), x.bfloat16(), module)
        with pytest.raises(ValueError, match="expected two"):
            Cb.combiner_apply(x, x[:2], module)


def _block_args(g, b, s, w, dtype, device):
    f = 4 * w
    return (_t(g, (b, s, w), 1.0, dtype, device),
            _t(g, (w,), 0.1, dtype, device, 1.0), _t(g, (w,), 0.1, dtype, device),
            _t(g, (3 * w, w), 0.02, dtype, device), _t(g, (3 * w,), 0.02, dtype, device),
            _t(g, (w, w), 0.02, dtype, device), _t(g, (w,), 0.02, dtype, device),
            _t(g, (w,), 0.1, dtype, device, 1.0), _t(g, (w,), 0.1, dtype, device),
            _t(g, (f, w), 0.02, dtype, device), _t(g, (f,), 0.02, dtype, device),
            _t(g, (w, f), 0.02, dtype, device), _t(g, (w,), 0.02, dtype, device))


# (batch, seq, width, heads, causal): the text towers of ViT-B-16 and
# RN50x4 at b = 1 and 4, the ViT-B-16 trunk
BLOCK_SHAPES = [(1, 77, 512, 8, True), (4, 77, 512, 8, True), (1, 77, 640, 10, True),
                (4, 77, 640, 10, True), (2, 197, 768, 12, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("b,s,w,heads,causal", BLOCK_SHAPES)
def test_block_kernel_matches_plain(device, dtype, activation, b, s, w, heads, causal):
    """Kernel B10 (one launch) against its plain version (B1's then B2's
    rounding points), and against B1 + B2 launched one after the other,
    which run the same device code."""
    from fashionern_aaai2024_tpu_torch.ops import block as B

    args = _block_args(np.random.default_rng(30), b, s, w, dtype, device)
    n0 = B.transformer_block.launches
    got = B._launch_block(*args, heads, causal, activation, None, 1e-5)
    torch.cuda.synchronize()
    _close(got, B.transformer_block_plain(*args, heads, causal=causal, activation=activation),
           dtype)
    pair = M.mlp_subblock(A.attention_subblock(*args[:7], heads, causal=causal), *args[7:],
                          activation=activation)
    torch.testing.assert_close(got, pair, atol=0, rtol=0)
    B.transformer_block(*args, heads, causal=causal, activation=activation)
    assert B.transformer_block.launches == n0 + 1


def test_block_function_gradients_match_plain_autograd(device):
    """`BlockFunction` (forward: B10) against autograd of the plain
    version, fp32, text tower shape at B = 2: all 13 gradients."""
    from fashionern_aaai2024_tpu_torch.ops import block as B

    g = np.random.default_rng(31)
    args = _block_args(g, 2, 77, 512, torch.float32, device)
    up = _t(g, (2, 77, 512), 1.0, torch.float32, device)
    ours = [t.detach().clone().requires_grad_() for t in args]
    plain = [t.detach().clone().requires_grad_() for t in args]
    n0 = B.transformer_block.launches
    (B.transformer_block(*ours, 8, causal=True) * up).sum().backward()
    assert B.transformer_block.launches == n0 + 1
    (B.transformer_block_plain(*plain, 8, causal=True) * up).sum().backward()
    for a, b in zip(ours, plain):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4,
                                   atol=1e-5 * b.grad.abs().max().item())


def test_block_kernel_rejects_what_it_does_not_take(device):
    from fashionern_aaai2024_tpu_torch.ops import block as B

    args = _block_args(np.random.default_rng(32), 1, 77, 512, torch.float32, device)
    with pytest.raises(TypeError, match="mixed dtypes"):
        B._launch_block(args[0].bfloat16(), *args[1:], 8, True, "gelu", None, 1e-5)
    with pytest.raises(ValueError, match="head dim"):
        B._launch_block(*args, 4, True, "gelu", None, 1e-5)
    with pytest.raises(RuntimeError, match="requires grad"):
        B._launch_block(args[0].requires_grad_(), *args[1:], 8, True, "gelu", None, 1e-5)


def test_mha_autograd_gives_the_bias_gradient(device):
    """B9's autograd Function returns the gradient of an additive bias
    that requires grad (ROADMAP C9), equal to the plain version's."""
    g = np.random.default_rng(23)
    q0, k0, v0 = _mha_operands(g, 4, 8, 77, 13, 64, "rows", torch.float32, device)
    b0 = _t(g, (77, 13), 2.0, torch.float32, device)
    up = _t(g, (4, 8, 77, 64), 1.0, torch.float32, device)
    ours = [t.detach().clone().requires_grad_() for t in (q0, k0, v0, b0)]
    plain = [t.detach().clone().requires_grad_() for t in (q0, k0, v0, b0)]
    n0 = A.multi_head_attention.launches
    (A.multi_head_attention(*ours[:3], bias=ours[3]) * up).sum().backward()
    assert A.multi_head_attention.launches == n0 + 1
    (A.mha_plain(*plain) * up).sum().backward()
    for a, b in zip(ours, plain):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4,
                                   atol=1e-5 * b.grad.abs().max().item())


def test_grouped_mha_autograd_gives_the_bias_gradient(device):
    """B9 through the grouped kernel (Sk = 300, head dim 128): the
    autograd Function's gradients of q, k, v and the bias equal the plain
    version's."""
    g = np.random.default_rng(24)
    q0, k0, v0 = _mha_operands(g, 2, 4, 77, 300, 128, "rows", torch.float32, device)
    b0 = _t(g, (77, 300), 2.0, torch.float32, device)
    up = _t(g, (2, 4, 77, 128), 1.0, torch.float32, device)
    ours = [t.detach().clone().requires_grad_() for t in (q0, k0, v0, b0)]
    plain = [t.detach().clone().requires_grad_() for t in (q0, k0, v0, b0)]
    n0 = A.multi_head_attention.launches
    (A.multi_head_attention(*ours[:3], bias=ours[3]) * up).sum().backward()
    assert A.multi_head_attention.launches == n0 + 1
    (A.mha_plain(*plain) * up).sum().backward()
    for a, b in zip(ours, plain):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4,
                                   atol=1e-5 * b.grad.abs().max().item())


# --- the attention experiment, X1-X4 -------------------------------------


def _x1_operands(g, bh, dtype, device):
    """X1's padded operands: q [BH, 208, 128], k and v [BH, 256, 128],
    zero past 197 rows and 64 lanes; the fp32 [208, 256] bias masks the
    padded keys, and row 3 masks every key."""
    from fashionern_aaai2024_tpu_torch.ops import attn_experiment as X

    def pad(rows):
        t = torch.zeros((bh, rows, X.DP))
        t[:, :X.S, :X.DH] = torch.from_numpy(g.standard_normal((bh, X.S, X.DH)))
        return t.to(device, dtype)

    bias = torch.zeros((X.SP, X.SKP))
    bias[:, X.S:] = A.NEG_INF
    bias[3] = A.NEG_INF
    return pad(X.SP), pad(X.SKP), pad(X.SKP), bias.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grp", [1, 8])
def test_x1_grouped_kernel_matches_plain(device, dtype, grp):
    from fashionern_aaai2024_tpu_torch.ops import attn_experiment as X

    q, k, v, bias = _x1_operands(np.random.default_rng(40), 2 * X.H, dtype, device)
    n0 = X.mha_grouped.launches
    got = X.mha_grouped(q, k, v, bias, X.DH ** -0.5, grp)
    torch.cuda.synchronize()
    assert X.mha_grouped.launches == n0 + 1
    assert got.shape == q.shape
    _close(got, X.mha_grouped_plain(q, k, v, bias, X.DH ** -0.5, grp), dtype)
    _close(got[:, 3], v.float().mean(dim=1).expand(got.shape[0], -1), dtype)
    with pytest.raises(ValueError, match="do not divide"):
        X.mha_grouped(q, k, v, bias, X.DH ** -0.5, 5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gb", [1, 2, 4])
def test_x2_packed_kernel_matches_plain(device, dtype, gb):
    from fashionern_aaai2024_tpu_torch.ops import attn_experiment as X

    g = np.random.default_rng(41)
    qkv = _t(g, (4, X.SP, 3 * X.W), 1.0, dtype, device)
    qkv[:, X.S:] = 0
    bias = torch.zeros((X.SP, X.SP), device=device)
    bias[:, X.S:] = A.NEG_INF
    n0 = X.mha_packed.launches
    got = X.mha_packed(qkv, bias, X.DH ** -0.5, gb)
    torch.cuda.synchronize()
    assert X.mha_packed.launches == n0 + 1
    _close(got, X.mha_packed_plain(qkv, bias, X.DH ** -0.5, gb), dtype)
    with pytest.raises(ValueError, match="do not divide"):
        X.mha_packed(qkv, bias, X.DH ** -0.5, 3)


def _x_weights(g, dtype, device, w):
    return dict(g=_t(g, (w,), 0.1, dtype, device, 1.0), be=_t(g, (w,), 0.1, dtype, device),
                w_qkv=_t(g, (3 * w, w), 0.02, dtype, device),
                b_qkv=_t(g, (3 * w,), 0.02, dtype, device),
                w_out=_t(g, (w, w), 0.02, dtype, device), b_out=_t(g, (w,), 0.02, dtype, device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_x3_qkvattn_kernel_matches_plain(device, dtype):
    from fashionern_aaai2024_tpu_torch.ops import attn_experiment as X

    g = np.random.default_rng(42)
    x = _t(g, (2, X.S, X.W), 1.0, dtype, device)
    p = _x_weights(g, dtype, device, X.W)
    bias = _t(g, (X.S, X.S), 1.0, torch.float32, device)
    n0 = X.qkvattn.launches
    got = X.qkvattn(x, p["w_qkv"], p["b_qkv"], bias, X.DH ** -0.5)
    torch.cuda.synchronize()
    assert X.qkvattn.launches == n0 + 1
    _close(got, X.qkvattn_plain(x, p["w_qkv"], p["b_qkv"], bias, X.DH ** -0.5), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_x4_attnblock_kernel_matches_plain(device, dtype):
    from fashionern_aaai2024_tpu_torch.ops import attn_experiment as X

    g = np.random.default_rng(43)
    x = _t(g, (2, X.S, X.W), 1.0, dtype, device)
    p = _x_weights(g, dtype, device, X.W)
    bias = _t(g, (X.S, X.S), 1.0, torch.float32, device)
    args = (p["g"], p["be"], p["w_qkv"], p["b_qkv"], p["w_out"], p["b_out"], bias,
            X.DH ** -0.5)
    n0 = X.attnblock.launches
    got = X.attnblock(x, *args)
    torch.cuda.synchronize()
    assert X.attnblock.launches == n0 + 1
    _close(got, X.attnblock_plain(x, *args), dtype)


# --- the bf16 tensor-core tiles of the attention core and the grouped
# kernel: ragged edges, every layout, both staging widths ---------------

# (sq, sk) of the core's edge cases: 16-row warp tiles and 16-key tiles
# with one row or key short of, at, and one past a tile, the ViT's 197
EDGE_LENGTHS = (1, 15, 16, 17, 63, 65, 197)
CORE_EDGE_CROSS = [(1, 82), (15, 17), (16, 16), (17, 63), (63, 65), (65, 1), (197, 13),
                   (5, 256), (1, 1)]


def _left_padding_bias(sq, sk, device):
    """-inf on the keys before a row's index (the last key always kept),
    0 elsewhere: padding as PyTorch code writes it."""
    keep = torch.ones((sq, sk), dtype=torch.bool, device=device).triu()
    keep[:, -1] = True
    return torch.zeros((sq, sk), device=device).masked_fill(~keep, float("-inf"))


@pytest.mark.parametrize("dh", [64, 80])
@pytest.mark.parametrize("s", EDGE_LENGTHS)
@pytest.mark.parametrize("variant", ["plain", "causal", "bias", "-inf", "gb2"])
def test_core_packed_edges_match_plain(device, variant, s, dh):
    """B3 (packed qkv) in bf16 at the tiles' ragged edges: without a bias,
    causal, with an arbitrary or a -inf left-padding shared bias, and two
    images a block."""
    heads, b = 2, 4
    g = np.random.default_rng(50 + s)
    qkv = _t(g, (b, s, 3 * heads * dh), 1.0, torch.bfloat16, device)
    bias = {"bias": _t(g, (s, s), 2.0, torch.float32, device),
            "-inf": _left_padding_bias(s, s, device)}.get(variant)
    causal, gb = variant == "causal", 2 if variant == "gb2" else 1
    got = A.packed_qkv_self_attention(qkv, heads, causal=causal, attn_bias=bias,
                                      images_per_block=gb)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    _close(got, A.packed_qkv_self_attention_plain(qkv, heads, causal=causal, attn_bias=bias),
           torch.bfloat16)


@pytest.mark.parametrize("dh", [64, 80])
@pytest.mark.parametrize("sq,sk", CORE_EDGE_CROSS)
def test_core_cross_edges_match_plain(device, sq, sk, dh):
    """B8 (q + packed kv) in bf16 at the tiles' ragged edges, the
    attention pool's 1 x 82 first."""
    heads, b = 3, 2
    g = np.random.default_rng(60 + sq + sk)
    q = _t(g, (b, sq, heads * dh), 1.0, torch.bfloat16, device)
    kv = _t(g, (b, sk, 2 * heads * dh), 1.0, torch.bfloat16, device)
    got = A.packed_kv_cross_attention(q, kv, heads)
    torch.cuda.synchronize()
    _close(got, A.packed_kv_cross_attention_plain(q, kv, heads), torch.bfloat16)


@pytest.mark.parametrize("layout", ["rows", "contiguous"])
@pytest.mark.parametrize("dh", [64, 80])
@pytest.mark.parametrize("sq,sk", CORE_EDGE_CROSS)
def test_core_head_view_edges_match_plain(device, layout, sq, sk, dh):
    """B9 on the core (head views of [B, S, H*Dh] rows and contiguous
    [B, H, S, Dh]) in bf16 at the tiles' ragged edges, with a shared
    bias."""
    g = np.random.default_rng(70 + sq + sk)
    q, k, v = _mha_operands(g, 2, 3, sq, sk, dh, layout, torch.bfloat16, device)
    bias = _t(g, (sq, sk), 2.0, torch.float32, device)
    got = A.multi_head_attention(q, k, v, bias=bias)
    torch.cuda.synchronize()
    _close(got, A.mha_plain(q, k, v, bias), torch.bfloat16)


@pytest.mark.parametrize("s", [1, 17, 65, 197])
def test_core_fp32_output_edges_match_plain(device, s):
    """The core's bf16-operand, fp32-output instance (B6's attention) at
    the tiles' ragged edges, causal and not."""
    g = np.random.default_rng(80 + s)
    qkv = _t(g, (3, s, 3 * 4 * 64), 1.0, torch.bfloat16, device)
    for causal in (False, True):
        got = A.launch_attention_core(qkv, 4, causal=causal, scale=None,
                                      out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32
        _close(got, A.packed_qkv_self_attention_plain(qkv, 4, causal=causal,
                                                      out_dtype=torch.float32),
               torch.bfloat16)


@pytest.mark.parametrize("offset", [1, 2])
@pytest.mark.parametrize("dh", [64, 128])
def test_misaligned_views_take_the_narrow_staging(device, dh, offset):
    """Head views whose base is 2 or 4 bytes past a 16-byte boundary (and
    whose row stride is not a multiple of 8 elements): the launchers
    stage them with element or 4-byte copies, on the core (head dim 64)
    and the grouped kernel (128)."""
    g = np.random.default_rng(90 + dh + offset)
    b, h, sq, sk = 2, 4, 33, 70

    def view(s):
        big = _t(g, (b, s, h * dh + offset), 1.0, torch.bfloat16, device)
        return big[..., offset:].view(b, s, h, dh).transpose(1, 2)

    q, k, v = view(sq), view(sk), view(sk)
    assert q.data_ptr() % 16 == 2 * offset
    bias = _t(g, (sq, sk), 2.0, torch.float32, device)
    got = A.multi_head_attention(q, k, v, bias=bias)
    torch.cuda.synchronize()
    _close(got, A.mha_plain(q, k, v, bias), torch.bfloat16)


@pytest.mark.parametrize("sk", [1, 63, 64, 65, 300, 1024])
@pytest.mark.parametrize("dh,width", [(128, 16), (96, 16), (34, 4), (126, 4)])
def test_grouped_kernel_staging_widths(device, dh, width, sk):
    """The grouped kernel in bf16 with 16-byte staging (head dims 128,
    96: D % 8 == 0) and 4-byte staging (34, 126: D % 8 != 0) at chunk
    edges, with a -inf left-padding bias, and causal at Sq == Sk."""
    g = np.random.default_rng(100 + sk + dh)
    sq = min(sk, 77)
    q, k, v = _mha_operands(g, 2, 2, sq, sk, dh, "contiguous", torch.bfloat16, device)
    assert ((dh * 2) % 16 == 0) == (width == 16)
    bias = _left_padding_bias(sq, sk, device)
    got = A.multi_head_attention(q, k, v, bias=bias)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    _close(got, A.mha_plain(q, k, v, bias), torch.bfloat16)
    q, k, v = _mha_operands(g, 2, 2, sk, sk, dh, "rows", torch.bfloat16, device)
    got = A.multi_head_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    _close(got, A.mha_plain(q, k, v, A.shared_bias(True, None, sk, sk, device)),
           torch.bfloat16)


@pytest.mark.parametrize("b", [1, 32])
def test_block_kernel_bf16_equals_the_pair(device, b):
    """B10 in bf16 at the ViT-B-16 text tower, b = 1 and 32: bit for bit
    B1 + B2 (both run the tensor-core attention body)."""
    from fashionern_aaai2024_tpu_torch.ops import block as B

    args = _block_args(np.random.default_rng(33 + b), b, 77, 512, torch.bfloat16, device)
    got = B._launch_block(*args, 8, True, "quick_gelu", None, 1e-5)
    pair = M.mlp_subblock(A.attention_subblock(*args[:7], 8, causal=True), *args[7:])
    torch.cuda.synchronize()
    torch.testing.assert_close(got, pair, atol=0, rtol=0)
    _close(got, B.transformer_block_plain(*args, 8, causal=True), torch.bfloat16)


def _sass_functions(lib_path):
    """{mangled kernel name: SASS text} of the built library."""
    import shutil
    import subprocess

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return {k: "\n".join(v) for k, v in out.items()}


def test_bf16_attention_kernels_run_on_tensor_cores_and_cp_async(device):
    """The bf16 instances of the attention core and of the grouped kernel
    issue tensor-core products (HMMA) and asynchronous global-to-shared
    copies (LDGSTS) in their SASS."""
    common.LIBRARY.load()
    funcs = _sass_functions(common.LIBRARY.library_path())
    for kernel in ("attention_mma_kernel", "grouped_attention_mma_kernel"):
        found = {k: v for k, v in funcs.items()
                 if kernel in k and ("grouped" in kernel) == ("grouped" in k)}
        assert found, f"no {kernel} in the library"
        for name, sass in found.items():
            assert "HMMA" in sass and "LDGSTS" in sass, name
