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
limits `chip_smoke.py` holds the serve shapes to. B5 is four launches
(its c_proj takes both hidden groups in one). The int8 GEMM
(`ops/common.py launch_qgemm`, csrc/qgemm.cu: s8 warpgroup MMA on TMA-fed
tiles) at its tiles' edges, every width and the rule's: M in 1, 77, 127
and 129, N in 8-768, K in 16-768, bf16 and fp32, with the identity
activation equal bit for bit to the plain function on the exact product
(int32 sums are exact; every later step rounds as the plain version
does), with quick_gelu at the fp32 tolerance; B5's c_proj over both
hidden groups in one launch, bit for bit; a SASS check for integer GMMA
on UTMALDG-loaded tiles and no IMMA. The group quantizer equals
`quantize_rowwise` exactly on the card (codes and scales, an all-zero
row included), and the LN + quantize kernel is held at the
tower widths, the general routine's widths and W = 2,056.

B7 (`fused_qkv_self_attention`), B8 (`packed_kv_cross_attention`) and
B11 (`layer_norm`) at the tolerances above, at head dim 64 and 80; B8's
wide route (csrc/attention_wide.cu: other head dims, CaLa's single heads
of 512 and 640) at CaLa's shapes and at its tiles' edges (Sq 1-33, Sk
1-256, head dims 1-1,024, two heads, more blocks than SMs), the core's
sites bit for bit on the core, and the shapes past both raising; B11
also at widths 512-1280, 100 and 642 (every vector instance and the
general one) and 1 to 25,216 rows, with a SASS check for its 16-byte
loads and stores, and B10 bit for bit against B1 + B2 at W = 640 and
768 (B10's LN phases run B11's row routine); B11's autograd Function
against the plain version's autograd at rtol 1e-5 and an atol of 1e-5
times the largest gradient element (two fp32 reductions in another
order). The small RN50x4-shaped ResNet tower (tests/test_clip.py
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
d = 512 and 640 and M = 1, 2, 33, 63, 64, 65, 128, 129 and 1024 (fp32:
the products by 3xTF32 on the tensor cores, the hidden product in 4 K
slices up to M = 128, 2 at 129 and 1 at 1024 at d = 512; 3, 1 and 1 at
640), at the tolerances above; a SASS check holds its fp32 GEMM to tf32 HGMMA fed
by UTMALDG.

The data path: a dataset batch of the uint8 feed normalized on
the card equals the CPU's float feed bit for bit, and `PatchExtractor`
over a small seeded ViT on the card holds the CPU's features at 1e-4.
The gallery pipeline (`embed_gallery`): three batches staged ahead equal
the serial feed bit for bit over 64 batches, and a placed batch comes
from page-locked memory on the stage's own stream.

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

The bf16 GEMM (`ops/common.py launch_gemm`, csrc/gemm.cu on the
warpgroup-MMA body of gemm_wgmma.cuh) at its tiles' ragged edges, both
tile widths (128 and 256 columns): M in 1, 15, 63, 64, 65, 197 and
6,305 rows, N in 8, 72, 200, 640 and 2,304, K in 8, 40, 776 and 3,072,
with and without bias, residual and quick_gelu / ReLU, and an `out=`
column slice at ldc > N as kernel B12 writes it, against
`a.float() @ w.float().T` through the same epilogue at the bf16
tolerance; a misaligned operand view raises. The SASS test also holds
the GEMM to HGMMA (wgmma) and UTMALDG (TMA loads), and B10 to HGMMA.

The fp32 GEMM (fp32 `launch_gemm`, csrc/gemm_tf32.cu on the 3xTF32 body
of gemm_tf32.cuh: B1, B2 and B7 in fp32) at its tiles' edges, every tile
width (32, 64, 128 and the rule's): M in 1-1,024 around 64 and 128 and
B7's 91, N in 8-1,920, K in 8-3,072, every epilogue (bias, residual,
quick_gelu, gelu, ReLU), an `out=` column slice, against an fp32 product
at the fp32 tolerance, the widths equal bit for bit; a misaligned operand
view raises. A SASS test holds the GEMM, B4 and B10's fp32 instance to
tf32 HGMMA on UTMALDG-loaded tiles, with no FFMA between the GEMM's or
B4's first and last HGMMA.

B4 (`bbc_rowloss`, 3xTF32 scores): row losses at atol 5e-4, rtol 1e-5
(the temperature of 100 turns the fp32 ordering error of a d = 512 dot
product, about 1e-6, into about 1e-4 on a score), at B = 1-1,024 around
the 64-wide column and 128-row tiles and d = 24, 30 (padded), 512 and
640, and on a misaligned view (copied); gradients through the autograd
Function against the plain version's autograd at rtol 1e-4 and an atol
of 5e-5 times the largest gradient element (the fp32 rounding of scores
near 75 reaches the softmax as a relative error of about 1e-5).

Gradients through B1, B2, B3, B7 and B8 (their autograd Functions, whose
backward is autograd of the plain version): at the ViT-B-16 trunk, the
causal text tower, the DVR BERT at d = 640, the RN50x4 pool, the MR rows
and CaLa's single heads of 512 and 640 ([128, 13, d], the wide route),
in fp32 and bf16, every gradient (a shared attention bias's included)
against autograd of the plain version on the card at cosine >= 0.99999
in fp32 and 0.99 in bf16 (B10's thresholds); the Function's forward
equals the grad-free call bit for bit with the same launches, and its
backward launches nothing. The launches alone still refuse an operand
that requires grad, as B4's row loss does at its entry.
"""

import threading

import numpy as np
import pytest
import torch

from fashionern_aaai2024_tpu_torch.ops import attention as A
from fashionern_aaai2024_tpu_torch.ops import attn_experiment as XA
from fashionern_aaai2024_tpu_torch.ops import block as TB
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


# B8's wide route (csrc/attention_wide.cu), one head: CaLa on the ViT-B-16
# tower's 13 patch tokens (512) and RN50x4's (640), a BLIP-2 Q-Former's 32
# tokens (256, CaLa's own source), and a small case
WIDE_SHAPES = [(128, 13, 13, 512), (128, 13, 13, 640), (128, 32, 32, 256), (3, 5, 5, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,dh", WIDE_SHAPES)
def test_wide_cross_attention_matches_plain(device, dtype, b, sq, sk, dh):
    g = np.random.default_rng(12)
    q, kv = _t(g, (b, sq, dh), 1.0, dtype, device), _t(g, (b, sk, 2 * dh), 1.0, dtype, device)
    n8, nw = A.packed_kv_cross_attention.launches, A.wide_cross_attention.launches
    got = A.packed_kv_cross_attention(q, kv, 1)
    torch.cuda.synchronize()
    assert A.packed_kv_cross_attention.launches == n8 + 1
    assert A.wide_cross_attention.launches == nw + 1
    _close(got, A.packed_kv_cross_attention_plain(q, kv, 1), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,heads,dh", CROSS_SHAPES)
def test_core_cross_attention_is_the_core_bit_for_bit(device, dtype, b, sq, sk, heads, dh):
    """The MR rows and the RN50x4 pool (head dim 64 and 80) stay on the
    attention core: B8 equals the core's launch bit for bit, and the wide
    route launches nothing."""
    g = np.random.default_rng(13)
    w = heads * dh
    q, kv = _t(g, (b, sq, w), 1.0, dtype, device), _t(g, (b, sk, 2 * w), 1.0, dtype, device)
    nw = A.wide_cross_attention.launches
    got = A.packed_kv_cross_attention(q, kv, heads)
    want = A._launch_core("core", q, kv, w=w, sk=sk, heads=heads, q_ld=w, kv_ld=2 * w,
                          k_col=0, v_col=w, causal=False, scale=None, out_dtype=dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert A.wide_cross_attention.launches == nw


# the wide route's tile edges (a block a 16-row query tile, keys in
# chunks of 16 through a shared-memory ring, the head dim padded to 16):
# Sq around 16 and 32; Sk around 8 and 16 and at the 256 limit; head dims
# staged by element copies in bf16 (1, 7, 63, 65, 1,023), by 4-byte
# copies (6, and odd head dims in fp32), around 64, CaLa's and the 1,024
# limit (K, then V, streamed through the ring); two heads; more blocks
# than SMs (two blocks an SM share its shared memory: a one-stage ring at
# fp32 d = 640)
WIDE_EDGES = ([(2, sq, 13, 1, 512) for sq in (1, 15, 16, 17, 33)]
              + [(2, 17, sk, 1, 65) for sk in (1, 7, 8, 9, 17, 255, 256)]
              + [(2, 17, 33, 1, dh) for dh in (1, 6, 7, 63, 64, 65, 512, 640, 1023, 1024)]
              + [(2, 33, 256, 1, 1024), (3, 17, 13, 2, 192), (256, 13, 13, 1, 640)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,heads,dh", WIDE_EDGES)
def test_wide_cross_attention_edges(device, dtype, b, sq, sk, heads, dh):
    """The wide route's own launch (any head dim, 64 included) against
    the plain version."""
    g = np.random.default_rng(14)
    w = heads * dh
    q, kv = _t(g, (b, sq, w), 1.0, dtype, device), _t(g, (b, sk, 2 * w), 1.0, dtype, device)
    nw = A.wide_cross_attention.launches
    got = A.wide_cross_attention(q, kv, heads, None)
    torch.cuda.synchronize()
    assert A.wide_cross_attention.launches == nw + 1
    _close(got, A.packed_kv_cross_attention_plain(q, kv, heads), dtype)


def test_wide_cross_attention_refuses_what_it_does_not_take(device):
    for sk, w, heads in ((13, 2048, 1), (300, 512, 1), (300, 640, 8)):
        q, kv = torch.zeros((2, 3, w), device=device), torch.zeros((2, sk, 2 * w), device=device)
        with pytest.raises(ValueError, match="up to 1024 at S <= 256"):
            A.packed_kv_cross_attention(q, kv, heads)


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


# B11's instances: one warp a row in registers, 16-byte vectors, by
# vectors a lane (bf16 512 / 640 / 768 / 1024 / 1280: 2, 3, 3, 4, 5; fp32:
# 4, 5, 6, 8, and 1280 past the largest instance), and the general one
# (widths not a multiple of a vector: bf16 100, both 642)
LN_WIDTHS = (512, 640, 768, 1024, 1280, 100, 642)
LN_ROWS = (1, 7, 2464, 25216)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", LN_WIDTHS)
@pytest.mark.parametrize("rows", LN_ROWS)
def test_layer_norm_instances_match_plain(device, dtype, w, rows):
    """Every width and row count through B11's kernel instances (the
    grid-stride walk at 25,216 rows included), and at 7 rows an operand
    view one element past a 16-byte boundary (the general instance)."""
    g = np.random.default_rng(rows + w)
    x = _t(g, (rows, w), 1.0, dtype, device, offset=2.0)
    ln_w, ln_b = _t(g, (w,), 0.1, dtype, device, 1.0), _t(g, (w,), 0.1, dtype, device)
    _close(LN.layer_norm(x, ln_w, ln_b, 1e-5), LN.layer_norm_plain(x, ln_w, ln_b, 1e-5), dtype)
    if rows == 7:
        flat = torch.cat([x.flatten(), x.flatten()[:1]])
        view = flat[1:].view(rows, w)
        _close(LN.layer_norm(view, ln_w, ln_b, 1e-5),
               LN.layer_norm_plain(view, ln_w, ln_b, 1e-5), dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("w", [512, 768, 642])
def test_layer_norm_autograd_matches_plain_autograd_at_every_instance(device, w):
    g = np.random.default_rng(w)
    x0 = _t(g, (3, 17, w), 1.0, torch.float32, device)
    ln0 = (_t(g, (w,), 0.1, torch.float32, device, 1.0), _t(g, (w,), 0.1, torch.float32, device))
    up = _t(g, (3, 17, w), 1.0, torch.float32, device)
    ours = [t.clone().requires_grad_() for t in (x0, *ln0)]
    plain = [t.clone().requires_grad_() for t in (x0, *ln0)]
    (LN.layer_norm(*ours, 1e-5) * up).sum().backward()
    (LN.layer_norm_plain(*plain, 1e-5) * up).sum().backward()
    for a, b in zip(ours, plain):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5,
                                   atol=1e-5 * b.grad.abs().max().item())


def test_b7_b8_refuse_operands_that_require_grad(device):
    """B7's and B8's launches are forward-only: called straight, with grad
    mode on, they refuse an operand that requires grad (the wrappers take
    their autograd Functions instead, below); the shape checks raise
    before either."""
    w = 160
    x = torch.randn(2, 9, w, device=device, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        A._launch_fused_qkv(x, torch.zeros(3 * w, w, device=device),
                            torch.zeros(3 * w, device=device), None, 2, False, None)
    for core in (True, False):
        with pytest.raises(RuntimeError, match="requires grad"):
            A._launch_cross(x, torch.zeros(2, 13, 2 * w, device=device), 2, None, core)
    with pytest.raises(ValueError, match="head dim"):
        A.packed_kv_cross_attention(torch.zeros(2, 9, 2 * 1040, device=device),
                                    torch.zeros(2, 13, 4 * 1040, device=device), 2)
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


# B4's tile edges: rows around a warpgroup's 64 and a block tile's 128,
# columns around the 64-wide score tiles, the train batch (1,024) and a
# ragged one (1,000); d below one 32-deep K tile, the real widths, and
# one d % 4 != 0 (the wrapper pads it with zero columns)
@pytest.mark.parametrize("d", [24, 30, 512, 640])
@pytest.mark.parametrize("b", [1, 13, 63, 64, 65, 127, 128, 129, 200, 1000, 1024])
def test_bbc_rowloss_kernel_matches_plain(device, b, d):
    pred, tar = _bbc_inputs(b, d, device)
    n0 = L.bbc_rowloss.launches
    got = L.bbc_rowloss(pred, tar)
    torch.cuda.synchronize()
    assert L.bbc_rowloss.launches == n0 + 1
    torch.testing.assert_close(got, L.bbc_rowloss_plain(pred, tar), atol=5e-4, rtol=1e-5)


def test_bbc_rowloss_pads_what_tma_cannot_take(device):
    """Operands TMA cannot read as they are (d % 4 != 0, or a view that
    starts off a 16-byte boundary) are copied into zero-padded aligned
    buffers: the row losses still match the plain version's."""
    pred, tar = _bbc_inputs(129, 513, device, seed=5)
    n0 = L.bbc_rowloss.launches
    torch.testing.assert_close(L.bbc_rowloss(pred, tar), L.bbc_rowloss_plain(pred, tar),
                               atol=5e-4, rtol=1e-5)
    flat_p = torch.zeros(129 * 512 + 1, device=device)
    flat_t = torch.zeros(129 * 512 + 1, device=device)
    p, t = flat_p[1:].view(129, 512), flat_t[1:].view(129, 512)
    p.copy_(pred[:, :512])
    t.copy_(tar[:, :512])
    assert p.data_ptr() % 16 and t.data_ptr() % 16
    got = L.bbc_rowloss(p, t)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, L.bbc_rowloss_plain(p, t), atol=5e-4, rtol=1e-5)
    assert L.bbc_rowloss.launches == n0 + 2


# B4 with the positive at column offset + i over N >= B targets (the
# data-parallel loss's call: a rank's rows against the gathered targets):
# N around the score tiles' 64 columns, the offset at the first and the
# last rank, B = 512 against 1,024 (two ranks of the train batch)
@pytest.mark.parametrize("b,n,offset", [(13, 26, 13), (64, 128, 0), (65, 130, 65),
                                        (200, 800, 600), (512, 1024, 512), (1000, 1000, 0)])
def test_bbc_rowloss_offset_kernel_matches_plain(device, b, n, offset):
    pred, tar = _bbc_inputs(n, 512, device, seed=b)
    pred = pred[offset:offset + b].contiguous()
    n0 = L.bbc_rowloss.launches
    got = L.bbc_rowloss(pred, tar, offset=offset)
    torch.cuda.synchronize()
    assert L.bbc_rowloss.launches == n0 + 1
    torch.testing.assert_close(got, L.bbc_rowloss_plain(pred, tar, offset=offset),
                               atol=5e-4, rtol=1e-5)


def test_bbc_rowloss_offset_zero_is_the_local_call_bit_for_bit(device):
    pred, tar = _bbc_inputs(1024, 512, device, seed=9)
    assert torch.equal(L.bbc_rowloss(pred, tar, offset=0), L.bbc_rowloss(pred, tar))


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


@pytest.mark.parametrize("groups", [2, 4])
def test_grouped_bbc_loss_runs_b4_a_group(device, groups):
    """Per-rank negatives in one process (`train/step.py
    grouped_bbc_loss`): one B4 launch a group; the loss and its gradients
    against the plain version's, group by group."""
    from fashionern_aaai2024_tpu_torch.train.step import grouped_bbc_loss

    pred, tar = _bbc_inputs(1024, 512, device, seed=30 + groups)
    p1, t1 = pred.clone().requires_grad_(), tar.clone().requires_grad_()
    n0 = L.bbc_rowloss.launches
    loss = grouped_bbc_loss(p1, t1, groups)
    torch.cuda.synchronize()
    assert L.bbc_rowloss.launches == n0 + groups
    loss.backward()
    p2, t2 = pred.clone().requires_grad_(), tar.clone().requires_grad_()
    r = 1024 // groups
    want = torch.stack([L.bbc_rowloss_plain(p2[i * r:(i + 1) * r], t2[i * r:(i + 1) * r]).mean()
                        for i in range(groups)]).mean()
    want.backward()
    torch.testing.assert_close(loss, want, atol=5e-4, rtol=1e-5)
    for got, want in ((p1.grad, p2.grad), (t1.grad, t2.grad)):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=5e-5 * want.abs().max().item())


def test_cuda_wrappers_refuse_operands_that_require_grad(device):
    """A ctypes launch returns a tensor with no grad_fn: a gradient would
    be dropped, so the launches raise instead. B4's row loss (its
    gradient is `BBCMeanLoss`'s) refuses at its entry; B1, B2 and B3
    refuse at their launches, which their wrappers reach through their
    autograd Functions when a gradient is wanted."""
    w = 128
    x = torch.randn(2, 9, w, device=device, requires_grad=True)
    ln = torch.ones(w, device=device)
    zeros = torch.zeros(w, device=device)
    with pytest.raises(RuntimeError, match="requires grad"):
        A._launch_subblock(x, ln, zeros, torch.zeros(3 * w, w, device=device),
                           torch.zeros(3 * w, device=device),
                           torch.zeros(w, w, device=device), zeros, None, 2, False, None, 1e-5)
    with pytest.raises(RuntimeError, match="requires grad"):
        M._launch_mlp(x, ln, zeros, torch.zeros(4 * w, w, device=device),
                      torch.zeros(4 * w, device=device),
                      torch.zeros(w, 4 * w, device=device), zeros, "quick_gelu", 1e-5)
    with pytest.raises(RuntimeError, match="requires grad"):
        A._launch_packed(torch.randn(2, 9, 3 * w, device=device, requires_grad=True), None, 2,
                         False, None, 1)
    with pytest.raises(RuntimeError, match="requires grad"):
        L.bbc_rowloss(x[0], x[0])
    with torch.no_grad():
        A.packed_qkv_self_attention(torch.randn(2, 9, 3 * w, device=device,
                                                requires_grad=True), 2)


# --- gradients through B1, B2, B3, B7 and B8 (their autograd Functions) --

GRAD_COSINE = {torch.float32: 0.99999, torch.bfloat16: 0.99}
# (kernel, site): the ViT-B-16 trunk with a shared bias and the causal
# text tower (B1, B3), both activations (B2), the DVR BERT at d = 640
# with a shared bias (B7), the RN50x4 pool, the MR rows and CaLa's single
# heads at ViT-B-16 and RN50x4 width on the wide route (B8)
GRAD_SITES = [("B1", "vit"), ("B1", "text"), ("B2", "vit"), ("B2", "text_gelu"),
              ("B3", "vit"), ("B3", "text"), ("B7", "bert640"), ("B8", "pool"), ("B8", "mr"),
              ("B8", "cala512"), ("B8", "cala640")]


def _grad_call(kernel, site, dtype, device):
    """(wrapper, operands, call, plain) at a site: `call(*operands)` runs
    the wrapper, `plain(*operands)` its plain version."""
    g = np.random.default_rng(len(kernel + site))

    def t(shape, scale=0.02, offset=0.0, dt=dtype):
        return _t(g, shape, scale, dt, device, offset)

    b, s, w, heads, causal = {"vit": (4, 197, 768, 12, False), "text": (4, 77, 512, 8, True),
                              "text_gelu": (4, 77, 512, 8, False)}.get(site, (4, 91, 640, 8,
                                                                             False))
    bias = None if causal else t((s, s), 2.0, dt=torch.float32)
    if kernel == "B1":
        ops = (t((b, s, w), 1.0), t((w,), 0.1, 1.0), t((w,), 0.1), t((3 * w, w)), t((3 * w,)),
               t((w, w)), t((w,)), bias)
        return (A.attention_subblock, ops,
                lambda *o: A.attention_subblock(*o[:7], heads, causal=causal, attn_bias=o[7]),
                lambda *o: A.attention_subblock_plain(*o[:7], heads, causal=causal,
                                                      attn_bias=o[7]))
    if kernel == "B2":
        act = "gelu" if site == "text_gelu" else "quick_gelu"
        ops = (t((b, s, w), 1.0), t((w,), 0.1, 1.0), t((w,), 0.1), t((4 * w, w)), t((4 * w,)),
               t((w, 4 * w)), t((w,)))
        return (M.mlp_subblock, ops, lambda *o: M.mlp_subblock(*o, activation=act),
                lambda *o: M.mlp_subblock_plain(*o, activation=act))
    if kernel == "B3":
        ops = (t((b, s, 3 * w), 1.0), bias)
        return (A.packed_qkv_self_attention, ops,
                lambda q, m: A.packed_qkv_self_attention(q, heads, causal=causal, attn_bias=m),
                lambda q, m: A.packed_qkv_self_attention_plain(q, heads, causal=causal,
                                                               attn_bias=m))
    if kernel == "B7":
        ops = (t((b, s, w), 1.0), t((3 * w, w)), t((3 * w,)), bias)
        return (A.fused_qkv_self_attention, ops,
                lambda *o: A.fused_qkv_self_attention(*o[:3], heads, attn_bias=o[3]),
                lambda *o: A.fused_qkv_self_attention_plain(*o[:3], heads, attn_bias=o[3]))
    b, sq, sk, heads, dh = {"pool": (4, 1, 82, 40, 64), "mr": (4, 77, 13, 8, 80),
                            "cala512": (128, 13, 13, 1, 512),
                            "cala640": (128, 13, 13, 1, 640)}[site]
    ops = (t((b, sq, heads * dh), 1.0), t((b, sk, 2 * heads * dh), 1.0))
    return (A.packed_kv_cross_attention, ops,
            lambda q, kv: A.packed_kv_cross_attention(q, kv, heads),
            lambda q, kv: A.packed_kv_cross_attention_plain(q, kv, heads))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel,site", GRAD_SITES)
def test_kernel_functions_match_plain_autograd(device, dtype, kernel, site):
    """Each wrapper that differentiates, called with operands that require
    grad, runs its kernels inside its autograd Function: the forward
    equals the grad-free call bit for bit with the same launches (one
    count of the wrapper, on the wide route one more of its own), the
    backward launches nothing, and every gradient (the shared attention
    bias's included) holds against autograd of the plain version on the
    card at cosine >= 0.99999 in fp32, 0.99 in bf16."""
    wrapper, ops, call, plain = _grad_call(kernel, site, dtype, device)
    with torch.no_grad(), common.recording() as free:
        want_out = call(*ops)
    ours = [None if o is None else o.detach().clone().requires_grad_() for o in ops]
    ref = [None if o is None else o.detach().clone().requires_grad_() for o in ops]
    n0 = wrapper.launches
    with common.recording() as fwd:
        out = call(*ours)
    assert type(out.grad_fn).__name__.endswith("FunctionBackward")
    assert wrapper.launches == n0 + 1
    assert fwd.entries == free.entries and fwd.wrappers == free.wrappers
    assert torch.equal(out, want_out)
    up = torch.randn(out.shape, generator=torch.Generator().manual_seed(5)).to(dtype).to(device)
    with common.recording() as bwd:
        (out.float() * up.float()).sum().backward()
        torch.cuda.synchronize()
    assert not bwd.entries and not bwd.wrappers
    want = plain(*ref)
    (want.float() * up.float()).sum().backward()
    _close(out.detach(), want.detach(), dtype)
    for a, r in zip(ours, ref):
        if a is None:
            continue
        cos = torch.nn.functional.cosine_similarity(a.grad.double().flatten(),
                                                    r.grad.double().flatten(), dim=0).item()
        assert cos >= GRAD_COSINE[dtype], (tuple(a.shape), cos)


# --- B5 and B6: the int8 sub-blocks -------------------------------------

# and RN50x4's text tower (W = 640, 10 heads of 64; B5's hidden in two
# groups of 1,280)
INT8_SHAPES = [(2, 9, 128, 2, False)] + SHAPES + [(1, 77, 640, 10, True),
                                                  (4, 77, 640, 10, True)]
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


# LN + quantize at the tower widths, the general routine's widths (bf16
# 100, both 642, and 2,056, past the vector instances) and a vector
# instance at W = 640
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,w", [(2, 9, 128), (4, 197, 768), (1, 77, 512), (1, 77, 640),
                                   (3, 43, 100), (2, 9, 642), (1, 5, 2056)])
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


# quantize in groups: B6's attention output (W = 768, one group), B5's
# hidden at ViT-B-16 (3,072 in two groups) and the text tower (2,048 in
# two), a group the vector routine cannot take (770 columns) and one past
# its largest instance (6,400)
@pytest.mark.parametrize("width,groups", [(768, 1), (3072, 2), (2048, 2), (1540, 2),
                                          (6400, 1)])
@pytest.mark.parametrize("rows", [1, 77, 129, 6304])
def test_quant_groups_kernel_equals_quantize_rowwise(device, rows, width, groups):
    """The group quantizer's codes and scales equal `quantize_rowwise` on
    each group exactly, both on the card (absmax, one IEEE division,
    round half to even): an all-zero row (scale 1e-8 / 127, codes 0)
    included."""
    g = np.random.default_rng(rows + width)
    x = _t(g, (rows, width), 2.0, torch.float32, device)
    x[rows // 2] = 0.0
    q, scale = common.launch_quant_groups(x, groups)
    c = width // groups
    for i in range(groups):
        want_q, want_scale = quantize_rowwise(x[:, c * i:c * (i + 1)])
        assert torch.equal(q[:, c * i:c * (i + 1)], want_q)
        assert torch.equal(scale[:, i:i + 1], want_scale)
    assert not q[rows // 2].any()
    assert scale[rows // 2, 0].item() == np.float32(1e-8) / np.float32(127.0)


# the int8 GEMM (csrc/qgemm.cu: s8 warpgroup MMA on TMA-fed 128 x 64 / 128
# tiles, 128-deep K tiles) at its tiles' edges: the text tower's 77 rows,
# one row, one short of and one past a 128-row tile; columns inside and
# past the 64- and 128-wide tiles (and 264) and ViT's 768; K of one k32
# step, short of, at and one k32 step past a K tile, and 768; epilogues
# (bias, residual, activation, fp32 output) as B5 and B6 use them
INT8_GEMM_M = (1, 77, 127, 129)
INT8_GEMM_N = (8, 72, 200, 264, 768)
INT8_GEMM_K = (16, 112, 128, 144, 768)
INT8_GEMM_EPILOGUES = ((True, False, None, False), (True, True, None, False),
                       (True, False, "quick_gelu", True), (False, False, None, True))


def _qgemm_plain(a, a_scale, w, w_scale, bias, res, activation, out_dtype, groups=1):
    """The int8 GEMM's function on the plain product: each group's int32
    sums times its row scale, times the column scale, added in group
    order; then bias, activation, the cast and the residual."""
    from fashionern_aaai2024_tpu_torch.ops.mlp import act_f32
    from fashionern_aaai2024_tpu_torch.ops.qmatmul import int8_product

    c, acc = a.shape[1] // groups, None
    for i in range(groups):
        lo = c * i
        o = int8_product(a[:, lo:lo + c], w[:, lo:lo + c]) * a_scale[:, i:i + 1] * w_scale
        acc = o if acc is None else acc + o
    if bias is not None:
        acc = acc + bias.float()
    if activation is not None:
        acc = act_f32(acc, activation)
    return acc.to(out_dtype) if res is None else res + acc.to(res.dtype)


def _qgemm_operands(g, m, k, n, groups, dtype, device):
    a = torch.tensor(g.integers(-127, 128, (m, k)), dtype=torch.int8, device=device)
    w = torch.tensor(g.integers(-127, 128, (n, k)), dtype=torch.int8, device=device)
    a_scale = _t(g, (m, groups), 0.01, torch.float32, device, 0.03)
    w_scale = _t(g, (n,), 1e-4, torch.float32, device, 4e-4)
    return a, a_scale, w, w_scale, _t(g, (n,), 0.5, dtype, device), _t(g, (m, n), 1.0, dtype,
                                                                         device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", INT8_GEMM_M)
def test_int8_gemm_tile_edges_equal_plain(device, m, dtype):
    """Every width (64, 128 and the rule's) at every N x K, each an
    epilogue: with the identity activation equal to the plain function bit
    for bit (int32 sums are exact, every later step rounds as the plain
    version does); with quick_gelu at the fp32 tolerance."""
    g = np.random.default_rng(m)
    for i, n in enumerate(INT8_GEMM_N):
        for j, k in enumerate(INT8_GEMM_K):
            with_bias, with_res, act, out_f32 = INT8_GEMM_EPILOGUES[(i + j) % 4]
            a, a_s, w, w_s, bias, res = _qgemm_operands(g, m, k, n, 1, dtype, device)
            bias, res = bias if with_bias else None, res if with_res else None
            out_dtype = torch.float32 if out_f32 else dtype
            want = _qgemm_plain(a, a_s, w, w_s, bias, res, act, out_dtype)
            for tile in (0, 64, 128):
                got = common.launch_qgemm(a, a_s, w, w_s, bias=bias, residual=res,
                                          activation=act, out_dtype=out_dtype, tile=tile)
                torch.cuda.synchronize()
                if act is None:
                    assert torch.equal(got, want), (m, n, k, tile)
                else:
                    torch.testing.assert_close(got, want, **TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [77, 129, 6304])
def test_int8_gemm_one_launch_c_proj_equals_plain(device, m, dtype):
    """B5's c_proj over both hidden groups in one launch (F = 3,072 and
    2,048, the second group from K tile 12 or 8 on with the row scale's
    column 1; bias and residual) equals the plain products bit for bit:
    the group sums are added in group order, as the two-product plain sum
    adds them."""
    g = np.random.default_rng(m + 1)
    for f in (3072, 2048):
        a, a_s, w, w_s, bias, res = _qgemm_operands(g, m, f, 768, 2, dtype, device)
        want = _qgemm_plain(a, a_s, w, w_s, bias, res, None, dtype, groups=2)
        got = common.launch_qgemm(a, a_s, w, w_s, groups=2, bias=bias, residual=res,
                                  out_dtype=dtype)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f


def test_int8_kernels_run_int8_wgmma_fed_by_tma(device):
    """The int8 GEMM issues integer warpgroup MMA (GMMA) on tiles that TMA
    loads (UTMALDG), with no WMMA integer MMA (IMMA) left; every vector
    instance of the quantize kernels loads 16 bytes a lane (LDG.E.128)."""
    import re

    common.LIBRARY.load()
    funcs = _sass_functions(common.LIBRARY.library_path())
    gemms = {k: v for k, v in funcs.items() if "qgemm_kernel" in k}
    assert len(gemms) == 6, sorted(gemms)
    for name, sass in gemms.items():
        assert "GMMA" in sass and "UTMALDG" in sass and "IMMA" not in sass, name
    quant = {k: v for k, v in funcs.items()
             if ("ln_quant_kernel" in k and re.search(r"Li[1-8]E", k))
             or ("quant_groups_kernel" in k and re.search(r"ILi([1-9]|1[0-2])E", k))}
    assert len(quant) == 16 + 12, sorted(quant)
    for name, sass in quant.items():
        assert "LDG.E.128" in sass, name


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


def test_mha_autograd_matches_plain_autograd_at_head_dim_80(device):
    """B9's backward at RN50x4's TME (d = 640, 8 heads of 80), as the TME
    train step takes it: `MHAFunction` against the plain version's
    autograd."""
    g = np.random.default_rng(22)
    q0, k0, v0 = _mha_operands(g, 4, 8, 77, 13, 80, "rows", torch.float32, device)
    up = _t(g, (4, 8, 77, 80), 1.0, torch.float32, device)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [512, 640])
@pytest.mark.parametrize("m", [1, 2, 63, 64, 65, 128, 129, 1024])
def test_combiner_kernel_matches_plain_at_the_tile_edges(device, dtype, d, m):
    """B12 at rows around a warpgroup's 64 and the 128-row tile: fp32 runs
    the 3xTF32 products (the hidden product split over K into 4 / 3 slices
    at M <= 128 for d = 512 / 640, into 2 / 1 at M = 129, not at M =
    1024), at the fp32 tolerance."""
    g = np.random.default_rng(m + d)
    module = _combiner(d, dtype, device, seed=d + 1)
    img, txt = _t(g, (m, d), 1.0, dtype, device), _t(g, (m, d), 1.0, dtype, device)
    with torch.no_grad():
        got = Cb.combiner_apply(img, txt, module)
        torch.cuda.synchronize()
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


# --- the tensor-core tiles of the attention core and the grouped kernel
# (bf16 tiles, and the fp32 instances' 3xTF32 tiles): ragged edges, every
# layout, both staging widths ------------------------------------------

ATTN_DTYPES = [torch.float32, torch.bfloat16]
# (sq, sk) of the core's edge cases: 16-row warp tiles and 16-key tiles
# (8-key tiles and 32-key groups in fp32) with one row or key short of,
# at, and one past a tile, the ViT's 197
EDGE_LENGTHS = (1, 15, 16, 17, 63, 65, 197)
CORE_EDGE_CROSS = [(1, 82), (15, 17), (16, 16), (17, 63), (63, 65), (65, 1), (197, 13),
                   (5, 256), (1, 1)]


def _left_padding_bias(sq, sk, device):
    """-inf on the keys before a row's index (the last key always kept),
    0 elsewhere: padding as PyTorch code writes it."""
    keep = torch.ones((sq, sk), dtype=torch.bool, device=device).triu()
    keep[:, -1] = True
    return torch.zeros((sq, sk), device=device).masked_fill(~keep, float("-inf"))


@pytest.mark.parametrize("dtype", ATTN_DTYPES)
@pytest.mark.parametrize("dh", [64, 80])
@pytest.mark.parametrize("s", EDGE_LENGTHS)
@pytest.mark.parametrize("variant", ["plain", "causal", "bias", "-inf", "gb2"])
def test_core_packed_edges_match_plain(device, variant, s, dh, dtype):
    """B3 (packed qkv) in bf16 and fp32 at the tiles' ragged edges:
    without a bias, causal, with an arbitrary or a -inf left-padding
    shared bias, and two images a block."""
    heads, b = 2, 4
    g = np.random.default_rng(50 + s)
    qkv = _t(g, (b, s, 3 * heads * dh), 1.0, dtype, device)
    bias = {"bias": _t(g, (s, s), 2.0, torch.float32, device),
            "-inf": _left_padding_bias(s, s, device)}.get(variant)
    causal, gb = variant == "causal", 2 if variant == "gb2" else 1
    got = A.packed_qkv_self_attention(qkv, heads, causal=causal, attn_bias=bias,
                                      images_per_block=gb)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    _close(got, A.packed_qkv_self_attention_plain(qkv, heads, causal=causal, attn_bias=bias),
           dtype)


@pytest.mark.parametrize("dtype", ATTN_DTYPES)
@pytest.mark.parametrize("dh", [64, 80])
@pytest.mark.parametrize("sq,sk", CORE_EDGE_CROSS)
def test_core_cross_edges_match_plain(device, sq, sk, dh, dtype):
    """B8 (q + packed kv) in bf16 and fp32 at the tiles' ragged edges, the
    attention pool's 1 x 82 first."""
    heads, b = 3, 2
    g = np.random.default_rng(60 + sq + sk)
    q = _t(g, (b, sq, heads * dh), 1.0, dtype, device)
    kv = _t(g, (b, sk, 2 * heads * dh), 1.0, dtype, device)
    got = A.packed_kv_cross_attention(q, kv, heads)
    torch.cuda.synchronize()
    _close(got, A.packed_kv_cross_attention_plain(q, kv, heads), dtype)


@pytest.mark.parametrize("dtype", ATTN_DTYPES)
@pytest.mark.parametrize("layout", ["rows", "contiguous"])
@pytest.mark.parametrize("dh", [64, 80])
@pytest.mark.parametrize("sq,sk", CORE_EDGE_CROSS)
def test_core_head_view_edges_match_plain(device, layout, sq, sk, dh, dtype):
    """B9 on the core (head views of [B, S, H*Dh] rows and contiguous
    [B, H, S, Dh]) in bf16 and fp32 at the tiles' ragged edges, with a
    shared bias."""
    g = np.random.default_rng(70 + sq + sk)
    q, k, v = _mha_operands(g, 2, 3, sq, sk, dh, layout, dtype, device)
    bias = _t(g, (sq, sk), 2.0, torch.float32, device)
    got = A.multi_head_attention(q, k, v, bias=bias)
    torch.cuda.synchronize()
    _close(got, A.mha_plain(q, k, v, bias), dtype)


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


@pytest.mark.parametrize("dtype", ATTN_DTYPES)
@pytest.mark.parametrize("offset", [1, 2])
@pytest.mark.parametrize("dh", [64, 128])
def test_misaligned_views_take_the_narrow_staging(device, dh, offset, dtype):
    """Head views whose base is one or two elements past a 16-byte
    boundary (and whose row stride is not a multiple of 16 bytes): the
    launchers stage them with element or 4-byte copies in bf16, 4-byte
    copies in fp32, on the core (head dim 64) and the grouped kernel
    (128)."""
    g = np.random.default_rng(90 + dh + offset)
    b, h, sq, sk = 2, 4, 33, 70

    def view(s):
        big = _t(g, (b, s, h * dh + offset), 1.0, dtype, device)
        return big[..., offset:].view(b, s, h, dh).transpose(1, 2)

    q, k, v = view(sq), view(sk), view(sk)
    assert q.data_ptr() % 16 == q.element_size() * offset
    bias = _t(g, (sq, sk), 2.0, torch.float32, device)
    got = A.multi_head_attention(q, k, v, bias=bias)
    torch.cuda.synchronize()
    _close(got, A.mha_plain(q, k, v, bias), dtype)


@pytest.mark.parametrize("dtype", ATTN_DTYPES)
@pytest.mark.parametrize("sk", [1, 63, 64, 65, 300, 1024])
@pytest.mark.parametrize("dh,width", [(128, 16), (96, 16), (34, 4), (126, 4)])
def test_grouped_kernel_staging_widths(device, dh, width, sk, dtype):
    """The grouped kernel in bf16 and fp32 with 16-byte staging (head dims
    128, 96: a head's row is a multiple of 16 bytes) and 4-byte staging
    (34, 126: it is not) at chunk edges, with a -inf left-padding bias,
    and causal at Sq == Sk."""
    g = np.random.default_rng(100 + sk + dh)
    sq = min(sk, 77)
    q, k, v = _mha_operands(g, 2, 2, sq, sk, dh, "contiguous", dtype, device)
    assert ((dh * q.element_size()) % 16 == 0) == (width == 16)
    bias = _left_padding_bias(sq, sk, device)
    got = A.multi_head_attention(q, k, v, bias=bias)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    _close(got, A.mha_plain(q, k, v, bias), dtype)
    q, k, v = _mha_operands(g, 2, 2, sk, sk, dh, "rows", dtype, device)
    got = A.multi_head_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    _close(got, A.mha_plain(q, k, v, A.shared_bias(True, None, sk, sk, device)), dtype)


@pytest.mark.parametrize("sk", [300, 512])
@pytest.mark.parametrize("dh", [2, 8, 30, 64, 80, 96, 126, 128])
def test_grouped_kernel_fp32_head_dims(device, dh, sk):
    """The grouped kernel's fp32 instance at every head-dim class from 2
    to 128 (padded to 64 or 128 in shared memory, its k-steps and output
    columns past the head's dims skipped) over 300 and 512 keys, with an
    arbitrary bias: std-1 operands against the plain version, and std-2
    operands against the float64 function. At std 2 and head dim 128 the
    scores reach ~20, and the plain version's own fp32 rounding of them
    moves its outputs most of the fp32 tolerance from the float64 function
    while 3xTF32 stays closer to it (`tests/test_torch_ops.py
    test_attention_tf32_beats_plain_fp32_at_large_scores`), so there the
    float64 function is the reference the tolerance is held to."""
    g = np.random.default_rng(110 + sk + dh)
    bias = _t(g, (77, sk), 2.0, torch.float32, device)
    q, k, v = _mha_operands(g, 2, 3, 77, sk, dh, "rows", torch.float32, device)
    got = A.multi_head_attention(q, k, v, bias=bias)
    torch.cuda.synchronize()
    _close(got, A.mha_plain(q, k, v, bias), torch.float32)
    q, k, v = (2.0 * t for t in _mha_operands(g, 2, 3, 77, sk, dh, "rows", torch.float32,
                                              device))
    got = A.multi_head_attention(q, k, v, bias=bias)
    scores = q.double() @ k.double().transpose(-1, -2) * dh ** -0.5 + bias.double()
    want = torch.softmax(scores, dim=-1) @ v.double()
    torch.cuda.synchronize()
    _close(got, want, torch.float32)


def test_core_fp32_spreads_few_pairs_over_the_card(device):
    """B7's core at b = 1 (8 heads x 6 row tiles) and B3 at one image of 2
    heads, and over 256 keys (the instance of 8 key groups): the tiles of
    few pairs spread over one-warp blocks, with the same result as the
    plain version."""
    g = np.random.default_rng(120)
    for b, s, w, heads, causal in ((1, 91, 640, 8, False), (1, 197, 128, 2, False),
                                   (2, 256, 640, 8, True), (3, 256, 512, 8, False)):
        qkv = _t(g, (b, s, 3 * w), 1.0, torch.float32, device)
        got = A.packed_qkv_self_attention(qkv, heads, causal=causal)
        torch.cuda.synchronize()
        _close(got, A.packed_qkv_self_attention_plain(qkv, heads, causal=causal),
               torch.float32)


@pytest.mark.parametrize("b", [1, 32])
def test_block_kernel_fp32_equals_the_pair(device, b):
    """B10 in fp32 at the ViT-B-16 text tower, b = 1 and 32: bit for bit
    B1 + B2 (both run the 3xTF32 attention body and the 3xTF32 GEMM)."""
    from fashionern_aaai2024_tpu_torch.ops import block as B

    args = _block_args(np.random.default_rng(35 + b), b, 77, 512, torch.float32, device)
    got = B._launch_block(*args, 8, True, "quick_gelu", None, 1e-5)
    pair = M.mlp_subblock(A.attention_subblock(*args[:7], 8, causal=True), *args[7:])
    torch.cuda.synchronize()
    torch.testing.assert_close(got, pair, atol=0, rtol=0)
    _close(got, B.transformer_block_plain(*args, 8, causal=True), torch.float32)


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


def test_fp32_attention_kernels_run_3xtf32_mma(device):
    """Every fp32 instance of the attention core (32: head dims 64 and 80,
    with and without a bias, 1-8 key groups), of the grouped kernel (4),
    of B8's wide route (8: 1-8 column units a warp) and B10's fp32
    instance issue their attention products as tf32 tensor-core MMA
    (HMMA.1688.F32.TF32) fed by asynchronous copies (LDGSTS), the core,
    the grouped kernel and the wide route with no other HMMA; the wide
    route's bf16 instances (8) issue bf16 HMMA only, on LDGSTS too; the
    CUDA-core fp32 kernels they replace are gone from the library."""
    common.LIBRARY.load()
    funcs = _sass_functions(common.LIBRARY.library_path())
    core = {k: v for k, v in funcs.items()
            if "attention_tf32_kernel" in k and "grouped" not in k}
    grouped = {k: v for k, v in funcs.items() if "grouped_attention_tf32_kernel" in k}
    wide = {k: v for k, v in funcs.items() if "wide_tf32_attention_kernel" in k}
    assert len(core) == 32 and len(grouped) == 4 and len(wide) == 8, (
        sorted(core), sorted(grouped), sorted(wide))
    for name, sass in {**core, **grouped, **wide}.items():
        hmma = [line.strip() for line in sass.splitlines() if "HMMA" in line]
        assert hmma and all("F32.TF32" in line for line in hmma), (name, hmma[:4])
        assert "LDGSTS" in sass, name
    blocks = {k: v for k, v in funcs.items() if "block_kernel" in k and "bfloat16" not in k}
    assert blocks, "no fp32 block_kernel in the library"
    for name, sass in blocks.items():
        assert "HMMA.1688.F32.TF32" in sass and "LDGSTS" in sass, name
    wide_bf16 = {k: v for k, v in funcs.items() if "wide_mma_attention_kernel" in k}
    assert len(wide_bf16) == 8, sorted(wide_bf16)
    for name, sass in wide_bf16.items():
        hmma = [line.strip() for line in sass.splitlines() if "HMMA" in line]
        assert hmma and all("F32.BF16" in line for line in hmma), (name, hmma[:4])
        assert "LDGSTS" in sass, name
    old = [k for k in funcs if "attention_kernel" in k and "mma" not in k and "tf32" not in k]
    assert not old, old


# the bf16 GEMM's ragged edges: rows one short of, at and one past a
# warpgroup's 64 and the ViT-B-16 trunk's 197 and 32 x 197 + 1; columns
# short of, inside and past 128 / 256-wide tiles; K short of, one past and
# at multiples of the 64-deep K tile
GEMM_M = (1, 15, 63, 64, 65, 197, 6305)
GEMM_N = (8, 72, 200, 640, 2304)
GEMM_K = (8, 40, 776, 3072)
# (bias, residual, activation): every combination the callers use
GEMM_EPILOGUES = ((True, False, None), (False, True, None), (True, True, None),
                  (True, False, "quick_gelu"), (True, False, "relu"), (False, False, None))


def _gemm_reference(a, w, bias, res, activation):
    """The GEMM's epilogue on an fp32 product: bias and activation in
    fp32, the cast, then the residual added in bf16."""
    from fashionern_aaai2024_tpu_torch.ops.mlp import act_f32

    v = a.float() @ w.float().T
    if bias is not None:
        v = v + bias.float()
    if activation == "relu":
        v = torch.relu(v)
    elif activation is not None:
        v = act_f32(v, activation)
    v = v.to(torch.bfloat16)
    return v if res is None else res + v


@pytest.mark.parametrize("n", GEMM_N)
@pytest.mark.parametrize("m", GEMM_M)
def test_bf16_gemm_edges_match_reference(device, m, n):
    g = np.random.default_rng(1000 * m + n)
    for i, k in enumerate(GEMM_K):
        with_bias, with_res, activation = GEMM_EPILOGUES[(GEMM_M.index(m) + i) %
                                                         len(GEMM_EPILOGUES)]
        a = _t(g, (m, k), 1.0, torch.bfloat16, device)
        w = _t(g, (n, k), 0.02, torch.bfloat16, device)
        bias = _t(g, (n,), 0.02, torch.bfloat16, device) if with_bias else None
        res = _t(g, (m, n), 1.0, torch.bfloat16, device) if with_res else None
        want = _gemm_reference(a, w, bias, res, activation)
        for tile in (128, 256):
            got = common._gemm(a, w, bias, res, activation, None, tile)
            torch.cuda.synchronize()
            _close(got, want, torch.bfloat16)
        _close(common.launch_gemm(a, w, bias, residual=res, activation=activation), want,
               torch.bfloat16)


def test_bf16_gemm_writes_a_column_slice(device):
    """`out=` a column slice at ldc > N (B12's concat halves): the slice
    holds the product, the columns beside it stay as they were."""
    g = np.random.default_rng(77)
    for m, k, n in ((1, 512, 640), (197, 640, 640), (1024, 512, 512)):
        a = _t(g, (m, k), 1.0, torch.bfloat16, device)
        w = _t(g, (n, k), 0.02, torch.bfloat16, device)
        bias = _t(g, (n,), 0.02, torch.bfloat16, device)
        cat = torch.full((m, 2 * n + 8), 7.0, dtype=torch.bfloat16, device=device)
        common.launch_gemm(a, w, bias, activation="relu", out=cat[:, n:2 * n])
        torch.cuda.synchronize()
        _close(cat[:, n:2 * n], _gemm_reference(a, w, bias, None, "relu"), torch.bfloat16)
        assert (cat[:, :n] == 7).all() and (cat[:, 2 * n:] == 7).all()


def test_bf16_gemm_refuses_misaligned_operands(device):
    """TMA takes 16-byte aligned bases only: a view one element into its
    storage raises, for either operand, with nothing launched."""
    a = torch.zeros(197 * 512 + 8, dtype=torch.bfloat16, device=device)
    w = torch.zeros(640 * 512 + 8, dtype=torch.bfloat16, device=device)
    good_a, good_w = a[:197 * 512].view(197, 512), w[:640 * 512].view(640, 512)
    with pytest.raises(ValueError, match="16 bytes"):
        common.launch_gemm(a[1:197 * 512 + 1].view(197, 512), good_w, None)
    with pytest.raises(ValueError, match="16 bytes"):
        common.launch_gemm(good_a, w[1:640 * 512 + 1].view(640, 512), None)
    with pytest.raises(ValueError, match="multiples of 8"):
        common.launch_gemm(a[:197 * 500].view(197, 500), w[:640 * 500].view(640, 500), None)


def test_bf16_gemm_runs_wgmma_fed_by_tma(device):
    """The bf16 GEMM issues warpgroup MMA (HGMMA) on tiles that TMA loads
    (UTMALDG) and no WMMA / mma.sync (HMMA); B10's bf16 kernel runs its
    products on the same HGMMA body."""
    common.LIBRARY.load()
    funcs = _sass_functions(common.LIBRARY.library_path())
    gemms = {k: v for k, v in funcs.items() if "gemm_bf16_kernel" in k}
    assert gemms, "no gemm_bf16_kernel in the library"
    for name, sass in gemms.items():
        assert "HGMMA" in sass and "UTMALDG" in sass and "HMMA" not in sass, name
    blocks = {k: v for k, v in funcs.items()
              if "block_kernel" in k and "bfloat16" in k}
    assert blocks, "no bf16 block_kernel in the library"
    for name, sass in blocks.items():
        assert "HGMMA" in sass, name


# the fp32 GEMM (3xTF32 warpgroup MMA, csrc/gemm_tf32.cu) at its tiles'
# edges: rows one short of, at and one past a warpgroup's 64 and a block
# tile's 128, B7's 91 query rows and 1,024; columns inside and past the
# 32-, 64- and 128-wide tiles and B7's 1,920; K short of, one past and at
# multiples of the 32-deep K tile, and c_proj's 3,072
F32_GEMM_M = (1, 63, 64, 65, 91, 127, 128, 129, 1024)
F32_GEMM_N = (8, 72, 200, 640, 1920)
F32_GEMM_K = (8, 40, 776, 3072)
F32_GEMM_EPILOGUES = GEMM_EPILOGUES + ((True, False, "gelu"),)


def _f32_gemm_reference(a, w, bias, res, activation):
    """The fp32 GEMM's function in full fp32: bias, activation, residual."""
    from fashionern_aaai2024_tpu_torch.ops.mlp import act_f32

    v = a @ w.T
    if bias is not None:
        v = v + bias
    if activation == "relu":
        v = torch.relu(v)
    elif activation is not None:
        v = act_f32(v, activation)
    return v if res is None else res + v


@pytest.mark.parametrize("n", F32_GEMM_N)
@pytest.mark.parametrize("m", F32_GEMM_M)
def test_f32_gemm_edges_match_reference(device, m, n):
    """Every tile width (32, 64, 128 and the rule's) against an fp32
    product through the same epilogue at the fp32 tolerance; the widths
    give the same bits (the sums' order does not depend on the width)."""
    g = np.random.default_rng(2000 * m + n)
    for i, k in enumerate(F32_GEMM_K):
        with_bias, with_res, activation = F32_GEMM_EPILOGUES[(F32_GEMM_M.index(m) + i) %
                                                             len(F32_GEMM_EPILOGUES)]
        a = _t(g, (m, k), 1.0, torch.float32, device)
        w = _t(g, (n, k), 0.02, torch.float32, device)
        bias = _t(g, (n,), 0.02, torch.float32, device) if with_bias else None
        res = _t(g, (m, n), 1.0, torch.float32, device) if with_res else None
        want = _f32_gemm_reference(a, w, bias, res, activation)
        got = {tile: common._gemm(a, w, bias, res, activation, None, tile)
               for tile in (32, 64, 128)}
        rule = common.launch_gemm(a, w, bias, residual=res, activation=activation)
        torch.cuda.synchronize()
        _close(got[128], want, torch.float32)
        for other in (got[32], got[64], rule):
            torch.testing.assert_close(other, got[128], atol=0, rtol=0)


def test_f32_gemm_writes_a_column_slice(device):
    """`out=` a column slice at ldc > N in fp32: the slice holds the
    product, the columns beside it stay as they were."""
    g = np.random.default_rng(78)
    for m, k, n in ((1, 512, 640), (91, 640, 1920), (1024, 512, 512)):
        a = _t(g, (m, k), 1.0, torch.float32, device)
        w = _t(g, (n, k), 0.02, torch.float32, device)
        bias = _t(g, (n,), 0.02, torch.float32, device)
        cat = torch.full((m, 2 * n + 8), 7.0, device=device)
        common.launch_gemm(a, w, bias, activation="relu", out=cat[:, n:2 * n])
        torch.cuda.synchronize()
        _close(cat[:, n:2 * n], _f32_gemm_reference(a, w, bias, None, "relu"), torch.float32)
        assert (cat[:, :n] == 7).all() and (cat[:, 2 * n:] == 7).all()


def test_f32_gemm_refuses_misaligned_operands(device):
    """TMA takes 16-byte aligned bases only, in fp32 too: a view one
    element into its storage raises, for either operand."""
    a = torch.zeros(91 * 640 + 4, device=device)
    w = torch.zeros(1920 * 640 + 4, device=device)
    good_a, good_w = a[:91 * 640].view(91, 640), w[:1920 * 640].view(1920, 640)
    with pytest.raises(ValueError, match="16 bytes"):
        common.launch_gemm(a[1:91 * 640 + 1].view(91, 640), good_w, None)
    with pytest.raises(ValueError, match="16 bytes"):
        common.launch_gemm(good_a, w[1:1920 * 640 + 1].view(1920, 640), None)


def _hgmma_lines(sass):
    """The product instructions of a kernel's SASS: ptxas also places a
    no-op HGMMA (RZ operands, gdesc[URZ]) where a warpgroup commits an
    empty group."""
    return [line.strip() for line in sass.splitlines()
            if "HGMMA" in line and "gdesc[URZ]" not in line]


def test_fp32_gemm_b4_and_b10_run_3xtf32_wgmma(device):
    """The fp32 GEMM (every tile width and activation), B4 and B10's fp32
    instance issue their products as tf32 warpgroup MMA (HGMMA ... TF32)
    on TMA-loaded tiles (UTMALDG); and no FFMA lies between the first and
    the last HGMMA of the GEMM or of B4 (no SIMT main loop left)."""
    common.LIBRARY.load()
    funcs = _sass_functions(common.LIBRARY.library_path())
    found = {k: v for k, v in funcs.items() if "gemm_tf32_kernel" in k or "bbc_partial" in k}
    assert len([k for k in found if "gemm_tf32_kernel" in k]) == 14, sorted(found)
    assert any("bbc_partial" in k for k in found), sorted(found)
    for name, sass in found.items():
        hgmma = _hgmma_lines(sass)
        assert hgmma and all("TF32" in line for line in hgmma), (name, hgmma[:4])
        assert "UTMALDG" in sass and "HMMA" not in sass, name
        lines = sass.splitlines()
        first = next(i for i, line in enumerate(lines) if "HGMMA" in line)
        last = max(i for i, line in enumerate(lines) if "HGMMA" in line)
        assert not any("FFMA" in line for line in lines[first:last]), name
    blocks = {k: v for k, v in funcs.items()
              if "block_kernel" in k and "bfloat16" not in k}
    assert blocks, "no fp32 block_kernel in the library"
    for name, sass in blocks.items():
        hgmma = _hgmma_lines(sass)
        assert hgmma and all("TF32" in line for line in hgmma), (name, hgmma[:4])
        assert "UTMALDG" in sass, name


def test_b12_fp32_runs_3xtf32_wgmma_and_b11_vector_loads(device):
    """B12's fp32 GEMM issues its products as tf32 warpgroup MMA (HGMMA
    ... TF32) on tiles that TMA loads (UTMALDG); every vector instance of
    B11's kernel loads and stores 16 bytes a lane (LDG.E.128, STG.E.128)."""
    import re

    common.LIBRARY.load()
    funcs = _sass_functions(common.LIBRARY.library_path())
    tf32 = {k: v for k, v in funcs.items() if "gemm_tf32_kernel" in k}
    assert tf32, "no gemm_tf32_kernel in the library"
    for name, sass in tf32.items():
        # the products; ptxas also places a no-op HGMMA (RZ operands,
        # gdesc[URZ]) where a warpgroup commits an empty group
        hgmma = [line for line in sass.splitlines()
                 if "HGMMA" in line and "gdesc[URZ]" not in line]
        other = [line.strip() for line in hgmma if "TF32" not in line]
        assert hgmma and not other, (name, other[:4])
        assert "UTMALDG" in sass and "HMMA" not in sass, name
    lns = {k: v for k, v in funcs.items()
           if "layernorm_kernel" in k and re.search(r"Li[1-8]E", k)}
    assert len(lns) == 16, sorted(lns)
    for name, sass in lns.items():
        assert "LDG.E.128" in sass and "STG.E.128" in sass, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,w,heads,causal", [(1, 77, 640, 10, True),
                                                (2, 197, 768, 12, False)])
def test_block_kernel_equals_the_pair_at_the_ln_widths(device, dtype, b, s, w, heads, causal):
    """B10's LN phases run B11's row routine, chosen by the same rule: at
    the RN50x4 text width and the ViT width (other vector instances than
    the 512 of `test_block_kernel_bf16_equals_the_pair`), B10 stays bit
    for bit B1 + B2."""
    from fashionern_aaai2024_tpu_torch.ops import block as B

    args = _block_args(np.random.default_rng(w + b), b, s, w, dtype, device)
    got = B._launch_block(*args, heads, causal, "quick_gelu", None, 1e-5)
    pair = M.mlp_subblock(A.attention_subblock(*args[:7], heads, causal=causal), *args[7:])
    torch.cuda.synchronize()
    torch.testing.assert_close(got, pair, atol=0, rtol=0)


def test_uint8_feed_normalized_on_the_card_equals_the_cpu_feed(device, tmp_path):
    """A dataset batch of the uint8 feed, normalized on the card
    (`normalize_on_device`, as `CLIP.encode_image` does), equals the float
    feed the CPU normalizes (`native.normalize_images`) bit for bit: both
    round x * (1 / (255 std)) and then + (-mean / std)."""
    from fashionern_aaai2024_tpu_torch.data.fashioniq import DRESS_TYPES, FashionIQDataset
    from fashionern_aaai2024_tpu_torch.data.loader import Loader
    from fashionern_aaai2024_tpu_torch.data.transforms import normalize_on_device
    from fashionern_aaai2024_tpu_torch.tools.make_fixture import make_fixture

    root = make_fixture(str(tmp_path / "fiq"), "fashioniq", dim=16, learnable=True,
                        n_images=6, n_triplets=4)
    batches = {}
    for dtype in ("uint8", "float32"):
        ds = FashionIQDataset(root, "train", DRESS_TYPES, dim=224, image_dtype=dtype)
        batches[dtype] = next(iter(Loader(ds, 8, num_workers=0)))
    u8 = batches["uint8"]["ref_image"]
    assert u8.dtype == np.uint8 and u8.shape == (8, 224, 224, 3)
    got = normalize_on_device(u8, device)
    assert got.device.type == "cuda"
    want = torch.from_numpy(batches["float32"]["ref_image"])
    torch.testing.assert_close(got.cpu(), want, atol=0, rtol=0)


def test_extract_patches_card_against_cpu(device, tmp_path):
    """`PatchExtractor` over a small seeded ViT on the card (fp32, the
    kernels) against the same tower on the CPU (the plain versions): every
    crop's feature at the fp32 tolerance of a two-layer tower."""
    from PIL import Image

    from fashionern_aaai2024_tpu_torch.models.clip import config as C
    from fashionern_aaai2024_tpu_torch.models.composed import ComposedCIRModel, random_init_
    from fashionern_aaai2024_tpu_torch.tools.extract_patches import (
        PatchExtractor,
        enumerate_image_dir,
    )

    cfg = C.CLIPConfig(name="small", vision=C.VisionConfig(
        kind="vit", image_size=32, embed_dim=24, width=128, layers=2, heads=2, patch_size=16),
        text=C.TextConfig(vocab_size=100, context_length=16, width=64, heads=2, layers=2,
                          embed_dim=24))
    g = np.random.default_rng(0)
    (tmp_path / "images").mkdir()
    for i, (h, w) in enumerate(((120, 90), (64, 64), (50, 130))):
        Image.fromarray(g.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            tmp_path / "images" / f"im{i}.png")
    items = enumerate_image_dir(str(tmp_path))
    model = random_init_(ComposedCIRModel(cfg), torch.Generator().manual_seed(0)).eval()
    feats = {}
    for dev in ("cpu", device):
        model = model.to(dev)

        @torch.inference_mode()
        def encode(crops):
            return model.encode_image(torch.from_numpy(crops).to(dev))[0].float().cpu()

        feats[str(dev)] = torch.from_numpy(
            PatchExtractor(encode, 32, batch_images=2).extract_batch([p for p, _ in items]))
    got, want = feats[str(device)], feats["cpu"]
    assert got.shape == (3, 13, 24)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


# --- the gallery pipeline (retrieval/engine.py embed_gallery, Placer) -------------


def _gallery_api(device):
    """A small seeded fp32 ViT (image 32, 2 layers of 128, d = 24) on the
    card, its image tower on B1-B3 and B11."""
    from fashionern_aaai2024_tpu_torch.models.clip import config as C
    from fashionern_aaai2024_tpu_torch.models.composed import ComposedCIRModel, random_init_
    from fashionern_aaai2024_tpu_torch.retrieval.evaluate import InferenceAPI

    cfg = C.CLIPConfig(name="gallery-small", vision=C.VisionConfig(
        kind="vit", image_size=32, embed_dim=24, width=128, layers=2, heads=2, patch_size=16),
        text=C.TextConfig(vocab_size=100, context_length=16, width=64, heads=2, layers=2,
                          embed_dim=24))
    model = random_init_(ComposedCIRModel(cfg), torch.Generator().manual_seed(0))
    return InferenceAPI(model, tokenizer=None, device=device, batch_size=4, context_length=16)


def _gallery_batches(n, seed):
    g = np.random.default_rng(seed)
    return [{"name": [f"b{i}-{j}" for j in range(4)],
             "image": g.random((4, 32, 32, 3), dtype=np.float32),
             "patch": g.standard_normal((4, 13, 24)).astype(np.float32)} for i in range(n)]


def test_gallery_pipeline_three_deep_equals_the_serial_feed(device):
    """`embed_gallery` at prefetch 3 over 64 batches equals prefetch 0 bit
    for bit (tokens kept): with a warm allocator and three batches staged
    ahead, a placed batch not marked for the compute stream
    (`record_stream`) would be read after its block went to a later copy.
    Every batch's images and patches were copied from page-locked memory
    on the stage's stream."""
    from fashionern_aaai2024_tpu_torch.retrieval.engine import embed_gallery

    api = _gallery_api(device)
    batches = _gallery_batches(64, seed=0)
    serial = embed_gallery(api.gallery_encode_fn(), batches, 4, keep_tokens=True, prefetch=0)
    fn = api.gallery_encode_fn()
    deep = embed_gallery(fn, batches, 4, keep_tokens=True, prefetch=3)
    assert deep.names == serial.names and len(deep.names) == 256
    for key in ("features", "local_features", "token_features"):
        torch.testing.assert_close(getattr(deep, key), getattr(serial, key), atol=0, rtol=0,
                                   msg=key)
    assert deep.features.is_cuda and deep.local_features.is_cuda
    assert deep.token_features.device.type == "cpu"
    assert fn.place.batches == 64 and fn.place.copies == 128
    want = torch.from_numpy(np.concatenate([b["patch"] for b in batches])).to(device)
    torch.testing.assert_close(deep.local_features, want, atol=0, rtol=0)


def test_a_placed_batch_comes_from_page_locked_memory_on_the_copy_stream(device):
    """`.place` on a strided numpy view: its values on the card, copied
    from page-locked memory while the placer's own stream (not the
    caller's) was current, with an event that `ready` makes the caller's
    stream wait on; the patches as fp32."""
    api = _gallery_api(device)
    place = api.gallery_encode_fn().place
    g = np.random.default_rng(1)
    images = g.random((5, 32, 64, 3), dtype=np.float32)[:, :, ::2]
    patch = g.standard_normal((5, 13, 24))
    placed = place(images, patch)
    assert place.stream is not None and place.stream != torch.cuda.current_stream()
    assert place.batches == 1 and place.copies == 2 and placed.event is not None
    got, got_patch = placed.ready()
    assert got.is_cuda and got_patch.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), torch.from_numpy(np.ascontiguousarray(images)),
                               atol=0, rtol=0)
    torch.testing.assert_close(got_patch.cpu(), torch.from_numpy(patch).float(), atol=0,
                               rtol=0)


# --- the serve program as CUDA graphs (retrieval/evaluate.py ServeFn) -----------


def _serve_api(device, tme=False, quantize=False):
    """A seeded model whose text tower takes B10 (width 512, 8 heads of
    64, 16 tokens; with `quantize`, the int8 blocks B5 and B6) and whose
    DVR runs at d = 512, under the bf16 serve policy, on the card."""
    from fashionern_aaai2024_tpu_torch.models.clip import config as C
    from fashionern_aaai2024_tpu_torch.models.composed import (
        ComposedCIRModel,
        apply_precision,
        random_init_,
    )
    from fashionern_aaai2024_tpu_torch.retrieval.evaluate import InferenceAPI

    cfg = C.CLIPConfig(name="serve-small", vision=C.VisionConfig(
        kind="vit", image_size=32, embed_dim=512, width=128, layers=1, heads=2, patch_size=16),
        text=C.TextConfig(vocab_size=1000, context_length=16, width=512, heads=8, layers=2,
                          embed_dim=512, tme=tme), quantize_mlp=quantize)
    model = random_init_(ComposedCIRModel(cfg), torch.Generator().manual_seed(0))
    apply_precision(model, "bf16")
    return InferenceAPI(model, tokenizer=None, device=device, context_length=16)


def _serve_arrays(n, seed, d=512):
    g = np.random.default_rng(seed)
    gal = g.standard_normal((n, d)).astype(np.float32)
    gal /= np.linalg.norm(gal, axis=1, keepdims=True)
    return (gal, g.standard_normal((n, d)).astype(np.float32),
            g.standard_normal((n, 13, d)).astype(np.float32))


def _serve_ids(n, seed):
    ids = np.random.default_rng(seed).integers(1, 998, (n, 16)).astype(np.int32)
    ids[:, 9] = 999   # EOT: the largest id
    ids[:, 10:] = 0
    return ids


@pytest.mark.parametrize("tme", [False, True])
def test_serve_graphs_replay_the_eager_body(device, tme):
    """Each bucket's graph replay against the same body run eagerly on the
    same static inputs: equal rows, scores within 1e-6 (cuBLAS may take
    another algorithm under capture; the kernels of the port give the
    same bits)."""
    api = _serve_api(device, tme)
    gal, rf, rp = _serve_arrays(300, 1)
    fn = api.build_serve_fn(gal, k_max=50, ref_features=rf, ref_patches=rp, capacity=512)
    for b in fn.buckets:
        ids, rows = _serve_ids(b, b), np.random.default_rng(b).integers(0, 300, b)
        got_s, got_i = fn(ids, rows, k=50)
        want_s, want_i = fn.body(torch.from_numpy(ids).to(device),
                                 torch.from_numpy(rows).to(device))
        assert np.array_equal(got_i, want_i.cpu().numpy())
        np.testing.assert_allclose(got_s, want_s.cpu().numpy(), atol=1e-6, rtol=0)
        assert np.isfinite(got_s).all() and int(got_i.max()) < 300


def test_nccl_world1_sharded_serve_graphs_replay_the_eager_body(device):
    """The gallery-sharded serve program on an NCCL group of world size 1
    (the card's machine has one GPU): each bucket's graph, NCCL
    collectives inside, against the same body run eagerly, and against
    the single-device program: equal rows, scores within 1e-6."""
    from fashionern_aaai2024_tpu_torch.parallel import mesh as PM

    mesh = PM.initialize_distributed(device="cuda", timeout=120.0)
    try:
        assert (mesh.backend, mesh.size) == ("nccl", 1)
        api = _serve_api(device)
        gal, rf, rp = _serve_arrays(300, 2)
        api.mesh = mesh
        fn = api.build_serve_fn(gal, k_max=50, ref_features=rf, ref_patches=rp)
        api.mesh = None
        single = api.build_serve_fn(gal, k_max=50, ref_features=rf, ref_patches=rp)
        assert all(b.graph is not None for b in fn._buckets.values()) and fn.per == 300
        for b in fn.buckets:
            ids, rows = _serve_ids(b, b), np.random.default_rng(b).integers(0, 300, b)
            got_s, got_i = fn(ids, rows, k=50)
            want_s, want_i = fn.body(torch.from_numpy(ids).to(device),
                                     torch.from_numpy(rows).to(device))
            assert np.array_equal(got_i, want_i.cpu().numpy())
            np.testing.assert_allclose(got_s, want_s.cpu().numpy(), atol=1e-6, rtol=0)
            one_s, one_i = single(ids, rows, k=50)
            assert np.array_equal(got_i, one_i)
            np.testing.assert_allclose(got_s, one_s, atol=1e-6, rtol=0)
        fn.close()
    finally:
        PM.destroy(mesh)


def test_graph_barrier_words_are_isolated(device):
    """B10 captured at two sizes (two graphs, each with its own barrier
    word, allocated before its capture and held by it) and replayed
    interleaved with eager B10 calls on the default stream: the same bits
    every time."""
    from fashionern_aaai2024_tpu_torch.ops.graphs import CapturedCall

    calls = []
    for b, seed in ((1, 0), (8, 1)):
        g = np.random.default_rng(seed)
        x = _t(g, (b, 77, 512), 1.0, torch.bfloat16, device)
        ws = [_t(g, s, 0.02, torch.bfloat16, device, offset=o) for s, o in (
            ((512,), 1.0), ((512,), 0.0), ((1536, 512), 0.0), ((1536,), 0.0), ((512, 512), 0.0),
            ((512,), 0.0), ((512,), 1.0), ((512,), 0.0), ((2048, 512), 0.0), ((2048,), 0.0),
            ((512, 2048), 0.0), ((512,), 0.0))]
        calls.append(lambda x=x, ws=ws: TB.transformer_block(x, *ws, heads=8, causal=True))
    want = [c().clone() for c in calls]
    graphs = [CapturedCall(c) for c in calls]
    assert graphs[0].barrier_word.data_ptr() != graphs[1].barrier_word.data_ptr()
    for _ in range(20):
        for c, g, w in zip(calls, graphs, want):
            g.replay()
            assert torch.equal(c(), w)
        torch.cuda.synchronize()
        for g, w in zip(graphs, want):
            assert torch.equal(g.outputs, w)


def test_live_adds_need_no_recapture(device):
    """`update_rows` writes into the static tensors the graphs read: the
    graphs and the tensors' addresses stay, and the answers equal a
    program built over the grown gallery."""
    api = _serve_api(device)
    gal, rf, rp = _serve_arrays(200, 2)
    fn = api.build_serve_fn(gal, k_max=20, buckets=(1, 8), ref_features=rf, ref_patches=rp,
                            capacity=256)
    graphs = {b: fn._buckets[b].graph for b in fn.buckets}   # captured at the build
    ptrs = [t.data_ptr() for t in (fn.gallery, fn.ref_f, fn.ref_p, fn._n_valid_dev)]
    more = _serve_arrays(30, 3)
    over = _serve_arrays(5, 4)
    assert fn.update_rows(200, *more) == 230
    assert fn.update_rows(10, *over) == 230
    assert {b: fn._buckets[b].graph for b in fn.buckets} == graphs
    assert [t.data_ptr() for t in (fn.gallery, fn.ref_f, fn.ref_p, fn._n_valid_dev)] == ptrs
    grown = [np.concatenate([a, m]) for a, m in zip((gal, rf, rp), more)]
    for a, o in zip(grown, over):
        a[10:15] = o
    fresh = api.build_serve_fn(grown[0], k_max=20, buckets=(1, 8), ref_features=grown[1],
                               ref_patches=grown[2])
    ids, rows = _serve_ids(6, 5), np.asarray([0, 12, 150, 201, 229, 14])
    got_s, got_i = fn(ids, rows, k=20)
    want_s, want_i = fresh(ids, rows, k=20)
    assert np.array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, atol=1e-5, rtol=0)
    assert int(got_i.max()) < 230


def _kernel_wrappers():
    return (A.attention_subblock, A.packed_qkv_self_attention, A.fused_qkv_self_attention,
            A.packed_kv_cross_attention, A.multi_head_attention, M.mlp_subblock,
            LN.layer_norm, Cb.combiner_apply, L.bbc_rowloss, Q.int8_mlp_subblock,
            Q.int8_attention_subblock, TB.transformer_block, XA.mha_grouped, XA.mha_packed,
            XA.qkvattn, XA.attnblock)


# per serve call of `_serve_api`'s model: B10 in each of the text tower's 2
# blocks, B11 at ln_final and the DVR BERT's 5 LNs, B7 in its 2 layers, B8
# at MR, B12 in the three combiners
def _serve_per_call():
    return {TB.transformer_block: 2, LN.layer_norm: 6, A.fused_qkv_self_attention: 2,
            A.packed_kv_cross_attention: 1, Cb.combiner_apply: 3}


def test_launch_counts_follow_replays(device):
    """The build counts its one eager call and no capture; each replay
    counts its graph's kernels."""
    api = _serve_api(device)
    gal, rf, rp = _serve_arrays(100, 6)
    per_call = _serve_per_call()
    for c in _kernel_wrappers():
        c.launches = 0
    fn = api.build_serve_fn(gal, k_max=10, buckets=(1,), ref_features=rf, ref_patches=rp)
    for c in _kernel_wrappers():
        assert c.launches == per_call.get(c, 0), c.__name__
    assert fn._buckets[1].graph.launches == per_call
    for _ in range(7):
        fn(_serve_ids(1, 7), np.asarray([3]), k=5)
    torch.cuda.synchronize()
    for c in _kernel_wrappers():
        assert c.launches == 8 * per_call.get(c, 0), c.__name__


def test_replay_runs_the_graphs_kernel_nodes(device):
    """One replay of each bucket under the profiler: the port kernels in
    the trace are the graph's kernel nodes (`kernel_nodes`, read from the
    libcuda at capture and checked there against the recorded launches),
    one event each."""
    import collections

    from fashionern_aaai2024_tpu_torch.ops.graphs import port_kernel

    api = _serve_api(device, tme=True)
    gal, rf, rp = _serve_arrays(120, 8)
    fn = api.build_serve_fn(gal, k_max=20, ref_features=rf, ref_patches=rp, capacity=128)
    for b in fn.buckets:
        graph = fn._buckets[b].graph
        assert graph.kernel_nodes[graph.kernel_nodes.most_common(1)[0][0]] > 0
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        traced = collections.Counter()
        for e in prof.key_averages():
            if port_kernel(e.key):
                traced[port_kernel(e.key)] += e.count
        assert traced == graph.kernel_nodes, b


def test_capture_beside_another_threads_launches(device):
    """A serve program built while another thread launches B10 eagerly:
    the capture records only its own thread, so the counters hold the
    other thread's launches, the build's eager call and the replays, and
    the replay equals the eager body."""
    api = _serve_api(device)
    gal, rf, rp = _serve_arrays(100, 9)
    g = np.random.default_rng(10)
    x = _t(g, (1, 77, 512), 1.0, torch.bfloat16, device)
    ws = [_t(g, s, 0.02, torch.bfloat16, device, offset=o) for s, o in (
        ((512,), 1.0), ((512,), 0.0), ((1536, 512), 0.0), ((1536,), 0.0), ((512, 512), 0.0),
        ((512,), 0.0), ((512,), 1.0), ((512,), 0.0), ((2048, 512), 0.0), ((2048,), 0.0),
        ((512, 2048), 0.0), ((512,), 0.0))]
    want = TB.transformer_block(x, *ws, heads=8, causal=True).clone()
    per_call = _serve_per_call()
    for c in _kernel_wrappers():
        c.launches = 0
    stop, calls, same = threading.Event(), [0], [True]

    def eager():
        while not stop.is_set() or calls[0] < 50:
            same[0] &= torch.equal(TB.transformer_block(x, *ws, heads=8, causal=True), want)
            calls[0] += 1
    other = threading.Thread(target=eager)
    other.start()
    try:
        fn = api.build_serve_fn(gal, k_max=10, buckets=(1, 8), ref_features=rf,
                                ref_patches=rp)
    finally:
        stop.set()
        other.join()
    assert same[0]
    for c in _kernel_wrappers():
        extra = calls[0] if c is TB.transformer_block else 0
        assert c.launches == 2 * per_call.get(c, 0) + extra, c.__name__
    ids, rows = _serve_ids(8, 11), np.arange(8)
    got_s, got_i = fn(ids, rows, k=10)
    want_s, want_i = fn.body(torch.from_numpy(ids).to(device), torch.from_numpy(rows).to(device))
    assert np.array_equal(got_i, want_i[:, :10].cpu().numpy())
    np.testing.assert_allclose(got_s, want_s[:, :10].cpu().numpy(), atol=1e-6, rtol=0)
    assert TB.transformer_block.launches == 4 * per_call[TB.transformer_block] + calls[0]


def test_fold_matches_numpy_twin_on_the_card(device):
    """The approximate tier's fold on the card (strided bins, first
    maximal slot, stable top-k of the bin maxima) against its numpy twin,
    on scores with ties inside the bins."""
    from fashionern_aaai2024_tpu_torch.ops import similarity as S

    for n, k in ((5000, 51), (1024, 50), (20000, 10), (3000, 1)):
        s = np.round(np.random.default_rng(n).standard_normal((8, n)), 2).astype(np.float32)
        bins, r = S.reduction_output_size(n, k, 0.95)
        padded = np.full((8, bins << r), -np.inf, np.float32)
        padded[:, :n] = s
        folded = padded.reshape(8, 1 << r, bins)
        slot, best = folded.argmax(axis=1), folded.max(axis=1)
        chosen = np.argsort(-best, axis=1, kind="stable")[:, :k]
        got_s, got_i = S.select_top_k(torch.from_numpy(s).to(device), k, 0.95)
        assert np.array_equal(got_i.cpu().numpy(),
                              np.take_along_axis(slot, chosen, 1) * bins + chosen)
        assert np.array_equal(got_s.cpu().numpy(), np.take_along_axis(best, chosen, 1))


def _exported(device, tmp_path, gallery_scale=1.0):
    """A by-rows serve program of `_serve_api` over 300 rows, and its
    artifact."""
    from fashionern_aaai2024_tpu_torch.retrieval import artifact as ART

    gal, rf, rp = _serve_arrays(300, 3)
    fn = _serve_api(device).build_serve_fn(gal * gallery_scale, k_max=50, ref_features=rf,
                                           ref_patches=rp)
    out = str(tmp_path / "artifact")
    ART.export_serve_artifact(fn, out, gallery_names=[f"n{i}" for i in range(300)])
    return fn, out


def test_exported_programs_run_the_kernels_as_the_live_body(device, tmp_path):
    """The exported program of each bucket, called on CUDA tensors, runs
    the registered ops' kernels (their launch counters move) and answers
    as the live body: equal rows, scores within 1e-6."""
    import json

    fn, out = _exported(device, tmp_path)
    manifest = json.load(open(f"{out}/manifest.json"))
    assert manifest["platform"] == "cuda"
    consts = fn.consts
    for b in fn.buckets:
        program = torch.export.load(f"{out}/serve_b{b}.pt2").module()
        ids = torch.from_numpy(_serve_ids(b, b)).to(device)
        rows = torch.from_numpy(np.random.default_rng(b).integers(0, 300, b)).to(device)
        n0 = TB.transformer_block.launches
        with torch.no_grad():
            got_s, got_i = program(consts, ids, rows)
        assert TB.transformer_block.launches == n0 + 2   # the text tower's 2 blocks
        want_s, want_i = fn.body(ids, rows)
        assert torch.equal(got_i, want_i)
        torch.testing.assert_close(got_s, want_s, atol=1e-6, rtol=0)


def test_artifact_graphs_hold_their_launches_and_reload_without_recapture(device, tmp_path):
    """`load_serve_artifact` on the card captures each bucket as one CUDA
    graph whose port kernel nodes are the launches its capture recorded;
    `reload_consts` after `refresh_consts` (a 2x gallery) copies into the
    static consts: the same graphs then give doubled scores."""
    from fashionern_aaai2024_tpu_torch.retrieval import artifact as ART

    fn, out = _exported(device, tmp_path)
    art = ART.load_serve_artifact(out, device=device)
    graphs = {b: art._buckets[b].graph for b in art.buckets}
    for b, graph in graphs.items():
        assert graph is not None and sum(graph.kernel_nodes.values()) > 0
        assert graph.launches[TB.transformer_block] == 2
    ids = _serve_ids(5, 5)
    rows = np.random.default_rng(5).integers(0, 300, 5)
    s1, i1 = art.query(ids, rows, k=10)
    live_s, live_i = fn(ids, rows, k=10)
    assert np.array_equal(i1, live_i)
    np.testing.assert_allclose(s1, live_s, atol=1e-6, rtol=0)
    doubled, _ = _exported(device, tmp_path / "x2", gallery_scale=2.0)
    ART.refresh_consts(out, doubled)
    art.reload_consts()
    assert all(art._buckets[b].graph is g for b, g in graphs.items())
    s2, i2 = art.query(ids, rows, k=10)
    assert np.array_equal(i2, i1)
    np.testing.assert_allclose(s2, 2 * s1, rtol=1e-5, atol=1e-6)


def test_int8_serve_graphs_survive_a_rebuilt_weight_cache(device):
    """An int8-tower serve program's graphs read the int8 weight sets
    cached at capture. Another `InferenceAPI` over the same model (its
    `.to()` drops every block's cache) and an eager query (which rebuilds
    it) must leave the replays' answers as they were: the program holds
    the sets its graphs read."""
    from fashionern_aaai2024_tpu_torch.retrieval.evaluate import InferenceAPI

    api = _serve_api(device, quantize=True)
    model = api.model
    gal, rf, rp = _serve_arrays(300, 4)
    fn = api.build_serve_fn(gal, k_max=50, ref_features=rf, ref_patches=rp)
    ids, rows = _serve_ids(5, 5), np.random.default_rng(5).integers(0, 300, 5)
    before = fn(ids, rows, k=20)
    n0 = Q.int8_mlp_subblock.launches
    other = InferenceAPI(model, device=device, context_length=16)
    other.encode_text(ids)
    assert Q.int8_mlp_subblock.launches == n0 + 2   # the eager query ran the int8 blocks
    # blocks of the cached sets' sizes, zero-filled: where the caching
    # allocator hands out memory the captured sets held, a replay that
    # read it would see zeros
    sets = [m._int8[1] for m in model.modules() if getattr(m, "_int8", None) is not None]
    junk = [torch.zeros(t.numel() * t.element_size(), dtype=torch.uint8, device=device)
            for weights in sets for pair in weights.values() for t in pair for _ in range(4)]
    torch.cuda.synchronize()
    after = fn(ids, rows, k=20)
    del junk
    assert np.array_equal(after[1], before[1])
    assert np.array_equal(after[0], before[0])
