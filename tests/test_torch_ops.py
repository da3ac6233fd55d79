"""The port's ops (plain versions, on the CPU) against the JAX package.

Kernels B1 (`attention_subblock`), B2 (`mlp_subblock`) and B3
(`packed_qkv_self_attention`) are held against the JAX Pallas kernels run
as the JAX tests run them (`force_pallas=True, interpret=True`); exact
GELU against `_mlp_ref(activation="gelu")`. B7
(`fused_qkv_self_attention`), B8 (`packed_kv_cross_attention`) and B11
(`layer_norm`) against `_qkv_fused_pallas`, `_packed_cross_pallas` and
`_layer_norm_pallas` with `interpret=True`, at head dim 64 and 80. B9
(`multi_head_attention`) against `multi_head_attention(force_pallas=True,
interpret=True)` (the `_mha_pallas` kernel) with no bias, causal, an
arbitrary bias and Sq != Sk, and its autograd Function against `jax.vjp`
of `_mha_ref`; B12 (`combiner_apply`) against `combiner_apply(
force_pallas=True, interpret=True)` and the flax `CombinerSimple`. Kernel B4 (`bbc_rowloss`)
against `_bbc_rowloss_pallas(..., interpret=True)` and `_bbc_rowloss_ref`,
and its autograd against `jax.grad` of the custom-VJP `_bbc_mean_loss`.
The same numpy inputs feed both sides.

Tolerances: fp32 atol 2e-5 (the module tolerance of the parity suites);
bf16 atol = rtol = 2e-2 (bf16 keeps about three significant digits and
the two frameworks accumulate in different orders). B4's row losses at
atol 5e-4, rtol 1e-5: the temperature of 100 turns the fp32 ordering
error of a d = 512 dot product (about 1e-6) into about 1e-4 on a score.
Its gradients at rtol 1e-4 and an atol of 5e-5 times the largest
gradient element: a score near 75 carries an fp32 rounding error of
about 1e-5 (its ulp is 7.6e-6), which the softmax passes on as a relative
error of each probability, and each gradient element is a sum of such
probabilities times rows of the other operand.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from fashionern_aaai2024_tpu.ops import attention as JA
from fashionern_aaai2024_tpu.ops import combiner as JCb
from fashionern_aaai2024_tpu.ops import layernorm as JLN
from fashionern_aaai2024_tpu.ops import losses as JL
from fashionern_aaai2024_tpu.ops import mlp as JM
from fashionern_aaai2024_tpu_torch.ops import attention as TA
from fashionern_aaai2024_tpu_torch.ops import combiner as TCb
from fashionern_aaai2024_tpu_torch.ops import common as TCm
from fashionern_aaai2024_tpu_torch.ops import layernorm as TLN
from fashionern_aaai2024_tpu_torch.ops import losses as TL
from fashionern_aaai2024_tpu_torch.ops import mlp as TM

torch.set_num_threads(2)

DTYPES = {"fp32": (jnp.float32, torch.float32, dict(atol=2e-5, rtol=0.0)),
          "bf16": (jnp.bfloat16, torch.bfloat16, dict(atol=2e-2, rtol=2e-2))}


def _pair(a: np.ndarray, dtype: str):
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.tensor(a).to(td)


def _close(jax_out, torch_out, dtype: str):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out, np.float32), **DTYPES[dtype][2])


# the card kernels' ragged edges: rows and keys one short of, at, and one
# past a 16-row / 16-key tile of the bf16 tensor-core tiles, and the ViT's
# 197 (the plain versions the card holds its kernels to, held here to the
# interpret-mode Pallas kernels)
EDGE_LENGTHS = [1, 15, 16, 17, 63, 65, 197]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", sorted({17, 33, *EDGE_LENGTHS}))
def test_packed_qkv_attention_matches_pallas(dtype, causal, s):
    g = np.random.default_rng(7)
    jq, tq = _pair(g.standard_normal((2, s, 3 * 128)).astype(np.float32), dtype)
    want = JA.packed_qkv_self_attention(jq, 2, causal=causal, force_pallas=True,
                                        interpret=True)
    _close(want, TA.packed_qkv_self_attention(tq, 2, causal=causal), dtype)


def _subblock_inputs(s, w=128, seed=13):
    g = np.random.default_rng(seed)
    f = np.float32
    return (g.standard_normal((2, s, w)).astype(f),
            (1 + 0.1 * g.standard_normal(w)).astype(f), (0.1 * g.standard_normal(w)).astype(f),
            (0.05 * g.standard_normal((w, 3 * w))).astype(f),
            (0.05 * g.standard_normal(3 * w)).astype(f),
            (0.05 * g.standard_normal((w, w))).astype(f), (0.05 * g.standard_normal(w)).astype(f))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [17, 33])
def test_attention_subblock_matches_pallas(dtype, causal, s):
    x, g_, b_, wqkv, bqkv, wo, bo = _subblock_inputs(s)
    jargs, targs = zip(*(_pair(a, dtype) for a in (x, g_, b_, wqkv, bqkv, wo, bo)))
    want = JA.attention_subblock(*jargs, 2, causal=causal, force_pallas=True, interpret=True)
    tx, tg, tb, twqkv, tbqkv, two, tbo = targs
    # the port takes torch-layout weights: [out, in]
    got = TA.attention_subblock(tx, tg, tb, twqkv.t().contiguous(), tbqkv,
                                two.t().contiguous(), tbo, 2, causal=causal)
    _close(want, got, dtype)


def _mlp_inputs(s, w=128, f=512, seed=7):
    g = np.random.default_rng(seed)
    t = np.float32
    return (g.standard_normal((2, s, w)).astype(t),
            (1 + 0.1 * g.standard_normal(w)).astype(t), (0.1 * g.standard_normal(w)).astype(t),
            (0.05 * g.standard_normal((w, f))).astype(t), (0.05 * g.standard_normal(f)).astype(t),
            (0.05 * g.standard_normal((f, w))).astype(t), (0.05 * g.standard_normal(w)).astype(t))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("activation", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("s", [17, 33])
def test_mlp_subblock_matches_jax(dtype, activation, s):
    arrays = _mlp_inputs(s)
    jargs, targs = zip(*(_pair(a, dtype) for a in arrays))
    if activation == "quick_gelu":
        want = JM.mlp_subblock(*jargs, activation=activation, force_pallas=True,
                               interpret=True)
    else:
        want = JM._mlp_ref(*jargs, activation, 1e-5)
    tx, tg, tb, twfc, tbfc, twp, tbp = targs
    got = TM.mlp_subblock(tx, tg, tb, twfc.t().contiguous(), tbfc, twp.t().contiguous(),
                          tbp, activation=activation)
    _close(want, got, dtype)


@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_matches_mha_ref(causal):
    g = np.random.default_rng(3)
    q, k, v = (g.standard_normal((2, 3, 19, 16)).astype(np.float32) for _ in range(3))
    bias = (JA._NEG_INF * np.triu(np.ones((19, 19), np.float32), 1)) if causal else None
    want = JA._mha_ref(*(jnp.asarray(a) for a in (q, k, v)),
                       None if bias is None else jnp.asarray(bias)[None, None], 16 ** -0.5)
    got = TA.multi_head_attention(*(torch.tensor(a) for a in (q, k, v)), causal=causal)
    _close(want, got, "fp32")


def test_packed_kv_cross_attention_matches_jax():
    g = np.random.default_rng(4)
    q = g.standard_normal((3, 77, 64)).astype(np.float32)
    kv = g.standard_normal((3, 13, 128)).astype(np.float32)
    want = JA.packed_kv_cross_attention(jnp.asarray(q), jnp.asarray(kv), 8)
    _close(want, TA.packed_kv_cross_attention(torch.tensor(q), torch.tensor(kv), 8), "fp32")


def test_fused_qkv_self_attention_matches_jax():
    g = np.random.default_rng(5)
    x = g.standard_normal((2, 21, 64)).astype(np.float32)
    w = (0.1 * g.standard_normal((64, 192))).astype(np.float32)
    b = (0.1 * g.standard_normal(192)).astype(np.float32)
    want = JA.fused_qkv_self_attention(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 8)
    got = TA.fused_qkv_self_attention(torch.tensor(x), torch.tensor(w).t().contiguous(),
                                      torch.tensor(b), 8)
    _close(want, got, "fp32")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_layer_norm_matches_jax(dtype):
    from fashionern_aaai2024_tpu.ops.layernorm import layer_norm

    g = np.random.default_rng(6)
    x = (3 + g.standard_normal((4, 5, 96))).astype(np.float32)
    w = (1 + 0.1 * g.standard_normal(96)).astype(np.float32)
    b = (0.1 * g.standard_normal(96)).astype(np.float32)
    (jx, tx), (jw, tw), (jb, tb) = (_pair(a, dtype) for a in (x, w, b))
    _close(layer_norm(jx, jw, jb, 1e-12), TLN.layer_norm(tx, tw, tb, 1e-12), dtype)


# --- B7, B8 and B11 against the interpret-mode Pallas kernels ------------


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("dh", [64, 80])
@pytest.mark.parametrize("sq,sk", [(1, 10), (5, 13), (1, 82), (15, 17), (16, 16), (17, 63),
                                   (63, 65), (65, 1), (197, 13)])
def test_packed_kv_cross_attention_matches_pallas(dtype, dh, sq, sk):
    g = np.random.default_rng(20 + dh + sq)
    w = 2 * dh
    (jq, tq), (jkv, tkv) = (_pair(g.standard_normal(shape).astype(np.float32), dtype)
                            for shape in ((3, sq, w), (3, sk, 2 * w)))
    want = JA._packed_cross_pallas(jq, jkv, jnp.zeros((sq, sk), jnp.float32), dh ** -0.5, 1,
                                   2, interpret=True)
    _close(want, TA.packed_kv_cross_attention(tq, tkv, 2), dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("dh", [64, 80])
@pytest.mark.parametrize("s", [11, 91])
def test_fused_qkv_self_attention_matches_pallas(dtype, dh, s):
    g = np.random.default_rng(30 + dh + s)
    w = 2 * dh
    f = np.float32
    arrays = (g.standard_normal((2, s, w)).astype(f),
              (0.05 * g.standard_normal((w, 3 * w))).astype(f),
              (0.05 * g.standard_normal(3 * w)).astype(f))
    (jx, tx), (jw, tw), (jb, tb) = (_pair(a, dtype) for a in arrays)
    want = JA._qkv_fused_pallas(jx, jw, jb, jnp.zeros((s, s), jnp.float32), dh ** -0.5, 2,
                                interpret=True)
    # the port takes the torch layout: [3W, W]
    _close(want, TA.fused_qkv_self_attention(tx, tw.t().contiguous(), tb, 2), dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("eps", [1e-5, 1e-12])
@pytest.mark.parametrize("w", [128, 640])
def test_layer_norm_matches_pallas(dtype, eps, w):
    g = np.random.default_rng(40 + w)
    f = np.float32
    arrays = ((2 + g.standard_normal((3, 13, w))).astype(f),       # 39 rows: ragged
              (1 + 0.1 * g.standard_normal(w)).astype(f), (0.1 * g.standard_normal(w)).astype(f))
    (jx, tx), (jw, tw), (jb, tb) = (_pair(a, dtype) for a in arrays)
    want = JLN._layer_norm_pallas(jx, jw, jb, eps, interpret=True)
    _close(want, TLN.layer_norm(tx, tw, tb, eps), dtype)


def test_bf16_cross_attention_follows_the_kernel_not_the_xla_formula():
    """ROADMAP C6: in bf16 the port's B8 (and B7) keeps the Pallas
    kernels' fp32 scores, where JAX's dispatch default, `_packed_cross_ref`
    through `_mha_ref`, rounds the scores to bf16; at the attention pool's
    shape (Sq = 1, Sk = 82) the two differ by more than the bf16
    tolerance while the port matches the kernel. In fp32 all three agree."""
    g = np.random.default_rng(50)
    q = (2 * g.standard_normal((2, 1, 128))).astype(np.float32)
    kv = (2 * g.standard_normal((2, 82, 256))).astype(np.float32)
    diffs = {}
    for dtype in ("fp32", "bf16"):
        (jq, tq), (jkv, tkv) = _pair(q, dtype), _pair(kv, dtype)
        kernel = np.asarray(JA._packed_cross_pallas(
            jq, jkv, jnp.zeros((1, 82), jnp.float32), 64 ** -0.5, 1, 2, interpret=True),
            np.float32)
        xla = np.asarray(JA.packed_kv_cross_attention(jq, jkv, 2), np.float32)
        port = TA.packed_kv_cross_attention(tq, tkv, 2).float().numpy()
        diffs[dtype] = (np.abs(port - kernel).max(), np.abs(port - xla).max())
    assert max(diffs["fp32"]) <= 2e-5
    to_kernel, to_xla = diffs["bf16"]
    assert to_xla > 2e-2
    assert to_kernel <= to_xla / 10


def test_layer_norm_function_backward_is_the_plain_gradient(monkeypatch):
    """B11's autograd Function (the CUDA path) differentiates the plain
    version. Run here with the kernel launch replaced by the plain
    formula: its gradients equal plain autograd's, for x, weight and bias
    and for x alone."""
    monkeypatch.setattr(TCm, "launch_layer_norm", TLN.layer_norm_plain)
    g = np.random.default_rng(51)
    x0 = torch.tensor(g.standard_normal((4, 7, 24)), dtype=torch.float32)
    w0 = torch.tensor(1 + 0.1 * g.standard_normal(24), dtype=torch.float32)
    b0 = torch.tensor(0.1 * g.standard_normal(24), dtype=torch.float32)
    up = torch.tensor(g.standard_normal((4, 7, 24)), dtype=torch.float32)
    for needs in ((True, True, True), (True, False, False)):
        ours = [t.clone().requires_grad_(n) for t, n in zip((x0, w0, b0), needs)]
        plain = [t.clone().requires_grad_(n) for t, n in zip((x0, w0, b0), needs)]
        (TLN.LayerNormFunction.apply(*ours, 1e-12) * up).sum().backward()
        (TLN.layer_norm_plain(*plain, 1e-12) * up).sum().backward()
        for a, b in zip(ours, plain):
            if b.grad is None:
                assert a.grad is None
            else:
                torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_versions_of_b7_b8_b11():
    g = np.random.default_rng(52)
    x = torch.tensor(g.standard_normal((2, 9, 160)), dtype=torch.float32)
    w = torch.tensor(0.05 * g.standard_normal((480, 160)), dtype=torch.float32)
    b = torch.zeros(480)
    before = (TA.fused_qkv_self_attention.launches, TA.packed_kv_cross_attention.launches,
              TLN.layer_norm.launches)
    torch.testing.assert_close(TA.fused_qkv_self_attention(x, w, b, 2),
                               TA.fused_qkv_self_attention_plain(x, w, b, 2), rtol=0, atol=0)
    kv = torch.cat([x, x], dim=-1)
    torch.testing.assert_close(TA.packed_kv_cross_attention(x[:, :1].contiguous(), kv, 2),
                               TA.packed_kv_cross_attention_plain(x[:, :1], kv, 2),
                               rtol=0, atol=0)
    torch.testing.assert_close(TLN.layer_norm(x, w[0], b[:160], 1e-5),
                               TLN.layer_norm_plain(x, w[0], b[:160], 1e-5), rtol=0, atol=0)
    assert (TA.fused_qkv_self_attention.launches, TA.packed_kv_cross_attention.launches,
            TLN.layer_norm.launches) == before
    assert TCm.LIBRARY._lib is None


def test_cpu_tensors_take_the_plain_version():
    """The dispatch rule: a CPU tensor never touches the kernel library,
    so its launch counters stay where they were."""
    x, g_, b_, wqkv, bqkv, wo, bo = (torch.tensor(a) for a in _subblock_inputs(17))
    before = (TA.attention_subblock.launches, TA.packed_qkv_self_attention.launches)
    out = TA.attention_subblock(x, g_, b_, wqkv.t().contiguous(), bqkv, wo, bo, 2)
    torch.testing.assert_close(out, TA.attention_subblock_plain(
        x, g_, b_, wqkv.t().contiguous(), bqkv, wo, bo, 2), rtol=0, atol=0)
    assert (TA.attention_subblock.launches, TA.packed_qkv_self_attention.launches) == before
    assert TCm.LIBRARY._lib is None


def test_unsupported_device_raises():
    with pytest.raises(ValueError, match="meta"):
        TA.packed_qkv_self_attention(torch.zeros((1, 4, 384), device="meta"), 2)


def test_kernel_library_hash_tracks_sources(tmp_path):
    """The build key changes with any source byte, so a stale library is
    never loaded for edited sources."""
    import shutil

    src = tmp_path / "csrc"
    shutil.copytree(TCm.CSRC_DIR, src)
    lib = TCm.KernelLibrary(csrc_dir=src, build_root=tmp_path / "build")
    before = lib.library_path()
    assert before.parent.parent == tmp_path / "build"
    assert lib.source_hash() == TCm.KernelLibrary().source_hash()
    (src / "attention.cu").write_text((src / "attention.cu").read_text() + "\n// edit\n")
    assert lib.library_path() != before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launch_gemm_refuses_what_tma_cannot_take(dtype):
    """`launch_gemm` checks its operands before any launch: a view that
    starts off a 16-byte boundary (TMA's rule for a base address) raises,
    as do K or N off a multiple of 8 (16-byte row strides); an aligned
    operand passes the checks (and only then reaches the library)."""
    a = torch.zeros(77 * 512 + 8, dtype=dtype)
    w = torch.zeros(640 * 512 + 8, dtype=dtype)
    good_a, good_w = a[:77 * 512].view(77, 512), w[:640 * 512].view(640, 512)
    assert good_a.data_ptr() % 16 == 0 and good_w.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="a \\(77, 512\\) starts at an address"):
        TCm.launch_gemm(a[2:77 * 512 + 2].view(77, 512), good_w, None)
    with pytest.raises(ValueError, match="weight \\(640, 512\\) starts at an address"):
        TCm.launch_gemm(good_a, w[1:640 * 512 + 1].view(640, 512), None)
    with pytest.raises(ValueError, match="multiples of 8"):
        TCm.launch_gemm(a[:77 * 500].view(77, 500), w[:640 * 500].view(640, 500), None)
    with pytest.raises(ValueError, match="multiples of 8"):
        TCm.launch_gemm(good_a, torch.zeros((644, 512), dtype=dtype), None)


# --- B4: the BBC row loss ------------------------------------------------

ROW_TOL = dict(atol=5e-4, rtol=1e-5)
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 5e-5


def _grad_close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_OF_MAX * np.abs(want).max())


def _bbc_inputs(b, d, seed=11):
    """Unit rows around one shared direction, as the fusion stack's
    normalized outputs are early in training, each target a little
    closer to its own query: every score is near 75 and the row losses
    are a few units, so neither the diagonal nor one column dominates."""
    g = np.random.default_rng(seed)
    c = g.standard_normal(d)
    n1, n2 = (g.standard_normal((b, d)) / np.sqrt(d) for _ in range(2))
    pred, tar = c / np.linalg.norm(c) + 0.6 * n1, c / np.linalg.norm(c) + 0.6 * n2 + 0.1 * n1
    unit = lambda a: (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)
    return unit(pred), unit(tar)


@pytest.mark.parametrize("d", [24, 512, 640])
@pytest.mark.parametrize("b", [1, 13, 128, 200, 1024])
def test_bbc_rowloss_matches_ref(b, d):
    pred, tar = _bbc_inputs(b, d)
    want = JL._bbc_rowloss_ref(jnp.asarray(pred), jnp.asarray(tar), 100.0)
    got = TL.bbc_rowloss(torch.from_numpy(pred), torch.from_numpy(tar))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROW_TOL)


@pytest.mark.parametrize("b,d", [(1, 24), (13, 24), (128, 512), (200, 640)])
def test_bbc_rowloss_matches_pallas(b, d):
    pred, tar = _bbc_inputs(b, d, seed=12)
    want = JL._bbc_rowloss_pallas(jnp.asarray(pred), jnp.asarray(tar), 100.0, interpret=True)
    got = TL.bbc_rowloss(torch.from_numpy(pred), torch.from_numpy(tar))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROW_TOL)


@pytest.mark.parametrize("b,d", [(1, 24), (13, 24), (32, 512), (200, 640)])
def test_bbc_mean_loss_and_grads_match_custom_vjp(b, d):
    pred, tar = _bbc_inputs(b, d, seed=13)
    want, (jgp, jgt) = jax.value_and_grad(JL._bbc_mean_loss, argnums=(0, 1))(
        jnp.asarray(pred), jnp.asarray(tar), 100.0)
    tp = torch.from_numpy(pred).requires_grad_()
    tt = torch.from_numpy(tar).requires_grad_()
    loss = TL.batch_based_classification_loss(tp, tt)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), **ROW_TOL)
    _grad_close(tp.grad, jgp)
    _grad_close(tt.grad, jgt)


def test_bbc_global_negatives():
    """One device: "global" negatives are the local ones, as in a
    one-device JAX run, with no mesh or on a one-process mesh (the
    process-group case: tests/test_torch_parallel.py)."""
    from fashionern_aaai2024_tpu_torch.parallel.mesh import create_mesh

    pred, tar = (torch.from_numpy(a) for a in _bbc_inputs(16, 24))
    local = TL.batch_based_classification_loss(pred, tar)
    assert TL.batch_based_classification_loss(pred, tar, negatives="global") == local
    assert TL.batch_based_classification_loss(pred, tar, negatives="global",
                                              mesh=create_mesh(device="cpu")) == local
    with pytest.raises(ValueError):
        TL.batch_based_classification_loss(pred, tar, negatives="nope")


@pytest.mark.parametrize("b", [1, 13, 64, 65, 1000, 1024, 4096])
@pytest.mark.parametrize("sms", [1, 132])
def test_bbc_split_plan_covers_every_tile(b, sms):
    """The kernel's C entry point refuses a plan where a split owns no
    64-wide column tile; every plan the wrapper makes passes that check,
    and its grid of 128-row tiles x splits holds no more blocks than the
    SMs (one block an SM) unless the row tiles alone exceed them."""
    splits, per_split = TL.split_plan(b, sms)
    tiles, rows = -(-b // 64), -(-b // 128)
    assert splits == -(-tiles // per_split)
    assert (splits - 1) * per_split < tiles <= splits * per_split
    assert rows * splits <= max(sms, rows)


def _bbc_rowloss_tf32(pred: torch.Tensor, tar: torch.Tensor, passes: int) -> torch.Tensor:
    """B4's arithmetic on the card, emulated: the scores p_i . t_j from
    tf32 operands (one pass, or the 3xTF32 split of `csrc/gemm_tf32.cuh`),
    times the temperature, then the row's log-sum-exp minus its diagonal
    in fp32."""
    s = TL.TEMPERATURE * _linear_tf32(pred, tar, 0.0, passes)
    return torch.logsumexp(s, dim=-1) - torch.diagonal(s)


@pytest.mark.parametrize("b,d", [(128, 512), (200, 640)])
def test_bbc_rowloss_3xtf32_meets_the_row_tolerance(b, d):
    """3xTF32 scores hold JAX's `_bbc_rowloss_ref` and the interpret-mode
    `_bbc_rowloss_pallas` at ROW_TOL, while one tf32 pass does not: the
    temperature of 100 turns tf32's ~1e-3 relative error of a score into
    more than the 5e-4 the row losses allow."""
    pred, tar = _bbc_inputs(b, d, seed=14)
    ref = np.asarray(JL._bbc_rowloss_ref(jnp.asarray(pred), jnp.asarray(tar), 100.0))
    pallas = np.asarray(JL._bbc_rowloss_pallas(jnp.asarray(pred), jnp.asarray(tar), 100.0,
                                               interpret=True))
    tp, tt = torch.from_numpy(pred), torch.from_numpy(tar)
    three = _bbc_rowloss_tf32(tp, tt, passes=3).numpy()
    one = _bbc_rowloss_tf32(tp, tt, passes=1).numpy()
    for want in (ref, pallas):
        np.testing.assert_allclose(three, want, **ROW_TOL)
        assert np.any(np.abs(one - want) > ROW_TOL["atol"] + ROW_TOL["rtol"] * np.abs(want))


def _gemm_inputs(m, k, n, seed):
    """a [m, k] around N(0, 1), weight [k, n] (the JAX layout) and bias at
    std 0.05."""
    g = np.random.default_rng(seed)
    f = np.float32
    return (g.standard_normal((m, k)).astype(f), (0.05 * g.standard_normal((k, n))).astype(f),
            (0.05 * g.standard_normal(n)).astype(f))


@pytest.mark.parametrize("d,dh", [(512, 64), (640, 80)])
def test_fused_qkv_3xtf32_projection_meets_the_fp32_tolerance(d, dh):
    """B7 at the DVR BERT's widths (d = 512 / 640, 8 heads of 64 / 80, 91
    tokens): the QKV projection emulated as the fp32 GEMM runs it on the
    card (3xTF32), then the plain attention core, holds the interpret-mode
    `_qkv_fused_pallas` at the fp32 tolerance; one tf32 pass does not."""
    s, heads = 91, d // dh
    x, w, b = _gemm_inputs(2 * s, d, 3 * d, seed=d)
    want = np.asarray(JA._qkv_fused_pallas(jnp.asarray(x.reshape(2, s, d)), jnp.asarray(w),
                                           jnp.asarray(b), jnp.zeros((s, s), jnp.float32),
                                           dh ** -0.5, heads, interpret=True))
    got = {}
    for passes in (3, 1):
        qkv = _linear_tf32(torch.from_numpy(x), torch.from_numpy(w).t().contiguous(),
                           torch.from_numpy(b), passes)
        got[passes] = TA.packed_qkv_self_attention_plain(qkv.view(2, s, 3 * d), heads).numpy()
    np.testing.assert_allclose(got[3], want, atol=2e-5, rtol=0)
    assert np.abs(got[1] - want).max() > 2e-5


# The fp32 attention kernels' arithmetic (csrc/attention_tf32.cuh): 8-key
# tiles of `mma.sync.m16n8k8` tf32, whose k index t is dim 2t (S) or key
# 2t (P . V, the key permutation) of the step and t + 4 is dim / key
# 2t + 1. A lane (g, t) of the S accumulator holds keys 2t, 2t + 1 of rows
# g and g + 8.
_TF32_PERM = [0, 2, 4, 6, 1, 3, 5, 7]  # k' -> key (or dim) of a step


def _pv_fragments(p_tile: np.ndarray, v_tile: np.ndarray):
    """A [16, 8] and B [8, n] of one P . V mma as the kernel's lanes load
    them: A from the S accumulator registers (c0, c2, c1, c3), B from the
    staged V rows 2t and 2t + 1 at column g of each 8-column step."""
    a = np.zeros((16, 8), p_tile.dtype)
    b = np.zeros((8, v_tile.shape[1]), v_tile.dtype)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        c = (p_tile[g, 2 * t], p_tile[g, 2 * t + 1], p_tile[g + 8, 2 * t],
             p_tile[g + 8, 2 * t + 1])
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = c[0], c[2], c[1], c[3]
        for n0 in range(0, v_tile.shape[1], 8):
            b[t, n0 + g], b[t + 4, n0 + g] = v_tile[2 * t, n0 + g], v_tile[2 * t + 1, n0 + g]
    return a, b


def test_tf32_key_permutation_feeds_p_from_the_accumulators():
    """The P . V operands rebuilt lane by lane from the S accumulator and
    the staged V rows multiply to P . V of the tile (and are P and V with
    the keys permuted), and the S operands' dim mapping gives Q K^T."""
    g = np.random.default_rng(5)
    p, v = g.standard_normal((16, 8)), g.standard_normal((8, 80))
    a, b = _pv_fragments(p, v)
    np.testing.assert_array_equal(a, p[:, _TF32_PERM])
    np.testing.assert_array_equal(b, v[_TF32_PERM])
    np.testing.assert_allclose(a @ b, p @ v, rtol=1e-12, atol=1e-12)
    q, k = g.standard_normal((16, 8)), g.standard_normal((8, 8))
    qa, kb = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        gg, t = lane // 4, lane % 4
        # a0 / a2: row g at dims 2t / 2t + 1 (one 8-byte load); b0 / b1: key g
        qa[gg, t], qa[gg + 8, t], qa[gg, t + 4], qa[gg + 8, t + 4] = (
            q[gg, 2 * t], q[gg + 8, 2 * t], q[gg, 2 * t + 1], q[gg + 8, 2 * t + 1])
        kb[t, gg], kb[t + 4, gg] = k[gg, 2 * t], k[gg, 2 * t + 1]
    np.testing.assert_allclose(qa @ kb, q @ k.T, rtol=1e-12, atol=1e-12)


def _mma_rz(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One tf32 mma as the tensor cores add: the products of tf32 values
    exact, their sum with the fp32 accumulator truncated toward zero (the
    cores do not round their accumulation to nearest)."""
    x = acc.double() + a.double() @ b.double()
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _mma3_rz(a: torch.Tensor, b: torch.Tensor, passes: int,
             acc: torch.Tensor | None = None) -> torch.Tensor:
    """a . b in tf32 added to `acc` (a fresh partial when None): the
    3xTF32 lo.hi + hi.lo + hi.hi (small terms first) or one hi.hi pass,
    each pass one truncating mma."""
    ah, bh = _tf32(a), _tf32(b)
    part = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32) if acc is None else acc
    if passes == 3:
        part = _mma_rz(part, _tf32(a - ah), bh)
        part = _mma_rz(part, ah, _tf32(b - bh))
    return _mma_rz(part, ah, bh)


def _scores_tf32(q, k, passes: int, fold: bool = True) -> torch.Tensor:
    """Unscaled Q K^T of q [N, Sq, D] against k [N, Sk, D] over D / 8
    k-steps (dims of a step in the mma's k order), each step's 3xTF32 (or
    one-pass) partial folded into the fp32 scores (round to nearest);
    `fold` False: one truncating accumulator instead."""
    s = torch.zeros((q.shape[0], q.shape[1], k.shape[1]))
    for kk in range(0, q.shape[-1], 8):
        dims = [kk + i for i in _TF32_PERM]
        part = _mma3_rz(q[..., dims], k[..., dims].transpose(1, 2), passes, None if fold else s)
        s = s + part if fold else part
    return s


def _attention_tf32(q, k, v, bias, scale: float, passes: int, fold: bool = True) -> torch.Tensor:
    """The fp32 attention core's arithmetic on [N, S, D] fp32 operands:
    S as `_scores_tf32`; the scale and the bias rounded on their own; the softmax in fp32, p / denom; P . V
    over 8-key tiles with the keys permuted (`_pv_fragments`), each tile's
    partial folded into the fp32 output. Keys are zero-padded to a whole
    tile, with p = 0 there. `fold` False: every mma adds into one truncating
    accumulator instead (the design the folds replace)."""
    n, sq, d = q.shape
    sk = k.shape[1]
    skp = -(-sk // 8) * 8
    kp = torch.zeros((n, skp, d)).index_copy_(1, torch.arange(sk), k)
    vp = torch.zeros((n, skp, d)).index_copy_(1, torch.arange(sk), v)
    s = _scores_tf32(q, kp, passes, fold)[..., :sk] * scale
    if bias is not None:
        s = s + bias
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.zeros((n, sq, skp)).index_copy_(2, torch.arange(sk), e / e.sum(-1, keepdim=True))
    o = torch.zeros((n, sq, d))
    for j0 in range(0, skp, 8):
        keys = [j0 + i for i in _TF32_PERM]
        part = _mma3_rz(p[..., keys], vp[:, keys], passes, None if fold else o)
        o = o + part if fold else part
    return o


def _attention_tf32_chunked(q, k, v, bias, scale: float, passes: int,
                            chunk: int = 32) -> torch.Tensor:
    """The grouped kernel's fp32 arithmetic on [N, S, D] fp32 operands:
    two passes over `chunk`-key chunks (keys zero-padded to whole chunks,
    masked to -inf past Sk). Pass 1 keeps each row's running max and a
    rescaled sum: per chunk, the new max n = max(m, the chunk's max), the
    sum times exp(m - n) (0 while m is -inf), plus exp(x - n) over the
    chunk's finite scores. Pass 2 recomputes the scores, forms p =
    exp(s - m) / l in fp32 and runs P . V over 8-key tiles with the keys
    permuted, each tile's partial folded into the fp32 output. S, the
    scale and the bias as `_attention_tf32`."""
    n, sq, d = q.shape
    sk = k.shape[1]
    skp = -(-sk // chunk) * chunk
    kp = torch.zeros((n, skp, d)).index_copy_(1, torch.arange(sk), k)
    vp = torch.zeros((n, skp, d)).index_copy_(1, torch.arange(sk), v)

    def chunk_scores(j0):
        x = _scores_tf32(q, kp[:, j0:j0 + chunk], passes) * scale
        if bias is not None:
            x[..., :min(chunk, sk - j0)] += bias[:, j0:j0 + chunk]
        x[..., max(0, sk - j0):] = float("-inf")
        return x

    m = torch.full((n, sq, 1), float("-inf"))
    l = torch.zeros((n, sq, 1))
    for j0 in range(0, skp, chunk):
        x = chunk_scores(j0)
        new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        l = torch.where(m == float("-inf"), 0.0, l * torch.exp(m - new))
        l = l + torch.where(x == float("-inf"), 0.0, torch.exp(x - new)).sum(-1, keepdim=True)
        m = new
    o = torch.zeros((n, sq, d))
    for j0 in range(0, skp, chunk):
        p = torch.exp(chunk_scores(j0) - m) / l
        for t0 in range(0, chunk, 8):
            keys = [t0 + i for i in _TF32_PERM]
            o = o + _mma3_rz(p[..., keys], vp[:, [j0 + i for i in keys]], passes)
    return o


def _heads_tf32(q, k, v, heads: int, bias, passes: int) -> torch.Tensor:
    """`_attention_tf32` over the heads of q [B, Sq, W], k, v [B, Sk, W]
    -> [B, Sq, W]."""
    b, sq, w = q.shape
    dh = w // heads
    split = lambda t: t.reshape(b, t.shape[1], heads, dh).transpose(1, 2).reshape(  # noqa: E731
        b * heads, t.shape[1], dh)
    o = _attention_tf32(split(q), split(k), split(v), bias, dh ** -0.5, passes)
    return o.reshape(b, heads, sq, dh).transpose(1, 2).reshape(b, sq, w)


def _tf32_attention_case(case: str, passes_list=(3, 1)):
    """(JAX output, {passes: the emulation's output}) of one fp32 case."""
    g = np.random.default_rng(sum(map(ord, case)))
    f = np.float32
    got = {}
    if case in ("bert512", "bert640"):  # B7: the DVR BERT, 91 rows
        d, heads = int(case[4:]), 8
        x, w, bias = _gemm_inputs(2 * 91, d, 3 * d, seed=d + 1)
        want = JA._qkv_fused_pallas(jnp.asarray(x.reshape(2, 91, d)), jnp.asarray(w),
                                    jnp.asarray(bias), jnp.zeros((91, 91), jnp.float32),
                                    (d // heads) ** -0.5, heads, interpret=True)
        qkv = _linear_tf32(torch.from_numpy(x), torch.from_numpy(w).t().contiguous(),
                           torch.from_numpy(bias), 3).view(2, 91, 3 * d)
        for passes in passes_list:
            got[passes] = _heads_tf32(*qkv.split(d, dim=-1), heads, None, passes)
    elif case in ("mr512", "mr640"):  # B8: the MR cross-attention, 77 x 13 keys
        d, heads = int(case[2:]), 8
        q, kv = (g.standard_normal(shape).astype(f) for shape in ((2, 77, d), (2, 13, 2 * d)))
        want = JA._packed_cross_pallas(jnp.asarray(q), jnp.asarray(kv),
                                       jnp.zeros((77, 13), jnp.float32), (d // heads) ** -0.5,
                                       1, heads, interpret=True)
        tq, tkv = torch.from_numpy(q), torch.from_numpy(kv)
        for passes in passes_list:
            got[passes] = _heads_tf32(tq, *tkv.split(d, dim=-1), heads, None, passes)
    elif case == "text_causal":  # B3: the text tower's causal rows
        qkv = g.standard_normal((2, 77, 3 * 512)).astype(f)
        want = JA.packed_qkv_self_attention(jnp.asarray(qkv), 8, causal=True,
                                            force_pallas=True, interpret=True)
        mask = TA.causal_bias(77, "cpu")
        for passes in passes_list:
            got[passes] = _heads_tf32(*torch.from_numpy(qkv).split(512, dim=-1), 8, mask, passes)
    else:  # B9: TME's [2, 8, 77, 64] x 13 keys with a bias; 300 keys at D = 128, std 2
        sk, dh, std = (13, 64, 1.0) if case == "tme" else (300, 128, 2.0)
        g = np.random.default_rng(sum(map(ord, case.removesuffix("_one_pass"))))
        q, k, v = ((std * g.standard_normal((2, 8, s, dh))).astype(f) for s in (77, sk, sk))
        bias = (2 * g.standard_normal((77, sk))).astype(f)
        want = JA.multi_head_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                       bias=jnp.asarray(bias), force_pallas=True,
                                       interpret=True)
        tq, tk, tv = (torch.from_numpy(a).reshape(16, -1, dh) for a in (q, k, v))
        # past 256 keys B9 runs on the grouped kernel: its two chunked
        # passes (the `_one_pass` control: the core's one-pass softmax)
        emulate = (_attention_tf32 if sk <= 256 or case.endswith("_one_pass")
                   else _attention_tf32_chunked)
        for passes in passes_list:
            got[passes] = emulate(tq, tk, tv, torch.from_numpy(bias), dh ** -0.5,
                                  passes).reshape(2, 8, 77, dh)
    return np.asarray(want), {p_: t.numpy() for p_, t in got.items()}


TF32_ATTENTION_CASES = ["bert512", "bert640", "mr512", "mr640", "tme", "text_causal",
                        "d128_sk300", "d128_sk300_one_pass"]


@pytest.mark.parametrize("case", TF32_ATTENTION_CASES)
def test_attention_3xtf32_meets_the_fp32_tolerance(case):
    """The fp32 attention core and grouped kernel as they run on the card
    (3xTF32 `mma.sync` tiles, truncating accumulation with every k-step's
    and key tile's partial folded in, the key permutation), emulated here,
    hold the interpret-mode Pallas kernels at the fp32 tolerance (atol
    2e-5): B7 at the DVR BERT (bert512 / bert640, 91 rows), B8 at the MR
    cross-attention, B9 at TME's shape with a bias, B3 over causal text
    rows, B9 (the grouped kernel: two passes over 32-key chunks, an online
    max and a rescaled sum) over 300 keys at head dim 128 with std-2
    operands, and the same inputs through the core's one-pass softmax.
    One tf32 pass is the control: the same arithmetic with it misses the
    tolerance, so the check tells the two apart."""
    want, got = _tf32_attention_case(case)
    np.testing.assert_allclose(got[3], want, atol=2e-5, rtol=0)
    assert np.abs(got[1] - want).max() > 2e-5


def test_attention_tf32_folds_hold_against_truncating_accumulation():
    """Why the fp32 attention kernels fold every k-step's and key tile's
    partial into the fp32 sum on the CUDA cores: at X1's worst shape (one
    pair of 208 rows against 256 keys at D = 128, std-2 operands), the
    3xTF32 arithmetic with one truncating accumulator a product drifts
    past the fp32 tolerance from the float64 result, and with the folds it
    stays within half of it."""
    g = np.random.default_rng(128)
    q, k, v = (torch.from_numpy((2 * g.standard_normal((1, s, 128))).astype(np.float32))
               for s in (208, 256, 256))
    scores = q.double() @ k.double().transpose(1, 2) * 128 ** -0.5
    want = torch.softmax(scores, dim=-1) @ v.double()
    err = {fold: (_attention_tf32(q, k, v, None, 128 ** -0.5, 3, fold).double() - want)
           .abs().max().item() for fold in (True, False)}
    assert err[True] < 1e-5 and err[False] > 2e-5, err


def test_attention_tf32_beats_plain_fp32_at_large_scores():
    """At std-2 operands over head dim 128 and 300 keys with an std-2 bias
    (scores up to ~20), the plain version's own fp32 rounding moves its
    outputs most of the fp32 tolerance from the float64 function, while
    the kernels' 3xTF32 arithmetic stays closer to it: there the card
    test holds the kernel to the float64 function
    (`tests/test_torch_cuda.py test_grouped_kernel_fp32_head_dims`)."""
    g = np.random.default_rng(538)
    q, k, v = (torch.from_numpy((2 * g.standard_normal((6, s, 128))).astype(np.float32))
               for s in (77, 300, 300))
    bias = torch.from_numpy((2 * g.standard_normal((77, 300))).astype(np.float32))
    scale = 128 ** -0.5
    want = torch.softmax(q.double() @ k.double().transpose(1, 2) * scale + bias.double(),
                         dim=-1) @ v.double()
    plain = (TA.mha_plain(q, k, v, bias, scale).double() - want).abs().max().item()
    tf32 = (_attention_tf32(q, k, v, bias, scale, 3).double() - want).abs().max().item()
    assert tf32 < 1e-5 < plain and tf32 < plain, (tf32, plain)


@pytest.mark.parametrize("w,heads", [(512, 8), (768, 12)])
def test_subblocks_3xtf32_products_meet_the_fp32_tolerance(w, heads):
    """B1 and B2 at the towers' real widths (W = 512 / 768, hidden 2,048 /
    3,072; c_proj's K = 3,072 is the deepest fp32 product), 5 tokens: the
    four products emulated as the fp32 GEMM runs them (3xTF32), with the
    plain LN, attention core and quick_gelu between them, hold the
    interpret-mode Pallas sub-blocks at the fp32 tolerance; one tf32 pass
    does not."""
    s, f = 5, 4 * w
    attn = _subblock_inputs(s, w=w, seed=w)
    mlp = _mlp_inputs(s, w=w, f=f, seed=w + 1)
    jattn = JA.attention_subblock(*(jnp.asarray(a) for a in attn), heads, causal=True,
                                  force_pallas=True, interpret=True)
    jmlp = JM.mlp_subblock(*(jnp.asarray(a) for a in mlp), activation="quick_gelu",
                           force_pallas=True, interpret=True)
    for passes, holds in ((3, True), (1, False)):
        x, g_, b_, wqkv, bqkv, wo, bo = (torch.from_numpy(a) for a in attn)
        lin = lambda v, wt, bias: _linear_tf32(v, wt.t().contiguous(), bias, passes)  # noqa: E731
        x2 = x.view(-1, w)
        qkv = lin(TLN.layer_norm_plain(x2, g_, b_, 1e-5), wqkv, bqkv)
        o = TA.packed_qkv_self_attention_plain(qkv.view(2, s, 3 * w), heads, causal=True)
        got_attn = (x2 + lin(o.view(-1, w), wo, bo)).view(2, s, w).numpy()
        x, g_, b_, wfc, bfc, wp, bp = (torch.from_numpy(a) for a in mlp)
        x2 = x.view(-1, w)
        h = TM.act_f32(lin(TLN.layer_norm_plain(x2, g_, b_, 1e-5), wfc, bfc), "quick_gelu")
        got_mlp = (x2 + lin(h, wp, bp)).view(2, s, w).numpy()
        for got, want in ((got_attn, jattn), (got_mlp, jmlp)):
            err = np.abs(got - np.asarray(want)).max()
            assert (err <= 2e-5) == holds, (passes, err)


def test_plain_path_keeps_autograd():
    """On the CPU every wrapper takes its plain version, which autograd
    differentiates; the no-grad guard applies to CUDA launches only."""
    x, g_, b_, wqkv, bqkv, wo, bo = (torch.tensor(a) for a in _subblock_inputs(17))
    x.requires_grad_()
    out = TA.attention_subblock(x, g_, b_, wqkv.t().contiguous(), bqkv, wo, bo, 2)
    assert out.grad_fn is not None
    f = torch.tensor(np.random.default_rng(1).standard_normal((512, 128)) * 0.05,
                     dtype=torch.float32)
    out = TM.mlp_subblock(out, g_, b_, f, torch.zeros(512), f.t().contiguous(),
                          torch.zeros(128))
    qkv = torch.randn(2, 9, 384, requires_grad=True)
    att = TA.packed_qkv_self_attention(qkv, 2)
    (out.sum() + att.sum()).backward()
    assert x.grad is not None and qkv.grad is not None
    assert torch.isfinite(x.grad).all()


def test_no_grad_guard_names_the_operand():
    """The guard itself, which every CUDA wrapper calls before a launch."""
    w = torch.zeros(4, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        TCm.check_no_grad("gemm", torch.zeros(4), w)
    with torch.no_grad():
        TCm.check_no_grad("gemm", torch.zeros(4), w)
    TCm.check_no_grad("gemm", torch.zeros(4), w.detach(), None)


# --- B9: [B, H, S, Dh] attention with a shared bias ----------------------

# (sq, sk, causal, bias): none, causal, an arbitrary bias with Sq != Sk
# (TME's 77 text tokens against 13 patches), and causal + bias, Sq != Sk
MHA_CASES = [(9, 9, False, False), (9, 9, True, False), (77, 13, False, True),
             (13, 9, True, True)]
# the core's tile edges; bias "-inf": -inf on the keys before a row's
# index, 0 from it on and on the last key (left padding)
MHA_EDGE_CASES = [(1, 65, False, "-inf"), (17, 16, False, "-inf"), (63, 63, True, False),
                  (16, 1, False, True), (65, 197, False, "-inf"), (15, 15, True, True)]


def _mha_inputs(b, h, sq, sk, dh, with_bias, seed):
    g = np.random.default_rng(seed)
    f = np.float32
    q, k, v = (g.standard_normal((b, h, s, dh)).astype(f) for s in (sq, sk, sk))
    bias = (2 * g.standard_normal((sq, sk))).astype(f) if with_bias else None
    if with_bias == "-inf":
        keep = np.triu(np.ones((sq, sk), bool))
        keep[:, -1] = True
        bias = np.where(keep, 0.0, -np.inf).astype(f)
    return q, k, v, bias


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("dh", [64, 80])
@pytest.mark.parametrize("sq,sk,causal,with_bias", MHA_CASES + MHA_EDGE_CASES)
def test_mha_plain_matches_pallas(dtype, dh, sq, sk, causal, with_bias):
    q, k, v, bias = _mha_inputs(2, 2, sq, sk, dh, with_bias, seed=60 + sq + dh)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    jb = None if bias is None else jnp.asarray(bias)
    tb = None if bias is None else torch.from_numpy(bias)
    want = JA.multi_head_attention(jq, jk, jv, causal=causal, bias=jb, force_pallas=True,
                                   interpret=True)
    got = TA.multi_head_attention(tq, tk, tv, causal=causal, bias=tb)
    _close(want, got, dtype)
    torch.testing.assert_close(got, TA.mha_plain(
        tq, tk, tv, TA.shared_bias(causal, tb, sq, sk, "cpu")), rtol=0, atol=0)


@pytest.mark.parametrize("sq,sk,causal,with_bias", MHA_CASES)
def test_mha_autograd_matches_jax_vjp(monkeypatch, sq, sk, causal, with_bias):
    """B9's autograd Function (the CUDA path, its launch replaced here by
    the plain version, returning the kernel's strided view) and the CPU
    path's autograd both give `jax.vjp` of `_mha_ref`'s gradients."""
    def plain_launch(q, k, v, bias, scale):
        b, h, s, dh = q.shape
        out = TA.mha_plain(q, k, v, bias, scale)
        return out.transpose(1, 2).contiguous().view(b, s, h, dh).transpose(1, 2)

    monkeypatch.setattr(TA, "_launch_mha", plain_launch)
    q, k, v, bias = _mha_inputs(2, 3, sq, sk, 64, with_bias, seed=70 + sq)
    up = np.random.default_rng(71).standard_normal((2, 3, sq, 64)).astype(np.float32)
    tb = TA.shared_bias(causal, None if bias is None else torch.from_numpy(bias), sq, sk, "cpu")
    # `_mha_pallas_diff_bwd`: zeros where there is no mask
    jbias = jnp.zeros((sq, sk)) if tb is None else jnp.asarray(tb.numpy())
    _, vjp = jax.vjp(lambda q_, k_, v_: JA._mha_ref(q_, k_, v_, jbias[None, None], 64 ** -0.5),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(up))
    for path in ("function", "plain"):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        if path == "function":
            out = TA.MHAFunction.apply(*ts, tb, 64 ** -0.5)
        else:
            out = TA.multi_head_attention(*ts, causal=causal,
                                          bias=None if bias is None else torch.from_numpy(bias))
        (out * torch.from_numpy(up)).sum().backward()
        for t, w in zip(ts, want):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-5 * np.abs(np.asarray(w)).max(), err_msg=path)


def test_mha_function_gives_the_bias_gradient(monkeypatch):
    """B9's autograd Function, its launch replaced by `mha_ref`, returns
    the gradients of q, k, v and an additive [Sq, Sk] bias that requires
    grad (dS summed over the batch and the heads, as `_mha_pallas_diff_bwd`
    gives it), equal to autograd of `mha_plain`; `multi_head_attention`
    takes the Function when only the bias requires grad."""
    monkeypatch.setattr(TA, "_launch_mha", lambda q, k, v, bias, scale: TA.mha_ref(
        q, k, v, bias, scale))
    q, k, v, bias = _mha_inputs(2, 3, 7, 5, 64, True, seed=72)
    # upstream gradient at std 0.1: every gradient element stays below 1,
    # where two fp32 summation orders differ by ~1e-7, inside atol 1e-6
    up = torch.from_numpy(0.1 * np.random.default_rng(73).standard_normal((2, 3, 7, 64)).astype(
        np.float32))
    grads = {}
    for path in ("function", "plain"):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
        fn = TA.MHAFunction.apply if path == "function" else TA.mha_plain
        (fn(*ts, 64 ** -0.5) * up).sum().backward()
        grads[path] = [t.grad for t in ts]
    for got, want in zip(grads["function"], grads["plain"]):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    assert grads["function"][3].abs().max() > 1e-2
    calls = []
    monkeypatch.setattr(TA.MHAFunction, "apply", lambda *a: calls.append(a) or TA.mha_ref(
        *a))
    monkeypatch.setattr(TA.common, "is_cuda", lambda t: True)
    tb = torch.from_numpy(bias).requires_grad_()
    TA.multi_head_attention(*(torch.from_numpy(a) for a in (q, k, v)), bias=tb)
    assert len(calls) == 1 and calls[0][3].requires_grad


def test_mha_core_layouts():
    """The kernel reads [B, H, S, Dh] operands through their strides: a
    head view of [B, S, H*Dh] rows (TME's projections) as (B, H, H*Dh),
    contiguous as (B*H, 1, Dh), a head view of packed [B, S, 2W] kv at
    its row stride; a permuted layout is refused (and copied)."""
    x = torch.zeros(2, 7, 4 * 64)
    rows = x.view(2, 7, 4, 64).transpose(1, 2)
    assert TA._core_layout(rows) == (2, 4, 256)
    assert TA._core_layout(rows.contiguous()) == (8, 1, 64)
    kv = torch.zeros(2, 5, 2 * 256)
    assert TA._core_layout(kv[..., 256:].view(2, 5, 4, 64).transpose(1, 2)) == (2, 4, 512)
    assert TA._core_layout(torch.zeros(2, 64, 7, 4).permute(0, 3, 2, 1)) is None
    one = torch.zeros(3, 1, 1, 80)
    assert TA._core_layout(one) == (3, 1, 80)


# --- B12: the sigma-gated combiner ---------------------------------------


def _combiner_pair(d, dtype, seed):
    from fashionern_aaai2024_tpu.models.ern.fusion import CombinerSimple as JaxCombiner
    from fashionern_aaai2024_tpu_torch.models import convert
    from fashionern_aaai2024_tpu_torch.models.ern.fusion import CombinerSimple

    g = np.random.default_rng(seed)
    img = g.standard_normal((10, d)).astype(np.float32)
    txt = g.standard_normal((10, d)).astype(np.float32)
    jm = JaxCombiner(d)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed), img, txt))
    tm = CombinerSimple(d)
    tm.load_state_dict({k[2:]: t for k, t in convert._combiner(v["params"], "m").items()})
    return jm, v, tm.to(DTYPES[dtype][1]).eval(), img, txt


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("d", [16, 24])
def test_combiner_plain_matches_pallas(dtype, d):
    jm, v, tm, img, txt = _combiner_pair(d, dtype, seed=80 + d)
    jd = DTYPES[dtype][0]
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jd), v["params"])
    (jimg, timg), (jtxt, ttxt) = _pair(img, dtype), _pair(txt, dtype)
    want = JCb.combiner_apply(jimg, jtxt, params, force_pallas=True, interpret=True)
    with torch.no_grad():
        got = TCb.combiner_apply(timg, ttxt, tm)
        _close(want, got, dtype)
        assert got.dtype == timg.dtype
        torch.testing.assert_close(tm(timg, ttxt), got, rtol=0, atol=0)


@pytest.mark.parametrize("d", [16, 24])
def test_combiner_matches_flax_module(d):
    jm, v, tm, img, txt = _combiner_pair(d, "fp32", seed=90 + d)
    want = jm.apply(v, img, txt)
    with torch.no_grad():
        _close(want, TCb.combiner_apply(torch.from_numpy(img), torch.from_numpy(txt), tm),
               "fp32")


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32 by masking, as `cvt.rna.tf32.f32` rounds: to
    nearest, ties away from zero (adding half of the 13 dropped mantissa
    bits to the magnitude, then clearing them)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _linear_tf32(x, w, b, passes: int):
    """x @ w.T + b with tf32 operands: one pass (hi . hi) or the 3xTF32
    split of `csrc/gemm_tf32.cu` (lo . hi + hi . lo + hi . hi, fp32 sums)."""
    xh, wh = _tf32(x), _tf32(w)
    if passes == 1:
        return xh @ wh.T + b
    xl, wl = _tf32(x - xh), _tf32(w - wh)
    return xl @ wh.T + xh @ wl.T + xh @ wh.T + b


def _combiner_tf32(image, text, module, passes: int):
    """`combiner_apply_plain` in fp32 with its three products emulated in
    tf32 (the gate's dot product stays fp32, as in `csrc/combiner.cu`)."""
    wt, bt, wi, bi, wh, bh, wo, bo = TCb._weights(module)
    cat = torch.cat([torch.relu(_linear_tf32(text, wt, bt, passes)),
                     torch.relu(_linear_tf32(image, wi, bi, passes))], dim=-1)
    h = torch.relu(_linear_tf32(cat, wh, bh, passes))
    sigma = torch.sigmoid(torch.nn.functional.linear(h, wo, bo))
    out = sigma * text + (1.0 - sigma) * image
    return out / torch.sqrt(torch.sum(out * out, dim=-1, keepdim=True)).clamp_min(TCb.NORM_EPS)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """The emulation's rounding on values that pin it down: exact tf32
    values stay, a value one ulp (of fp32) past a tie rounds to the
    nearer, a tie rounds away from zero in both signs."""
    step = 2.0 ** -10  # tf32's ulp at 1.0
    x = torch.tensor([1.0, 1.0 + step, 1.0 + step / 2, -(1.0 + step / 2),
                      1.0 + step / 2 - 2.0 ** -23])
    want = torch.tensor([1.0, 1.0 + step, 1.0 + step, -(1.0 + step), 1.0])
    torch.testing.assert_close(_tf32(x), want, rtol=0, atol=0)


@pytest.mark.parametrize("d", [512, 640])
def test_combiner_3xtf32_meets_the_fp32_tolerance(d):
    """B12's fp32 arithmetic on the card, emulated here at the combiner's
    widths (64 rows, JAX's own init): 3xTF32 products hold the JAX
    `combiner_apply` at the fp32 tolerance (atol 2e-5), while one tf32
    pass does not, so the check can tell the two apart."""
    from fashionern_aaai2024_tpu.models.ern.fusion import CombinerSimple as JaxCombiner
    from fashionern_aaai2024_tpu_torch.models import convert
    from fashionern_aaai2024_tpu_torch.models.ern.fusion import CombinerSimple

    g = np.random.default_rng(d)
    img = g.standard_normal((64, d)).astype(np.float32)
    txt = g.standard_normal((64, d)).astype(np.float32)
    v = jax.tree_util.tree_map(np.asarray,
                               JaxCombiner(d).init(jax.random.PRNGKey(d), img, txt))
    tm = CombinerSimple(d).eval()
    tm.load_state_dict({k[2:]: t for k, t in convert._combiner(v["params"], "m").items()})
    want = JCb.combiner_apply(jnp.asarray(img), jnp.asarray(txt), v["params"])
    with torch.no_grad():
        image, text = torch.from_numpy(img), torch.from_numpy(txt)
        _close(want, _combiner_tf32(image, text, tm, passes=3), "fp32")
        one_pass = _combiner_tf32(image, text, tm, passes=1).numpy()
    assert np.abs(one_pass - np.asarray(want)).max() > 2e-5


@pytest.mark.parametrize("m,d,splits", [(1, 512, 4), (33, 512, 4), (128, 512, 4), (128, 640, 3),
                                         (1024, 512, 1), (1024, 640, 1), (4, 3, 1)])
def test_combiner_split_k_covers_k(m, d, splits):
    """B12's fp32 hidden product ([m, 8d] x [8d, 8d]) on a card of 132
    SMs: split only where its 128 x 128 tiles leave SMs idle; the K
    slices are whole k tiles and cover K exactly once."""
    k = n = 8 * d
    k_per = TCb.hidden_k_slice(m, n, k, 132)
    got = -(-k // k_per)
    assert got == splits and k_per % 32 == 0
    assert (got - 1) * k_per < k <= got * k_per


@pytest.mark.parametrize("sms", [1, 78, 114, 132])
def test_combiner_k_slices_cover_k_at_every_row_count(sms):
    """`hidden_k_slice` over every row count to 2,048 at the combiner's
    widths and a few others: whole 32-deep K tiles, no slice empty or
    past K, no slice shallower than 8 K tiles unless K is, and never more
    blocks than the SMs hold when the product is split."""
    for d in (8, 64, 512, 640):
        k = n = 8 * d
        tiles_n = -(-n // 128)
        for m in range(1, 2049):
            k_per = TCb.hidden_k_slice(m, n, k, sms)
            splits = -(-k // k_per)
            starts = [z * k_per for z in range(splits)]
            assert k_per % 32 == 0 and all(s0 < k for s0 in starts)
            assert sum(min(k, s0 + k_per) - s0 for s0 in starts) == k
            if splits > 1:
                assert k_per >= 8 * 32
                assert -(-m // 128) * tiles_n * splits <= sms


def test_cpu_tensors_take_the_plain_versions_of_b9_b12():
    _, _, tm, img, txt = _combiner_pair(16, "fp32", seed=99)
    q, k, v, _ = _mha_inputs(1, 2, 5, 7, 64, False, seed=98)
    before = (TA.multi_head_attention.launches, TCb.combiner_apply.launches)
    with torch.no_grad():
        TCb.combiner_apply(torch.from_numpy(img), torch.from_numpy(txt), tm)
    TA.multi_head_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert (TA.multi_head_attention.launches, TCb.combiner_apply.launches) == before
    assert TCm.LIBRARY._lib is None
