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
    one-device JAX run; across a process group they are not ported."""
    pred, tar = (torch.from_numpy(a) for a in _bbc_inputs(16, 24))
    local = TL.batch_based_classification_loss(pred, tar)
    assert TL.batch_based_classification_loss(pred, tar, negatives="global") == local
    with pytest.raises(NotImplementedError, match="A8"):
        TL.batch_based_classification_loss(pred, tar, negatives="global",
                                           process_group=object())
    with pytest.raises(ValueError):
        TL.batch_based_classification_loss(pred, tar, negatives="nope")


@pytest.mark.parametrize("b", [1, 13, 64, 65, 1000, 1024, 4096])
@pytest.mark.parametrize("sms", [1, 132])
def test_bbc_split_plan_covers_every_tile(b, sms):
    """The kernel's C entry point refuses a plan where a split owns no
    column tile; every plan the wrapper makes passes that check."""
    splits, per_split = TL.split_plan(b, sms)
    tiles = -(-b // 64)
    assert splits == -(-tiles // per_split)
    assert (splits - 1) * per_split < tiles <= splits * per_split


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


@pytest.mark.parametrize("m,d,splits", [(1, 512, 8), (33, 512, 8), (128, 512, 5), (128, 640, 4),
                                         (1024, 512, 1), (1024, 640, 1), (4, 3, 1)])
def test_combiner_split_k_covers_k(m, d, splits):
    """B12's fp32 hidden product ([m, 8d] x [8d, 8d]) on a card of 132
    SMs: the K slices are whole k tiles and cover K exactly once."""
    k = n = 8 * d
    k_per, got = TCb._split_k(m, n, k, 132)
    assert got == splits and k_per % 16 == 0
    assert (got - 1) * k_per < k <= got * k_per


def test_cpu_tensors_take_the_plain_versions_of_b9_b12():
    _, _, tm, img, txt = _combiner_pair(16, "fp32", seed=99)
    q, k, v, _ = _mha_inputs(1, 2, 5, 7, 64, False, seed=98)
    before = (TA.multi_head_attention.launches, TCb.combiner_apply.launches)
    with torch.no_grad():
        TCb.combiner_apply(torch.from_numpy(img), torch.from_numpy(txt), tm)
    TA.multi_head_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert (TA.multi_head_attention.launches, TCb.combiner_apply.launches) == before
    assert TCm.LIBRARY._lib is None
