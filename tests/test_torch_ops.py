"""The port's ops (plain versions, on the CPU) against the JAX package.

Kernels B1 (`attention_subblock`), B2 (`mlp_subblock`) and B3
(`packed_qkv_self_attention`) are held against the JAX Pallas kernels run
as the JAX tests run them (`force_pallas=True, interpret=True`); exact
GELU against `_mlp_ref(activation="gelu")`. The same numpy inputs feed
both sides.

Tolerances: fp32 atol 2e-5 (the module tolerance of the parity suites);
bf16 atol = rtol = 2e-2 (bf16 keeps about three significant digits and
the two frameworks accumulate in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionern_aaai2024_tpu.ops import attention as JA
from fashionern_aaai2024_tpu.ops import mlp as JM
from fashionern_aaai2024_tpu_torch.ops import attention as TA
from fashionern_aaai2024_tpu_torch.ops import mlp as TM
from fashionern_aaai2024_tpu_torch.ops import common as TCm

torch.set_num_threads(2)

DTYPES = {"fp32": (jnp.float32, torch.float32, dict(atol=2e-5, rtol=0.0)),
          "bf16": (jnp.bfloat16, torch.bfloat16, dict(atol=2e-2, rtol=2e-2))}


def _pair(a: np.ndarray, dtype: str):
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.tensor(a).to(td)


def _close(jax_out, torch_out, dtype: str):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out, np.float32), **DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [17, 33])
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
    _close(layer_norm(jx, jw, jb, 1e-12), TCm.layer_norm(tx, tw, tb, 1e-12), dtype)


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
