"""The port's attention experiment (X1-X4, `ops/attn_experiment.py`, and
its runner `benchmarks/attn_experiment.py` in the port) against the JAX
script `benchmarks/attn_experiment.py`, on the CPU.

The JAX script is loaded from its path and left as it is. Its four
Pallas kernels run in interpret mode (`force_tpu_interpret_mode`) at
batch 2 (X1 at BH = 24 and 8), and the port's plain versions (what a CPU
tensor takes) get the same numpy inputs: X1 on every row and lane of its
padded [BH, 208, 128] output, with one query row whose every key carries
the -1e30 bias (the Pallas kernel then averages all keys uniformly, and
so must the port); X2 at gb 1 and 2; X3 and X4 with the JAX [in, out]
weights carried over by `attn_experiment_params_from_jax`. Also:
`attention_ref` against `xla_ref`, the converter's layout, B9
(`multi_head_attention`) at 300 keys and head dim 128 (the shapes the
grouped kernel takes on the card), one case with keys masked by -inf,
against JAX's `_mha_pallas` in interpret mode, the wrappers' launch arguments on a stand-in for the
card, and the runner's four entry points at batch 2 with `device="cpu"`.

Tolerances: fp32 atol 2e-5 (the port's module tolerance); bf16 atol =
rtol = 2e-2 (bf16 keeps about three significant digits and the two
frameworks accumulate in other orders).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_attn_experiment.py -q
"""

import importlib.util
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fashionern_aaai2024_tpu.ops import attention as JA
from fashionern_aaai2024_tpu_torch.benchmarks import attn_experiment as runner
from fashionern_aaai2024_tpu_torch.models.convert import attn_experiment_params_from_jax
from fashionern_aaai2024_tpu_torch.ops import attention as TA
from fashionern_aaai2024_tpu_torch.ops import attn_experiment as X
from fashionern_aaai2024_tpu_torch.ops import common

torch.set_num_threads(2)

_SCRIPT = Path(__file__).resolve().parent.parent / "benchmarks" / "attn_experiment.py"
_spec = importlib.util.spec_from_file_location("jax_attn_experiment", _SCRIPT)
JX = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(JX)

DTYPES = {"fp32": (jnp.float32, torch.float32, dict(atol=2e-5, rtol=0.0)),
          "bf16": (jnp.bfloat16, torch.bfloat16, dict(atol=2e-2, rtol=2e-2))}
SCALE = X.DH ** -0.5
MASKED_ROW = 3


def _pair(a: np.ndarray, dtype: str):
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.ascontiguousarray(a)).to(td)


def _close(jax_out, torch_out, dtype: str):
    np.testing.assert_allclose(torch_out.float().numpy(), np.asarray(jax_out, np.float32),
                               **DTYPES[dtype][2])


def test_the_port_keeps_the_experiments_shapes():
    assert (X.B, X.H, X.S, X.DH, X.SP, X.SKP, X.DP, X.W) == (
        JX.B, JX.H, JX.S, JX.DH, JX.SP, JX.SKP, JX.DP, JX.W)


def _x1_inputs(bh: int, seed: int):
    """X1's padded operands as the JAX script builds them, and its bias
    with one more row masked on every key."""
    g = np.random.default_rng(seed)
    out = []
    for rows in (X.SP, X.SKP, X.SKP):
        t = np.zeros((bh, rows, X.DP), np.float32)
        t[:, :X.S, :X.DH] = g.standard_normal((bh, X.S, X.DH))
        out.append(t)
    bias = np.full((X.SP, X.SKP), -1e30, np.float32)
    bias[:, :X.S] = 0.0
    bias[MASKED_ROW] = -1e30
    return (*out, bias)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("bh,g", [(24, 8), (8, 1), (8, 4)])
def test_x1_plain_matches_the_pallas_kernel(dtype, bh, g):
    q, k, v, bias = _x1_inputs(bh, seed=bh + g)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        want = JX.mha_grouped(jq, jk, jv, jnp.asarray(bias), SCALE, g)
    got = X.mha_grouped(tq, tk, tv, torch.from_numpy(bias), SCALE, g)
    assert got.shape == (bh, X.SP, X.DP) and got.dtype == tq.dtype
    _close(want, got, dtype)
    # every key of the masked row carries -1e30: a uniform average of all
    # 256 keys, padding included, on both sides
    np.testing.assert_allclose(got[:, MASKED_ROW].float().numpy(),
                               tv.float().mean(dim=1).numpy(), **DTYPES[dtype][2])
    assert np.abs(np.asarray(want, np.float32)[:, MASKED_ROW]).max() > 1e-3


def _left_padding(s: int) -> np.ndarray:
    """fp32 [s, s]: -inf on the keys before a row's index (the last key
    always kept), 0 elsewhere."""
    keep = np.triu(np.ones((s, s), bool))
    keep[:, -1] = True
    return np.where(keep, 0.0, -np.inf).astype(np.float32)


# X2's -1e30 padding bias, and a -inf left-padding bias (the Pallas
# kernel takes SP rows only)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("gb,bias_kind", [
    pytest.param(1, "padding", id="1"), pytest.param(2, "padding", id="2"),
    pytest.param(1, "-inf", id="1-left-padding"), pytest.param(2, "-inf", id="2-left-padding")])
def test_x2_plain_matches_the_pallas_kernel(dtype, gb, bias_kind):
    g = np.random.default_rng(10 + gb)
    qkv = g.standard_normal((2, X.SP, 3 * X.W)).astype(np.float32)
    qkv[:, X.S:] = 0.0
    bias = np.full((X.SP, X.SP), -1e30, np.float32)
    bias[:, :X.S] = 0.0
    if bias_kind == "-inf":
        bias = _left_padding(X.SP)
    jqkv, tqkv = _pair(qkv, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = JX.mha_packed(jqkv, jnp.asarray(bias), SCALE, gb)
    _close(want, X.mha_packed(tqkv, torch.from_numpy(bias), SCALE, gb), dtype)


def _weights(seed: int) -> dict:
    g = np.random.default_rng(seed)
    w = X.W
    return {"g_": (g.standard_normal((w,)) * 0.1 + 1.0).astype(np.float32),
            "be": (g.standard_normal((w,)) * 0.1).astype(np.float32),
            "w_qkv": (g.standard_normal((w, 3 * w)) * 0.02).astype(np.float32),
            "b_qkv": (g.standard_normal((3 * w,)) * 0.02).astype(np.float32),
            "w_out": (g.standard_normal((w, w)) * 0.02).astype(np.float32),
            "b_out": (g.standard_normal((w,)) * 0.02).astype(np.float32)}


def _experiment_bias(seed: int) -> np.ndarray:
    """An arbitrary [S, S] fp32 bias (the JAX script passes zeros)."""
    return np.random.default_rng(seed).standard_normal((X.S, X.S)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_x3_plain_matches_the_pallas_kernel(dtype):
    jw = _weights(20)
    x = np.random.default_rng(21).standard_normal((2, X.S, X.W)).astype(np.float32)
    bias = _experiment_bias(22)
    jd, td, _ = DTYPES[dtype]
    jx, tx = _pair(x, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = JX.qkvattn(jx, jnp.asarray(jw["w_qkv"], jd), jnp.asarray(jw["b_qkv"], jd),
                          jnp.asarray(bias), SCALE)
    p = attn_experiment_params_from_jax({n: jw[n] for n in ("w_qkv", "b_qkv")}, dtype=td,
                                        device="cpu")
    _close(want, X.qkvattn(tx, p["w_qkv"], p["b_qkv"], torch.from_numpy(bias), SCALE), dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_x4_plain_matches_the_pallas_kernel(dtype):
    jw = _weights(30)
    x = np.random.default_rng(31).standard_normal((2, X.S, X.W)).astype(np.float32)
    bias = _experiment_bias(32)
    jd, td, _ = DTYPES[dtype]
    jx, tx = _pair(x, dtype)
    names = ("g_", "be", "w_qkv", "b_qkv", "w_out", "b_out")
    with pltpu.force_tpu_interpret_mode():
        want = JX.attnblock(jx, *(jnp.asarray(jw[n], jd) for n in names), jnp.asarray(bias),
                            SCALE)
    p = attn_experiment_params_from_jax(jw, dtype=td, device="cpu")
    got = X.attnblock(tx, p["g"], p["be"], p["w_qkv"], p["b_qkv"], p["w_out"], p["b_out"],
                      torch.from_numpy(bias), SCALE)
    _close(want, got, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_attention_ref_matches_xla_ref(dtype):
    g = np.random.default_rng(40)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(g.standard_normal((6, X.S, X.DH)).astype(np.float32), dtype) for _ in range(3))
    _close(JX.xla_ref(jq, jk, jv, SCALE), X.attention_ref(tq, tk, tv, SCALE), dtype)


def test_converter_gives_the_torch_layout():
    jw = _weights(50)
    p = attn_experiment_params_from_jax(jw, device="cpu")
    assert set(p) == {"g", "be", "w_qkv", "b_qkv", "w_out", "b_out"}
    np.testing.assert_array_equal(p["w_qkv"].numpy(), jw["w_qkv"].T)
    np.testing.assert_array_equal(p["w_out"].numpy(), jw["w_out"].T)
    for port, jax_name in (("g", "g_"), ("be", "be"), ("b_qkv", "b_qkv"), ("b_out", "b_out")):
        np.testing.assert_array_equal(p[port].numpy(), jw[jax_name])
    assert all(t.is_contiguous() and t.dtype == torch.float32 for t in p.values())
    pb = attn_experiment_params_from_jax({"w_qkv": jnp.asarray(jw["w_qkv"], jnp.bfloat16)},
                                         dtype=torch.bfloat16, device="cpu")
    np.testing.assert_array_equal(
        pb["w_qkv"].float().numpy(),
        np.asarray(jnp.asarray(jw["w_qkv"], jnp.bfloat16), np.float32).T)
    with pytest.raises(KeyError, match="unknown"):
        attn_experiment_params_from_jax({"w": jw["w_qkv"]})


def test_converter_puts_the_weights_on_the_card_by_default():
    """Without `device=` the weights (X3's and X4's arguments) go to the
    card; without a card the call raises and never falls back to the
    CPU."""
    default = inspect.signature(attn_experiment_params_from_jax).parameters["device"].default
    assert default == "cuda"
    jw = _weights(51)
    if torch.cuda.is_available():
        assert all(t.device.type == "cuda" for t in attn_experiment_params_from_jax(jw).values())
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            attn_experiment_params_from_jax(jw)


# (sq, sk, head dim, causal, bias): the grouped kernel's shapes on the
# card; bias "-inf": -inf on the keys before a row's index, 0 from it on
# and on the last key (left padding as PyTorch code often writes it:
# masked keys come before a row's finite ones)
LONG_MHA_CASES = [(7, 300, 128, False, True), (9, 300, 128, True, False),
                  (5, 300, 96, False, False), (40, 300, 128, False, "-inf")]
# the grouped kernel's 64-key chunk and 16-row tile edges on the card, at
# head dims with 16-byte staging (128, 96) and 4-byte (34: D % 8 != 0)
LONG_MHA_EDGE_CASES = [(1, 1, 128, False, True), (15, 63, 96, False, "-inf"),
                       (16, 64, 34, False, True), (17, 65, 128, False, "-inf"),
                       (63, 63, 34, True, False), (65, 300, 96, True, True),
                       (1, 1024, 34, False, "-inf")]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("sq,sk,dh,causal,with_bias", LONG_MHA_CASES + LONG_MHA_EDGE_CASES)
def test_mha_at_long_keys_matches_pallas(dtype, sq, sk, dh, causal, with_bias):
    g = np.random.default_rng(60 + sq)
    q, k, v = (g.standard_normal((2, 2, s, dh)).astype(np.float32) for s in (sq, sk, sk))
    bias = (2 * g.standard_normal((sq, sk))).astype(np.float32) if with_bias else None
    if with_bias == "-inf":
        keep = np.triu(np.ones((sq, sk), bool))
        keep[:, -1] = True
        bias = np.where(keep, 0.0, -np.inf).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = JA.multi_head_attention(jq, jk, jv, causal=causal,
                                   bias=None if bias is None else jnp.asarray(bias),
                                   force_pallas=True, interpret=True)
    got = TA.multi_head_attention(tq, tk, tv, causal=causal,
                                  bias=None if bias is None else torch.from_numpy(bias))
    assert torch.isfinite(got.float()).all()
    _close(want, got, dtype)


@pytest.fixture
def fake_card(monkeypatch):
    """Every tensor counts as a CUDA tensor of a 132-SM card and every
    launch is recorded (name, arguments) instead of run: the wrappers'
    plumbing on the CPU."""
    calls = []
    monkeypatch.setattr(common, "is_cuda", lambda t: True)
    monkeypatch.setattr(common, "stream_of", lambda t: 0)
    monkeypatch.setattr(common, "sm_count", lambda device: 132)
    monkeypatch.setattr(common, "launch", lambda name, *args: calls.append((name, args)))
    return calls


def test_mha_routes_to_the_grouped_kernel(fake_card):
    """B9: head dim 64 / 80 at Sk <= 256 launches the core, any other even
    head dim up to 128 or a longer Sk the grouped kernel with MHA_GROUP
    pairs a block; odd head dims and head dims above 128 raise."""
    def run(dh, sk, layout="rows"):
        t = [torch.zeros(2, 5 if s == "q" else sk, 3 * dh).view(
            2, -1, 3, dh).transpose(1, 2) for s in ("q", "kv", "kv")]
        if layout == "contiguous":
            t = [x.contiguous() for x in t]
        TA._launch_mha(*t, None, 0.1)
        return fake_card.pop()

    assert run(64, 256)[0] == "fern_attention"
    assert run(80, 13)[0] == "fern_attention"
    for dh, sk, layout in ((128, 13, "rows"), (64, 257, "rows"), (96, 1024, "contiguous")):
        name, args = run(dh, sk, layout)
        assert name == "fern_attention_grouped"
        batch, sq, skk, heads, head_dim, q_ld, kv_ld, group, split = args[5:14]
        assert (sq, skk, head_dim, group, split) == (5, sk, dh, TA.MHA_GROUP, 1)
        if layout == "rows":
            assert (batch, heads, q_ld, kv_ld) == (2, 3, 3 * dh, 3 * dh)
        else:
            assert (batch, heads, q_ld, kv_ld) == (6, 1, dh, dh)
    for dh in (127, 160):
        with pytest.raises(ValueError, match="head dim"):
            run(dh, 13)


@pytest.mark.parametrize("sq,sk", [(1, 82), (77, 1)])
def test_mha_reads_one_row_operands_in_one_layout(fake_card, sq, sk):
    """B9 on contiguous [B, H, S, Dh] operands with one query or one key
    (not both): PyTorch keeps the stride of a length-1 S as the view had
    it, so such an operand also looks like a head view of rows; every
    operand must reach the kernel in the layout of the others, (B*H, 1,
    Dh)."""
    b, h, dh = 2, 3, 64

    def operand(s):
        return torch.zeros(b, s, h * dh).view(b, s, h, dh).transpose(1, 2).contiguous()

    TA._launch_mha(operand(sq), operand(sk), operand(sk), None, 0.1)
    name, args = fake_card.pop()
    assert name == "fern_attention"
    batch, q_sq, q_sk, heads, head_dim, q_ld, kv_ld = args[5:12]
    assert (batch, q_sq, q_sk, heads, head_dim, q_ld, kv_ld) == (b * h, sq, sk, 1, dh, dh, dh)


def test_experiment_wrappers_launch_their_kernels(fake_card):
    """X1 launches the grouped kernel with its G; X2 the core with its gb
    and bias; X3 GEMM then the core; X4 LN, GEMM, core, GEMM (fp32: the
    3xTF32 GEMM); a G or gb that does not divide raises before any
    launch; each wrapper counts one launch a call."""
    n = {fn: fn.launches for fn in (X.mha_grouped, X.mha_packed, X.qkvattn, X.attnblock)}
    q, k, v, bias = (torch.from_numpy(a) for a in _x1_inputs(8, seed=0))
    X.mha_grouped(q, k, v, bias, SCALE, 4)
    name, args = fake_card.pop()
    assert name == "fern_attention_grouped" and args[3] == bias.data_ptr()
    assert args[5:14] == (8, X.SP, X.SKP, 1, X.DP, X.DP, X.DP, 4, 0)
    with pytest.raises(ValueError, match="do not divide"):
        X.mha_grouped(q, k, v, bias, SCALE, 3)
    qkv = torch.zeros(4, X.SP, 3 * X.W)
    pbias = torch.zeros(X.SP, X.SP)
    X.mha_packed(qkv, pbias, SCALE, 2)
    name, args = fake_card.pop()
    assert name == "fern_attention" and args[3] == pbias.data_ptr() and args[16] == 2
    assert args[5:10] == (4, X.SP, X.SP, X.H, X.DH)
    with pytest.raises(ValueError, match="do not divide"):
        X.mha_packed(qkv, pbias, SCALE, 3)
    with pytest.raises(ValueError, match="bias"):
        X.mha_packed(qkv, torch.zeros(X.S, X.S), SCALE, 1)
    assert not fake_card
    p = attn_experiment_params_from_jax(_weights(1), device="cpu")
    x = torch.zeros(2, X.S, X.W)
    sbias = torch.zeros(X.S, X.S)
    X.qkvattn(x, p["w_qkv"], p["b_qkv"], sbias, SCALE)
    assert [c[0] for c in fake_card] == ["fern_gemm_tf32", "fern_attention"]
    assert fake_card[1][1][3] == sbias.data_ptr() and fake_card[1][1][16] == 1
    fake_card.clear()
    X.attnblock(x, p["g"], p["be"], p["w_qkv"], p["b_qkv"], p["w_out"], p["b_out"], sbias,
                SCALE)
    assert [c[0] for c in fake_card] == ["fern_layernorm", "fern_gemm_tf32", "fern_attention",
                                         "fern_gemm_tf32"]
    assert fake_card[3][1][6] == x.data_ptr()  # the residual
    for fn, calls in ((X.mha_grouped, 1), (X.mha_packed, 1), (X.qkvattn, 1), (X.attnblock, 1)):
        assert fn.launches == n[fn] + calls


@pytest.mark.parametrize("name", list(runner.ENTRY_POINTS))
def test_runner_entry_points_run_on_the_cpu(name):
    """Each entry point of the runner at batch 2 on the CPU: the check
    (here the plain version against itself, exactly), the JAX script's
    own comparison, and a time for each G / gb that divides."""
    lines = []
    out = runner.ENTRY_POINTS[name](device="cpu", batch=2, iters=1, windows=1,
                                    log=lines.append)
    assert out["max_abs_err"] == 0.0
    assert out["ref_max_abs_err"] < 2e-5
    want = {"grouped": [1, 4, 8], "packed": [1, 2]}.get(name, [1])
    assert sorted(out["times_ms"]) == want
    assert out["library_ms"] > 0 and all(t > 0 for t in out["times_ms"].values())
    assert any("max err vs plain" in line for line in lines)


def test_runner_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.main(["--packed"])
