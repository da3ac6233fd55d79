"""The int8 serving tier of the port against the JAX package's, on the CPU.

Same inputs from a numpy seed through both packages. What is held, and
at which tolerance:
  * the quantizers (`quantize_rowwise`, `quantize_colwise`,
    `quantize_rows`): int8 codes and scales exactly equal, zero rows and
    exact .5 ties included (round half to even on both sides);
  * B5 and B6's plain versions against the Pallas kernels in interpret
    mode (`force_pallas=True, interpret=True`): fp32 at atol 2e-5, the
    port's module tolerance (the LN and the fp32 rescales sum in another
    order; at these seeds no int8 code flips, and a flip would show as
    an error of a quantization step, far above it); bf16 at atol = rtol
    = 1e-2, one bf16 step of the output;
  * the same at the rows and widths the int8 GEMM's tiles end on (M = 77,
    the text tower at b = 1, and 129, one row past a 128-row tile) and at
    the text tower's W = 512, F = 2048 (two hidden groups of 1,024); the
    row quantizer there too, per hidden group, with an all-zero row
    (scale 1e-8 / 127, codes 0) and a row of half-step ties;
  * at F = 3072 (two hidden groups) the port follows the kernel and not
    `_qmlp_ref`, which quantizes whole hidden rows (the difference is
    asserted to be large);
  * quantized CLIP towers through the weight bridge at 2e-5, one config
    on B6's branch (head dim 64, W = 128) and one on the float-attention
    branch (head dim 16 / 8);
  * `RetrievalIndex(quantize=True).search`: indices equal, scores at
    1e-6; a quantized `RetrievalService` against the JAX multi-dispatch
    path: identical result names, scores at 2e-4 (`test_e2e_parity.py`);
  * where the two sides' summation orders put a value on either side of
    a rounding boundary, one int8 code differs by one step, and every
    output that depends on it moves by about one quantization step
    (1e-2 here): exact GELU (torch's erf against XLA's) and the train
    step's 16 images show one such row, and those tests allow at most
    one row off the fp32 tolerance, by at most one step
    (`assert_close_up_to_flips`); the loss then moves by about 4e-4
    relative, so it is held at rtol 1e-3;
  * the int8 weight cache equals `quantize_colwise` of the current
    weights after every kind of change, and the bridge loads a JAX
    `CLIP(quantize_mlp=True)` tree.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fashionern_aaai2024_tpu.data.loader import Loader
from fashionern_aaai2024_tpu.models.clip import config as jax_config
from fashionern_aaai2024_tpu.ops import qmatmul as JQM
from fashionern_aaai2024_tpu.ops import qmlp as JQ
from fashionern_aaai2024_tpu.ops import quant as JQuant
from fashionern_aaai2024_tpu.retrieval import engine as JEng
from fashionern_aaai2024_tpu.retrieval import evaluate as JE
from fashionern_aaai2024_tpu.retrieval.server import RetrievalService as JaxService
from fashionern_aaai2024_tpu.train import schedule as JSched
from fashionern_aaai2024_tpu.train import step as JStep
from fashionern_aaai2024_tpu.train.state import create_train_state as jax_create_state
from fashionern_aaai2024_tpu_torch.models import composed as torch_composed
from fashionern_aaai2024_tpu_torch.models.clip import config as torch_config
from fashionern_aaai2024_tpu_torch.models.clip.transformer import ResidualAttentionBlock
from fashionern_aaai2024_tpu_torch.ops import dropout as TD
from fashionern_aaai2024_tpu_torch.ops import qmatmul as TQM
from fashionern_aaai2024_tpu_torch.ops import qmlp as TQ
from fashionern_aaai2024_tpu_torch.ops import quant as TQuant
from fashionern_aaai2024_tpu_torch.retrieval.engine import RetrievalIndex
from fashionern_aaai2024_tpu_torch.retrieval.evaluate import InferenceAPI
from fashionern_aaai2024_tpu_torch.retrieval.server import RetrievalService
from fashionern_aaai2024_tpu_torch.train import schedule as TSched
from fashionern_aaai2024_tpu_torch.train import step as TStep
from fashionern_aaai2024_tpu_torch.train import trainer as TT
from fashionern_aaai2024_tpu_torch.train.state import create_train_state
from torch_port_helpers import (
    CTX,
    D,
    PATCH_NUM,
    crc_tokenizer,
    jax_model_and_variables,
    port_model,
    small_config,
    tiny_config,
    to_np,
)

torch.set_num_threads(2)

F32_TOL = dict(atol=2e-5, rtol=0)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def assert_close_up_to_flips(got, want, *, rows: int, step: float):
    """fp32 tolerance everywhere except at most `rows` rows (last axis),
    which may differ by up to one quantization step."""
    got, want = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    err = np.abs(got - want)
    off = int((err > F32_TOL["atol"]).any(axis=1).sum())
    assert off <= rows, f"{off} rows off the fp32 tolerance (max error {err.max()})"
    assert err.max() <= step, err.max()


def quantized(cfg_fn, module, **kw):
    return dataclasses.replace(cfg_fn(module, **kw), quantize_mlp=True)


def both_quantized(cfg_fn=small_config, seed=0):
    jm, variables = jax_model_and_variables(quantized(cfg_fn, jax_config), seed)
    return jm, variables, port_model(quantized(cfg_fn, torch_config), variables)


# --- the quantizers ------------------------------------------------------


def _quant_input(seed=0):
    """Random rows, a zero row, and a row of exact .5 ties: its absmax is
    127, so both recipes give scale 1.0 and values +-0.5, 1.5, 2.5 ...
    land on round-half-to-even's boundary."""
    g = np.random.default_rng(seed)
    x = g.standard_normal((6, 40)).astype(np.float32)
    x[2] = 0.0
    ties = np.arange(40, dtype=np.float32) - 19.5
    ties[0] = 127.0
    x[4] = ties
    x[5, :3] = [126.5, -125.5, 127.0]
    return x


@pytest.mark.parametrize("name", ["quantize_rowwise", "quantize_colwise", "quantize_rows"])
def test_quantizers_equal_jax(name):
    x = _quant_input()
    if name == "quantize_colwise":
        x = np.ascontiguousarray(x.T)
    module_j, module_t = (JQuant, TQuant) if name == "quantize_rows" else (JQM, TQM)
    jq, js = getattr(module_j, name)(jnp.asarray(x))
    tq, ts = getattr(module_t, name)(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_dequantize_rows_and_int8_matmul_equal_jax():
    x = _quant_input()
    q, s = TQuant.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(TQuant.dequantize_rows(q, s).numpy(),
                                  np.asarray(JQuant.dequantize_rows(jnp.asarray(q.numpy()),
                                                                    jnp.asarray(s.numpy()))))
    g = np.random.default_rng(1)
    w = g.standard_normal((40, 24)).astype(np.float32)
    b = g.standard_normal(24).astype(np.float32)
    want = JQM.int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = TQM.int8_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("rows,width,groups", [(77, 512, 1), (129, 768, 1), (77, 2048, 2),
                                               (129, 3072, 2)])
def test_row_quantizer_equals_the_kernels_at_the_tile_edges(rows, width, groups):
    """`quantize_rowwise` on each hidden group of a [rows, F] block (B5's
    hidden, B6's attention output with one group) gives the codes and
    scales of the Pallas kernels' `_quant_rows_f32`, exactly: an all-zero
    row (scale 1e-8 / 127, codes 0) and a row of half-step ties (its
    absmax 127: scale 1.0, ties rounded to even) included."""
    g = np.random.default_rng(rows + width)
    x = (3.0 * g.standard_normal((rows, width))).astype(np.float32)
    x[rows // 2] = 0.0
    x[-1] = np.resize(np.arange(-63.5, 64.5, 1.0, dtype=np.float32), width)
    x[-1, ::97] = 127.0
    c = width // groups
    for i in range(groups):
        block = np.ascontiguousarray(x[:, c * i:c * (i + 1)])
        jq, js = JQ._quant_rows_f32(jnp.asarray(block))
        tq, ts = TQM.quantize_rowwise(torch.from_numpy(block))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert ts[rows // 2].item() == np.float32(1e-8) / np.float32(127.0)
        assert not tq[rows // 2].any()
        assert ts[-1].item() == 1.0
        ties = block[-1] - np.trunc(block[-1]) != 0
        assert ties.any() and (tq[-1].numpy()[ties] % 2 == 0).all()


def test_int8_product_is_the_exact_int32_product():
    g = np.random.default_rng(2)
    a = g.integers(-127, 128, (5, 3072)).astype(np.int8)
    b = g.integers(-127, 128, (7, 3072)).astype(np.int8)
    exact = a.astype(np.int64) @ b.astype(np.int64).T
    got = TQM.int8_product(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.int32).astype(np.float32))


# --- B5 and B6 against the interpret-mode Pallas kernels ------------------


def _mlp_inputs(b, s, w, f, seed=0):
    g = np.random.default_rng(seed)
    n = lambda *shape, std=1.0, mean=0.0: (mean + std * g.standard_normal(shape)).astype(
        np.float32)
    return (n(b, s, w), n(w, std=0.1, mean=1.0), n(w, std=0.1), n(w, f, std=0.1),
            n(f, std=0.02), n(f, w, std=0.1), n(w, std=0.02))


def _port_weights(w, dtype):
    """JAX-layout [in, out] float weight -> the port's cached form."""
    q, s = TQM.quantize_rowwise(torch.from_numpy(w).to(dtype).t())
    return q, s.reshape(-1)


def _b5(args, dtype, activation):
    jd, td = DTYPES[dtype]
    x, g_, be, wfc, bfc, wp, bp = args
    J = lambda a: jnp.asarray(a).astype(jd)
    T = lambda a: torch.from_numpy(a).to(td)
    kernel = JQ.int8_mlp_subblock(*map(J, args), activation=activation, force_pallas=True,
                                  interpret=True)
    ref = JQ._qmlp_ref(*map(J, args), activation, 1e-5)
    got = TQ.int8_mlp_subblock(T(x), T(g_), T(be), *_port_weights(wfc, td), T(bfc),
                               *_port_weights(wp, td), T(bp), activation=activation)
    return to_np(got), np.asarray(kernel.astype(jnp.float32)), np.asarray(
        ref.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_int8_mlp_plain_matches_the_pallas_kernel(dtype):
    got, kernel, _ = _b5(_mlp_inputs(2, 9, 128, 256), dtype, "quick_gelu")
    np.testing.assert_allclose(got, kernel, **(F32_TOL if dtype == "fp32" else BF16_TOL))


# (b, s, w, f): the text tower at b = 1 (M = 77, W = 512, F = 2048: two
# hidden groups of 1,024), and M = 129, one row past a 128-row tile
EDGE_MLP = [(1, 77, 512, 2048), (3, 43, 128, 512)]
# (b, s, w, heads, causal): the text tower at b = 1, and M = 129
EDGE_ATTN = [(1, 77, 512, 8, True), (3, 43, 128, 2, False)]


@pytest.mark.parametrize("b,s,w,f", EDGE_MLP)
def test_int8_mlp_plain_matches_the_pallas_kernel_at_the_tile_edges(b, s, w, f):
    got, kernel, _ = _b5(_mlp_inputs(b, s, w, f, seed=b + w), "fp32", "quick_gelu")
    assert_close_up_to_flips(got, kernel, rows=1, step=1e-2)


def test_int8_mlp_follows_the_kernel_not_qmlp_ref_at_two_groups():
    """F = 3072: the kernel quantizes the hidden per row in two groups of
    1536 columns; `_qmlp_ref` (JAX off the TPU and at b < 8) per whole
    row. The port is the kernel's function."""
    assert TQ.pick_splits(3072) == 2 and TQ.pick_splits(2048) == 2
    got, kernel, ref = _b5(_mlp_inputs(2, 9, 128, 3072, seed=1), "fp32", "quick_gelu")
    np.testing.assert_allclose(got, kernel, **F32_TOL)
    assert np.abs(kernel - ref).max() > 1e-2


def test_int8_mlp_exact_gelu_matches_qmlp_ref():
    """Exact GELU never reached the Pallas kernel; with it the port
    quantizes whole hidden rows, as `_qmlp_ref`."""
    args = _mlp_inputs(2, 9, 128, 3072, seed=2)
    got, _, _ = _b5(args, "fp32", "gelu")
    ref = JQ._qmlp_ref(*map(jnp.asarray, args), "gelu", 1e-5)
    assert_close_up_to_flips(got, np.asarray(ref), rows=1, step=1e-2)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_int8_attention_plain_matches_the_pallas_kernel(dtype, causal):
    _check_b6(dtype, 2, 9, 128, 2, causal, seed=3)


@pytest.mark.parametrize("b,s,w,heads,causal", EDGE_ATTN)
def test_int8_attention_plain_matches_the_pallas_kernel_at_the_tile_edges(b, s, w, heads,
                                                                         causal):
    """One attention-output code flips at M = 129 (one row off 2e-5, by
    less than a step): held as the flips above."""
    got, want = _b6(DTYPES["fp32"], b, s, w, heads, causal, seed=b + w)
    assert_close_up_to_flips(got, want, rows=1, step=1e-2)


def _check_b6(dtype, b, s, w, heads, causal, seed):
    got, want = _b6(DTYPES[dtype], b, s, w, heads, causal, seed)
    np.testing.assert_allclose(got, want, **(F32_TOL if dtype == "fp32" else BF16_TOL))


def _b6(dtypes, b, s, w, heads, causal, seed):
    """(the port's B6 on the CPU, the Pallas kernel in interpret mode) as
    fp32 numpy arrays, on one seeded input."""
    jd, td = dtypes
    g = np.random.default_rng(seed)
    n = lambda *shape, std=1.0, mean=0.0: (mean + std * g.standard_normal(shape)).astype(
        np.float32)
    x, g_, be = n(b, s, w), n(w, std=0.1, mean=1.0), n(w, std=0.1)
    wq, bq, wo, bo = n(w, 3 * w, std=0.1), n(3 * w, std=0.02), n(w, w, std=0.1), n(w, std=0.02)
    J = lambda a: jnp.asarray(a).astype(jd)
    T = lambda a: torch.from_numpy(a).to(td)
    want = JQ.int8_attention_subblock(J(x), J(g_), J(be), J(wq), J(bq), J(wo), J(bo), heads,
                                      causal=causal, force_pallas=True, interpret=True)
    got = TQ.int8_attention_subblock(T(x), T(g_), T(be), *_port_weights(wq, td), T(bq),
                                     *_port_weights(wo, td), T(bo), heads, causal=causal)
    return to_np(got), np.asarray(want.astype(jnp.float32))


# --- the quantized towers ----------------------------------------------


@pytest.mark.parametrize("cfg_fn", [small_config, tiny_config], ids=["b6_branch", "float_attn"])
def test_quantized_towers_match_jax(cfg_fn):
    jm, variables, tm = both_quantized(cfg_fn)
    g = np.random.default_rng(4)
    images = g.random((3, 32, 32, 3), dtype=np.float32)
    ids = crc_tokenizer(["make it red", "longer sleeves and darker", "in blue"])
    jg, jt = jm.apply(variables, jnp.asarray(images), method=jm.encode_image)
    jtg, jts = jm.apply(variables, jnp.asarray(ids), method=jm.encode_text)
    with torch.no_grad():
        tg, tt = tm.encode_image(torch.from_numpy(images))
        ttg, tts = tm.encode_text(torch.from_numpy(ids).long())
    for got, want in ((tg, jg), (tt, jt), (ttg, jtg), (tts, jts)):
        np.testing.assert_allclose(to_np(got), np.asarray(want), **F32_TOL)


def test_quantized_towers_differ_from_float_towers():
    """The int8 branch is really taken: same weights, another function."""
    _, variables, tm = both_quantized()
    tf = port_model(small_config(torch_config), variables)
    images = torch.from_numpy(np.random.default_rng(5).random((2, 32, 32, 3), np.float32))
    with torch.no_grad():
        a, b = tm.encode_image(images)[0], tf.encode_image(images)[0]
    assert 1e-5 < (a - b).abs().max().item() < 0.1 * b.abs().max().item()


def test_bridge_loads_a_quantized_jax_clip_tree():
    """`CLIP(quantize_mlp=True)` has the float tree (JAX pins it at
    tests/test_ops.py:457-459): the bridge loads it, strict, into a
    quantized port model, with no parameter beyond the float model's."""
    _, variables = jax_model_and_variables(quantized(small_config, jax_config))
    _, float_vars = jax_model_and_variables(small_config(jax_config))
    assert (jax.tree_util.tree_structure(variables)
            == jax.tree_util.tree_structure(float_vars))
    tm = port_model(quantized(small_config, torch_config), variables)
    tf = torch_composed.ComposedCIRModel(small_config(torch_config), patch_num=PATCH_NUM)
    assert tm.state_dict().keys() == tf.state_dict().keys()
    assert all(b.quantize for b in tm.clip.transformer.resblocks)
    assert all(b.quantize for b in tm.clip.visual.transformer.resblocks)


def _assert_cache_is_current(block):
    cache = block.int8_weights()
    for name, w in block._float_weights().items():
        q, s = JQM.quantize_colwise(jnp.asarray(w.detach().float().numpy().T))
        np.testing.assert_array_equal(cache[name][0].numpy(), np.asarray(q).T, err_msg=name)
        np.testing.assert_array_equal(cache[name][1].numpy(), np.asarray(s)[0], err_msg=name)


def test_int8_weight_cache_never_goes_stale():
    """The cache equals `quantize_colwise` of the weights as they are now:
    after an in-place write, `load_state_dict`, cast round trips that
    can put the rounded weights back at their old address, and the serve
    policy's bf16 cast (then of the bf16-rounded weights)."""
    torch.manual_seed(0)
    block = ResidualAttentionBlock(128, 2, "quick_gelu", quantize=True)
    for p in block.parameters():
        torch.nn.init.normal_(p, std=0.1)
    _assert_cache_is_current(block)
    first = block.int8_weights()
    assert block.int8_weights() is first                        # cached, not rebuilt
    with torch.no_grad():
        block.mlp["c_fc"].weight.mul_(3.0)
    _assert_cache_is_current(block)
    sd = {k: torch.randn_like(v) for k, v in block.state_dict().items()}
    block.load_state_dict(sd)
    _assert_cache_is_current(block)
    # the allocator may put a round trip's result at the old address: then
    # each weight keeps its id, pointer, dtype and version, as here
    block.int8_weights()
    block._apply(lambda t: t.data.copy_(t.to(torch.bfloat16).to(t.dtype)))
    _assert_cache_is_current(block)
    block.load_state_dict(sd)
    for _ in range(3):
        block.int8_weights()
        block.to(torch.bfloat16).to(torch.float32)
        _assert_cache_is_current(block)
    block.to(torch.bfloat16)
    assert block.int8_weights()["qkv"][1].dtype == torch.float32
    _assert_cache_is_current(block)
    with torch.no_grad():
        block.attn.out_proj.weight.copy_(torch.randn(128, 128))
    _assert_cache_is_current(block)


# --- the int8 index and service ----------------------------------------


def _gallery(seed=0):
    g = np.random.default_rng(seed)
    base = g.standard_normal((9, 16)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    gal = base[g.integers(0, 9, 40)]                          # duplicate rows: ties
    gal[7] = 0.0                                              # a zero row (scale 1.0)
    q = base[:3] + 0.05 * g.standard_normal((3, 16)).astype(np.float32)
    return q, gal


@pytest.mark.parametrize("chunk", [None, 8, 13])
@pytest.mark.parametrize("k", [1, 9, 40])
def test_int8_index_search_matches_jax(chunk, k):
    q, gal = _gallery()
    names = [f"g{i}" for i in range(len(gal))]
    js, ji = JEng.RetrievalIndex(names, gal, quantize=True).search(q, k=k, chunk=chunk)
    index = RetrievalIndex(names, torch.from_numpy(gal), quantize=True)
    ts, ti = index.search(torch.from_numpy(q), k=k, chunk=chunk)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, atol=1e-6, rtol=0)
    assert index.features_q.dtype == torch.int8 and index.features.dtype == torch.float32


SERVICE_QUERIES = [("img3", "make it red"), ("img0", "longer sleeves"),
                   ("img5", "in blue"), ("img11", "more formal and darker")]


def _items(n=12, seed=1):
    g = np.random.default_rng(seed)
    return [{"name": f"img{i}", "image": g.random((32, 32, 3), dtype=np.float32),
             "patch": g.standard_normal((PATCH_NUM, D)).astype(np.float32)}
            for i in range(n)]


@pytest.fixture(scope="module")
def int8_services():
    jm, variables, tm = both_quantized(small_config)
    jax_api = JE.InferenceAPI(jm, variables, batch_size=8, context_length=CTX,
                              tokenizer=crc_tokenizer, quantize_gallery=True)
    jax_service = JaxService(jax_api, Loader(_items(), 8, num_workers=0), warmup=False)
    # every query through the multi-dispatch path (`server.py:291-296`)
    jax_service._serve_fn = types.SimpleNamespace(k_max=0)
    api = InferenceAPI(tm, tokenizer=crc_tokenizer, device="cpu", batch_size=8,
                       context_length=CTX, quantize_gallery=True)
    return jax_service, RetrievalService(api, Loader(_items(), 8, num_workers=0))


@pytest.mark.parametrize("k", [5, 12])
def test_int8_service_matches_jax_multi_dispatch(int8_services, k):
    jax_service, port_service = int8_services
    assert port_service.index.quantized and jax_service.index.quantized
    refs, caps = zip(*SERVICE_QUERIES)
    for batch in ([refs[0]], [caps[0]]), (list(refs), list(caps)):
        want, _ = jax_service.query(*batch, k=k)
        got, _ = port_service.query(*batch, k=k)
        for jr, pr in zip(want, got):
            assert [r["name"] for r in pr] == [r["name"] for r in jr]
            np.testing.assert_allclose([r["score"] for r in pr], [r["score"] for r in jr],
                                       atol=2e-4, rtol=0)


# --- the train step with int8 towers ------------------------------------


def _keep_all_jax(key, p=0.5, shape=None, *args, **kwargs):
    return jnp.ones(() if shape is None else shape, bool)


def _keep_all_torch(shape, keep, generator, device):
    return torch.ones(shape, dtype=torch.bool, device=device)


@functools.cache
def _train_batch(b=8, seed=0):
    g = np.random.default_rng(seed)
    return {"ref_image": g.random((b, 32, 32, 3), dtype=np.float32),
            "tar_image": g.random((b, 32, 32, 3), dtype=np.float32),
            "text_ids": g.integers(1, 100, (b, CTX)).astype(np.int32),
            "ref_patch": g.standard_normal((b, PATCH_NUM, D)).astype(np.float32),
            "tar_patch": g.standard_normal((b, PATCH_NUM, D)).astype(np.float32)}


def test_train_step_with_int8_towers_matches_jax():
    batch = _train_batch()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", _keep_all_jax)
        mp.setattr(TD, "dropout_mask", _keep_all_torch)
        jm, variables = jax_model_and_variables(quantized(small_config, jax_config))
        opt = optax.adam(JSched.cosine_annealing_schedule(1e-3, 40))
        step = JStep.build_train_step(jm, opt, negatives="local", local_groups=1, donate=False)
        _, jloss = step(jax_create_state(variables, opt, jax.random.PRNGKey(0)), batch)
        model = port_model(quantized(small_config, torch_config), variables)
        state = create_train_state(model, seed=0)
        tstep = TStep.build_train_step(model, TSched.cosine_annealing_schedule(1e-3, 40))
        tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
              for k, v in batch.items()}
        _, loss = tstep(state, tb)
    images = np.concatenate([batch["ref_image"], batch["tar_image"]])
    want = jm.apply(variables, jnp.asarray(images), method=jm.encode_image)[0]
    with torch.no_grad():
        got = model.encode_image(torch.from_numpy(images))[0]
    assert_close_up_to_flips(to_np(got), np.asarray(want), rows=1, step=2e-2)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-3)


def test_trainer_builds_int8_towers_for_quantize_towers(tmp_path, monkeypatch):
    """`TrainConfig.quantize_towers` builds the CLIP config with
    `quantize_mlp=True` (`trainer.py:295-299` of the JAX package) and
    trains: the towers run the int8 blocks under `torch.no_grad()`."""
    seen = []

    def get_config(name, activation=None, quantize_mlp=None, tme=None):
        seen.append(quantize_mlp)
        cfg = small_config(torch_config)
        return dataclasses.replace(cfg, quantize_mlp=bool(quantize_mlp))

    monkeypatch.setattr(TT, "get_clip_config", get_config)
    batch = _train_batch(b=8, seed=1)
    items = [{"ref_name": f"i{i}", "tar_name": f"i{i + 1}", "captions": ["is red", "longer"],
              "ref_image": batch["ref_image"][i], "tar_image": batch["tar_image"][i],
              "ref_patch": batch["ref_patch"][i], "tar_patch": batch["tar_patch"][i]}
             for i in range(8)]
    cfg = TT.TrainConfig(dataset="fashioniq", clip_model_name="ViT-B-16", batch_size=4,
                         num_epochs=1, num_workers=0, ckpt_dir=str(tmp_path),
                         quantize_towers=True, print_frequency=1000)
    tr = TT.Trainer(cfg, device="cpu", train_dataset=items,
                    plugin=TT.DatasetPlugin("s", lambda c: items, TT._fiq_captions),
                    tokenizer=crc_tokenizer)
    assert seen == [True] and tr.model.clip_config.quantize_mlp
    state = tr.train()
    assert state.step == 2
    assert all(b._int8 is not None for b in tr.model.clip.visual.transformer.resblocks)
