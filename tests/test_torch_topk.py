"""The approximate top-k tier of the port (`ops/similarity.py`,
`ops/quant.py`, `retrieval/engine.py`) against the JAX package's.

  * `reduction_output_size` equals XLA's `ApproxTopKReductionOutputSize`
    (`jax._src.lib._jax.approx_top_k_reduction_output_size`, rank 2) over
    a grid of gallery sizes, k and recall targets;
  * on the CPU the approximate tier is the exact sort, bit for bit JAX's
    CPU `lax.approx_max_k` (fp32 and int8, chunked and whole, tied rows;
    at k = 1 both take the last maximal column);
  * the fold of the card's route (`folded_top_k`) against a numpy twin;
  * `measured_approx_recall` and `calibrate_approx` (the warning and the
    refusal, worded as JAX's) against JAX's on the same gallery.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.lib import _jax

from fashionern_aaai2024_tpu.ops import quant as JQ
from fashionern_aaai2024_tpu.ops import similarity as JS
from fashionern_aaai2024_tpu.retrieval import engine as JEng
from fashionern_aaai2024_tpu_torch.ops import quant as TQ
from fashionern_aaai2024_tpu_torch.ops import similarity as TS
from fashionern_aaai2024_tpu_torch.retrieval import engine as TEng

SIZES = [1, 100, 128, 129, 256, 300, 512, 1000, 1024, 1025, 4096, 5000, 10007, 65536,
         200_000, 1_000_000]
KS = [1, 2, 10, 50, 51, 100, 128, 500]
RECALLS = [0.5, 0.8, 0.9, 0.95, 0.99, 0.999, 1.0]


def _unit(g, n, d):
    x = g.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("n", SIZES)
def test_reduction_output_size_matches_xla(n):
    for k in (k for k in KS if k <= n):
        for r in RECALLS:
            want = tuple(_jax.approx_top_k_reduction_output_size(n, 2, k, r, False, -1))
            assert TS.reduction_output_size(n, k, r) == want, (n, k, r)


def test_reduction_output_size_examples():
    assert TS.reduction_output_size(200_000, 51, 0.95) == (1664, 7)
    assert TS.reduction_output_size(512, 10, 0.95) == (256, 1)
    with pytest.raises(ValueError, match="recall_target"):
        TS.reduction_output_size(5000, 10, 0.0)


def _tied(g, n=700, d=16):
    base = _unit(g, 9, d)
    return base[g.integers(0, 9, n)]


@pytest.mark.parametrize("chunk", [None, 128, 300])
@pytest.mark.parametrize("k", [1, 20, 51])
def test_cpu_approx_tier_equals_jax_cpu_bit_for_bit(chunk, k):
    g = np.random.default_rng(k)
    gal = _tied(g)
    q = _unit(g, 7, 16)
    js, ji = JS.blocked_top_k_similarity(jnp.asarray(q), jnp.asarray(gal), k=k, chunk=chunk,
                                         approx_recall=0.95)
    ts, ti = TS.blocked_top_k_similarity(torch.from_numpy(q), torch.from_numpy(gal), k=k,
                                         chunk=chunk, approx_recall=0.95)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)
    es, ei = TS.blocked_top_k_similarity(torch.from_numpy(q), torch.from_numpy(gal), k=k,
                                         chunk=chunk)
    assert torch.equal(ts, es)
    assert torch.equal(ti, ei) == (k > 1)   # the rows tie: top-1 takes the last


@pytest.mark.parametrize("chunk", [None, 256])
def test_cpu_int8_approx_tier_equals_jax_cpu(chunk):
    g = np.random.default_rng(5)
    gal = _unit(g, 600, 24)
    q = _unit(g, 5, 24)
    jv, js_ = JQ.quantize_rows(jnp.asarray(gal))
    tv, ts_ = TQ.quantize_rows(torch.from_numpy(gal))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
    want_s, want_i = JQ.blocked_top_k_similarity_int8(jnp.asarray(q), jv, js_, k=30, chunk=chunk,
                                                     approx_recall=0.95)
    got_s, got_i = TQ.blocked_top_k_similarity_int8(torch.from_numpy(q), tv, ts_, k=30,
                                                    chunk=chunk, approx_recall=0.95)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-6, rtol=0)


def test_quantize_rows_is_jax_host_twin():
    g = np.random.default_rng(6)
    x = g.standard_normal((50, 640)).astype(np.float32) * 3
    x[7] = 0.0
    want_v, want_s = JQ.quantize_rows_np(x)
    got_v, got_s = TQ.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_s.numpy(), want_s)


def _fold_twin(s: np.ndarray, k: int, recall: float):
    """The card's fold in numpy: strided bins of the -inf-padded rows,
    the first maximal slot a bin, the stable top-k of the bin maxima."""
    q, n = s.shape
    bins, r = TS.reduction_output_size(n, k, recall)
    if r == 0:
        order = np.argsort(-s, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(s, order, 1), order
    padded = np.full((q, bins << r), -np.inf, np.float32)
    padded[:, :n] = s
    folded = padded.reshape(q, 1 << r, bins)
    slot = folded.argmax(axis=1)
    best = folded.max(axis=1)
    chosen = np.argsort(-best, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(best, chosen, 1), np.take_along_axis(slot, chosen, 1) * bins + chosen


@pytest.mark.parametrize("n, k, recall", [(512, 10, 0.95), (5000, 51, 0.95), (5000, 1, 0.9),
                                          (20000, 50, 0.99), (300, 5, 0.5), (100, 10, 0.95)])
def test_fold_matches_numpy_twin(n, k, recall):
    g = np.random.default_rng(n + k)
    s = np.round(g.standard_normal((4, n)), 2).astype(np.float32)  # ties inside bins
    got_s, got_i = TS.folded_top_k(torch.from_numpy(s), k, recall)
    want_s, want_i = _fold_twin(s, k, recall)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(np.take_along_axis(s, got_i.numpy(), 1), got_s.numpy())


def test_fold_recall_is_near_its_target_on_uniform_scores():
    """XLA's rule sizes the fold for recall >= the target on scores
    without structure; the fold must not do much worse there."""
    g = np.random.default_rng(0)
    s = torch.from_numpy(g.standard_normal((64, 50_000)).astype(np.float32))
    _, approx = TS.folded_top_k(s, 50, 0.95)
    _, exact = TS.stable_top_k(s, 50)
    recall = np.mean([len(set(a.tolist()) & set(e.tolist())) / 50
                      for a, e in zip(approx, exact)])
    assert recall >= 0.93


def test_cpu_select_is_exact_and_cuda_route_folds(monkeypatch):
    s = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 5000)).astype(np.float32))
    assert torch.equal(TS.select_top_k(s, 20, 0.95)[1], TS.stable_top_k(s, 20)[1])
    seen = []
    monkeypatch.setattr(TS, "folded_top_k", lambda s, k, r: seen.append((k, r)))
    TS.select_top_k(types.SimpleNamespace(device=torch.device("cuda")), 20, 0.95)
    assert seen == [(20, 0.95)]


@pytest.mark.parametrize("quantize", [False, True])
def test_measured_recall_and_search_match_jax(quantize):
    g = np.random.default_rng(8)
    gal = _unit(g, 400, 24)
    names = [f"g{i}" for i in range(400)]
    j = JEng.RetrievalIndex(names, gal, quantize=quantize, approx_recall=0.95)
    t = TEng.RetrievalIndex(names, torch.from_numpy(gal), quantize=quantize,
                            approx_recall=0.95)
    assert t.calibrate_approx(k=30) == j.calibrate_approx(k=30) == 1.0
    assert TS.measured_approx_recall(torch.from_numpy(gal), k=500) == JS.measured_approx_recall(
        gal, k=500)
    q = _unit(g, 6, 24)
    js, ji = j.search(q, k=25, chunk=128)
    ts, ti = t.search(torch.from_numpy(q), k=25, chunk=128)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, atol=1e-6, rtol=0)


@pytest.mark.parametrize("measured, strict, raises", [(0.93, False, False), (0.93, True, False),
                                                      (0.85, False, False),
                                                      (0.85, True, True)])
def test_calibrate_approx_warns_and_refuses_as_jax(monkeypatch, capsys, measured, strict,
                                                   raises):
    g = np.random.default_rng(9)
    gal = _unit(g, 64, 8)
    names = [f"g{i}" for i in range(64)]
    monkeypatch.setattr(JS, "measured_approx_recall", lambda *a, **kw: measured)
    monkeypatch.setattr(TEng, "measured_approx_recall", lambda *a, **kw: measured)
    out = {}
    for side, index in (("jax", JEng.RetrievalIndex(names, gal, approx_recall=0.95)),
                        ("port", TEng.RetrievalIndex(names, torch.from_numpy(gal),
                                                     approx_recall=0.95))):
        try:
            out[side] = index.calibrate_approx(k=10, strict=strict)
        except RuntimeError as e:
            out[side] = str(e)
        out[side + "_err"] = capsys.readouterr().err
    assert out["port"] == out["jax"] and out["port_err"] == out["jax_err"]
    assert isinstance(out["port"], str) == raises
    assert ("WARNING" in out["port_err"]) == (not raises)
    assert TEng.RetrievalIndex(names, torch.from_numpy(gal)).calibrate_approx() is None
