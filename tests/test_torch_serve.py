"""The serve slice as a whole: the port's RetrievalService against the
JAX package's, on the same gallery items, weights and tokenizer (the
TINY config of tests/test_server.py), on the CPU in fp32.

Per-query scores agree at atol 2e-4, the end-to-end tolerance of
tests/test_e2e_parity.py:147, and the result names are identical.
Also: exact top-k tie-breaking against `blocked_top_k_similarity`, the
CUDA device rule, and that no port module imports JAX.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fashionern_aaai2024_tpu.data.loader import Loader
from fashionern_aaai2024_tpu.ops import similarity as JS
from fashionern_aaai2024_tpu.retrieval import evaluate as JE
from fashionern_aaai2024_tpu.retrieval.server import RetrievalService as JaxService
from fashionern_aaai2024_tpu_torch.ops import similarity as TS
from fashionern_aaai2024_tpu_torch.retrieval.evaluate import InferenceAPI
from fashionern_aaai2024_tpu_torch.retrieval.server import RetrievalService
from torch_port_helpers import CTX, D, PATCH_NUM, both_models, crc_tokenizer, tiny_config

torch.set_num_threads(2)

QUERIES = [("img3", "make it red"), ("img0", "longer sleeves"), ("img5", "in blue"),
           ("img11", "more formal and darker")]


def _items(n=12, seed=1):
    g = np.random.default_rng(seed)
    return [{"name": f"img{i}", "image": g.random((32, 32, 3), dtype=np.float32),
             "patch": g.standard_normal((PATCH_NUM, D)).astype(np.float32)}
            for i in range(n)]


@pytest.fixture(scope="module")
def services():
    jm, variables, tm = both_models(tiny_config)
    jax_api = JE.InferenceAPI(jm, variables, batch_size=8, context_length=CTX,
                              tokenizer=crc_tokenizer)
    jax_service = JaxService(jax_api, Loader(_items(), 8, num_workers=0), warmup=False)
    api = InferenceAPI(tm, tokenizer=crc_tokenizer, device="cpu", batch_size=8,
                       context_length=CTX)
    port_service = RetrievalService(api, Loader(_items(), 8, num_workers=0))
    return jax_service, port_service


def _check(jax_results, port_results):
    assert len(jax_results) == len(port_results)
    for jr, pr in zip(jax_results, port_results):
        assert [r["name"] for r in pr] == [r["name"] for r in jr]
        np.testing.assert_allclose([r["score"] for r in pr], [r["score"] for r in jr],
                                   atol=2e-4, rtol=0)


@pytest.mark.parametrize("k", [5, 12])
@pytest.mark.parametrize("q", range(len(QUERIES)))
def test_single_query_matches_jax_service(services, q, k):
    jax_service, port_service = services
    ref, caption = QUERIES[q]
    want, _ = jax_service.query([ref], [caption], k=k)
    got, latency = port_service.query([ref], [caption], k=k)
    assert latency > 0
    _check(want, got)


def test_batch_query_matches_jax_service(services):
    jax_service, port_service = services
    refs, caps = zip(*QUERIES)
    want, _ = jax_service.query(list(refs), list(caps), k=10)
    got, _ = port_service.query(list(refs), list(caps), k=10)
    _check(want, got)
    for res in got:
        scores = [r["score"] for r in res]
        assert scores == sorted(scores, reverse=True)


def test_gallery_features_match_jax_service(services):
    jax_service, port_service = services
    assert port_service.gallery.names == jax_service.gallery.names
    np.testing.assert_allclose(port_service.gallery.features.numpy(),
                               np.asarray(jax_service.gallery.features, np.float32),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(port_service.index.features.numpy(),
                               np.asarray(jax_service._initial_refined), atol=2e-5, rtol=0)


def test_unknown_ref_and_length_mismatch_raise(services):
    _, port_service = services
    with pytest.raises(KeyError):
        port_service.query(["nope"], ["x"], k=3)
    with pytest.raises(ValueError):
        port_service.query(["img0"], ["x", "y"], k=3)


def _tied_gallery(seed=0):
    """Rows repeated so many scores tie exactly."""
    g = np.random.default_rng(seed)
    base = g.standard_normal((7, 16)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    gal = base[g.integers(0, 7, 40)]
    q = base[:3] + 0.01 * g.standard_normal((3, 16)).astype(np.float32)
    return q, gal


@pytest.mark.parametrize("chunk", [None, 8, 13])
@pytest.mark.parametrize("k", [1, 9, 40])
def test_top_k_tie_break_matches_jax(chunk, k):
    q, gal = _tied_gallery()
    js, ji = JS.blocked_top_k_similarity(jnp.asarray(q), jnp.asarray(gal), k=k, chunk=chunk)
    ts, ti = TS.blocked_top_k_similarity(torch.from_numpy(q), torch.from_numpy(gal), k=k,
                                         chunk=chunk)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)


def test_merge_top_k_matches_jax():
    g = np.random.default_rng(2)
    scores = np.round(g.standard_normal((4, 30)), 1).astype(np.float32)  # many ties
    idx = np.stack([g.permutation(100)[:30] for _ in range(4)]).astype(np.int32)
    js, ji = JS.merge_top_k(jnp.asarray(scores), jnp.asarray(idx), 10)
    ts, ti = TS.merge_top_k(torch.from_numpy(scores), torch.from_numpy(idx).long(), 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_cuda_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, tm = both_models(tiny_config)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceAPI(tm, tokenizer=crc_tokenizer, device="cuda")


def test_port_imports_no_jax():
    """Every module of the port imports with jax, flax and the JAX
    package made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'fashionern_aaai2024_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import fashionern_aaai2024_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
