"""The port's serving front against the JAX package's, on the CPU.

Mirrors tests/test_server.py case for case (the service, HTTP, the serve
program's buckets and large-k path, the micro-batcher, live adds), with
the port's `RetrievalService` next to JAX's on the same items, weights
and tokenizer (the TINY config of tests/test_server.py), and holds the
port's one-dispatch serve program (`InferenceAPI.build_serve_fn`)
against JAX's in every single-device form: by features and by rows at
every bucket (1, 8, 32), with `capacity` and `update_rows` (append and
overwrite), `quantize_gallery`, `quantize_refs`, the approximate tier,
and a TME model. The criterion is tests/test_e2e_parity.py:147's: equal
top-k rows (the seeded scores do not tie) and scores at atol 2e-4.

Also the `serve` CLI: `build_service` wired from `serve` arguments, and
`fashionern-torch serve --device cpu` in a subprocess answering
/healthz, /query (single and batch), /add (with --capacity) and /stats.
"""

import concurrent.futures as futures
import json
import os
import subprocess
import sys
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from fashionern_aaai2024_tpu.data.loader import Loader
from fashionern_aaai2024_tpu.retrieval import evaluate as JE
from fashionern_aaai2024_tpu.retrieval.server import RetrievalService as JaxService
from fashionern_aaai2024_tpu.tools.make_fixture import make_fixture as jax_make_fixture
from fashionern_aaai2024_tpu_torch.cli import main as cli
from fashionern_aaai2024_tpu_torch.models.clip import config as torch_config
from fashionern_aaai2024_tpu_torch.parallel.mesh import create_mesh
from fashionern_aaai2024_tpu_torch.retrieval.evaluate import InferenceAPI
from fashionern_aaai2024_tpu_torch.retrieval.server import (
    MicroBatcher,
    RetrievalService,
    serve,
)
from test_torch_tme import _both_tme_models
from torch_port_helpers import CTX, D, PATCH_NUM, both_models, crc_tokenizer, tiny_config

torch.set_num_threads(2)

ATOL = 2e-4


def _items(seed=1, n=12, prefix="img"):
    g = np.random.default_rng(seed)
    return [{"name": f"{prefix}{i}", "image": g.random((32, 32, 3), dtype=np.float32),
             "patch": g.standard_normal((PATCH_NUM, D)).astype(np.float32)}
            for i in range(n)]


@pytest.fixture(scope="module")
def models():
    return both_models(tiny_config)


def _apis(models, **kw):
    jm, variables, tm = models
    jax_api = JE.InferenceAPI(jm, variables, batch_size=8, context_length=CTX,
                              tokenizer=crc_tokenizer, **kw)
    api = InferenceAPI(tm, tokenizer=crc_tokenizer, device="cpu", batch_size=8,
                       context_length=CTX, **kw)
    return jax_api, api


def _service(models, items, side="port", **kw):
    jax_api, api = _apis(models)
    if side == "jax":
        return JaxService(jax_api, Loader(items, 8, num_workers=0), warmup=False, **kw)
    return RetrievalService(api, Loader(items, 8, num_workers=0), **kw)


@pytest.fixture(scope="module")
def service(models):
    return _service(models, _items())


@pytest.fixture(scope="module")
def jax_service(models):
    return _service(models, _items(), side="jax")


@pytest.fixture(scope="module")
def base_url(service):
    httpd = serve(service, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    service.batcher.close()
    service.batcher = None


def _post(url, payload, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _same(port_results, jax_results):
    assert len(port_results) == len(jax_results)
    for p, j in zip(port_results, jax_results):
        assert [r["name"] for r in p] == [r["name"] for r in j]
        np.testing.assert_allclose([r["score"] for r in p], [r["score"] for r in j],
                                   atol=ATOL, rtol=0)


# --- the service (tests/test_server.py TestRetrievalService) -------------------


def test_query_matches_offline_eval_ranking(service, jax_service):
    results, _ = service.query(["img3"], ["make it red"], k=12)
    rows = np.asarray([service.rows["img3"]])
    ids = service.api.tokenize(["make it red"])
    ref_patch = service.gallery.local_features[rows]
    tg, tseq = service.api.encode_text(ids, visual_emb=ref_patch)
    preds = service.api.query(service.gallery.features[rows], ref_patch, tg, tseq)
    _, idx = service.index.search(preds, k=12)
    assert [r["name"] for r in results[0]] == [service.gallery.names[j] for j in idx[0]]
    _same(results, jax_service.query(["img3"], ["make it red"], k=12)[0])


def test_batch_and_scores_sorted(service, jax_service):
    results, _ = service.query(["img0", "img5"], ["longer sleeves", "in blue"], k=5)
    assert len(results) == 2
    for res in results:
        scores = [r["score"] for r in res]
        assert scores == sorted(scores, reverse=True)
    _same(results, jax_service.query(["img0", "img5"], ["longer sleeves", "in blue"], k=5)[0])


def test_unknown_ref_raises(service):
    with pytest.raises(KeyError):
        service.query(["nope"], ["x"], k=3)
    with pytest.raises(ValueError, match="length mismatch"):
        service.query(["img0"], ["x", "y"], k=3)


# --- HTTP (TestHTTP) -------------------------------------------------------------


def test_healthz(base_url):
    assert _get(f"{base_url}/healthz") == {"status": "ok", "gallery_size": 12}


def test_query_roundtrip(base_url, jax_service):
    data = _post(f"{base_url}/query", {"ref_name": "img2", "caption": "with a belt", "k": 4})
    assert len(data["results"]) == 4
    assert {"name", "score"} <= set(data["results"][0])
    assert data["latency_ms"] >= 0
    _same([data["results"]], jax_service.query(["img2"], ["with a belt"], k=4)[0])


def test_batch_roundtrip(base_url, jax_service):
    data = _post(f"{base_url}/query", {"ref_names": ["img1", "img2"], "captions": ["a", "b"],
                                       "k": 3})
    assert len(data["results"]) == 2 and len(data["results"][0]) == 3
    _same(data["results"], jax_service.query(["img1", "img2"], ["a", "b"], k=3)[0])


def test_unknown_ref_404(base_url):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{base_url}/query", {"ref_name": "ghost", "caption": "x"})
    assert e.value.code == 404


def test_bad_request_400(base_url):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{base_url}/query", {"caption": "missing ref"})
    assert e.value.code == 400


def test_stats(base_url):
    _post(f"{base_url}/query", {"ref_name": "img0", "caption": "y"})
    data = _get(f"{base_url}/stats")
    assert data["requests"] >= 1
    assert data["gallery_size"] == 12
    assert data["latency_ms"]["p50"] is not None


def test_batch_with_stray_ref_name_stays_batch(base_url):
    data = _post(f"{base_url}/query", {"ref_names": ["img1", "img2"], "ref_name": "img1",
                                       "captions": ["a", "b"], "k": 3})
    assert len(data["results"]) == 2 and len(data["results"][0]) == 3


def test_reload_and_unknown_paths_404(base_url):
    for path in ("/reload", "/nowhere"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base_url}{path}", {})
        assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(f"{base_url}/nowhere")
    assert e.value.code == 404


# --- the serve program (TestServeFn) ---------------------------------------------


def test_buckets_consistent_and_match_search(service):
    api, fn = service.api, service._serve_fn
    assert fn.by_rows and fn.buckets == (1, 8, 32) and fn.k_max == 12
    ids = api.tokenize(["with a belt", "longer and red", "plain"])
    rows = np.asarray([2, 5, 7])
    s3, i3 = fn(ids, rows, k=5)          # bucket 8
    s1, i1 = fn(ids[:1], rows[:1], k=5)  # bucket 1
    np.testing.assert_array_equal(i3[:1], i1)
    np.testing.assert_allclose(s3[:1], s1, atol=1e-5)
    ref_patch = service.gallery.local_features[rows]
    tg, ts = api.encode_text(ids, visual_emb=ref_patch)
    preds = api.query(service.gallery.features[rows], ref_patch, tg, ts)
    sw, iw = service.index.search(preds, k=5)
    np.testing.assert_array_equal(i3, iw)
    np.testing.assert_allclose(s3, sw, atol=1e-4)


def test_large_k_falls_back(service, jax_service, monkeypatch):
    k_max = service._serve_fn.k_max
    monkeypatch.setattr(service._serve_fn, "k_max", 6)
    monkeypatch.setattr(jax_service._serve_fn, "k_max", 6)
    out, _ = service.query(["img1", "img4"], ["anything bigger", "red"], k=10)
    assert len(out[0]) == 10
    _same(out, jax_service.query(["img1", "img4"], ["anything bigger", "red"], k=10)[0])
    assert service._serve_fn.k_max == 6 != k_max
    out, _ = service.query(["img1"], ["anything bigger"], k=100)
    assert len(out[0]) == service.gallery_size


def test_batch_past_the_largest_bucket_raises(service):
    with pytest.raises(ValueError, match="largest compile bucket 32"):
        service.query(["img0"] * 33, ["x"] * 33, k=3)


# --- the serve program against JAX's in every single-device form ---------------


def _arrays(seed, n):
    g = np.random.default_rng(seed)
    return (g.standard_normal((n, D)).astype(np.float32),
            g.standard_normal((n, D)).astype(np.float32),
            g.standard_normal((n, PATCH_NUM, D)).astype(np.float32))


CAPS = ["is red", "blue dress", "long", "with a belt", "darker and longer", "short",
        "more formal", "plain"]


def _check_fn(jfn, tfn, batches, ref_of):
    for n in batches:
        ids = crc_tokenizer([CAPS[i % len(CAPS)] + f" {i}" for i in range(n)], CTX)
        args = ref_of(n)
        js, ji = jfn(ids, *args, k=7)
        ts, ti = tfn(ids, *args, k=7)
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_allclose(ts, np.asarray(js), atol=ATOL, rtol=0)


@pytest.mark.parametrize("form", ["features", "rows"])
def test_serve_fn_matches_jax_at_every_bucket(models, form):
    jax_api, api = _apis(models)
    gal, rf, rp = _arrays(11, 21)
    kw = dict(ref_features=rf, ref_patches=rp) if form == "rows" else {}
    jfn = jax_api.build_serve_fn(gal, k_max=7, **kw)
    tfn = api.build_serve_fn(gal, k_max=7, **kw)
    assert tfn.buckets == jfn.buckets == (1, 8, 32)
    assert (tfn.by_rows, tfn.growable, tfn.capacity, tfn.k_max) == (
        jfn.by_rows, jfn.growable, jfn.capacity, jfn.k_max)
    g = np.random.default_rng(0)
    if form == "rows":
        ref_of = lambda n: (g.integers(0, 21, n),)  # noqa: E731
    else:
        ref_of = lambda n: (rf[g.integers(0, 21, n)], rp[g.integers(0, 21, n)])  # noqa: E731
    _check_fn(jfn, tfn, (1, 5, 8, 20), ref_of)


@pytest.mark.parametrize("flags", [{}, dict(quantize_gallery=True), dict(quantize_refs=True),
                                   dict(approx_recall=0.95)])
def test_growable_serve_fn_matches_jax_after_updates(models, flags):
    jax_api, api = _apis(models, **flags)
    gal, rf, rp = _arrays(21, 15)
    jfn = jax_api.build_serve_fn(gal, k_max=7, buckets=(4,), ref_features=rf, ref_patches=rp,
                                 capacity=40)
    tfn = api.build_serve_fn(gal, k_max=7, buckets=(4,), ref_features=rf, ref_patches=rp,
                             capacity=40)
    assert tfn.growable and tfn.n_valid() == jfn.n_valid() == 15
    rows = lambda n: (np.asarray([0, 14, 3, 9][:n]),)  # noqa: E731
    _check_fn(jfn, tfn, (2, 4), rows)
    added = _arrays(23, 6)
    assert tfn.update_rows(15, *added) == jfn.update_rows(15, *added) == 21
    over = _arrays(25, 3)
    assert tfn.update_rows(4, *over) == jfn.update_rows(4, *over) == 21
    _check_fn(jfn, tfn, (3, 4), lambda n: (np.asarray([0, 17, 20, 5][:n]),))
    ids = crc_tokenizer(["is red"], CTX)
    _, idx = tfn(ids, [5], k=30)
    assert idx.shape == (1, 7) and int(idx.max()) < 21


def test_quantized_refs_are_int8_on_the_device(models):
    _, api = _apis(models, quantize_refs=True, quantize_gallery=True)
    gal, rf, rp = _arrays(7, 21)
    fn = api.build_serve_fn(gal, k_max=7, ref_features=rf, ref_patches=rp)
    assert fn.ref_f[0].dtype == fn.ref_p[0].dtype == fn.gallery[0].dtype == torch.int8
    assert fn.ref_p[1].shape == (21, PATCH_NUM)


def test_tme_serve_fn_matches_jax():
    jm, variables, tm = _both_tme_models(tiny_config)
    jax_api = JE.InferenceAPI(jm, variables, batch_size=8, context_length=CTX,
                              tokenizer=crc_tokenizer)
    api = InferenceAPI(tm, tokenizer=crc_tokenizer, device="cpu", batch_size=8,
                       context_length=CTX)
    gal, rf, rp = _arrays(31, 21)
    jfn = jax_api.build_serve_fn(gal, k_max=7, buckets=(1, 8), ref_features=rf,
                                 ref_patches=rp, capacity=32)
    tfn = api.build_serve_fn(gal, k_max=7, buckets=(1, 8), ref_features=rf, ref_patches=rp,
                             capacity=32)
    _check_fn(jfn, tfn, (1, 6), lambda n: (np.arange(n) * 3,))


def test_serve_fn_errors(models):
    _, api = _apis(models)
    gal, rf, rp = _arrays(28, 10)
    with pytest.raises(ValueError, match="capacity 5 < current"):
        api.build_serve_fn(gal, ref_features=rf, ref_patches=rp, capacity=5)
    with pytest.raises(ValueError, match="by-rows"):
        api.build_serve_fn(gal, capacity=20)
    mesh = create_mesh(device="cpu")
    with pytest.raises(ValueError, match="single-device"):
        api.build_serve_fn(gal, ref_features=rf, ref_patches=rp, mesh=mesh, capacity=12)
    with pytest.raises(ValueError, match="by-rows"):
        api.build_serve_fn(gal, mesh=mesh)
    grow = api.build_serve_fn(gal, k_max=7, buckets=(4,), ref_features=rf, ref_patches=rp,
                              capacity=12)
    more = _arrays(29, 5)
    with pytest.raises(ValueError, match="exceeds capacity"):
        grow.update_rows(10, *more)
    with pytest.raises(ValueError, match="don't agree"):
        grow.update_rows(10, more[0][:2], more[1][:1], more[2][:2])
    assert grow.n_valid() == 10
    with pytest.raises(ValueError, match="without capacity"):
        api.build_serve_fn(gal, ref_features=rf, ref_patches=rp).update_rows(10, *more)
    with pytest.raises(ValueError, match="largest compile bucket 4"):
        grow(crc_tokenizer(["x"] * 5, CTX), np.zeros(5, np.int64))


# --- the micro-batcher (TestMicroBatcher) ----------------------------------------


def test_concurrent_singles_coalesce_and_stay_correct(service):
    b = MicroBatcher(service, max_batch=8, max_wait_ms=30.0)
    try:
        reqs = [(f"img{i % 12}", f"caption {i} words", 3) for i in range(16)]
        with futures.ThreadPoolExecutor(16) as pool:
            got = list(pool.map(lambda r: b.submit(*r)[0], reqs))
        for (ref, cap, k), res in zip(reqs, got):
            want, _ = service.query([ref], [cap], k=k)
            assert [x["name"] for x in res] == [x["name"] for x in want[0]]
            assert len(res) == k
        assert b.batches_run < 16
        assert b.items_run == 16
    finally:
        b.close()


def test_unknown_ref_fails_fast_without_poisoning(service):
    b = MicroBatcher(service, max_batch=4, max_wait_ms=5.0)
    try:
        with pytest.raises(KeyError):
            b.submit("ghost", "x", 3)
        res, _ = b.submit("img1", "still works", 2)
        assert len(res) == 2
    finally:
        b.close()


def test_http_singles_share_batches(base_url):
    def post_one(i):
        return _post(f"{base_url}/query", {"ref_name": f"img{i % 12}",
                                           "caption": f"belted {i}", "k": 2})

    with futures.ThreadPoolExecutor(8) as pool:
        outs = list(pool.map(post_one, range(8)))
    assert all(len(o["results"]) == 2 for o in outs)
    stats = _get(f"{base_url}/stats")
    assert "dynamic_batching" in stats
    assert stats["dynamic_batching"]["items"] >= 8


# --- live adds (TestLiveAdds) -----------------------------------------------------


def _add(svc, items, names=None):
    return svc.add_items(names or [it["name"] for it in items],
                         np.stack([it["image"] for it in items]),
                         np.stack([it["patch"] for it in items]))


def test_add_items_matches_rebuild(models):
    base, new = _items(1, 12), _items(2, 3, prefix="new")
    svc = _service(models, base, capacity=20, warmup=False)
    jsvc = _service(models, base, side="jax", capacity=20)
    out = _add(svc, new)
    assert out["added"] == 3 and out["gallery_size"] == 15 and svc.gallery_size == 15
    _add(jsvc, new)
    res, _ = svc.query(["new1", "img0"], ["is red", "short"], k=15)
    assert {"new0", "new1", "new2"} & ({r["name"] for r in res[0]} | {r["name"] for r in res[1]})
    _same(res, jsvc.query(["new1", "img0"], ["is red", "short"], k=15)[0])
    rebuilt = _service(models, base + new)
    res2, _ = rebuilt.query(["new1", "img0"], ["is red", "short"], k=15)
    for a, b in zip(res, res2):
        assert [x["name"] for x in a] == [x["name"] for x in b]
    # the large-k path (k > k_max) runs over the rebuilt index
    svc._serve_fn.k_max = 5
    big1, _ = svc.query(["new0"], ["is red"], k=14)
    big2, _ = rebuilt.query(["new0"], ["is red"], k=14)
    assert [x["name"] for x in big1[0]] == [x["name"] for x in big2[0]]


def test_add_requires_capacity(models):
    svc = _service(models, _items(3, 6), warmup=False)
    with pytest.raises(ValueError, match="capacity"):
        _add(svc, _items(4, 1))


def test_add_from_paths_http(models, tmp_path):
    from PIL import Image

    svc = _service(models, _items(5, 8), capacity=16, warmup=False,
                   image_spec=dict(dim=32, pad_mode="target", target_ratio=1.25),
                   add_root=str(tmp_path))
    httpd = serve(svc, port=0, dynamic_batching=False)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        g = np.random.default_rng(9)
        Image.fromarray((g.random((48, 40, 3)) * 255).astype(np.uint8)).save(
            tmp_path / "fresh.jpg", quality=90)
        np.save(tmp_path / "fresh.npy", g.standard_normal((PATCH_NUM, D)).astype(np.float32))
        item = {"name": "fresh", "image_path": str(tmp_path / "fresh.jpg"),
                "patch_path": str(tmp_path / "fresh.npy")}
        assert _post(f"{url}/add", {"items": [item]})["gallery_size"] == 9
        res = _post(f"{url}/query", {"ref_name": "fresh", "caption": "is red", "k": 3})
        assert len(res["results"]) == 3
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{url}/add", {"items": [dict(item, image_path="/etc/hostname")]})
        assert e.value.code == 409
    finally:
        httpd.shutdown()


def test_re_add_replaces_in_place(models):
    base, repl = _items(6, 10), _items(7, 2, prefix="x")
    svc = _service(models, base, capacity=16, warmup=False)
    jsvc = _service(models, base, side="jax", capacity=16)
    out = _add(svc, repl, names=["img3", "x0"])
    assert out == {**out, "added": 1, "replaced": 1, "gallery_size": 11}
    _add(jsvc, repl, names=["img3", "x0"])
    base2 = [dict(it) for it in base]
    base2[3] = {"name": "img3", "image": repl[0]["image"], "patch": repl[0]["patch"]}
    rebuilt = _service(models, base2 + [dict(repl[1], name="x0")])
    r1, _ = svc.query(["img3", "x0"], ["is red", "short"], k=11)
    r2, _ = rebuilt.query(["img3", "x0"], ["is red", "short"], k=11)
    for a, b in zip(r1, r2):
        assert [x["name"] for x in a] == [x["name"] for x in b]
    _same(r1, jsvc.query(["img3", "x0"], ["is red", "short"], k=11)[0])
    for row in r1:
        ns = [x["name"] for x in row]
        assert len(ns) == len(set(ns))


# --- the serve CLI ----------------------------------------------------------------

CLI_NAME = "tiny-serve"


def _cli_config():
    return torch_config.CLIPConfig(
        name=CLI_NAME,
        vision=torch_config.VisionConfig(kind="vit", image_size=32, embed_dim=D, width=64,
                                         layers=2, heads=4, patch_size=16),
        text=torch_config.TextConfig(vocab_size=600, context_length=CTX, width=32, heads=4,
                                     layers=2, embed_dim=D))


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    return jax_make_fixture(str(tmp_path_factory.mktemp("serve_fx")), "fashioniq", dim=D,
                            patch_num=PATCH_NUM, seed=1, n_images=10, n_triplets=6)


def _serve_args(root, **kw):
    base = dict(dataset="fashioniq", data_root=root, clip_model_name=CLI_NAME,
                patch_num=PATCH_NUM, num_workers=0, worker_type="thread", target_ratio=1.25,
                transform="targetpad", image_dtype="float32",
                bpe_path=os.path.join(root, "bpe.txt.gz"), clip_path=None,
                fusion_model_path=None, seed=None, batch_size=8, split="val",
                quantize_towers=False, quantize_gallery=False, quantize_refs=False,
                topk_recall=None, fold_bn=False, data_parallel=False, precision="fp32",
                capacity=None, tme=False, device="cpu")
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("flags", [{}, dict(quantize_gallery=True, quantize_refs=True,
                                            topk_recall=0.95, capacity=64)])
def test_build_service_and_http(monkeypatch, fixture_root, flags):
    monkeypatch.setitem(torch_config._CONFIGS, CLI_NAME, _cli_config())
    service = cli.build_service(_serve_args(fixture_root, **flags))
    assert service.gallery_size > 0
    assert service._serve_fn.quantized == bool(flags)
    assert service._serve_fn.capacity == flags.get("capacity")
    assert service.measured_topk_recall == (1.0 if flags else None)
    httpd = serve(service, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        ref = service.gallery.names[0]
        data = _post(f"{url}/query", {"ref_name": ref, "caption": "low red", "k": 2})
        assert len(data["results"]) == 2
        assert data["results"] == service.query([ref], ["low red"], k=2)[0][0]
    finally:
        httpd.shutdown()
        service.batcher.close()


def test_serve_data_parallel_raises(fixture_root, monkeypatch):
    """`--data-parallel` of many ranks without torchrun's coordinator
    raises before any group starts (the sharded service itself:
    tests/test_torch_parallel.py)."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        cli.build_service(_serve_args(fixture_root, data_parallel=True))


_SERVE_MAIN = """
import sys
from fashionern_aaai2024_tpu_torch.cli import main as cli
from fashionern_aaai2024_tpu_torch.models.clip import config as C
C._CONFIGS[{name!r}] = C.CLIPConfig(
    name={name!r},
    vision=C.VisionConfig(kind="vit", image_size=32, embed_dim={d}, width=64, layers=2,
                          heads=4, patch_size=16),
    text=C.TextConfig(vocab_size=600, context_length={ctx}, width=32, heads=4, layers=2,
                      embed_dim={d}))
sys.exit(cli.main(sys.argv[1:]))
"""


def test_serve_command_answers_over_http(fixture_root, tmp_path):
    """`fashionern-torch serve --device cpu --capacity` in its own
    process: /healthz, /query (single and batch), /add, /stats."""
    from PIL import Image

    code = _SERVE_MAIN.format(name=CLI_NAME, d=D, ctx=CTX)
    argv = [sys.executable, "-c", code, "serve", "--dataset", "fashioniq", "--data-root",
            fixture_root, "--clip-model-name", CLI_NAME, "--bpe-path",
            os.path.join(fixture_root, "bpe.txt.gz"), "--num-workers", "0", "--batch-size",
            "8", "--device", "cpu", "--precision", "fp32", "--port", "0", "--capacity", "32"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
         os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="2")
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env)
    try:
        url = None
        for line in proc.stdout:
            if line.startswith("serving "):
                url = line.split(" on ")[1].split()[0]
                break
        assert url is not None, proc.stderr.read()
        health = _get(f"{url}/healthz")
        assert health["status"] == "ok"
        n = health["gallery_size"]
        names = sorted(os.listdir(os.path.join(fixture_root, "images")))
        ref = os.path.splitext(names[0])[0]
        one = _post(f"{url}/query", {"ref_name": ref, "caption": "is red", "k": 3})
        assert len(one["results"]) == 3
        two = _post(f"{url}/query", {"ref_names": [ref, ref], "captions": ["is red", "blue"],
                                     "k": 2})
        assert len(two["results"]) == 2
        _same(two["results"][:1], [one["results"][:2]])   # buckets 8 and 1
        img = tmp_path / "new.png"
        Image.fromarray(np.full((40, 36, 3), 120, np.uint8)).save(img)
        added = os.path.join(fixture_root, "added")
        os.makedirs(added, exist_ok=True)
        Image.open(img).save(os.path.join(added, "new.png"))
        np.save(os.path.join(added, "new.npy"), np.ones((PATCH_NUM, D), np.float32))
        out = _post(f"{url}/add", {"items": [{
            "name": "brand-new", "image_path": os.path.join(added, "new.png"),
            "patch_path": os.path.join(added, "new.npy")}]})
        assert out["added"] == 1 and out["gallery_size"] == n + 1
        res = _post(f"{url}/query", {"ref_name": "brand-new", "caption": "is red", "k": 2})
        assert len(res["results"]) == 2
        stats = _get(f"{url}/stats")
        assert stats["requests"] >= 3 and stats["gallery_size"] == n + 1
    finally:
        proc.terminate()
        proc.wait(timeout=30)


# --- the graph layer (ops/graphs.py, ops/block.py) --------------------------------


def _kernel_wrappers():
    """Every function of the port's `ops` modules that carries an integer
    `launches` counter."""
    import importlib
    import pkgutil

    from fashionern_aaai2024_tpu_torch import ops

    found = set()
    for info in pkgutil.iter_modules(ops.__path__):
        module = importlib.import_module(f"{ops.__name__}.{info.name}")
        found.update(v for v in vars(module).values()
                     if callable(v) and getattr(v, "__module__", None) == module.__name__
                     and isinstance(getattr(v, "launches", None), int))
    return found


def test_launch_counters_are_every_kernel_wrapper():
    """Each kernel wrapper counts its launches through `common.count`, once
    in its module (in the wrapper, or in the registered entry that it
    calls: `attention.py mha`, `combiner.py combiner`), so that a capture
    records them."""
    import inspect

    from fashionern_aaai2024_tpu_torch.ops import attention as A
    from fashionern_aaai2024_tpu_torch.ops import block, combiner, layernorm, losses, mlp, qmlp

    want = {A.attention_subblock, A.packed_qkv_self_attention, A.fused_qkv_self_attention,
            A.packed_kv_cross_attention, A.wide_cross_attention, A.multi_head_attention,
            mlp.mlp_subblock,
            block.transformer_block, layernorm.layer_norm, combiner.combiner_apply,
            losses.bbc_rowloss, qmlp.int8_mlp_subblock, qmlp.int8_attention_subblock}
    got = _kernel_wrappers()
    assert want <= got and len(got) == len(want) + 4   # and X1-X4 of the experiment
    for wrapper in got:
        source = inspect.getsource(inspect.getmodule(wrapper))
        assert source.count(f"common.count({wrapper.__name__})") == 1, wrapper.__name__
        assert "launches +=" not in source, wrapper.__name__


def test_recording_keeps_to_its_thread():
    """`common.recording` records the launches of its own thread; another
    thread's launches move the counters and are not recorded."""
    from fashionern_aaai2024_tpu_torch.ops import common

    def wrapper():
        pass
    wrapper.launches = 0
    with common.recording() as record:
        common.count(wrapper)
        other = threading.Thread(target=lambda: [common.count(wrapper) for _ in range(5)])
        other.start()
        other.join()
        common.count(wrapper)
    common.count(wrapper)
    assert wrapper.launches == 8 and record.wrappers == {wrapper: 2}
    assert not record.entries


@pytest.mark.parametrize("name, kernel", [
    ("_ZN4fern12block_kernelI13__nv_bfloat16EEvNS_9BlockArgsIT_EE", "block_kernel"),
    ("_ZN4fern16layernorm_kernelI13__nv_bfloat16Li2EEEvPKT_S4_S4_PS2_iif", "layernorm_kernel"),
    ("void fern::block_kernel<__nv_bfloat16>(fern::BlockArgs<__nv_bfloat16>)", "block_kernel"),
    ("void fern::attention_mma_kernel<__nv_bfloat16, 64, false, 1>(fern::AttnArgs)",
     "attention_mma_kernel"),
    ("void fern::grouped_attention_mma_kernel<64, false>(fern::GroupedArgs)",
     "grouped_attention_mma_kernel"),
    ("_ZN4fern28grouped_attention_mma_kernelILi64ELb0EEEvNS_11GroupedArgsE",
     "grouped_attention_mma_kernel"),
    ("_ZN4fern12qgemm_kernelILi128ELi4ELi1EEEvNS_9QGemmArgsE", "qgemm_kernel"),
    ("nvjet_tst_64x8_64x16_2x4_h_bz_NNT", None),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>(float)", None),
])
def test_port_kernel_reads_libcuda_and_profiler_names(name, kernel):
    """A kernel node's name from libcuda (mangled) or the profiler
    (demangled) names its port kernel; cuBLAS and PyTorch kernels none."""
    from fashionern_aaai2024_tpu_torch.ops.graphs import port_kernel

    assert port_kernel(name) == kernel


def test_kernel_entry_table_covers_the_sources():
    """Every `__global__` kernel of `csrc/` has its C entry point in the
    graph check's table, and every entry point of the library has its
    kernels there."""
    import re
    from pathlib import Path

    from fashionern_aaai2024_tpu_torch.ops import common
    from fashionern_aaai2024_tpu_torch.ops.graphs import KERNEL_ENTRY

    kernels = set()
    for path in Path(common.CSRC_DIR).iterdir():
        kernels.update(re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
                                  path.read_text()))
    assert kernels == set(KERNEL_ENTRY)
    assert set(KERNEL_ENTRY.values()) == set(common._SIGNATURES)


@pytest.mark.parametrize("nodes, entries, ok", [
    (["block_kernel"] * 2 + ["layernorm_kernel", "nvjet_x"], {"fern_block": 2,
                                                              "fern_layernorm": 1}, True),
    (["block_kernel", "layernorm_kernel"], {"fern_block": 2, "fern_layernorm": 1}, False),
    (["block_kernel"] * 3 + ["layernorm_kernel"], {"fern_block": 2, "fern_layernorm": 1}, False),
    (["attention_mma_kernel", "attention_tf32_kernel"], {"fern_attention": 2}, True),
    (["bbc_partial_kernel", "bbc_combine_kernel"], {"fern_bbc_rowloss": 1}, True),
    (["bbc_partial_kernel"], {"fern_bbc_rowloss": 1}, False),
    (["gemm_bf16_kernel"], {}, False),
])
def test_graph_check_holds_nodes_to_the_recorded_launches(nodes, entries, ok):
    """The capture's check: the graph's port kernel nodes are the kernels
    of the C calls that the capture recorded, one node for each (two for
    the BBC loss's entry point), other kernels ignored; a missing or an
    extra node raises."""
    import collections

    from fashionern_aaai2024_tpu_torch.ops.graphs import check_graph_launches

    if ok:
        got = check_graph_launches(collections.Counter(entries), nodes)
        assert got == collections.Counter(n for n in nodes if not n.startswith("nvjet"))
    else:
        with pytest.raises(RuntimeError, match="captured graph"):
            check_graph_launches(collections.Counter(entries), nodes)


def test_serve_fn_builds_every_bucket_at_once(models):
    """Every bucket exists when `build_serve_fn` returns (on the card: its
    graph is captured then), and `warmup` adds none."""
    api = InferenceAPI(models[2], tokenizer=None, device="cpu", context_length=CTX)
    g = np.random.default_rng(3)
    fn = api.build_serve_fn(g.standard_normal((20, D)).astype(np.float32), k_max=5,
                            buckets=(8, 1, 4))
    buckets = dict(fn._buckets)
    assert list(buckets) == [1, 4, 8]
    fn.warmup()
    assert fn._buckets == buckets


def test_b10_under_capture_needs_a_graph_barrier_word(monkeypatch):
    """A capture without a word of its own raises; inside `graph_barrier`
    every B10 launch takes that word, eager calls their stream's."""
    from fashionern_aaai2024_tpu_torch.ops import block

    word = torch.zeros(1, dtype=torch.int32)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="graph_barrier"):
        block._barrier(torch.device("cpu"), 7)
    with block.graph_barrier(word):
        assert block._barrier(torch.device("cpu"), 7) is word
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    eager = block._barrier(torch.device("cpu"), 7)
    assert eager is not word and block._barrier(torch.device("cpu"), 7) is eager
    block._BARRIERS.pop((None, 7))


def test_eval_pipeline_approx_matches_exact_and_jax(models):
    """`eval --topk-recall` on the CPU: the evaluator's search takes the
    approximate tier, which is the exact sort there (JAX
    tests/test_evaluate.py TestApproxTopK.test_eval_pipeline_matches_exact),
    and the recalls equal JAX's."""
    from fashionern_aaai2024_tpu.retrieval import evaluate as JEv
    from fashionern_aaai2024_tpu_torch.retrieval import evaluate as TEv

    names = [f"img{i}" for i in range(20)]
    gallery = _items(7, 20)
    g = np.random.default_rng(13)
    rel = [{"ref_name": names[i], "tar_name": names[(i + 3) % 20],
            "captions": ["is red", "has sleeves"],
            "ref_patch": g.standard_normal((PATCH_NUM, D)).astype(np.float32)}
           for i in range(10)]
    out = {}
    for approx in (None, 0.95):
        jax_api, api = _apis(models, approx_recall=approx)
        out[approx] = TEv.evaluate_fiq_split(api, Loader(gallery, 8, num_workers=0),
                                             Loader(rel, 8, num_workers=0), ks=(1, 5))
        out[("jax", approx)] = JEv.evaluate_fiq_split(jax_api, Loader(gallery, 8, num_workers=0),
                                                      Loader(rel, 8, num_workers=0), ks=(1, 5))
    assert out[0.95] == out[None] == out[("jax", 0.95)] == out[("jax", None)]
