"""The port's native serving front (`native/fastserve.cpp`,
`native/serve_frontend.py`) through real sockets, mirroring
tests/test_native_serve.py case for case:

  * stub-backed: a fake serve program pins the protocol (batching, the
    Python tokenizer for the rows the C core flags, errors, live name
    swaps);
  * the port's tokenizer on the IO thread: the ids equal the Python
    path's, the JAX tokenizer's too, for the same merges;
  * the tiny model: the port's RetrievalService behind the native front
    answers what the Python front and the JAX service answer.

JAX's sanitizer leg (`fastserve_fuzz.cpp`) is not ported (ROADMAP A1).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from fashionern_aaai2024_tpu.data.loader import Loader
from fashionern_aaai2024_tpu.models.clip.tokenizer import SimpleTokenizer as JaxTokenizer
from fashionern_aaai2024_tpu.retrieval import evaluate as JE
from fashionern_aaai2024_tpu.retrieval.server import RetrievalService as JaxService
from fashionern_aaai2024_tpu_torch.models.clip.tokenizer import SimpleTokenizer, learn_merges
from fashionern_aaai2024_tpu_torch.native import serve_frontend as SF
from fashionern_aaai2024_tpu_torch.retrieval.evaluate import InferenceAPI
from fashionern_aaai2024_tpu_torch.retrieval.server import RetrievalService
from torch_port_helpers import CTX, D, PATCH_NUM, both_models, crc_tokenizer, tiny_config

torch.set_num_threads(2)


def _post(url, payload, timeout=30):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _post_err(url, payload) -> tuple[int, dict]:
    try:
        _post(url, payload)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    raise AssertionError("expected an HTTP error")


# --- stubs -------------------------------------------------------------------------


class StubServeFn:
    """The serve program's interface; the scores encode the row and the
    first token id, so a test sees what reached the device thread."""

    k_max = 5
    buckets = (1, 4, 8)

    def __init__(self):
        self.seen = []
        self.raise_next = None

    def __call__(self, ids, rows, k=10):
        if self.raise_next is not None:
            e, self.raise_next = self.raise_next, None
            raise e
        self.seen.append((np.array(ids), np.array(rows), k))
        n = ids.shape[0]
        k = min(k, self.k_max)
        idx = np.tile(np.arange(k, dtype=np.int32), (n, 1))
        scores = (rows[:, None].astype(np.float32) * 1000.0 + ids[:, 1:2].astype(np.float32)
                  - np.arange(k, dtype=np.float32))
        return scores, idx


class StubAPI:
    def __init__(self, tokenizer, ctx):
        self._tokenizer = tokenizer
        self.context_length = ctx

    def tokenize(self, caps):
        return self._tokenizer(caps, self.context_length)


class StubService:
    def __init__(self, names, tokenizer, ctx=CTX, caption_join=None):
        self.gallery = type("G", (), {})()
        self.gallery.names = list(names)
        self.api = StubAPI(tokenizer, ctx)
        self._serve_fn = StubServeFn()
        self.caption_join = caption_join or (lambda c: c)
        self.caption_join_is_identity = caption_join is None


@pytest.fixture()
def stub():
    svc = StubService([f"img{i}" for i in range(10)], crc_tokenizer)
    ns = SF.serve_native(svc, port=0)
    yield svc, ns, f"http://127.0.0.1:{ns.port}"
    ns.shutdown()


def test_healthz_and_stats(stub):
    _, _, url = stub
    assert _get(f"{url}/healthz") == {"status": "ok", "gallery_size": 10}
    s = _get(f"{url}/stats")
    assert s["native_frontend"] is True and s["gallery_size"] == 10


def test_single_query_roundtrip(stub):
    svc, _, url = stub
    out = _post(f"{url}/query", {"ref_name": "img3", "caption": "red dress", "k": 3})
    assert len(out["results"]) == 3 and out["results"][0]["name"] == "img0"
    ids, rows, _ = svc._serve_fn.seen[-1]
    assert rows[0] == 3
    np.testing.assert_array_equal(ids[0], crc_tokenizer(["red dress"])[0])
    assert out["results"][0]["score"] == pytest.approx(3000.0 + float(ids[0, 1]))


def test_client_batch(stub):
    svc, _, url = stub
    out = _post(f"{url}/query", {"ref_names": ["img1", "img2"],
                                 "captions": ["blue shoes", "green hat"], "k": 2})
    assert len(out["results"]) == 2 and all(len(r) == 2 for r in out["results"])
    _, rows, _ = svc._serve_fn.seen[-1]
    assert list(rows[:2]) == [1, 2]


def test_unknown_ref_404(stub):
    _, _, url = stub
    code, body = _post_err(f"{url}/query", {"ref_name": "nope", "caption": "x", "k": 2})
    assert code == 404 and "nope" in body["error"]


def test_bad_json_400(stub):
    _, _, url = stub
    req = urllib.request.Request(f"{url}/query", data=b"{not json", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=10)
    assert e.value.code == 400


def test_k_above_kmax_400(stub):
    _, _, url = stub
    code, body = _post_err(f"{url}/query", {"ref_name": "img0", "caption": "x", "k": 99})
    assert code == 400 and "k_max" in body["error"]


def test_caption_too_long_400(stub):
    _, _, url = stub
    code, body = _post_err(f"{url}/query", {"ref_name": "img0",
                                            "caption": "y" * (SF.MAX_CAPTION + 1024)})
    assert code == 400 and "caption too long" in body["error"]


def test_admin_endpoints_501(stub):
    _, _, url = stub
    for path in ("/add", "/reload"):
        code, body = _post_err(f"{url}{path}", {"items": []})
        assert code == 501 and "admin" in body["error"]


def test_unknown_path_404(stub):
    _, _, url = stub
    code, _ = _post_err(f"{url}/wat", {})
    assert code == 404


def test_dispatch_failure_500(stub):
    svc, _, url = stub
    svc._serve_fn.raise_next = RuntimeError("device exploded")
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{url}/query", {"ref_name": "img0", "caption": "x", "k": 2})
    assert e.value.code == 500 and "device exploded" in json.loads(e.value.read())["error"]
    out = _post(f"{url}/query", {"ref_name": "img1", "caption": "y", "k": 5})
    assert len(out["results"]) == 5


def test_live_name_swap(stub):
    svc, _, url = stub
    svc.gallery.names.append("newitem")
    svc.names_changed_cb()  # what add_items calls
    out = _post(f"{url}/query", {"ref_name": "newitem", "caption": "z", "k": 1})
    _, rows, _ = svc._serve_fn.seen[-1]
    assert rows[0] == 10 and out["results"]


def test_concurrent_singles_coalesce(stub):
    svc, _, url = stub
    n0 = len(svc._serve_fn.seen)
    results = {}

    def one(i):
        results[i] = _post(f"{url}/query", {"ref_name": f"img{i % 10}", "caption": f"cap {i}",
                                            "k": 1})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(results) == 16
    assert sum(r[0].shape[0] for r in svc._serve_fn.seen[n0:]) == 16
    for i, out in results.items():
        ids = crc_tokenizer([f"cap {i}"])[0]
        assert out["results"][0]["score"] == pytest.approx(float(i % 10) * 1000.0 + ids[1])
    s = _get(f"{url}/stats")
    assert s["dynamic_batching"]["items"] >= 16 and s["latency_ms"]["p50"] is not None


# --- IO-thread tokenization --------------------------------------------------------


def test_io_thread_ids_match_python_and_jax():
    corpus = ("a red dress with long sleeves and a blue floral print shirt is shown darker "
              "more colorful").split()
    merges = learn_merges(corpus, 120)
    tok = SimpleTokenizer(merges=merges)
    jax_tok = JaxTokenizer(merges=merges)
    svc = StubService([f"img{i}" for i in range(4)], lambda caps, ctx: tok(caps, ctx))
    api = InferenceAPI.__new__(InferenceAPI)
    api._tokenizer, api.context_length = tok, CTX
    svc.api = api
    assert SF._service_merges(svc) == tok._merges
    sf = SF.NativeFrontend(svc.gallery.names, ctx=CTX, max_batch=8, k_max=5, merges=merges)
    sf.listen("127.0.0.1", 0)
    t = threading.Thread(target=SF._device_loop, args=(sf, svc), daemon=True)
    t.start()
    url = f"http://127.0.0.1:{sf.port}"
    try:
        caps = ["a red dress", "blue floral\tshirt", "DARKER  print"]
        _post(f"{url}/query", {"ref_names": ["img0", "img1", "img2"], "captions": caps,
                               "k": 1})
        ids, _, _ = svc._serve_fn.seen[-1]
        np.testing.assert_array_equal(ids[:3], tok.python_ids(caps, CTX))
        np.testing.assert_array_equal(ids[:3], jax_tok(caps, CTX))
        _post(f"{url}/query", {"ref_name": "img3", "caption": "café", "k": 1})
        ids2, _, _ = svc._serve_fn.seen[-1]
        np.testing.assert_array_equal(ids2[0], tok(["café"], CTX)[0])
    finally:
        sf.shutdown()
        t.join(timeout=10)
        sf.close()


def test_custom_caption_join_or_tokenizer_keeps_python_tokenization():
    svc = StubService(["a"], crc_tokenizer, caption_join=str.upper)
    assert SF._service_merges(svc) is None
    svc = StubService(["a"], crc_tokenizer)
    assert SF._service_merges(svc) is None   # no `api._tokenizer` of the port's BPE


# --- the tiny model ---------------------------------------------------------------------


def _items(n=12, seed=1):
    g = np.random.default_rng(seed)
    return [{"name": f"img{i}", "image": g.random((32, 32, 3), dtype=np.float32),
             "patch": g.standard_normal((PATCH_NUM, D)).astype(np.float32)}
            for i in range(n)]


@pytest.fixture(scope="module")
def models():
    return both_models(tiny_config)


@pytest.fixture(scope="module")
def tiny_service(models):
    _, _, tm = models
    api = InferenceAPI(tm, tokenizer=crc_tokenizer, device="cpu", batch_size=8,
                       context_length=CTX)
    return RetrievalService(api, Loader(_items(), 8, num_workers=0))


def test_native_front_matches_python_and_jax_services(models, tiny_service):
    jm, variables, _ = models
    jax_api = JE.InferenceAPI(jm, variables, batch_size=8, context_length=CTX,
                              tokenizer=crc_tokenizer)
    jax_service = JaxService(jax_api, Loader(_items(), 8, num_workers=0), warmup=False)
    ns = SF.serve_native(tiny_service, port=0)
    url = f"http://127.0.0.1:{ns.port}"
    try:
        refs, caps = ["img2", "img7"], ["make it red", "longer sleeves"]
        out = _post(f"{url}/query", {"ref_names": refs, "captions": caps, "k": 4})
        for want, _ in (tiny_service.query(refs, caps, k=4), jax_service.query(refs, caps, k=4)):
            for got_row, want_row in zip(out["results"], want, strict=True):
                assert [r["name"] for r in got_row] == [r["name"] for r in want_row]
                np.testing.assert_allclose([r["score"] for r in got_row],
                                           [r["score"] for r in want_row], atol=2e-4, rtol=0)
        assert _get(f"{url}/healthz")["gallery_size"] == 12
    finally:
        ns.shutdown()


def test_live_add_visible_through_native_front(models):
    _, _, tm = models
    api = InferenceAPI(tm, tokenizer=crc_tokenizer, device="cpu", batch_size=8,
                       context_length=CTX)
    g = np.random.default_rng(5)
    svc = RetrievalService(api, Loader(_items(8, seed=5), 8, num_workers=0), capacity=12,
                           warmup=False)
    ns = SF.serve_native(svc, port=0)
    url = f"http://127.0.0.1:{ns.port}"
    try:
        code, _ = _post_err(f"{url}/query", {"ref_name": "fresh", "caption": "x", "k": 1})
        assert code == 404
        svc.add_items(["fresh"], g.random((1, 32, 32, 3), dtype=np.float32),
                      g.standard_normal((1, PATCH_NUM, D)).astype(np.float32))
        out = _post(f"{url}/query", {"ref_name": "fresh", "caption": "make it red", "k": 3})
        assert len(out["results"]) == 3
        want = svc.query(["fresh"], ["make it red"], k=3)[0][0]
        assert [r["name"] for r in out["results"]] == [r["name"] for r in want]
        # the C front prints 6 significant digits
        np.testing.assert_allclose([r["score"] for r in out["results"]],
                                   [r["score"] for r in want], rtol=1e-5, atol=0)
        assert _get(f"{url}/healthz")["gallery_size"] == 9
    finally:
        ns.shutdown()


def test_sequential_singles_reuse_daemon(tiny_service):
    ns = SF.serve_native(tiny_service, port=0)
    url = f"http://127.0.0.1:{ns.port}"
    try:
        t0 = time.time()
        for i in range(5):
            out = _post(f"{url}/query", {"ref_name": f"img{i}", "caption": "x", "k": 1})
            assert len(out["results"]) == 1
        assert time.time() - t0 < 60
        assert _get(f"{url}/stats")["requests"] >= 5
    finally:
        ns.shutdown()


def test_failed_build_raises(monkeypatch, tmp_path):
    """No silent Python fallback: a source that does not compile raises
    with the compiler's output."""
    bad = tmp_path / "fastserve.cpp"
    bad.write_text("this is not C++\n")
    lib = SF.NativeLibrary(bad, "libbad.so", [("-O0", "-shared", "-fPIC")], SF._bind,
                           includes=[SF._HERE / "fasttokenizer.cpp"])
    monkeypatch.setattr(SF, "LIBRARY", lib)
    monkeypatch.setattr(SF.NativeLibrary, "library_path",
                        lambda self, flags: tmp_path / "out" / self.name)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        SF.NativeFrontend(["a"], ctx=CTX)


class TestSanitizedFuzz:
    """Adversarial byte-level drive of the port's C++ front under
    sanitizers (tests/test_native_serve.py `TestSanitizedFuzz`, case for
    case). `native/fastserve_fuzz.cpp` embeds the port's server, a
    device-thread stub and an fs_set_names race thread, and attacks the
    socket with the committed regression corpus
    (tests/fixtures/fastserve_corpus/) plus generated hostile traffic:
    ASAN + UBSAN and TSAN builds with `g++`, 120 iterations each."""

    @pytest.fixture(scope="class")
    def fuzz_src(self):
        import os

        src = os.path.join(os.path.dirname(SF.__file__), "fastserve_fuzz.cpp")
        corpus = os.path.join(os.path.dirname(__file__), "fixtures", "fastserve_corpus")
        assert os.path.exists(src) and os.path.isdir(corpus)
        return src, corpus

    @pytest.mark.slow
    @pytest.mark.parametrize("san,iters", [("address,undefined", 120), ("thread", 120)])
    def test_fuzz_sanitizer_clean(self, fuzz_src, tmp_path, san, iters):
        import shutil
        import subprocess

        if shutil.which("g++") is None:
            pytest.skip("no g++")
        src, corpus = fuzz_src
        exe = str(tmp_path / "fuzz")
        build = subprocess.run(["g++", "-O1", "-g", f"-fsanitize={san}", "-pthread",
                                "-std=c++17", src, "-o", exe],
                               capture_output=True, text=True, timeout=300)
        if build.returncode != 0:
            pytest.skip(f"sanitizer build unavailable: {build.stderr[-200:]}")
        run = subprocess.run([exe, str(iters), corpus], capture_output=True, text=True,
                             timeout=560)
        assert run.returncode == 0, run.stderr[-2000:]
        assert "control failures=0" in run.stderr
        assert "WARNING" not in run.stderr
