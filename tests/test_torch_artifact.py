"""Serve artifacts of the port (`retrieval/artifact.py`, `ops/library.py`,
`ArtifactService`, `export` / `refresh-artifact` / `serve-artifact`), on
the CPU.

Case for case the counterpart of tests/test_cli.py `TestExportArtifact`
and tests/test_evaluate.py `test_export_roundtrip`: an exported artifact
answers as the live service at every bucket (1, 8, 32), plain and with
`--quantize-gallery` (and the quantized reference rows); `refresh-artifact`
republishes the consts and reloads a running daemon; `refresh_consts`
swaps them without a re-export and refuses a shape change; `POST /reload`
swaps a running service's consts; `serve-artifact` answers over HTTP as
the live service does; its parser takes no model flag; a platform
mismatch is refused. Beyond those: a program file holds no weights,
serving an artifact imports no module of `models/` or `data/`, the
artifact answers as the JAX package's live service on the same weights
(top-k rows equal, scores at atol 2e-4, `tests/test_e2e_parity.py:147`),
and growable programs are refused.

On the CPU the exported program runs the ops' plain versions through the
same registered ops (`torch.ops.fern.*`) as the card's kernels, so the
artifact's scores equal the live program's to rtol 1e-5 (JAX's
criterion; here they are bit-equal).
"""

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
from fashionern_aaai2024_tpu_torch.ops import library
from fashionern_aaai2024_tpu_torch.retrieval import artifact as A
from fashionern_aaai2024_tpu_torch.retrieval.evaluate import InferenceAPI
from fashionern_aaai2024_tpu_torch.retrieval.server import (
    ArtifactService,
    RetrievalService,
    serve,
)
from torch_port_helpers import CTX, D, PATCH_NUM, both_models, crc_tokenizer, tiny_config

torch.set_num_threads(2)

NAME = "tiny-artifact"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one query per bucket: 1 row, 5 rows (bucket 8), 20 rows (bucket 32)
SIZES = (1, 5, 20)


def _config():
    return torch_config.CLIPConfig(
        name=NAME,
        vision=torch_config.VisionConfig(kind="vit", image_size=32, embed_dim=D, width=64,
                                         layers=2, heads=4, patch_size=16),
        text=torch_config.TextConfig(vocab_size=600, context_length=CTX, width=32, heads=4,
                                     layers=2, embed_dim=D))


@pytest.fixture(scope="module")
def fiq_root(tmp_path_factory):
    return jax_make_fixture(str(tmp_path_factory.mktemp("artifact_fx")), "fashioniq", dim=D,
                            patch_num=PATCH_NUM, seed=1, n_images=24, n_triplets=6)


@pytest.fixture(autouse=True)
def _tiny_backbone(monkeypatch, fiq_root):
    """The tiny backbone, and the fixture's BPE table for the artifact
    service's tokenizer (`serve-artifact --bpe-path` sets the same)."""
    monkeypatch.setitem(torch_config._CONFIGS, NAME, _config())
    monkeypatch.setenv("FASHIONERN_BPE_PATH", os.path.join(fiq_root, "bpe.txt.gz"))


def _args(root, **kw):
    base = dict(dataset="fashioniq", data_root=root, clip_model_name=NAME,
                patch_num=PATCH_NUM, num_workers=0, worker_type="thread", target_ratio=1.25,
                transform="targetpad", image_dtype="float32",
                bpe_path=os.path.join(root, "bpe.txt.gz"), clip_path=None,
                fusion_model_path=None, seed=None, batch_size=8, split="val",
                quantize_towers=False, quantize_gallery=False, quantize_refs=False,
                topk_recall=None, fold_bn=False, data_parallel=False, precision="fp32",
                capacity=None, tme=False, device="cpu")
    base.update(kw)
    return types.SimpleNamespace(**base)


def _captions(n):
    words = ["is red", "more blue", "has stripes", "is longer", "darker", "with a collar"]
    return [words[i % len(words)] for i in range(n)]


def _post(url, payload, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _same(got, want, rtol=1e-5, atol=0.0):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [r["name"] for r in g] == [r["name"] for r in w]
        np.testing.assert_allclose([r["score"] for r in g], [r["score"] for r in w],
                                   rtol=rtol, atol=atol)


def _artifact_results(art, service, refs, caps, k):
    ids = service.api.tokenize(caps)
    scores, rows = art.query(ids, [art.row_for(r) for r in refs], k=k)
    return [[{"name": art.names[j], "score": float(s)} for j, s in zip(rr, ss)]
            for rr, ss in zip(rows, scores)]


def _check_every_bucket(art, service, k=5):
    names = service.gallery.names
    for n in SIZES:
        refs = [names[i % len(names)] for i in range(n)]
        caps = _captions(n)
        _same(_artifact_results(art, service, refs, caps, k),
              service.query(refs, caps, k=k)[0])


@pytest.mark.parametrize("flags", [{}, {"quantize_gallery": True},
                                   {"quantize_gallery": True, "quantize_towers": True}],
                         ids=["plain", "quantize_gallery", "quantize_gallery_and_towers"])
def test_roundtrip_matches_live_service(fiq_root, tmp_path, flags):
    """`export` -> `load_serve_artifact`: the exported programs answer every
    bucket as the live service does; under `--quantize-gallery` the int8
    gallery (values + row scales) travels in the consts."""
    out = str(tmp_path / "artifact")
    manifest = cli.run_export(_args(fiq_root, out=out, **flags))
    assert manifest["kind"] == "fashionern-serve" and manifest["platform"] == "cpu"
    assert set(manifest["files"]) == {"1", "8", "32"}
    assert manifest["quantize_gallery"] == bool(flags)
    assert manifest["quantize_towers"] == bool(flags.get("quantize_towers"))
    assert manifest["torch_version"] == torch.__version__
    service = cli.build_service(_args(fiq_root, **flags))
    art = A.load_serve_artifact(out, device="cpu")
    assert art.gallery_size == service.gallery_size and art.k_max == service._serve_fn.k_max
    n_consts = len(service._serve_fn.consts)
    assert len(manifest["consts_shapes"]) == n_consts
    if flags:
        assert "int8" in manifest["consts_dtypes"]
    _check_every_bucket(art, service)


def test_export_roundtrip_with_quantized_refs(tmp_path):
    """The quantized reference rows (nested (values, scales) pairs) and the
    int8 gallery survive export -> load at a bucket of 2 (tests/
    test_evaluate.py `test_export_roundtrip`)."""
    _, _, tm = both_models(tiny_config)
    api = InferenceAPI(tm, tokenizer=crc_tokenizer, device="cpu", context_length=CTX,
                       quantize_gallery=True, quantize_refs=True)
    g = np.random.default_rng(11)
    gal = g.standard_normal((30, D)).astype(np.float32)
    ref_f = g.standard_normal((30, D)).astype(np.float32)
    ref_p = g.standard_normal((30, PATCH_NUM, D)).astype(np.float32)
    fn = api.build_serve_fn(gal, k_max=5, buckets=(2,), ref_features=ref_f,
                            ref_patches=ref_p)
    A.export_serve_artifact(fn, str(tmp_path / "art"),
                            gallery_names=[f"img{i}" for i in range(30)])
    loaded = A.load_serve_artifact(str(tmp_path / "art"), device="cpu")
    ids = crc_tokenizer(["is red", "blue"])
    s1, i1 = fn(ids, [0, 20], k=5)
    s2, i2 = loaded.query(ids, [0, 20], k=5)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, atol=1e-5)


def test_program_file_holds_no_weights(fiq_root, tmp_path):
    """Each `serve_b{B}.pt2` is the graph alone: its exported program has
    no state, no constant and no example input, and every op of the
    kernel entries it reaches is a registered `fern` op."""
    out = str(tmp_path / "artifact")
    manifest = cli.run_export(_args(fiq_root, out=out))
    consts_bytes = os.path.getsize(os.path.join(out, "consts.pt"))
    for name in manifest["files"].values():
        ep = torch.export.load(os.path.join(out, name))
        assert not ep.state_dict and not ep.constants and ep.example_inputs is None
        assert os.path.getsize(os.path.join(out, name)) < consts_bytes / 4
        targets = {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}
        fern = {t for t in targets if t.startswith("fern.")}
        # the text tower's blocks: B10 where it takes them (the card's
        # rule), B1 then B2 where not
        blocks = ({"fern.transformer_block.default"} & fern
                  or {"fern.attention_subblock.default", "fern.mlp_subblock.default"})
        assert blocks | {"fern.fused_qkv_self_attention.default", "fern.layer_norm.default",
                         "fern.combiner.default",
                         "fern.packed_kv_cross_attention.default"} <= fern, fern
    library.register_all()
    ops = [n for n in dir(torch.ops.fern)
           if isinstance(getattr(torch.ops.fern, n), torch._ops.OpOverloadPacket)]
    assert len(ops) == 11, ops


def test_refresh_artifact_cli_republishes_and_reloads_daemon(fiq_root, tmp_path):
    """`refresh-artifact --reload-url`: republishes the consts from the
    checkpoint flags (here another seed) and POSTs /reload to the running
    daemon in one command; the daemon then answers as the new live
    service."""
    out = str(tmp_path / "artifact")
    cli.run_export(_args(fiq_root, out=out))
    svc = ArtifactService(out, warmup=False, device="cpu")
    srv = serve(svc, host="127.0.0.1", port=0, dynamic_batching=False)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        before = os.path.getmtime(os.path.join(out, "consts.pt"))
        manifest = cli.run_refresh_artifact(_args(fiq_root, artifact=out, seed=5,
                                                  reload_url=url))
        assert manifest["kind"] == "fashionern-serve"
        assert os.path.getmtime(os.path.join(out, "consts.pt")) >= before
        live = cli.build_service(_args(fiq_root, seed=5))
        ref = live.gallery.names[0]
        got = _post(f"{url}/query", {"ref_name": ref, "caption": "is red", "k": 3})["results"]
        _same([got], live.query([ref], ["is red"], k=3)[0])
    finally:
        srv.shutdown()


def test_serve_artifact_parser_is_model_free():
    """The deploy host's subcommand takes only the artifact and HTTP flags
    (and the port's --device), none of the dataset, model or checkpoint
    flags, in the full parser and in the one `main` uses."""
    for parser in (cli.build_parser(), cli.build_serve_artifact_parser()):
        args = parser.parse_args(["serve-artifact", "--artifact", "/x", "--port", "9"])
        assert args.command == "serve-artifact"
        assert args.artifact == "/x" and args.port == 9 and args.device == "cuda"
        assert not args.no_dynamic_batching
        assert not args.allow_platform_mismatch
        assert not hasattr(args, "data_root")
        assert not hasattr(args, "clip_model_name")


def test_refresh_consts_swaps_weights_without_reexport(fiq_root, tmp_path):
    """The consts file is swappable for a retrained service's with the same
    shapes: a 2x gallery doubles the served scores through the original
    programs; a shape change is refused."""
    out = str(tmp_path / "artifact")
    cli.run_export(_args(fiq_root, out=out))
    service = cli.build_service(_args(fiq_root))
    ids = service.api.tokenize(["is red"])
    s1, r1 = A.load_serve_artifact(out, device="cpu").query(ids, [0], k=3)
    consts = service._serve_fn.consts
    n_model = len(consts) - 3   # then the gallery, the reference features and patches
    doubled = consts[:n_model] + [consts[n_model] * 2] + consts[n_model + 1:]
    A.refresh_consts(out, types.SimpleNamespace(consts=doubled))
    s2, r2 = A.load_serve_artifact(out, device="cpu").query(ids, [0], k=3)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_allclose(s2, 2 * s1, rtol=1e-5)
    bad = consts[:n_model] + [consts[n_model][:, :4]] + consts[n_model + 1:]
    with pytest.raises(ValueError, match="re-export"):
        A.refresh_consts(out, types.SimpleNamespace(consts=bad))
    with pytest.raises(ValueError, match="re-export"):
        A.refresh_consts(out, types.SimpleNamespace(consts=consts[:-1]))


def test_live_reload_picks_up_republished_consts(fiq_root, tmp_path):
    """POST /reload on a running artifact service: after `refresh_consts`
    the same service instance serves the new consts, with no restart
    (scores double with a 2x gallery); a model-backed service answers
    /reload with 404."""
    out = str(tmp_path / "artifact")
    cli.run_export(_args(fiq_root, out=out))
    service = cli.build_service(_args(fiq_root))
    svc = ArtifactService(out, warmup=False, device="cpu")
    srv = serve(svc, host="127.0.0.1", port=0, dynamic_batching=False)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        ref = service.gallery.names[0]
        before = _post(f"{url}/query", {"ref_name": ref, "caption": "is red",
                                        "k": 3})["results"]
        consts = service._serve_fn.consts
        n_model = len(consts) - 3
        A.refresh_consts(out, types.SimpleNamespace(
            consts=consts[:n_model] + [consts[n_model] * 2] + consts[n_model + 1:]))
        resp = _post(f"{url}/reload", {})
        assert resp["reloaded"] and resp["gallery_size"] == svc.gallery_size
        after = _post(f"{url}/query", {"ref_name": ref, "caption": "is red",
                                       "k": 3})["results"]
        assert [r["name"] for r in after] == [r["name"] for r in before]
        np.testing.assert_allclose([r["score"] for r in after],
                                   [2 * r["score"] for r in before], rtol=1e-5)
    finally:
        srv.shutdown()
    live = serve(service, host="127.0.0.1", port=0, dynamic_batching=False)
    threading.Thread(target=live.serve_forever, daemon=True).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"http://127.0.0.1:{live.server_address[1]}/reload", {})
        assert e.value.code == 404
    finally:
        live.shutdown()


def test_serve_artifact_http_parity(fiq_root, tmp_path):
    """The artifact-backed HTTP service answers a composed query (single
    and batch) as the live service does; /stats names the artifact; an
    unknown reference is a 404."""
    out = str(tmp_path / "artifact")
    cli.run_export(_args(fiq_root, out=out))
    live = cli.build_service(_args(fiq_root))
    ref = live.gallery.names[0]
    svc = ArtifactService(out, device="cpu")
    assert svc.gallery_size == live.gallery_size
    httpd = serve(svc, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        one = _post(f"{url}/query", {"ref_name": ref, "caption": "is red", "k": 3})
        _same([one["results"]], live.query([ref], ["is red"], k=3)[0])
        refs = live.gallery.names[:5]
        many = _post(f"{url}/query", {"ref_names": refs, "captions": _captions(5), "k": 4})
        _same(many["results"], live.query(refs, _captions(5), k=4)[0])
        assert _get(f"{url}/stats")["artifact"]["dir"] == out
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{url}/query", {"ref_name": "nope", "caption": "x"})
        assert e.value.code == 404
    finally:
        httpd.shutdown()
        if svc.batcher is not None:
            svc.batcher.close()


def test_platform_mismatch_refused(tmp_path):
    out = tmp_path / "art2"
    out.mkdir()
    (out / "manifest.json").write_text(json.dumps(
        {"kind": "fashionern-serve", "platform": "tpu", "files": {}, "k_max": 1,
         "gallery_size": 1, "context_length": 16, "buckets": [1], "feature_dim": 8,
         "artifact_version": 1, "consts_file": "consts.pt", "consts_dtypes": [],
         "consts_shapes": []}))
    with pytest.raises(ValueError, match="platform"):
        A.load_serve_artifact(str(out), device="cpu")
    art = A.load_serve_artifact(str(out), device="cpu", allow_platform_mismatch=True)
    assert art.manifest["platform"] == "tpu"


def test_growable_and_by_features_programs_are_refused(tmp_path):
    _, _, tm = both_models(tiny_config)
    api = InferenceAPI(tm, tokenizer=crc_tokenizer, device="cpu", context_length=CTX)
    g = np.random.default_rng(3)
    gal = g.standard_normal((10, D)).astype(np.float32)
    rp = g.standard_normal((10, PATCH_NUM, D)).astype(np.float32)
    with pytest.raises(ValueError, match="growable"):
        A.export_serve_artifact(api.build_serve_fn(gal, ref_features=gal, ref_patches=rp,
                                                   capacity=16), str(tmp_path / "a"))
    with pytest.raises(ValueError, match="by-rows"):
        A.export_serve_artifact(api.build_serve_fn(gal), str(tmp_path / "b"))


def test_artifact_answers_as_the_jax_live_service(tmp_path):
    """One set of weights (the bridge), one gallery: the port's exported
    artifact against the JAX package's live `RetrievalService`, every
    bucket, top-k rows equal and scores at atol 2e-4."""
    jm, variables, tm = both_models(tiny_config)
    g = np.random.default_rng(4)
    items = [{"name": f"img{i}", "image": g.random((32, 32, 3), dtype=np.float32),
              "patch": g.standard_normal((PATCH_NUM, D)).astype(np.float32)}
             for i in range(24)]
    jax_api = JE.InferenceAPI(jm, variables, batch_size=8, context_length=CTX,
                              tokenizer=crc_tokenizer)
    jax_service = JaxService(jax_api, Loader(items, 8, num_workers=0), warmup=False)
    api = InferenceAPI(tm, tokenizer=crc_tokenizer, device="cpu", batch_size=8,
                       context_length=CTX)
    service = RetrievalService(api, Loader(items, 8, num_workers=0))
    A.export_serve_artifact(service._serve_fn, str(tmp_path / "art"),
                            gallery_names=service.gallery.names)
    art = A.load_serve_artifact(str(tmp_path / "art"), device="cpu")
    for n in SIZES:
        refs = [f"img{i % 24}" for i in range(n)]
        caps = _captions(n)
        _same(_artifact_results(art, service, refs, caps, 5),
              jax_service.query(refs, caps, k=5)[0], rtol=0, atol=2e-4)


def test_serve_artifact_command_imports_no_model_module(fiq_root, tmp_path):
    """`fashionern-torch serve-artifact --device cpu` in its own process
    answers /query as the live service does and /reload after a
    `refresh-artifact`, and that process imported no module of `models/`
    or `data/` (its /stats lists the port modules it imported)."""
    out = str(tmp_path / "artifact")
    cli.run_export(_args(fiq_root, out=out))
    live = cli.build_service(_args(fiq_root))
    code = ("import sys\n"
            "from fashionern_aaai2024_tpu_torch.cli import main as cli\n"
            "from fashionern_aaai2024_tpu_torch.retrieval import server\n"
            "stats = server.ArtifactService.stats\n"
            "server.ArtifactService.stats = lambda self: {**stats(self), 'modules': sorted(\n"
            "    m for m in sys.modules if m.startswith('fashionern_aaai2024_tpu'))}\n"
            "sys.exit(cli.main(sys.argv[1:]))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="2", FASHIONERN_BPE_PATH=os.path.join(fiq_root, "bpe.txt.gz"))
    proc = subprocess.Popen([sys.executable, "-c", code, "serve-artifact", "--artifact", out,
                             "--device", "cpu", "--port", "0"], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        url = None
        for line in proc.stdout:
            if line.startswith("serving "):
                url = line.split(" on ")[1].split()[0]
                break
        assert url is not None, proc.stderr.read()
        ref = live.gallery.names[1]
        got = _post(f"{url}/query", {"ref_name": ref, "caption": "is red", "k": 3})
        _same([got["results"]], live.query([ref], ["is red"], k=3)[0])
        modules = _get(f"{url}/stats")["modules"]
        assert "fashionern_aaai2024_tpu_torch.retrieval.artifact" in modules
        assert not [m for m in modules if m.startswith(("fashionern_aaai2024_tpu_torch.models",
                                                        "fashionern_aaai2024_tpu_torch.data",
                                                        "fashionern_aaai2024_tpu."))], modules
        cli.run_refresh_artifact(_args(fiq_root, artifact=out, seed=9, reload_url=url))
        new = cli.build_service(_args(fiq_root, seed=9))
        got = _post(f"{url}/query", {"ref_name": ref, "caption": "is red", "k": 3})
        _same([got["results"]], new.query([ref], ["is red"], k=3)[0])
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_artifact_modules_import_no_model_or_data_module():
    """`retrieval/artifact.py`, `retrieval/server.py` (`ArtifactService`),
    the registered ops and the tokenizer import nothing of `models/` or
    `data/` (nor of JAX)."""
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'flax', 'fashionern_aaai2024_tpu'):\n"
            "    sys.modules[name] = None\n"
            "from fashionern_aaai2024_tpu_torch.retrieval import artifact, server\n"
            "from fashionern_aaai2024_tpu_torch import tokenizer\n"
            "artifact.library.register_all()\n"
            "print(' '.join(sorted(m for m in sys.modules\n"
            "                      if m.startswith('fashionern_aaai2024_tpu_torch'))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    mods = out.stdout.split()
    assert "fashionern_aaai2024_tpu_torch.ops.library" in mods
    assert not [m for m in mods if m.startswith(("fashionern_aaai2024_tpu_torch.models",
                                                 "fashionern_aaai2024_tpu_torch.data"))], mods
