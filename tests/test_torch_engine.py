"""The port's gallery pipeline (`retrieval/engine.py embed_gallery`,
`Placer`, `InferenceAPI.gallery_encode_fn`) against the serial feed and
against the JAX package's `embed_gallery`, on the CPU.

  * every prefetch depth gives the serial feed's `GalleryFeatures` bit
    for bit (names, features, tokens, patches): the pipeline reorders
    when work happens, never what is computed (the port of JAX
    `tests/test_prefetch.py:71-91`, with a toy encoder as there and with
    the port's API);
  * the port's pipeline against JAX's `embed_gallery` on the same items,
    loader batches and weights (carried by the weight bridge), float and
    uint8 images: features, tokens and patches within 2e-5, the port's
    module tolerance (fp32, another summation order);
  * an exception in the loader or in the encode surfaces from the call,
    at both depths, and no prefetch thread outlives it;
  * on a 2-rank gloo gang (`tests/torch_parallel_workers.py`), the mesh
    API's gallery equals the unsharded one within 2e-5, both ranks'
    galleries are equal, and each rank's `.place` copied only its rows
    of a batch (`InferenceAPI._rank_rows`, the split of `_map`).
The card's side (page-locked copies on the copy stream, `record_stream`)
is in `tests/test_torch_cuda.py` and `chip_smoke.py` phase 12.
"""

import threading

import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from fashionern_aaai2024_tpu.data.loader import Loader as JaxLoader
from fashionern_aaai2024_tpu.retrieval import engine as JEng
from fashionern_aaai2024_tpu.retrieval import evaluate as JE
from fashionern_aaai2024_tpu_torch.data.loader import Loader
from fashionern_aaai2024_tpu_torch.data.prefetch import prefetch_iter
from fashionern_aaai2024_tpu_torch.models.clip import config as torch_config
from fashionern_aaai2024_tpu_torch.parallel import mesh as M
from fashionern_aaai2024_tpu_torch.retrieval import engine as TEng
from fashionern_aaai2024_tpu_torch.retrieval import evaluate as TE
from torch_port_helpers import CTX, D, PATCH_NUM, both_models, crc_tokenizer, small_config

torch.set_num_threads(2)

GANG_TIMEOUT = 240.0


@pytest.fixture(scope="module")
def models():
    jm, variables, tm = both_models(small_config)
    return jm, variables, tm


def _port_api(tm, batch_size=8, mesh=None):
    return TE.InferenceAPI(tm, tokenizer=crc_tokenizer, device="cpu", batch_size=batch_size,
                           context_length=CTX, mesh=mesh)


def _items(n, seed=0, dtype=np.float32):
    g = np.random.default_rng(seed)
    out = []
    for k in range(n):
        image = (g.integers(0, 256, (32, 32, 3), dtype=np.uint8) if dtype == np.uint8
                 else g.random((32, 32, 3), dtype=np.float32))
        out.append({"name": f"i{k}", "image": image,
                    "patch": g.standard_normal((PATCH_NUM, D)).astype(np.float32)})
    return out


def _toy_encode(images):
    """JAX test_prefetch.py's toy encoder: (per-image mean, first 5 values)."""
    return images.mean(dim=(1, 2)), images.reshape(images.shape[0], -1)[:, :5]


def _assert_same(a, b):
    assert a.names == b.names
    for key in ("features", "token_features", "local_features"):
        x, y = getattr(a, key), getattr(b, key)
        assert x.dtype == y.dtype and x.device == y.device, key
        torch.testing.assert_close(x, y, atol=0, rtol=0, msg=key)


# --- every depth is the serial feed ----------------------------------------------


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
@pytest.mark.parametrize("encoder", ["toy", "api"])
def test_every_depth_gives_the_serial_feed(models, encoder, depth):
    """11 items at batch 4 (a ragged last batch), tokens kept: every depth
    equals the serial feed bit for bit."""
    fn = _toy_encode if encoder == "toy" else _port_api(models[2], 4).gallery_encode_fn()
    loader = Loader(_items(11), 4, num_workers=0)
    serial = TEng.embed_gallery(fn, loader, 4, keep_tokens=True, prefetch=0)
    got = TEng.embed_gallery(fn, loader, 4, keep_tokens=True, prefetch=depth)
    assert len(got.names) == 11 and got.token_features.shape[0] == 11
    assert got.token_features.device.type == "cpu"
    _assert_same(serial, got)


def test_tokens_are_kept_only_when_asked(models):
    g = TEng.embed_gallery(_port_api(models[2]).gallery_encode_fn(),
                           Loader(_items(5), 4, num_workers=0))
    assert g.token_features is None and g.features.shape == (5, D)
    assert g.local_features.shape == (5, PATCH_NUM, D)
    empty = TEng.embed_gallery(_toy_encode, [])
    assert empty.names == [] and empty.features.shape == (0, 0)
    assert empty.local_features is None and empty.token_features is None


# --- against JAX -------------------------------------------------------------------


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8], ids=["float32", "uint8"])
def test_matches_jax_embed_gallery(models, dtype, depth):
    """20 items at batch 8 (the last batch of 4) through each package's
    Loader, API and `embed_gallery`, tokens kept."""
    jm, variables, tm = models
    items = _items(20, seed=3, dtype=dtype)
    jax_api = JE.InferenceAPI(jm, variables, batch_size=8, context_length=CTX,
                              tokenizer=crc_tokenizer)
    want = JEng.embed_gallery(jax_api.gallery_encode_fn(), JaxLoader(items, 8, num_workers=0),
                              8, keep_tokens=True)
    got = TEng.embed_gallery(_port_api(tm).gallery_encode_fn(), Loader(items, 8, num_workers=0),
                             8, keep_tokens=True, prefetch=depth)
    assert got.names == want.names
    for key in ("features", "token_features", "local_features"):
        np.testing.assert_allclose(getattr(got, key).float().numpy(), getattr(want, key),
                                   atol=2e-5, rtol=0, err_msg=key)


# --- the stage ---------------------------------------------------------------------


def test_the_encode_takes_the_placed_images_as_they_are(models, monkeypatch):
    """On the CPU the stage is `torch.as_tensor` (the loader's array, not a
    copy) and the encode runs the model on that very tensor: no second
    copy of an image batch inside the encode."""
    api = _port_api(models[2])
    fn = api.gallery_encode_fn()
    batches = [{"name": [it["name"] for it in b], "image": np.stack([it["image"] for it in b]),
                "patch": np.stack([it["patch"] for it in b])}
               for b in (_items(8, seed=1), _items(3, seed=2))]
    seen = []
    encode = api.model.encode_image
    monkeypatch.setattr(api.model, "encode_image",
                        lambda x: seen.append(x.data_ptr()) or encode(x))
    TEng.embed_gallery(fn, batches, 8)
    assert seen == [b["image"].ctypes.data for b in batches]
    assert fn.place.batches == 2 and fn.place.copies == 0 and fn.place.stream is None


def test_place_on_a_mesh_takes_only_the_ranks_rows(models):
    """`.place` on rank r of a 2-rank mesh: rows [r · per, (r + 1) · per) of
    the batch, the last repeated to per rows; the patches whole (every
    rank keeps the whole gallery)."""
    g = np.random.default_rng(4)
    images = g.random((4, 32, 32, 3), dtype=np.float32)
    patch = g.standard_normal((4, PATCH_NUM, D)).astype(np.float32)
    want = {(0, 3): [0, 1], (1, 3): [2, 2], (0, 1): [0], (1, 1): [0], (1, 4): [2, 3]}
    for (rank, m), rows in want.items():
        api = _port_api(models[2], 4, mesh=M.ProcessMesh(None, rank, 2, torch.device("cpu")))
        p = api.gallery_encode_fn().place(images[:m], patch[:m])
        torch.testing.assert_close(p.images, torch.from_numpy(images[rows]), atol=0, rtol=0)
        torch.testing.assert_close(p.patch, torch.from_numpy(patch[:m]), atol=0, rtol=0)
        assert p.event is None


def test_place_takes_strided_views_and_casts_the_patches():
    """A strided numpy view is staged as its values; patches become fp32,
    images keep the loader's dtype."""
    g = np.random.default_rng(5)
    images = g.integers(0, 256, (4, 8, 8, 3), dtype=np.uint8)
    patch = g.standard_normal((4, PATCH_NUM, 6))
    p = TEng.Placer("cpu")(images[1:, :, ::2], patch[:, :, ::2])
    assert p.images.dtype == torch.uint8 and p.patch.dtype == torch.float32
    np.testing.assert_array_equal(p.images.numpy(), images[1:, :, ::2])
    np.testing.assert_array_equal(p.patch.numpy(), patch[:, :, ::2].astype(np.float32))


# --- failures ----------------------------------------------------------------------


def _prefetch_threads():
    return {t for t in threading.enumerate() if t.name == "device-prefetch"}


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("where", ["loader", "encode"])
def test_a_failure_surfaces_and_stops_the_thread(models, where, depth):
    """A loader that raises at its third batch, or an encode that raises
    at the second: the call raises it, and no prefetch thread is left."""
    batches = Loader(_items(20, seed=6), 4, num_workers=0)

    def loader():
        for i, b in enumerate(batches):
            if where == "loader" and i == 2:
                raise OSError("corrupt image in batch 2")
            yield b

    fn = _port_api(models[2]).gallery_encode_fn()
    calls = []

    def encode(images):
        calls.append(len(images))
        if where == "encode" and len(calls) == 2:
            raise RuntimeError("encode failed at batch 1")
        return fn(images)

    encode.place = fn.place
    before = _prefetch_threads()
    with pytest.raises((OSError, RuntimeError), match="batch 2" if where == "loader"
                       else "batch 1") as failure:
        TEng.embed_gallery(encode, loader(), 4, prefetch=depth)
    # checked while the traceback (and so the call's frame) is still held
    assert failure.tb is not None and _prefetch_threads() <= before
    assert calls == [4, 4]


def test_prefetch_iter_joins_its_thread_when_closed():
    it = prefetch_iter(range(100), None, depth=1)
    assert next(it) == 0
    (worker,) = _prefetch_threads()
    it.close()
    assert not worker.is_alive()


# --- a two-rank mesh ------------------------------------------------------------------


def test_two_rank_mesh_gallery_equals_the_unsharded_one(models, tmp_path):
    """7 items at batch 4 (a ragged last batch), prefetch 2, tokens kept."""
    path = str(tmp_path / "model.pt")
    torch.save(models[2].state_dict(), path)
    items = _items(7, seed=8)
    out = M.spawn_cpu_gang(2, W.gallery_rank, small_config(torch_config), path, items,
                           timeout=GANG_TIMEOUT, store_dir=str(tmp_path))
    images = np.stack([it["image"] for it in items])
    for rank, res in enumerate(out):
        one, mesh = res["one"], res["mesh"]
        assert mesh["names"] == one["names"] == [it["name"] for it in items]
        for key in ("features", "tokens", "locals"):
            assert mesh[key].shape == one[key].shape, key
            np.testing.assert_allclose(mesh[key], one[key], atol=2e-5, rtol=0, err_msg=key)
            np.testing.assert_array_equal(mesh[key], out[0]["mesh"][key])
        rows = {0: ([0, 1], [4, 5]), 1: ([2, 3], [6, 6])}[rank]
        assert len(mesh["placed"]) == 2
        for placed, want in zip(mesh["placed"], rows, strict=True):
            np.testing.assert_array_equal(placed, images[want])
        assert [p.shape[0] for p in one["placed"]] == [4, 3]
