"""The port's data layer against the JAX package's, bit for bit.

  * `data/transforms.py load_and_preprocess` on PNG, RGB and gray JPEG,
    every pad mode, the uint8 feed, normalized and [0, 1] floats;
  * the native image library (`native/fastimage.cpp`: decode, the
    Pillow-exact bicubic, the fused pipeline, the 13 crops, the threaded
    batch) against the JAX package's copy, and the build without libjpeg
    (`-DFE_NO_JPEG`, the card's machine) whose resampler stays native;
  * the loader core (`native/fastloader.cpp`: `gather_rows`,
    `normalize_images`) and `PatchFeatureStore`;
  * every dataset class's items (keys, strings, arrays) in every mode and
    split, on trees the JAX `make_fixture` writes;
  * Fashion200k's caption index, its generated pairs and `resample_epoch`
    under one seed.
"""

import io
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from fashionern_aaai2024_tpu import native as jax_native
from fashionern_aaai2024_tpu.data import cirr as jax_cirr
from fashionern_aaai2024_tpu.data import fashion200k as jax_200k
from fashionern_aaai2024_tpu.data import fashioniq as jax_fiq
from fashionern_aaai2024_tpu.data import shoes as jax_shoes
from fashionern_aaai2024_tpu.data import transforms as jax_transforms
from fashionern_aaai2024_tpu.data.patch_store import PatchFeatureStore as JaxStore
from fashionern_aaai2024_tpu.native import image as jax_image
from fashionern_aaai2024_tpu.tools.make_fixture import make_fixture as jax_make_fixture
from fashionern_aaai2024_tpu_torch import native
from fashionern_aaai2024_tpu_torch.data import cirr, fashion200k, fashioniq, shoes, transforms
from fashionern_aaai2024_tpu_torch.data.patch_store import PatchFeatureStore
from fashionern_aaai2024_tpu_torch.native import build as native_build
from fashionern_aaai2024_tpu_torch.native import image as port_image

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on PATH")
needs_jpeg = pytest.mark.skipif(
    shutil.which("g++") is None or not native_build.header_found("jpeglib.h")
    or not jax_image.available(), reason="no libjpeg (the native decoder is not built)")

DIM = 32


def _save(arr: np.ndarray, path, fmt: str, **kw) -> None:
    Image.fromarray(arr).save(path, fmt, **kw)


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """PNG, RGB and gray JPEG files of several shapes: square, tall past
    the 1.25 target ratio, wide within it, and smaller than the crop."""
    d = tmp_path_factory.mktemp("images")
    g = np.random.default_rng(0)
    files = []
    for i, (h, w) in enumerate(((48, 48), (80, 30), (40, 44), (20, 12))):
        rgb = g.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for fmt, ext, arr in (("PNG", "png", rgb), ("JPEG", "jpg", rgb),
                              ("JPEG", "gray.jpg", rgb[..., 0])):
            path = d / f"img{i}.{ext}"
            _save(arr, path, fmt, **({"quality": 90} if fmt == "JPEG" else {}))
            files.append(str(path))
    return files


@needs_gxx
@pytest.mark.parametrize("kind", ["png", "jpg"])
@pytest.mark.parametrize("pad_mode", ["target", "square", "none"])
def test_load_and_preprocess_is_bit_equal(image_files, kind, pad_mode):
    for path in image_files:
        if not path.endswith(kind):
            continue
        for kw in (dict(), dict(normalize=False), dict(as_uint8=True), dict(rgb_first=True)):
            want = jax_transforms.load_and_preprocess(path, DIM, pad_mode, **kw)
            got = transforms.load_and_preprocess(path, DIM, pad_mode, **kw)
            assert got.dtype == want.dtype and got.shape == want.shape, (path, kw)
            assert np.array_equal(got, want), (path, pad_mode, kw)


def test_load_and_preprocess_counts_its_routes(image_files):
    before = dict(transforms.ROUTES)
    png = [p for p in image_files if p.endswith(".png")]
    for p in png:
        transforms.load_and_preprocess(p, DIM)
    assert transforms.ROUTES["pil"] - before.get("pil", 0) == len(png)


def test_normalize_on_device_matches_the_host_feed():
    g = np.random.default_rng(1)
    u8 = g.integers(0, 256, (2, 5, 7, 3), dtype=np.uint8)
    got = transforms.normalize_on_device(u8, "cpu")
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), native.normalize_images(u8))
    f = u8.astype(np.float32) / 255.0
    want = (f - jax_transforms.CLIP_MEAN) / jax_transforms.CLIP_STD
    np.testing.assert_array_equal(transforms.normalize_on_device(f, "cpu").numpy(), want)


# --- the native image library -----------------------------------------------


def _jpeg(arr: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=90, **kw)
    return buf.getvalue()


@needs_jpeg
def test_native_decode_matches_jax_and_pil():
    g = np.random.default_rng(2)
    assert port_image.has_decoder() and port_image.jpeg_route() == "native"
    for shape, kw in (((41, 33, 3), {}), ((97, 211, 3), {"progressive": True}),
                      ((60, 50), {})):
        data = _jpeg(g.integers(0, 256, shape, dtype=np.uint8), **kw)
        got = port_image.decode_jpeg(data)
        assert np.array_equal(got, jax_image.decode_jpeg(data))
        assert np.array_equal(got, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    assert port_image.decode_jpeg(b"\x89PNG....") is None


@needs_jpeg
@pytest.mark.parametrize("pad_mode", ["target", "square", "none"])
def test_native_pipeline_crops_and_batch_match_jax(pad_mode):
    g = np.random.default_rng(3)
    items = [_jpeg(g.integers(0, 256, s, dtype=np.uint8))
             for s in ((50, 40, 3), (90, 30, 3), (36, 36, 3))]
    for data in items:
        for normalize in (True, False):
            assert np.array_equal(
                port_image.decode_preprocess(data, DIM, pad_mode, 1.25, normalize),
                jax_image.decode_preprocess(data, DIM, pad_mode, 1.25, normalize))
        assert np.array_equal(port_image.extract_crops(data, DIM, 90),
                              jax_image.extract_crops(data, DIM, 90))
    got, got_s = port_image.decode_preprocess_batch(items + [b"not a jpeg"], DIM, pad_mode)
    want, want_s = jax_image.decode_preprocess_batch(items + [b"not a jpeg"], DIM, pad_mode)
    assert np.array_equal(got_s, want_s) and np.array_equal(got, want)
    assert got_s[-1] != port_image.OK


@needs_gxx
def test_native_bicubic_matches_jax_and_pil():
    g = np.random.default_rng(4)
    for (h, w, c), (ow, oh) in (((37, 53, 3), (20, 31)), ((16, 16, 1), (40, 9)),
                                ((64, 48, 3), (224, 300))):
        src = g.integers(0, 256, (h, w, c), dtype=np.uint8)
        got = port_image.resize_bicubic(src, ow, oh)
        if jax_image.available():
            assert np.array_equal(got, jax_image.resize_bicubic(src, ow, oh))
        pil = Image.fromarray(src[..., 0] if c == 1 else src).resize((ow, oh), Image.BICUBIC)
        assert np.array_equal(got.reshape(oh, ow, -1), np.asarray(pil).reshape(oh, ow, -1))


@needs_gxx
def test_build_without_libjpeg_keeps_the_resampler_native():
    """The -DFE_NO_JPEG build (no <jpeglib.h>, as on the card's machine):
    no decoder, every decoding entry point returns NO_DECODER, the
    resampler gives Pillow's pixels."""
    flags = port_image._PORTABLE + ("-DFE_NO_JPEG",)
    lib = native_build.NativeLibrary(port_image.SOURCE, "libfastimage.so", [flags],
                                     port_image._bind).load()
    assert lib.fe_has_jpeg() == 0
    data = np.frombuffer(_jpeg(np.zeros((8, 8, 3), np.uint8)), np.uint8)
    out = np.empty((DIM, DIM, 3), np.uint8)
    rc = lib.fe_decode_preprocess(data.ctypes.data, data.size, DIM, 1, 1.25, None, None, 0,
                                  out.ctypes.data)
    assert rc == port_image.NO_DECODER
    src = np.random.default_rng(5).integers(0, 256, (30, 20, 3), dtype=np.uint8)
    res = np.empty((11, 17, 3), np.uint8)
    assert lib.fe_resize_bicubic_u8(src.ctypes.data, 30, 20, 3, 17, 11, res.ctypes.data) == 0
    assert np.array_equal(res, np.asarray(Image.fromarray(src).resize((17, 11),
                                                                       Image.BICUBIC)))


@needs_gxx
def test_loader_core_matches_jax():
    g = np.random.default_rng(6)
    pack = g.standard_normal((20, 13, 8)).astype(np.float32)
    idx = [3, 0, 19, 3, 7]
    assert np.array_equal(native.gather_rows(pack, idx), jax_native.gather_rows(pack, idx))
    assert np.array_equal(native.gather_rows(pack[:, ::2], idx), pack[:, ::2][idx])
    with pytest.raises(IndexError):
        native.gather_rows(pack, [20])
    u8 = g.integers(0, 256, (3, 9, 11, 3), dtype=np.uint8)
    assert np.array_equal(native.normalize_images(u8), jax_native.normalize_images(u8))
    f = u8.astype(np.float64)
    assert np.array_equal(native.normalize_images(f), jax_native.normalize_images(f))


def test_patch_store_matches_jax(tmp_path):
    g = np.random.default_rng(7)
    names = [f"n{i}" for i in range(6)]
    feats = g.standard_normal((6, 13, 8)).astype(np.float32)
    loose = tmp_path / "loose"
    loose.mkdir()
    for n, f in zip(names, feats):
        np.save(loose / f"{n}.npy", f)
    torch.save(torch.from_numpy(feats[0] * 2), loose / "only_pth.pth")
    PatchFeatureStore.write_pack(str(tmp_path / "packed"), names[:4], feats[:4])
    JaxStore.write_pack(str(tmp_path / "jax_packed"), names[:4], feats[:4])
    for f in ("pack.npy", "pack.names.json"):
        assert (tmp_path / "packed" / f).read_bytes() == (tmp_path / "jax_packed" / f).read_bytes()
    for root in (loose, tmp_path / "packed"):
        port, jax = PatchFeatureStore(str(root)), JaxStore(str(root))
        present = names if root == loose else names[:4]
        for n in present:
            assert np.array_equal(port.get(n), jax.get(n))
        assert np.array_equal(port.get_batch(present[::-1]), jax.get_batch(present[::-1]))
        with pytest.raises(FileNotFoundError):
            port.get("missing")
    assert np.array_equal(PatchFeatureStore(str(loose)).get("only_pth"), feats[0] * 2)


# --- the dataset classes on JAX-written fixtures ----------------------------


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("fixtures")
    out = {}
    for name in ("fashioniq", "cirr", "shoes", "fashion200k"):
        out[name] = jax_make_fixture(str(root / name), name, dim=8, patch_num=13, seed=3)
    return out


def _items_equal(got, want, where):
    if want is None:
        assert got is None, where
        return
    assert list(got) == list(want), where
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), (where, k)
        else:
            assert g == w, (where, k)


def _all_items_equal(port_ds, jax_ds, where):
    assert len(port_ds) == len(jax_ds) > 0, where
    for i in range(len(jax_ds)):
        _items_equal(port_ds[i], jax_ds[i], (where, i))


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("mode", ["relative", "classic"])
def test_fashioniq_items_match_jax(trees, split, mode):
    for kw in (dict(), dict(image_dtype="uint8", dress_types=["shirt"]),
               dict(val_protocol=True, load_images=False)):
        kw = {"dress_types": list(jax_fiq.DRESS_TYPES), **kw}
        types = kw.pop("dress_types")
        _all_items_equal(
            fashioniq.FashionIQDataset(trees["fashioniq"], split, types, mode, dim=DIM, **kw),
            jax_fiq.FashionIQDataset(trees["fashioniq"], split, types, mode, dim=DIM, **kw),
            (split, mode, kw))


def test_fashioniq_test_split_and_corrupt_items(trees, tmp_path):
    """The test split (no targets) and `skip_corrupt`, on a copy of the
    tree with one image truncated."""
    root = tmp_path / "fiq"
    shutil.copytree(trees["fashioniq"], root)
    for dt in jax_fiq.DRESS_TYPES:
        for kind, name in (("captions", "cap"), ("image_splits", "split")):
            shutil.copy(root / kind / f"{name}.{dt}.val.json",
                        root / kind / f"{name}.{dt}.test.json")
    caps = json.loads((root / "captions" / "cap.dress.test.json").read_text())
    (root / "images" / f"{caps[0]['candidate']}.png").write_bytes(b"\x89PNG broken")
    for skip in (True, False):
        port = fashioniq.FashionIQDataset(str(root), "test", ["dress"], dim=DIM,
                                          skip_corrupt=skip)
        jax = jax_fiq.FashionIQDataset(str(root), "test", ["dress"], dim=DIM,
                                       skip_corrupt=skip)
        if skip:
            _all_items_equal(port, jax, "test split, skip_corrupt")
            assert port[0] is None
        else:
            with pytest.raises(Exception):
                port[0]
    with pytest.raises(ValueError):
        fashioniq.FashionIQDataset(str(root), "dev", ["dress"])


@pytest.mark.parametrize("split", ["train", "val", "test1"])
@pytest.mark.parametrize("mode", ["relative", "classic"])
def test_cirr_items_match_jax(trees, split, mode):
    for kw in (dict(), dict(image_dtype="uint8", pad_mode="square")):
        _all_items_equal(cirr.CIRRDataset(trees["cirr"], split, mode, dim=DIM, **kw),
                         jax_cirr.CIRRDataset(trees["cirr"], split, mode, dim=DIM, **kw),
                         (split, mode, kw))


@needs_gxx
@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("mode", ["relative", "classic"])
def test_shoes_items_match_jax(trees, split, mode):
    """Shoes images are JPEGs: the native route on both sides where
    libjpeg is found, PIL on both where it is not."""
    for kw in (dict(), dict(image_dtype="uint8")):
        _all_items_equal(shoes.ShoesDataset(trees["shoes"], split, mode, dim=DIM, **kw),
                         jax_shoes.ShoesDataset(trees["shoes"], split, mode, dim=DIM, **kw),
                         (split, mode, kw))


@needs_gxx
def test_fashion200k_items_match_jax(trees):
    root = trees["fashion200k"]
    for port_cls, jax_cls, split in (
            (fashion200k.Fashion200kDataset, jax_200k.Fashion200kDataset, "train"),
            (fashion200k.Fashion200kTestDataset, jax_200k.Fashion200kTestDataset, "test"),
            (fashion200k.Fashion200kTestDataset, jax_200k.Fashion200kTestDataset, "val"),
            (fashion200k.Fashion200kTestQueryDataset, jax_200k.Fashion200kTestQueryDataset,
             "test")):
        for kw in (dict(), dict(image_dtype="uint8", load_images=False)):
            _all_items_equal(port_cls(root, split=split, dim=DIM, **kw),
                             jax_cls(root, split=split, dim=DIM, **kw),
                             (port_cls.__name__, split, kw))


@pytest.mark.parametrize("seed", [0, 11])
def test_fashion200k_caption_index_and_resampling_match_jax(trees, seed):
    port = fashion200k.Fashion200kDataset(trees["fashion200k"], seed=seed, load_images=False)
    jax = jax_200k.Fashion200kDataset(trees["fashion200k"], seed=seed, load_images=False)
    assert port.caption2imgids == jax.caption2imgids
    assert port.parent2children_captions == jax.parent2children_captions
    assert port.num_modifiable_imgs == jax.num_modifiable_imgs > 0
    assert port.imgs == jax.imgs
    assert port.pairs == jax.pairs and len(port.pairs) > 0
    for n in (5, 2):
        port.resample_epoch(n)
        jax.resample_epoch(n)
        assert port.pairs == jax.pairs
    assert os.path.exists(os.path.join(trees["fashion200k"], "test_queries.txt"))
