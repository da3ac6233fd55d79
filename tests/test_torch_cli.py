"""The port's CLI (`cli/main.py`), its `run/` presets and its tools against
the JAX package's.

  * the parser: every JAX subcommand but `fetch-bpe` and `convert-ckpt`,
    with the same flags, defaults and choices, and `--device` besides;
  * `run_eval` against JAX `run_eval` on a tiny backbone, both loading one
    reference-format `.pth` pair, for fashioniq, fashioniq-val, cirr (val
    and the test1 submission files), shoes and fashion200k: recalls equal,
    the rest within 2e-4;
  * a one-epoch `train` (resume checkpoint, best checkpoint, sidecar) and
    the seed order explicit > sidecar > 42 with its two warnings (JAX
    `tests/test_cli.py TestSeedSidecar`);
  * the nine `run/` presets;
  * `extract_patches`: the crop geometry and crops equal to JAX's, and
    `PatchExtractor`'s features within 2e-5 of JAX's on bridged weights;
  * the `convert_patches` round trip;
  * every unported subcommand and flag raising with its ROADMAP item.
"""

import argparse
import importlib
import json
import os
import types
import warnings

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from fashionern_aaai2024_tpu.models.clip import config as jax_config
from fashionern_aaai2024_tpu.models.clip import tokenizer as jax_tokenizer
from fashionern_aaai2024_tpu.tools import convert_patches as jax_convert
from fashionern_aaai2024_tpu.tools import extract_patches as jax_extract
from fashionern_aaai2024_tpu.tools.make_fixture import make_fixture as jax_make_fixture
from fashionern_aaai2024_tpu.models.clip.convert import clip_variables_from_torch
from fashionern_aaai2024_tpu_torch.models.composed import ComposedCIRModel, random_init_
from fashionern_aaai2024_tpu_torch.models.clip import config as torch_config
from fashionern_aaai2024_tpu_torch.tools import convert_patches, extract_patches
from fashionern_aaai2024_tpu_torch.tools.make_fixture import make_fixture
from torch_port_helpers import CTX, D, PATCH_NUM

jax_cli = importlib.import_module("fashionern_aaai2024_tpu.cli.main")
cli = importlib.import_module("fashionern_aaai2024_tpu_torch.cli.main")

NAME = "tiny-cli"
NOT_PORTED = {"fetch-bpe", "convert-ckpt"}


def _tiny(module):
    return module.CLIPConfig(
        name=NAME,
        vision=module.VisionConfig(kind="vit", image_size=32, embed_dim=D, width=64, layers=2,
                                   heads=4, patch_size=16),
        text=module.TextConfig(vocab_size=600, context_length=CTX, width=32, heads=4,
                               layers=2, embed_dim=D))


@pytest.fixture()
def tiny(monkeypatch):
    monkeypatch.setitem(jax_config._CONFIGS, NAME, _tiny(jax_config))
    monkeypatch.setitem(torch_config._CONFIGS, NAME, _tiny(torch_config))
    # the JAX CLI exports the fixture's table as FASHIONERN_BPE_PATH: put
    # back after the test, so that later tests of this process do not find it
    bpe = os.environ.get("FASHIONERN_BPE_PATH")
    jax_tokenizer._default_tokenizer.cache_clear()
    yield NAME
    jax_tokenizer._default_tokenizer.cache_clear()
    if bpe is None:
        os.environ.pop("FASHIONERN_BPE_PATH", None)
    else:
        os.environ["FASHIONERN_BPE_PATH"] = bpe


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """One reference-format pair (`clip.pth`, `ern.pth`) of seeded weights,
    and the JAX CLIP variables the JAX converter reads from `clip.pth`."""
    d = tmp_path_factory.mktemp("weights")
    model = random_init_(ComposedCIRModel(_tiny(torch_config), patch_num=PATCH_NUM),
                         torch.Generator().manual_seed(3))
    for part in ("clip", "ern"):
        torch.save(getattr(model, part).state_dict(), d / f"{part}.pth")
    clip_vars = clip_variables_from_torch(torch.load(d / "clip.pth"), _tiny(jax_config))
    return str(d / "clip.pth"), str(d / "ern.pth"), model.state_dict(), clip_vars


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    sizes = {"fashioniq": dict(n_images=10, n_triplets=6), "cirr": dict(n_images=12,
                                                                        n_triplets=6),
             "shoes": dict(n_images=10, n_triplets=6), "fashion200k": dict(n_per_color=2)}
    return {name: jax_make_fixture(str(root / name), name, dim=D, patch_num=PATCH_NUM, seed=1,
                                   **kw)
            for name, kw in sizes.items()}


def _eval_args(dataset, root, clip_path, ern_path, **kw):
    base = dict(dataset=dataset, data_root=root, clip_model_name=NAME, patch_num=PATCH_NUM,
                num_workers=0, worker_type="thread", target_ratio=1.25, transform="targetpad",
                image_dtype="float32", bpe_path=os.path.join(root, "bpe.txt.gz"),
                clip_path=clip_path, fusion_model_path=ern_path, seed=None, batch_size=4,
                split="val", json=True, submission_dir=None, precision="fp32",
                device="cpu")
    base.update(kw)
    return types.SimpleNamespace(**base)


def _compare(got, want, where=""):
    assert set(got) == set(want), where
    for k, w in want.items():
        if isinstance(w, dict):
            _compare(got[k], w, f"{where}/{k}")
        elif "recall" in k:
            assert got[k] == w, f"{where}/{k}: {got[k]} != {w}"
        else:
            assert got[k] == pytest.approx(w, abs=2e-4), f"{where}/{k}"


# --- the parser ---------------------------------------------------------------


def _subparsers(parser):
    action = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return action.choices


def _flags(parser):
    return {a.option_strings[-1]: (a.default, a.choices, a.required, a.nargs, a.const)
            for a in parser._actions if a.option_strings and a.dest != "help"}


def test_parser_has_the_jax_subcommands_and_flags():
    want, got = _subparsers(jax_cli.build_parser()), _subparsers(cli.build_parser())
    assert set(got) == set(want) - NOT_PORTED
    for name, sub in want.items():
        if name in NOT_PORTED:
            continue
        flags = _flags(got[name])
        if "--device" in flags:
            assert flags.pop("--device")[0] == "cuda"
            assert name not in ("info", "convert-patches", "make-fixture")
        assert flags == _flags(sub), name
    text = cli.build_parser().format_help()
    assert "fetch-bpe" in text and "convert-ckpt" in text  # named as not ported


def test_train_defaults_match_the_reference():
    a = cli.build_parser().parse_args(["train", "--data-root", "/x"])
    assert a.lr == 4e-5 and a.batch_size == 1024 and a.num_epochs == 300
    assert a.validation_frequency == 3 and a.clip_model_name == "RN50x4"
    assert a.device == "cuda"


@pytest.mark.parametrize("argv", [["train"], ["eval", "--data-parallel"],
                                  ["serve", "--data-parallel"]])
def test_data_parallel_of_many_ranks_needs_a_coordinator(argv, monkeypatch):
    """`train` under torchrun's environment, and `eval` / `serve` with
    `--data-parallel`, join a group from that environment; many ranks
    without a coordinator address raise before any group starts."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        cli.main([*argv, "--data-root", "/x", "--device", "cpu"])


def test_cuda_device_without_a_gpu_raises(tiny, trees):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["eval", "--data-root", trees["fashioniq"], "--clip-model-name", tiny])


def test_info_names_the_routes_and_what_is_not_ported():
    info = cli.run_info()
    assert {"ViT-B-16", "RN50x4"} <= set(info["backbones"])
    assert info["datasets"] == ["cirr", "fashion200k", "fashioniq", "shoes"]
    assert info["image_routes"]["other"] == "pil"
    assert "serve" not in info["not_ported"] and "eval --topk-recall" not in info["not_ported"]
    assert not {"eval --data-parallel", "serve --data-parallel"} & set(info["not_ported"])
    assert not {"export", "refresh-artifact", "serve-artifact"} & set(info["not_ported"])
    assert "A7" not in info["not_ported"].values()
    assert info["native_serve_front"] is True


# --- eval parity ----------------------------------------------------------------


@pytest.mark.parametrize("dataset, split", [("fashioniq", "val"), ("fashioniq-val", "val"),
                                            ("cirr", "val"), ("shoes", "val"),
                                            ("fashion200k", "val")])
def test_run_eval_matches_jax(tiny, trees, weights, dataset, split):
    clip_path, ern_path, _, _ = weights
    root = trees[dataset.removesuffix("-val")]
    want = jax_cli.run_eval(_eval_args(dataset, root, clip_path, ern_path, split=split))
    got = cli.run_eval(_eval_args(dataset, root, clip_path, ern_path, split=split))
    _compare(got, want)


def test_cirr_test1_submission_matches_jax(tiny, trees, weights, tmp_path):
    clip_path, ern_path, _, _ = weights
    out = {}
    for side, run in (("jax", jax_cli.run_eval), ("port", cli.run_eval)):
        written = run(_eval_args("cirr", trees["cirr"], clip_path, ern_path, split="test1",
                                 submission_dir=str(tmp_path / side)))
        out[side] = {k: json.load(open(p)) for k, p in written.items()}
    assert set(out["port"]) == {"recall_submission", "recall_subset_submission"}
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("dataset", ["fashioniq", "fashioniq-val", "cirr", "shoes",
                                     "fashion200k"])
def test_make_classic_loader_matches_jax(tiny, trees, dataset):
    split = "test" if dataset == "fashion200k" else "val"
    args = _eval_args(dataset, trees[dataset.removesuffix("-val")], None, None, split=split)
    got, want = cli.make_classic_loader(args), jax_cli.make_classic_loader(args)
    assert len(got.dataset) == len(want.dataset) > 0
    for g, w in zip(got, want):
        assert g["name"] == w["name"]
        assert np.array_equal(g["image"], w["image"]) and np.array_equal(g["patch"], w["patch"])


# --- train, checkpoints and the seed order ----------------------------------------


def _train_args(root, ckpt_dir, seed, **kw):
    base = dict(dataset="fashioniq", data_root=root, clip_model_name=NAME,
                patch_num=PATCH_NUM, num_workers=0, target_ratio=1.25, transform="targetpad",
                bpe_path=os.path.join(root, "bpe.txt.gz"), lr=1e-3, batch_size=2,
                num_epochs=1, validation_frequency=1, print_frequency=100, validation_bs=4,
                clip_model_path=None, ckpt_dir=ckpt_dir, seed=seed, negatives="local",
                log_path=None, max_steps_per_epoch=2, resume=None, profile_dir=None,
                precision="fp32", device="cpu")
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.fixture(scope="module")
def trained(tmp_path_factory, trees):
    """One epoch of `train` at seed 7 (two steps), then the best checkpoint."""
    mp = pytest.MonkeyPatch()
    mp.setitem(torch_config._CONFIGS, NAME, _tiny(torch_config))
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    try:
        trainer = cli.run_train(_train_args(trees["fashioniq"], ckpt, 7))
    finally:
        mp.undo()
    return ckpt, trainer


def test_one_epoch_writes_resume_best_and_sidecar(trained, tiny, trees):
    ckpt, trainer = trained
    assert trainer.global_step == 2
    assert {"fashioniq-resume", "fashioniq-resume.frozen", "fashioniq-best",
            "fashioniq-best.meta.json"} <= set(os.listdir(ckpt))
    meta = json.load(open(os.path.join(ckpt, "fashioniq-best.meta.json")))
    assert meta["init_seed"] == 7 and meta["clip_from_checkpoint"] is False
    assert meta["tme"] is False and meta["clip_model_name"] == NAME
    # the trained eval reproduces the best validation metric exactly
    got = cli.run_eval(_eval_args("fashioniq", trees["fashioniq"], None,
                                  os.path.join(ckpt, "fashioniq-best"), batch_size=4))
    assert got["avg"] == meta["metric"]


def _same(a: torch.nn.Module, b: torch.nn.Module) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def test_seed_order_explicit_then_sidecar_then_42(trained, tiny):
    ckpt, trainer = trained
    best = os.path.join(ckpt, "fashioniq-best")
    cfg = _tiny(torch_config)
    auto = cli.load_model_variables(cfg, None, best, PATCH_NUM, device="cpu")
    seed7 = cli.load_model_variables(cfg, None, None, PATCH_NUM, seed=7, device="cpu")
    seed42 = cli.load_model_variables(cfg, None, None, PATCH_NUM, seed=42, device="cpu")
    assert _same(auto.clip, seed7.clip) and not _same(auto.clip, seed42.clip)
    assert _same(auto.clip, trainer.model.clip.cpu())
    override = cli.load_model_variables(cfg, None, best, PATCH_NUM, seed=42, device="cpu")
    assert _same(override.clip, seed42.clip)
    assert _same(auto.ern, override.ern)  # the fusion stack from the checkpoint either way
    default = cli.load_model_variables(cfg, None, None, PATCH_NUM, device="cpu")
    assert _same(default.clip, seed42.clip)


def test_sidecar_warnings(trained, tiny, tmp_path):
    ckpt, _ = trained
    best = str(tmp_path / "best")
    for suffix in ("", ".meta.json"):
        with open(os.path.join(ckpt, "fashioniq-best" + suffix), "rb") as f:
            open(best + suffix, "wb").write(f.read())
    meta = json.load(open(best + ".meta.json"))
    cfg = _tiny(torch_config)
    json.dump({**meta, "clip_from_checkpoint": True}, open(best + ".meta.json", "w"))
    with pytest.warns(UserWarning, match="random-init towers"):
        cli.load_model_variables(cfg, None, best, PATCH_NUM, device="cpu")
    json.dump({**meta, "tme": True}, open(best + ".meta.json", "w"))
    with pytest.warns(UserWarning, match="--tme"):
        cli.load_model_variables(cfg, None, best, PATCH_NUM, device="cpu")
    os.remove(best + ".meta.json")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cli.load_model_variables(cfg, None, best, PATCH_NUM, seed=7, device="cpu")


def test_reference_pth_pair_loads_every_weight(tiny, weights):
    clip_path, ern_path, want, _ = weights
    cfg = _tiny(torch_config)
    model = cli.load_model_variables(cfg, clip_path, ern_path, PATCH_NUM, seed=99, device="cpu")
    got = model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    # a DDP prefix and the reference ERN's CLIP wrappers are dropped
    sd = torch.load(ern_path)
    torch.save({"module." + k: v for k, v in sd.items()} | {"image_clip.x": torch.zeros(1)},
               ern_path + ".ddp.pth")
    again = cli.load_model_variables(cfg, clip_path, ern_path + ".ddp.pth", PATCH_NUM, device="cpu")
    assert _same(again.ern, model.ern)
    torch.save({**sd, "stray": torch.zeros(1)}, ern_path + ".bad.pth")
    with pytest.raises(KeyError, match="stray"):
        cli.load_model_variables(cfg, clip_path, ern_path + ".bad.pth", PATCH_NUM, device="cpu")


# --- the run/ presets ----------------------------------------------------------------


def test_presets_exist_and_forward_their_dataset(tiny, trees, weights, monkeypatch, capsys):
    for name in ("train_fiq", "train_cirr", "train_shoes", "train_200k", "test_fiq",
                 "test_val", "test_cirr", "test_shoes", "test_200k"):
        mod = importlib.import_module(f"fashionern_aaai2024_tpu_torch.run.{name}")
        jax_mod = importlib.import_module(f"fashionern_aaai2024_tpu.run.{name}")
        assert open(mod.__file__).read().split("_run(")[-1] == \
            open(jax_mod.__file__).read().split("_run(")[-1]
    from fashionern_aaai2024_tpu_torch.run import _run

    clip_path, ern_path, _, _ = weights
    root = trees["shoes"]
    monkeypatch.setattr("sys.argv", [
        "test_shoes", "--data-root", root, "--clip-model-name", tiny, "--batch-size", "4",
        "--num-workers", "0", "--json", "--device", "cpu", "--clip-path", clip_path,
        "--fusion-model-path", ern_path, "--bpe-path", os.path.join(root, "bpe.txt.gz")])
    assert _run("eval", "shoes") == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == {"recall_at10", "recall_at50", "avg"}


# --- extract-patches and convert-patches ---------------------------------------------


@pytest.fixture(scope="module")
def crop_images(tmp_path_factory):
    d = tmp_path_factory.mktemp("crops")
    g = np.random.default_rng(9)
    paths = []
    for i, (h, w) in enumerate(((100, 80), (61, 97))):
        arr = g.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for ext, kw in (("png", {}), ("jpg", {"quality": 90})):
            p = d / "images" / f"im{i}.{ext}"
            p.parent.mkdir(exist_ok=True)
            Image.fromarray(arr).save(p, **kw)
            paths.append(str(p))
    return str(d), paths


def test_crop_geometry_and_crops_match_jax(crop_images):
    _, paths = crop_images
    img = Image.open(paths[2]).convert("RGB")
    for grids in ((2, 3), (4,)):
        got, want = extract_patches.cut_crops(img, grids), jax_extract.cut_crops(img, grids)
        assert [c.size for c in got] == [c.size for c in want]
        assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(got, want))
    for p in paths + [img]:
        for ratio in (1.25, 1.0):
            assert np.array_equal(extract_patches.image_to_crop_array(p, 32, ratio),
                                  jax_extract.image_to_crop_array(p, 32, ratio))


def test_patch_extractor_matches_jax_on_bridged_weights(tiny, crop_images, weights, tmp_path):
    root, _ = crop_images
    clip_path, _, _, clip_vars = weights
    from fashionern_aaai2024_tpu.models.clip.model import CLIP as JaxCLIP

    jm = JaxCLIP(_tiny(jax_config))
    enc = jax.jit(lambda imgs: jm.apply(clip_vars, imgs, method=jm.encode_image)[0])
    items = jax_extract.enumerate_image_dir(root)
    assert items == extract_patches.enumerate_image_dir(root) and len(items) == 4
    jax_extract.PatchExtractor(enc, 32, batch_images=3).run(items, str(tmp_path / "jax"),
                                                            logger=lambda m: None)
    args = cli.build_parser().parse_args([
        "extract-patches", "--data-root", root, "--clip-model-name", tiny, "--clip-path",
        clip_path, "--out-dir", str(tmp_path / "port"), "--batch-images", "3",
        "--device", "cpu"])
    assert cli.run_extract_patches(args) == 4
    for _, name in items:
        got = np.load(tmp_path / "port" / f"{name}.npy")
        want = np.load(tmp_path / "jax" / f"{name}.npy")
        assert got.shape == (13, D)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    assert json.load(open(tmp_path / "port" / "pack.names.json")) == \
        json.load(open(tmp_path / "jax" / "pack.names.json"))


def test_convert_patches_round_trip(tmp_path):
    g = np.random.default_rng(10)
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    feats = {"a": g.standard_normal((13, 8)), "sub/b": g.standard_normal((13, 8))}
    for name, f in feats.items():
        torch.save(torch.from_numpy(f.astype(np.float32)), src / f"{name}.pth")
    assert convert_patches.convert_dir(str(src), str(tmp_path / "port"), logger=None) == 2
    assert jax_convert.convert_dir(str(src), str(tmp_path / "jax"), logger=None) == 2
    for rel in ("a.npy", "sub/b.npy", "pack.npy", "pack.names.json"):
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    for name, f in feats.items():
        assert np.array_equal(np.load(tmp_path / "port" / f"{name}.npy"), f.astype(np.float32))
    os.remove(tmp_path / "port" / "pack.npy")
    assert cli.main(["convert-patches", "--src", str(tmp_path / "port"), "--pack-only"]) == 0
    assert (tmp_path / "port" / "pack.npy").read_bytes() == \
        (tmp_path / "jax" / "pack.npy").read_bytes()


def test_make_fixture_subcommand(tmp_path, capsys):
    assert cli.main(["make-fixture", "--dataset", "shoes", "--out", str(tmp_path / "s"),
                     "--learnable", "--n-images", "6", "--n-triplets", "3"]) == 0
    assert "fixture written" in capsys.readouterr().out
    want = jax_make_fixture(str(tmp_path / "j"), "shoes", learnable=True, n_images=6,
                            n_triplets=3)
    assert json.load(open(tmp_path / "s" / "triplet.val.json")) == \
        json.load(open(os.path.join(want, "triplet.val.json")))
    make_fixture(str(tmp_path / "p"), "shoes", learnable=True, n_images=6, n_triplets=3)
    assert open(tmp_path / "p" / "fixture_attrs.json").read() == \
        open(tmp_path / "s" / "fixture_attrs.json").read()
