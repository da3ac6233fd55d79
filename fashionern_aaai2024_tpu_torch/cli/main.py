"""`fashionern-torch`: the port's CLI (train / eval / make-fixture / ...).

JAX counterpart: `fashionern_aaai2024_tpu/cli/main.py`: the same
subcommands with the same flags and defaults (`:28-306`), so that a
recipe of the JAX CLI runs here unchanged, and one flag of the port's
own, `--device` (default `cuda`; without a GPU that raises, and the run
never drops to the CPU unless `--device cpu` asks for it). Run it as
`fashionern-torch ...` or `python -m fashionern_aaai2024_tpu_torch.cli.main ...`.

Checkpoints: `--clip-path`, `--clip-model-path` and `--fusion-model-path`
take the reference's torch `state_dict`s (`.pth`) directly;
`--fusion-model-path` also takes the port's best checkpoint, whose
`.meta.json` sidecar gives the init seed of the random-init towers
(`load_model_variables`).

Not here: `fetch-bpe` (it downloads) and `convert-ckpt` (the port needs
no conversion): not to port (ROADMAP).

Data parallel (JAX `:124, 444-450, 594-601, 635-654`): launch one process
a device with `torchrun --nproc-per-node N -m
fashionern_aaai2024_tpu_torch.cli.main train ...` (as JAX's `train`
takes every device, the port's takes every rank of the launch) or `eval
| serve ... --data-parallel`; each process joins the group (`parallel/mesh.py initialize_distributed`:
NCCL on `cuda:LOCAL_RANK`, gloo with `--device cpu`; without torchrun's
environment, a group of one rank). `train` runs the Trainer on the mesh
(`--batch-size` a rank, `--negatives local|global`); `eval` splits each
batch over the ranks; `serve` builds the gallery-sharded serve program,
rank 0 owns the HTTP front and the micro-batcher and the other ranks
run each dispatch in lockstep (`ShardedServeFn.follow`). Only rank 0
prints results and writes files.

`export`, `refresh-artifact` and `serve-artifact` (JAX `:613-629`,
`:675-721`) write, republish and serve a serve artifact
(`retrieval/artifact.py`). `serve-artifact` imports nothing of `models/`
or `data/`: `main` parses it with its own parser, and this module imports
the model configs only where a command builds a model.

`serve` (`build_service`, `run_serve`; JAX `:569-612`, `:631-670`)
builds the service and serves it over HTTP until interrupted, and prints
one line with the bound URL (`--port 0` takes a free port). With
`--native-front` it serves `/query` through the C++ front and `/add` on
the admin port; where the front cannot be built, it raises (JAX falls
back to the Python server).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import warnings

_TORCH_EXTS = (".pth", ".pt", ".bin")


def get_clip_config(*args, **kwargs):
    from fashionern_aaai2024_tpu_torch.models.clip import config

    return config.get_clip_config(*args, **kwargs)


def _backbones() -> list:
    from fashionern_aaai2024_tpu_torch.models.clip.config import _CONFIGS

    return sorted(_CONFIGS)


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dataset", default="fashioniq",
                   choices=["fashioniq", "fashioniq-val", "cirr", "shoes", "fashion200k"])
    p.add_argument("--data-root", required=True,
                   help="Dataset root directory (replaces the reference's hardcoded paths)")
    p.add_argument("--clip-model-name", default="RN50x4", choices=_backbones())
    p.add_argument("--patch-num", default=13, type=int)
    p.add_argument("--num-workers", default=4, type=int)
    p.add_argument("--worker-type", default="thread", choices=["thread", "process"],
                   help="'process' = fork workers (reference DataLoader model), "
                        "for decode-bound datasets")
    p.add_argument("--target-ratio", default=1.25, type=float)
    p.add_argument("--transform", default="targetpad",
                   choices=["targetpad", "squarepad", "none"])
    p.add_argument("--image-dtype", default="float32",
                   choices=["float32", "uint8"],
                   help="'uint8' feeds raw pixels and normalizes on device "
                        "(4x less host->device transfer; ~1-ulp feature delta)")
    p.add_argument("--bpe-path", default=None,
                   help="Path to open_clip's bpe_simple_vocab_16e6.txt.gz")
    p.add_argument("--tme", action="store_true",
                   help="TME text enhancement: a trainable cross-attention "
                        "module (ERN subtree, models/ern/tme.py) conditions "
                        "text encoding on the reference patches — the "
                        "reconstruction of the reference's closed-source "
                        "fork surface (README.md:41). Pass the SAME flag "
                        "to train/eval/serve/export so checkpoints match")
    _add_device(p)


def _add_serve_artifact(sub) -> None:
    """The deploy host's subcommand: the artifact and the HTTP flags, none
    of the dataset, model or checkpoint flags."""
    sa = sub.add_parser("serve-artifact", help="serve an exported artifact over HTTP")
    sa.add_argument("--artifact", required=True, help="artifact directory "
                    "produced by `fashionern-torch export`")
    sa.add_argument("--host", default="127.0.0.1")
    sa.add_argument("--port", default=8080, type=int)
    sa.add_argument("--no-dynamic-batching", action="store_true")
    sa.add_argument("--allow-platform-mismatch", action="store_true",
                    help="load an artifact exported for another device type "
                         "(see its manifest)")
    sa.add_argument("--bpe-path", default=None,
                    help="BPE merges table for the server-side tokenizer")
    _add_device(sa)


def build_serve_artifact_parser() -> argparse.ArgumentParser:
    """A parser of `serve-artifact` alone (`main` parses that command with
    it, so that serving an artifact imports no model module)."""
    parser = argparse.ArgumentParser(prog="fashionern-torch")
    _add_serve_artifact(parser.add_subparsers(dest="command", required=True))
    return parser


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device the model runs on (the port's only flag of its "
                        "own); 'cuda' raises without a GPU, pass 'cpu' to run there")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="fashionern-torch",
        description="The PyTorch / CUDA port's CLI: the JAX `fashionern` CLI's "
                    "subcommands and flags.",
        epilog="Not ported: fetch-bpe (it downloads; pass --bpe-path) and convert-ckpt "
               "(the port loads the reference .pth state_dicts directly).")
    sub = parser.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="fine-tune the ERN fusion stack")
    _add_common(t)
    t.add_argument("--lr", default=4e-5, type=float)
    t.add_argument("--batch-size", default=1024, type=int,
                   help="per-shard batch (reference: per-rank)")
    t.add_argument("--num-epochs", default=300, type=int)
    t.add_argument("--validation-frequency", default=3, type=int)
    t.add_argument("--print-frequency", default=100, type=int)
    t.add_argument("--validation-bs", default=32, type=int)
    t.add_argument("--clip-model-path", default=None,
                   help="fine-tuned CLIP checkpoint (.pth with 'CLIP' key, or raw state dict)")
    t.add_argument("--ckpt-dir", default="ckpt")
    t.add_argument("--seed", default=42, type=int)
    t.add_argument("--negatives", default="local", choices=["local", "global"],
                   help="'local' = per-shard in-batch negatives (reference DDP parity)")
    t.add_argument("--log-path", default=None)
    t.add_argument("--max-steps-per-epoch", default=None, type=int)
    t.add_argument("--resume", default=None,
                   help="train-state file from a previous run "
                        "(written as <ckpt-dir>/<dataset>-resume)")
    t.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of steps 2-4 here")
    t.add_argument("--precision", default="fp32", choices=["fp32", "bf16"],
                   help="bf16 runs the frozen CLIP towers in bf16 (fusion stays fp32)")
    t.add_argument("--cache-features", action="store_true",
                   help="pre-encode unique train images once (CLIP is frozen); "
                        "per-step image towers become lookups, text stays online")
    t.add_argument("--quantize-towers", action="store_true",
                   help="int8 frozen towers in the train step (kernels B5 / B6): "
                        "the fallback when the image set outruns "
                        "--cache-features (the towers run without gradients, "
                        "so the forward-only int8 path is legal)")
    t.add_argument("--prefetch", default=2, type=int,
                   help="host->device prefetch depth: decode, tokenize and the "
                        "copy run on a background thread this many batches ahead "
                        "of the step (0 = serial feed; the same numbers either way)")
    t.add_argument("--validate-200k", action="store_true",
                   help="opt-in in-training validation for fashion200k "
                        "(multi-positive test-split eval per validation "
                        "epoch + best-ckpt selection; the reference skips "
                        "it for gallery size, base_trainer.py:50-53)")

    e = sub.add_parser("eval", help="run a retrieval benchmark")
    _add_common(e)
    e.add_argument("--clip-path", default=None,
                   help="fine-tuned CLIP checkpoint (reference saved_state_dict['CLIP'])")
    e.add_argument("--fusion-model-path", default=None,
                   help="fusion (ERN) checkpoint: the reference's .pth state_dict or "
                        "the port's best checkpoint (<ckpt-dir>/<dataset>-best)")
    e.add_argument("--seed", default=None, type=int,
                   help="init seed for random-init model parts (default: "
                        "the fusion ckpt's recorded train-init seed, "
                        "else 42)")
    e.add_argument("--batch-size", default=32, type=int)
    e.add_argument("--split", default="val")
    e.add_argument("--json", action="store_true", help="print metrics as one JSON line")
    e.add_argument("--submission-dir", default=None,
                   help="CIRR test1: write recall_submission.json + "
                        "recall_subset_submission.json here instead of metrics")
    e.add_argument("--data-parallel", action="store_true",
                   help="shard eval batches over the ranks of a torchrun launch")
    e.add_argument("--quantize-gallery", action="store_true",
                   help="int8 gallery for the top-k search (4x less HBM)")
    e.add_argument("--quantize-towers", action="store_true",
                   help="int8 tower projections (kernels B5 / B6): MLP matmuls "
                        "and the attention qkv/out projections; dynamic "
                        "symmetric quant, same checkpoints")
    e.add_argument("--fold-bn", action="store_true",
                   help="fold frozen BatchNorm into RN conv kernels at "
                        "weight load (the same forward up to one rounding)")
    e.add_argument("--topk-recall", default=None, type=float,
                   metavar="R",
                   help="approximate top-k at recall target R (the exact "
                        "top-k runs when omitted)")
    e.add_argument("--precision", default="fp32", choices=["fp32", "bf16"],
                   help="tower/fusion weight+activation dtype "
                        "(models/composed.py apply_precision)")

    sv = sub.add_parser("serve",
                        help="persistent retrieval service over HTTP")
    _add_common(sv)
    sv.add_argument("--clip-path", default=None)
    sv.add_argument("--fusion-model-path", default=None)
    sv.add_argument("--seed", default=None, type=int)
    sv.add_argument("--batch-size", default=32, type=int)
    sv.add_argument("--split", default="val")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", default=8080, type=int)
    sv.add_argument("--quantize-gallery", action="store_true")
    sv.add_argument("--quantize-refs", action="store_true",
                    help="int8 reference feature/patch rows in the serve "
                         "program (~4x on the dominant serving-HBM term "
                         "and on the export consts sidecar; ~0.4%% extra "
                         "quant error on DVR inputs)")
    sv.add_argument("--quantize-towers", action="store_true")
    sv.add_argument("--topk-recall", default=None, type=float, metavar="R",
                    help="approx top-k selector at recall target R "
                         "(serving tier; exact when omitted)")
    sv.add_argument("--fold-bn", action="store_true")
    sv.add_argument("--data-parallel", action="store_true",
                    help="gallery-sharded serving over the ranks of a torchrun launch "
                         "(rank 0 serves HTTP)")
    sv.add_argument("--precision", default="bf16", choices=["fp32", "bf16"],
                   help="serving dtype")
    sv.add_argument("--capacity", default=None, type=int,
                    help="pre-allocate gallery rows for LIVE additions "
                         "(POST /add embeds + serves new items with "
                         "zero recompiles; default: fixed gallery)")
    sv.add_argument("--no-dynamic-batching", action="store_true",
                    help="disable coalescing of concurrent single queries "
                         "into shared dispatches (on by default)")
    sv.add_argument("--native-front", action="store_true",
                    help="serve /query through the C++ epoll front-end "
                         "(native/fastserve.cpp): HTTP+JSON parse, BPE "
                         "tokenize, and micro-batching all run GIL-free; "
                         "Python keeps only the jitted dispatch. Admin "
                         "endpoints (/add, /reload) stay on a Python "
                         "server at --admin-port")
    sv.add_argument("--admin-port", default=None, type=int,
                    help="port for the Python admin server when "
                         "--native-front is set (default: port+1)")

    ex = sub.add_parser(
        "export",
        help="export the one-dispatch serve program as an artifact "
             "(torch.export, one program per bucket + a consts sidecar)")
    _add_common(ex)
    ex.add_argument("--clip-path", default=None)
    ex.add_argument("--fusion-model-path", default=None)
    ex.add_argument("--seed", default=None, type=int)
    ex.add_argument("--batch-size", default=32, type=int)
    ex.add_argument("--split", default="val")
    ex.add_argument("--out", required=True, help="artifact directory")
    ex.add_argument("--quantize-gallery", action="store_true")
    ex.add_argument("--quantize-refs", action="store_true",
                    help="int8 ref rows: ~4x smaller consts sidecar")
    ex.add_argument("--quantize-towers", action="store_true")
    ex.add_argument("--topk-recall", default=None, type=float, metavar="R",
                    help="approx top-k selector baked into the exported "
                         "serve programs (exact when omitted)")
    ex.add_argument("--fold-bn", action="store_true")
    ex.add_argument("--precision", default="bf16", choices=["fp32", "bf16"])

    rf = sub.add_parser(
        "refresh-artifact",
        help="republish an artifact's weights and gallery from a "
             "retrained checkpoint")
    _add_common(rf)
    rf.add_argument("--clip-path", default=None)
    rf.add_argument("--fusion-model-path", default=None)
    rf.add_argument("--seed", default=None, type=int)
    rf.add_argument("--batch-size", default=32, type=int)
    rf.add_argument("--split", default="val")
    rf.add_argument("--artifact", required=True, help="artifact directory "
                    "produced by `fashionern export`")
    rf.add_argument("--quantize-gallery", action="store_true")
    rf.add_argument("--quantize-refs", action="store_true",
                    help="must match the exported artifact's flag — the "
                         "consts tree structure differs")
    rf.add_argument("--quantize-towers", action="store_true")
    rf.add_argument("--topk-recall", default=None, type=float, metavar="R")
    rf.add_argument("--fold-bn", action="store_true")
    rf.add_argument("--precision", default="bf16", choices=["fp32", "bf16"])
    rf.add_argument("--reload-url", default=None,
                    help="base URL of a running serve-artifact daemon "
                         "(e.g. http://127.0.0.1:8080) to POST /reload "
                         "after republishing")

    _add_serve_artifact(sub)

    sub.add_parser("info", help="print backbones, datasets, native libraries, image "
                                "routes and what is not ported")

    x = sub.add_parser("extract-patches",
                       help="offline 13-crop patch features (batched on the card)")
    x.add_argument("--data-root", required=True)
    x.add_argument("--dataset", default="fashioniq",
                   choices=["fashioniq", "cirr", "shoes", "fashion200k"])
    x.add_argument("--clip-model-name", default="RN50x4", choices=_backbones())
    x.add_argument("--clip-path", default=None,
                   help="fine-tuned CLIP checkpoint for the crop encoder")
    x.add_argument("--out-dir", required=True)
    x.add_argument("--image-dir", default="images")
    x.add_argument("--batch-images", default=16, type=int)
    x.add_argument("--target-ratio", default=1.25, type=float)
    x.add_argument("--no-pack", action="store_true")
    _add_device(x)

    cp = sub.add_parser("convert-patches", help=".pth patch dumps → .npy + pack")
    cp.add_argument("--src", required=True)
    cp.add_argument("--dst", default=None)
    cp.add_argument("--pack-only", action="store_true",
                    help="only rebuild pack.npy from existing .npy files")

    mf = sub.add_parser("make-fixture",
                        help="write a tiny synthetic on-disk dataset in the "
                             "exact real layout (smoke tests / dress rehearsal)")
    mf.add_argument("--dataset", required=True,
                    choices=["fashioniq", "cirr", "shoes", "fashion200k"])
    mf.add_argument("--out", required=True)
    mf.add_argument("--dim", default=512, type=int,
                    help="patch feature dim (512 ViT-B-16 / 640 RN50x4)")
    mf.add_argument("--patch-num", default=13, type=int)
    mf.add_argument("--seed", default=0, type=int)
    mf.add_argument("--n-images", default=None, type=int,
                    help="per-type image universe size (default: tiny "
                         "plumbing fixture; accuracy soak uses larger)")
    mf.add_argument("--n-triplets", default=None, type=int,
                    help="per-type per-split triplet count")
    mf.add_argument("--n-per-color", default=None, type=int,
                    help="fashion200k only: images per (color,style) class "
                         "per split (gallery scale knob)")
    mf.add_argument("--n-queries", default=None, type=int,
                    help="fashion200k only: test_queries.txt size")
    mf.add_argument("--learnable", action="store_true",
                    help="images carry visible (color, pattern) attributes "
                         "and captions describe the target's — held-out "
                         "queries become genuinely learnable "
                         "(fashioniq/cirr/shoes)")

    return parser


def _load_torch_state_dict(path: str) -> dict:
    """A reference checkpoint's state_dict: the `CLIP` entry of a saved
    dict, a saved module's state_dict, or the dict itself; a DDP
    `module.` prefix is dropped. (A reference checkpoint may hold pickled
    objects, so this loads with `weights_only=False`, as JAX does: load
    only checkpoints you trust.)"""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "CLIP" in sd:
        sd = sd["CLIP"]
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k.removeprefix("module."): v for k, v in sd.items()}


def _load_into(module, sd: dict, what: str) -> None:
    """`load_state_dict` that tolerates what the JAX converters ignore
    (BatchNorm counters, mask buffers) and raises on anything else."""
    missing, unexpected = module.load_state_dict(sd, strict=False)
    ignorable = ("num_batches_tracked", "attn_mask")
    missing = [k for k in missing if not k.endswith(ignorable)]
    unexpected = [k for k in unexpected if not k.endswith(ignorable)]
    if missing or unexpected:
        raise KeyError(f"{what}: missing keys {missing[:20]}, unexpected keys "
                       f"{unexpected[:20]}")


def load_model_variables(clip_cfg, clip_path: str | None, fusion_path: str | None,
                         patch_num: int, seed: int | None = None, device="cuda"):
    """The composed model with its weights, on `device`: from checkpoints
    where given and the JAX package's seeded init (`models/composed.py
    jax_init_`, drawn on `device`) for the rest, so a seed gives the JAX
    CLI's weights.

    The seed of the random parts: explicit `seed` > the best checkpoint's
    `.meta.json` sidecar (the init seed the fusion stack was trained
    against) > 42. With random-init towers (no `clip_path`), a trained ERN
    evaluated against towers of another seed returns noise-level recalls."""
    from fashionern_aaai2024_tpu_torch.models.composed import seeded_model
    from fashionern_aaai2024_tpu_torch.train.checkpoint import load_meta, restore_params

    meta = {}
    if fusion_path and not fusion_path.endswith(_TORCH_EXTS):
        meta = load_meta(fusion_path) or {}
    if seed is None:
        seed = meta.get("init_seed", 42) if clip_path is None else 42
    if clip_path is None and meta.get("clip_from_checkpoint"):
        warnings.warn(
            "fusion checkpoint was trained against CLIP weights loaded "
            "from a checkpoint, but no --clip-model-path was given — "
            "evaluating it against random-init towers returns garbage",
            stacklevel=2)
    if "tme" in meta and bool(meta["tme"]) != bool(clip_cfg.text.tme):
        warnings.warn(
            f"fusion checkpoint was trained with tme={meta['tme']} but the "
            f"model is built with tme={clip_cfg.text.tme} — pass the same "
            "--tme flag the training run used (the ERN param trees differ)",
            stacklevel=2)
    model = seeded_model(clip_cfg, seed, device, patch_num=patch_num)
    if clip_path:
        _load_into(model.clip, _load_torch_state_dict(clip_path), clip_path)
    if fusion_path:
        if fusion_path.endswith(_TORCH_EXTS):
            # the reference ERN holds its frozen CLIP wrappers too
            sd = {k: v for k, v in _load_torch_state_dict(fusion_path).items()
                  if not k.startswith(("image_clip.", "text_clip."))}
        else:
            sd = restore_params(fusion_path)
        _load_into(model.ern, sd, fusion_path)
    return model


def _pad_mode(transform: str) -> str:
    return {"targetpad": "target", "squarepad": "square", "none": "none"}[transform]


def _tokenizer(args):
    """The BPE tokenizer of a run: `--bpe-path`'s table, else the one
    `default_bpe_path` finds."""
    from fashionern_aaai2024_tpu_torch.models.clip.tokenizer import SimpleTokenizer, tokenize

    return SimpleTokenizer(args.bpe_path) if getattr(args, "bpe_path", None) else tokenize


def _mesh(args):
    """The data-parallel mesh of a run: with `--data-parallel`, or for
    `train` under torchrun (WORLD_SIZE set; JAX's `train` always takes
    every device), this process joins the group on `--device`; else
    None."""
    launched = getattr(args, "command", None) == "train" and "WORLD_SIZE" in os.environ
    if not (getattr(args, "data_parallel", False) or launched):
        return None
    from fashionern_aaai2024_tpu_torch.parallel.mesh import initialize_distributed

    return initialize_distributed(device=getattr(args, "device", "cuda"))


def _is_primary() -> bool:
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _dataset_kwargs(args, clip_cfg) -> dict:
    return dict(dim=clip_cfg.input_dim, pad_mode=_pad_mode(args.transform),
                target_ratio=args.target_ratio,
                image_dtype=getattr(args, "image_dtype", "float32"))


def _loader(args, dataset):
    from fashionern_aaai2024_tpu_torch.data.loader import Loader

    return Loader(dataset, args.batch_size, num_workers=args.num_workers,
                  worker_type=getattr(args, "worker_type", "thread"))


def build_inference_api(args):
    """The InferenceAPI of an eval or serve run: the model from
    `--clip-path`, `--fusion-model-path` and the seed, with `--fold-bn`
    and the `--precision` policy, on `--device`; `--quantize-gallery`,
    `--quantize-refs` and `--topk-recall`."""
    from fashionern_aaai2024_tpu_torch.models.clip.resnet import ModifiedResNet, fold_batchnorm
    from fashionern_aaai2024_tpu_torch.models.composed import apply_precision
    from fashionern_aaai2024_tpu_torch.retrieval.evaluate import InferenceAPI, resolve_device

    mesh = _mesh(args)
    device = resolve_device(getattr(args, "device", "cuda") if mesh is None else mesh.device)
    clip_cfg = get_clip_config(
        args.clip_model_name,
        quantize_mlp=True if getattr(args, "quantize_towers", False) else None,
        tme=True if getattr(args, "tme", False) else None)
    model = load_model_variables(clip_cfg, args.clip_path, args.fusion_model_path,
                                 args.patch_num, seed=getattr(args, "seed", None),
                                 device=device)
    if getattr(args, "fold_bn", False) and isinstance(model.clip.visual, ModifiedResNet):
        fold_batchnorm(model.clip.visual)
    apply_precision(model, getattr(args, "precision", "fp32"))
    return InferenceAPI(model, tokenizer=_tokenizer(args), device=device,
                        batch_size=args.batch_size,
                        context_length=clip_cfg.text.context_length,
                        quantize_gallery=getattr(args, "quantize_gallery", False),
                        quantize_refs=getattr(args, "quantize_refs", False),
                        approx_recall=getattr(args, "topk_recall", None), mesh=mesh)


def run_eval(args) -> dict:
    """`eval`: the dataset's evaluator (`retrieval/evaluate.py`) over its
    classic (gallery) and relative (query) loaders; CIRR `test1` writes
    the two submission files instead and returns their paths."""
    from fashionern_aaai2024_tpu_torch.retrieval import evaluate as E

    api = build_inference_api(args)
    mk = _dataset_kwargs(args, get_clip_config(args.clip_model_name))
    if args.dataset in ("fashioniq", "fashioniq-val"):
        from fashionern_aaai2024_tpu_torch.data.fashioniq import DRESS_TYPES, FashionIQDataset

        val_protocol = args.dataset == "fashioniq-val"
        loaders = {}
        for dt in DRESS_TYPES:
            classic = FashionIQDataset(args.data_root, args.split, [dt], mode="classic",
                                       val_protocol=val_protocol, **mk)
            relative = FashionIQDataset(args.data_root, args.split, [dt], mode="relative",
                                        **mk)
            loaders[dt] = (_loader(args, classic), _loader(args, relative))
        if val_protocol:
            return {dt: E.evaluate_fiq_split(api, c, r, ks=(1, 5, 10, 15, 20, 30, 40, 50))
                    for dt, (c, r) in loaders.items()}
        return E.evaluate_fiq(api, loaders)
    if args.dataset == "cirr":
        from fashionern_aaai2024_tpu_torch.data.cirr import CIRRDataset

        classic = _loader(args, CIRRDataset(args.data_root, args.split, mode="classic", **mk))
        relative = _loader(args, CIRRDataset(args.data_root, args.split, mode="relative",
                                             **mk))
        if args.split == "test1":
            out_dir = args.submission_dir or "cirr_submission"
            payloads = E.generate_cirr_submission(api, classic, relative)
            written = {}
            for name, payload in payloads.items():
                path = os.path.join(out_dir, f"{name}.json")
                if _is_primary():
                    os.makedirs(out_dir, exist_ok=True)
                    with open(path, "w") as f:
                        json.dump(payload, f)
                written[name] = path
            return written
        return E.evaluate_cirr(api, classic, relative)
    if args.dataset == "shoes":
        from fashionern_aaai2024_tpu_torch.data.shoes import ShoesDataset

        return E.evaluate_shoes(
            api, _loader(args, ShoesDataset(args.data_root, args.split, mode="classic", **mk)),
            _loader(args, ShoesDataset(args.data_root, args.split, mode="relative", **mk)))
    # fashion200k: "val" (the default of the other datasets) is its test
    # split, which the reference evaluates (run/test/test_200k.py:116-193)
    from fashionern_aaai2024_tpu_torch.data.fashion200k import (
        Fashion200kTestDataset,
        Fashion200kTestQueryDataset,
    )

    split = "test" if args.split == "val" else args.split
    return E.evaluate_fashion200k(
        api, _loader(args, Fashion200kTestDataset(args.data_root, split=split, **mk)),
        _loader(args, Fashion200kTestQueryDataset(args.data_root, split=split, **mk)))


def make_classic_loader(args):
    """The gallery-side (classic-mode) dataset's loader for a dataset
    choice (JAX: shared by `eval` and `serve`)."""
    mk = _dataset_kwargs(args, get_clip_config(args.clip_model_name))
    if args.dataset in ("fashioniq", "fashioniq-val"):
        from fashionern_aaai2024_tpu_torch.data.fashioniq import DRESS_TYPES, FashionIQDataset

        ds = FashionIQDataset(args.data_root, args.split, DRESS_TYPES, mode="classic",
                              val_protocol=args.dataset == "fashioniq-val", **mk)
    elif args.dataset == "cirr":
        from fashionern_aaai2024_tpu_torch.data.cirr import CIRRDataset

        ds = CIRRDataset(args.data_root, args.split, mode="classic", **mk)
    elif args.dataset == "shoes":
        from fashionern_aaai2024_tpu_torch.data.shoes import ShoesDataset

        ds = ShoesDataset(args.data_root, args.split, mode="classic", **mk)
    else:
        from fashionern_aaai2024_tpu_torch.data.fashion200k import Fashion200kTestDataset

        ds = Fashion200kTestDataset(args.data_root, split=args.split, **mk)
    return _loader(args, ds)


def run_train(args):
    """`train`: the Trainer on `--device` over the dataset's plugin, then
    the resume checkpoint (`<ckpt-dir>/<dataset>-resume`). Returns the
    Trainer."""
    from fashionern_aaai2024_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = TrainConfig(
        dataset="fashioniq" if args.dataset == "fashioniq-val" else args.dataset,
        data_root=args.data_root,
        clip_model_name=args.clip_model_name,
        batch_size=args.batch_size,
        lr=args.lr,
        num_epochs=args.num_epochs,
        validation_frequency=args.validation_frequency,
        print_frequency=args.print_frequency,
        ckpt_dir=args.ckpt_dir,
        seed=args.seed,
        target_ratio=args.target_ratio,
        patch_num=args.patch_num,
        num_workers=args.num_workers,
        worker_type=getattr(args, "worker_type", "thread"),
        negatives=args.negatives,
        eval_batch_size=args.validation_bs,
        log_path=args.log_path,
        max_steps_per_epoch=args.max_steps_per_epoch,
        resume_path=args.resume,
        profile_dir=args.profile_dir,
        precision=args.precision,
        cache_features=getattr(args, "cache_features", False),
        quantize_towers=getattr(args, "quantize_towers", False),
        image_dtype=getattr(args, "image_dtype", "float32"),
        prefetch_batches=getattr(args, "prefetch", 2),
        validate_200k=getattr(args, "validate_200k", False),
        tme=getattr(args, "tme", False),
    )
    trainer = Trainer(cfg, device=getattr(args, "device", "cuda"), mesh=_mesh(args),
                      tokenizer=_tokenizer(args))
    if args.clip_model_path:
        trainer.load_clip_checkpoint(_load_torch_state_dict(args.clip_model_path))
    trainer.train()
    trainer.save_resume_checkpoint()
    return trainer


def build_service(args):
    """The model, the gallery and the RetrievalService of a `serve` run
    (apart from `run_serve`, so that tests drive the wiring without
    `serve_forever`)."""
    from fashionern_aaai2024_tpu_torch.retrieval.server import RetrievalService

    api = build_inference_api(args)
    print(f"embedding gallery ({args.dataset}/{args.split}) ...", flush=True)
    spec = _dataset_kwargs(args, get_clip_config(args.clip_model_name))
    return RetrievalService(api, make_classic_loader(args),
                            capacity=getattr(args, "capacity", None), image_spec=spec,
                            add_root=args.data_root)


def run_serve(args) -> None:
    """`serve`: the service over HTTP until interrupted; one line with the
    bound URL once it takes requests. With `--data-parallel`, rank 0
    serves and the other ranks follow its dispatches."""
    service = build_service(args)
    program = service._serve_fn
    if getattr(program, "mesh", None) is not None:
        if program.mesh.rank != 0:
            program.follow()   # until rank 0 closes the program
            return
        try:
            _serve_http(args, service)
        finally:
            program.close()
        return
    _serve_http(args, service)


def _serve_http(args, service) -> None:
    """The HTTP (or native) front of `serve` over a built service."""
    import threading

    from fashionern_aaai2024_tpu_torch.retrieval.server import serve

    dynamic = not args.no_dynamic_batching
    if args.native_front:
        from fashionern_aaai2024_tpu_torch.native import serve_frontend

        ns = serve_frontend.serve_native(service, host=args.host, port=args.port)
        admin_port = args.admin_port if args.admin_port is not None else args.port + 1
        httpd = serve(service, host=args.host, port=admin_port, dynamic_batching=dynamic)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        print(f"serving {service.gallery_size} gallery items on http://{args.host}:{ns.port} "
              f"(native front; admin /add on http://{args.host}:{httpd.server_address[1]}; "
              f"startup {service.startup_seconds:.1f}s)", flush=True)
        try:
            ns.wait()
        except KeyboardInterrupt:
            pass
        finally:
            ns.shutdown()
            httpd.shutdown()
        return
    httpd = serve(service, host=args.host, port=args.port, dynamic_batching=dynamic)
    print(f"serving {service.gallery_size} gallery items on "
          f"http://{args.host}:{httpd.server_address[1]} "
          f"(startup {service.startup_seconds:.1f}s)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


def run_export(args) -> dict:
    """`export` (JAX `:613-629`): the service that `serve` builds, its serve
    program exported with the consts sidecar (`retrieval/artifact.py`);
    returns the manifest."""
    from fashionern_aaai2024_tpu_torch.retrieval.artifact import export_serve_artifact

    service = build_service(args)
    return export_serve_artifact(
        service._serve_fn, args.out, model_name=args.clip_model_name,
        gallery_names=service.gallery.names,
        extra_meta={"dataset": args.dataset, "split": args.split,
                    "precision": getattr(args, "precision", "bf16"),
                    "quantize_gallery": bool(getattr(args, "quantize_gallery", False)),
                    "quantize_towers": bool(getattr(args, "quantize_towers", False))})


def run_refresh_artifact(args) -> dict:
    """`refresh-artifact` (JAX `:675-693`): the service rebuilt from the
    (retrained) checkpoint flags, its consts republished into the
    artifact, then `POST /reload` to `--reload-url` if given."""
    from fashionern_aaai2024_tpu_torch.retrieval.artifact import refresh_consts

    service = build_service(args)
    manifest = refresh_consts(args.artifact, service._serve_fn)
    print(f"republished consts for {manifest['gallery_size']}-item gallery at "
          f"{args.artifact}", flush=True)
    if getattr(args, "reload_url", None):
        import urllib.request

        req = urllib.request.Request(args.reload_url.rstrip("/") + "/reload", b"{}",
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            print("daemon reload:", r.read().decode(), flush=True)
    return manifest


def run_serve_artifact(args) -> None:
    """`serve-artifact` (JAX `:696-720`): the HTTP daemon over an artifact,
    with none of the model stack; one line with the bound URL once it
    takes requests."""
    from fashionern_aaai2024_tpu_torch.retrieval.server import ArtifactService, serve

    if args.bpe_path:
        os.environ["FASHIONERN_BPE_PATH"] = args.bpe_path
    service = ArtifactService(args.artifact, device=args.device,
                              allow_platform_mismatch=args.allow_platform_mismatch)
    httpd = serve(service, host=args.host, port=args.port,
                  dynamic_batching=not args.no_dynamic_batching)
    print(f"serving {service.gallery_size} gallery items from artifact {args.artifact} on "
          f"http://{args.host}:{httpd.server_address[1]} "
          f"(startup {service.startup_seconds:.1f}s)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


def _native_status(probe) -> object:
    try:
        return probe()
    except RuntimeError as e:  # a failed build: report it, do not hide it
        return f"unavailable: {str(e).splitlines()[0]}"


def run_info() -> dict:
    """Backbones, datasets, the losses and the comparison zoo, the native
    libraries and the image routes, the device, and what is not ported."""
    import torch

    from fashionern_aaai2024_tpu_torch import native
    from fashionern_aaai2024_tpu_torch.models.zoo import _ZOO
    from fashionern_aaai2024_tpu_torch.native import image as native_image
    from fashionern_aaai2024_tpu_torch.native import serve_frontend
    from fashionern_aaai2024_tpu_torch.native import tokenizer as native_tokenizer
    from fashionern_aaai2024_tpu_torch.ops.extra_losses import LOSS_REGISTRY
    from fashionern_aaai2024_tpu_torch.train.trainer import PLUGINS

    cuda = torch.cuda.is_available()
    return {
        "backbones": _backbones(),
        "datasets": sorted(PLUGINS),
        "losses": sorted(LOSS_REGISTRY),
        "zoo_models": sorted(_ZOO),
        "native_loader": _native_status(lambda: native.LIBRARY.load() is not None),
        "native_tokenizer": _native_status(lambda: native_tokenizer.load() is not None),
        "native_image": _native_status(lambda: native_image.library().load() is not None),
        "native_serve_front": _native_status(lambda: serve_frontend.LIBRARY.load() is not None),
        # gray/RGB JPEGs take the native pipeline where libjpeg was found
        "image_routes": {"jpeg": _native_status(native_image.jpeg_route), "other": "pil"},
        "torch": torch.__version__,
        "cuda": {"available": cuda,
                 "device": torch.cuda.get_device_name(0) if cuda else None},
        "not_ported": {"fetch-bpe": "not to port (it downloads)",
                       "convert-ckpt": "not to port (the .pth loads directly)"},
    }


def run_extract_patches(args) -> int:
    """`extract-patches`: 13-crop patch features from the image tower
    (`--clip-path`'s weights, else seed 42's) on `--device`."""
    import torch

    from fashionern_aaai2024_tpu_torch.retrieval.evaluate import resolve_device
    from fashionern_aaai2024_tpu_torch.tools.extract_patches import (
        PatchExtractor,
        enumerate_fashion200k,
        enumerate_image_dir,
    )

    device = resolve_device(args.device)
    clip_cfg = get_clip_config(args.clip_model_name)
    model = load_model_variables(clip_cfg, args.clip_path, None, 13, device=device).eval()

    @torch.inference_mode()
    def encode(images):
        return model.encode_image(torch.from_numpy(images).to(device))[0].float().cpu()

    if args.dataset == "fashion200k":
        items = enumerate_fashion200k(args.data_root)
    else:
        items = enumerate_image_dir(args.data_root, args.image_dir)
    ex = PatchExtractor(encode, clip_cfg.input_dim, batch_images=args.batch_images,
                        target_ratio=args.target_ratio)
    return ex.run(items, args.out_dir, write_pack=not args.no_pack)


def main(argv=None) -> int:
    import torch.distributed as dist

    joined = dist.is_initialized()
    try:
        return _main(argv)
    finally:
        # a group that --data-parallel started ends with the command
        if dist.is_initialized() and not joined:
            dist.destroy_process_group()


def _main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["serve-artifact"]:
        run_serve_artifact(build_serve_artifact_parser().parse_args(argv))
        return 0
    args = build_parser().parse_args(argv)
    if args.command == "export":
        manifest = run_export(args)
        print(f"exported {len(manifest['files'])} programs ({manifest['platform']}) to "
              f"{args.out}", flush=True)
        return 0
    if args.command == "refresh-artifact":
        run_refresh_artifact(args)
        return 0
    if args.command == "train":
        run_train(args)
        return 0
    if args.command == "eval":
        metrics = run_eval(args)
        if not _is_primary():
            return 0
        if args.json:
            print(json.dumps(metrics))
        else:
            for k, v in metrics.items():
                print(f"{k}: {v}")
        return 0
    if args.command == "serve":
        run_serve(args)
        return 0
    if args.command == "extract-patches":
        print(f"extracted {run_extract_patches(args)} images")
        return 0
    if args.command == "convert-patches":
        from fashionern_aaai2024_tpu_torch.tools.convert_patches import build_pack, convert_dir

        n = build_pack(args.src) if args.pack_only else convert_dir(args.src, args.dst)
        print(f"converted {n}")
        return 0
    if args.command == "make-fixture":
        from fashionern_aaai2024_tpu_torch.tools.make_fixture import make_fixture

        root = make_fixture(args.out, args.dataset, dim=args.dim, patch_num=args.patch_num,
                            seed=args.seed, n_images=args.n_images,
                            n_triplets=args.n_triplets, learnable=args.learnable,
                            n_per_color=args.n_per_color, n_queries=args.n_queries)
        print(f"fixture written to {root} (bpe table: {root}/bpe.txt.gz)")
        return 0
    print(json.dumps(run_info(), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
