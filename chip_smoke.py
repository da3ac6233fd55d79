"""Smoke run of the PyTorch port's serve path on one CUDA card.

    python3 chip_smoke.py [--json-out PATH]

Phases (each raises on failure; nothing is caught):
  1. device: require CUDA, print the card's name and power limit, build
     the hand-written kernels from `fashionern_aaai2024_tpu_torch/csrc/`;
  2. kernels: B1 (attention sub-block), B2 (MLP sub-block) and B3
     (packed-qkv attention) against their plain PyTorch versions at the
     slice's shapes, bf16 and fp32, with per-call times (CUDA events,
     median of 25);
  3. the slice: ViT-B-16 at full width with seeded weights under the
     bf16 serve policy, a RetrievalService over a 512-item synthetic
     gallery, 8 single queries and one 32-query batch at k=10, launch
     counts of every kernel on that run, and the card's embeddings held
     against the port's fp32 plain run on the CPU;
  4. timings: gallery embed + index refine in img/s (bench.py's
     definition: bf16, B=128, best of 3 windows of 20) and query P50
     latency at b=1 and b=32.

The line before the last is the kernel summary as one JSON object; the
last line is `{"ok": true, "device": {...}}`. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

from fashionern_aaai2024_tpu_torch.models.clip.config import get_clip_config
from fashionern_aaai2024_tpu_torch.models.clip.model import CLIP_MEAN, CLIP_STD
from fashionern_aaai2024_tpu_torch.models.composed import (
    ComposedCIRModel,
    apply_precision,
    random_init_,
)
from fashionern_aaai2024_tpu_torch.ops import attention as A
from fashionern_aaai2024_tpu_torch.ops import common
from fashionern_aaai2024_tpu_torch.ops import mlp as M
from fashionern_aaai2024_tpu_torch.retrieval.evaluate import InferenceAPI
from fashionern_aaai2024_tpu_torch.retrieval.server import RetrievalService

# tolerances of tests/test_torch_cuda.py: fp32 at the module tolerance;
# bf16 at three significant digits
TOL = {torch.float32: dict(atol=2e-5, rtol=0.0),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
VIT = dict(b=32, s=197, w=768, heads=12, causal=False)
TEXT = dict(s=77, w=512, heads=8, causal=True)
SHAPES = [("vit_b32", VIT), ("text_b32", dict(TEXT, b=32)), ("text_b1", dict(TEXT, b=1))]
GALLERY, BATCH, K, LAYERS = 512, 32, 10, 12
SOT, EOT, CTX = 49406, 49407, 77
CAPTIONS = ["is darker and has longer sleeves", "make it red", "more formal",
            "has a floral print", "is shorter and lighter", "with a collar",
            "less casual and in blue", "has stripes and no logo"]
KERNELS = {  # name -> (wrapper, source, TPU kernel it replaces)
    "attention_subblock (B1)": (A.attention_subblock, "fashionern_aaai2024_tpu_torch/csrc",
                                "fashionern_aaai2024_tpu/ops/attention.py:520"),
    "mlp_subblock (B2)": (M.mlp_subblock, "fashionern_aaai2024_tpu_torch/csrc",
                          "fashionern_aaai2024_tpu/ops/mlp.py:121"),
    "packed_qkv_self_attention (B3)": (A.packed_qkv_self_attention,
                                       "fashionern_aaai2024_tpu_torch/csrc/attention.cu",
                                       "fashionern_aaai2024_tpu/ops/attention.py:147"),
}
SOURCES = {"attention_subblock (B1)": ["layernorm.cu", "gemm.cu", "attention.cu"],
           "mlp_subblock (B2)": ["layernorm.cu", "gemm.cu"],
           "packed_qkv_self_attention (B3)": ["attention.cu"]}


def log(msg: str) -> None:
    print(msg, flush=True)


def tokenizer(texts, context_length=CTX):
    """Deterministic stand-in for the CLIP BPE: crc32 word ids in
    1..49405 between SOT and EOT, zero-padded, so EOT is the argmax."""
    out = np.zeros((len(texts), context_length), np.int32)
    for i, t in enumerate(texts):
        words = [zlib.crc32(w.encode()) % 49405 + 1 for w in t.split()]
        ids = [SOT] + words[:context_length - 2] + [EOT]
        out[i, :len(ids)] = ids
    return out


def median_ms(fn, runs: int = 25) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_inputs(b, s, w, dtype, seed):
    g = torch.Generator().manual_seed(seed)

    def t(*shape, scale=0.02, offset=0.0):
        return (offset + scale * torch.randn(shape, generator=g)).to(dtype).cuda()

    f = 4 * w
    return {
        "attention_subblock (B1)": (t(b, s, w, scale=1.0), t(w, scale=0.1, offset=1.0),
                                    t(w, scale=0.1), t(3 * w, w), t(3 * w), t(w, w), t(w)),
        "mlp_subblock (B2)": (t(b, s, w, scale=1.0), t(w, scale=0.1, offset=1.0),
                              t(w, scale=0.1), t(f, w), t(f), t(w, f), t(w)),
        "packed_qkv_self_attention (B3)": (t(b, s, 3 * w, scale=1.0),),
    }


def phase_kernels() -> tuple[dict, list]:
    plain = {"attention_subblock (B1)": A.attention_subblock_plain,
             "mlp_subblock (B2)": M.mlp_subblock_plain,
             "packed_qkv_self_attention (B3)": A.packed_qkv_self_attention_plain}
    rows, worst = [], {name: 0.0 for name in KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        for label, shp in SHAPES:
            inputs = kernel_inputs(shp["b"], shp["s"], shp["w"], dtype, seed=len(rows))
            for name, (wrapper, _, _) in KERNELS.items():
                args = inputs[name]
                kw = {"activation": "quick_gelu"} if name.startswith("mlp") else {
                    "causal": shp["causal"]}
                pos = () if name.startswith("mlp") else (shp["heads"],)
                got = wrapper(*args, *pos, **kw)
                want = plain[name](*args, *pos, **kw)
                torch.cuda.synchronize()
                torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
                err = (got.float() - want.float()).abs().max().item()
                worst[name] = max(worst[name], err)
                row = dict(kernel=name, shape=label, dtype=str(dtype).split(".")[1],
                           max_abs_err=err,
                           ms=median_ms(lambda: wrapper(*args, *pos, **kw)),
                           plain_ms=median_ms(lambda: plain[name](*args, *pos, **kw)))
                rows.append(row)
                log(f"  {name:32s} {label:9s} {row['dtype']:9s} err {err:.3e}  "
                    f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms")
    return worst, rows


def make_gallery(seed: int = 0):
    g = np.random.default_rng(seed)
    raw = g.random((GALLERY, 224, 224, 3), dtype=np.float32)
    images = ((raw - CLIP_MEAN) / CLIP_STD).astype(np.float32)
    patches = g.standard_normal((GALLERY, 13, 512)).astype(np.float32)
    names = [f"item{i:04d}" for i in range(GALLERY)]
    batches = [{"name": names[i:i + BATCH], "image": images[i:i + BATCH],
                "patch": patches[i:i + BATCH]} for i in range(0, GALLERY, BATCH)]
    return names, images, patches, batches


def cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.cosine_similarity(a.float().cpu(), b.float().cpu(), dim=-1)


def phase_slice(card_label: str) -> tuple[dict, RetrievalService, InferenceAPI]:
    cfg = get_clip_config("ViT-B-16", activation="quick_gelu")
    model = random_init_(ComposedCIRModel(cfg), torch.Generator().manual_seed(0))
    reference = copy.deepcopy(model).eval()          # fp32, plain versions, CPU
    apply_precision(model, "bf16")
    api = InferenceAPI(model, tokenizer=tokenizer, device="cuda", batch_size=BATCH)
    names, images, patches, batches = make_gallery()
    refs = [names[2 * i] for i in range(8)]          # inside the 16 checked items

    for fn, _, _ in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    service = RetrievalService(api, batches)
    singles = [service.query([r], [c], k=K)[0][0] for r, c in zip(refs, CAPTIONS)]
    batch_refs = [names[(7 * i) % GALLERY] for i in range(32)]
    batch_caps = [CAPTIONS[i % 8] for i in range(32)]
    batch_results, _ = service.query(batch_refs, batch_caps, k=K)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, (fn, _, _) in KERNELS.items()}

    tower_calls = GALLERY // BATCH + len(refs) + 1   # ViT batches + text calls
    log(f"  main path {run_s:.2f} s; launches {launches} "
        f"(expected {LAYERS * tower_calls} each: {LAYERS} layers x {tower_calls} tower calls)")
    for name, n in launches.items():
        if n != LAYERS * tower_calls:
            raise AssertionError(f"{name}: {n} launches, expected {LAYERS * tower_calls}")
    for res in singles + batch_results:
        scores = [r["score"] for r in res]
        if len(res) != K or not np.all(np.isfinite(scores)) or scores != sorted(
                scores, reverse=True):
            raise AssertionError(f"bad result list: {res}")

    # the card's final embeddings against the fp32 plain run on the CPU
    ref_api = InferenceAPI(reference, tokenizer=tokenizer, device="cpu", batch_size=16)
    g16, _ = ref_api.encode_image(images[:16])
    cpu_gallery = ref_api.refine_gallery(g16, patches[:16])
    card_gallery = service.index.features[:16]
    rows = [service.rows[r] for r in refs]
    ids = tokenizer(CAPTIONS)
    tg, ts = ref_api.encode_text(ids)
    cpu_query = ref_api.query(g16[rows], patches[rows], tg, ts)
    ctg, cts = api.encode_text(ids)
    card_query = api.query(service.gallery.features[rows], service.gallery.local_features[rows],
                           ctg, cts)
    cos_g, cos_q = cosine(card_gallery, cpu_gallery), cosine(card_query, cpu_query)
    _, top_card = service.index.search(card_query, k=K)
    _, top_cpu = service.index.search(cpu_query, k=K)
    overlap = float(np.mean([len(set(a) & set(b)) / K for a, b in zip(top_card, top_cpu)]))
    log(f"  card bf16 vs CPU fp32: gallery cosine min {cos_g.min().item():.5f}, "
        f"query cosine min {cos_q.min().item():.5f}, top-{K} overlap {overlap:.3f} "
        f"({card_label})")
    if cos_g.min() < 0.99 or cos_q.min() < 0.99:
        raise AssertionError("card embeddings disagree with the fp32 CPU run")
    return dict(main_path_seconds=run_s, launches=launches,
                gallery_cosine_min=cos_g.min().item(), query_cosine_min=cos_q.min().item(),
                topk_overlap=overlap, startup_seconds=service.startup_seconds), service, api


def phase_timings(service: RetrievalService, api: InferenceAPI) -> dict:
    g = np.random.default_rng(1)
    b = 128
    images = torch.from_numpy(g.random((b, 224, 224, 3), dtype=np.float32)).to(
        "cuda", torch.bfloat16)
    patches = torch.from_numpy(g.standard_normal((b, 13, 512)).astype(np.float32)).cuda()
    bench_api = InferenceAPI(api.model, tokenizer=tokenizer, device="cuda", batch_size=b)

    def embed_and_refine():
        feats, _ = bench_api.encode_image(images)
        return bench_api.refine_gallery(feats, patches)

    for _ in range(2):
        embed_and_refine()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(20):
            out = embed_and_refine()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    if not torch.isfinite(out).all():
        raise AssertionError("non-finite refined embeddings")
    img_s = b * 20 / best

    names = service.gallery.names
    lat = {}
    for qb, reps in ((1, 50), (32, 20)):
        for _ in range(3):
            service.query(names[:qb], [CAPTIONS[i % 8] for i in range(qb)], k=K)
        times = [service.query(names[i:i + qb], [CAPTIONS[(i + j) % 8] for j in range(qb)],
                               k=K)[1] for i in range(reps)]
        lat[f"query_p50_ms_b{qb}"] = statistics.median(times) * 1e3
    return dict(embed_refine_img_per_s=img_s, **lat)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json-out", help="also write every measurement to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this run needs one GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    t0 = time.perf_counter()
    common.LIBRARY.load()
    log(f"phase 1: kernels built in {common.LIBRARY.build_seconds:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s) at {common.LIBRARY.library_path()}")

    log(f"phase 2: kernels against their plain versions ({card})")
    worst, rows = phase_kernels()
    log(f"phase 3: the serve slice, ViT-B-16 bf16 ({card})")
    slice_info, service, api = phase_slice(card)
    log(f"phase 4: timings ({card})")
    timings = phase_timings(service, api)
    log(f"  embed + refine {timings['embed_refine_img_per_s']:.2f} img/s (B=128 bf16); "
        f"query P50 {timings['query_p50_ms_b1']:.3f} ms at b=1, "
        f"{timings['query_p50_ms_b32']:.3f} ms at b=32 ({card})")

    headline = {r["kernel"]: r for r in rows if r["shape"] == "vit_b32" and r["dtype"] == "bfloat16"}
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=slice_info["launches"][name], max_abs_err=worst[name],
                    ms=headline[name]["ms"], plain_ms=headline[name]["plain_ms"],
                    files=SOURCES[name])
               for name, (_, src, rep) in KERNELS.items()]
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(dict(card=card, kernel_rows=rows, slice=slice_info, timings=timings,
                           build_seconds=common.LIBRARY.build_seconds), f, indent=1)
    print(f"{card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
