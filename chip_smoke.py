"""Smoke run of the PyTorch port's serve and train paths on one CUDA card.

    python3 chip_smoke.py [--json-out PATH]

Phases (each raises on failure; nothing is caught):
  1. device: require CUDA, print the card's name and power limit, build
     the hand-written kernels from `fashionern_aaai2024_tpu_torch/csrc/`
     (one nvcc process per source, all at once);
  2. kernels: B1 (attention sub-block), B2 (MLP sub-block) and B3
     (packed-qkv attention) against their plain PyTorch versions at the
     serve path's shapes in bf16 and fp32 (ViT-B-16, and the text towers
     of ViT-B-16 and RN50x4) and at the train path's (the frozen towers at
     B = 1024) in bf16; B7 (QKV projection + attention) at the DVR BERT's
     shapes (b = 32 and 1), B8 (packed-kv cross-attention) at the RN50x4
     attention pool's and the MR cross-attention's, B11 (LayerNorm) at
     ln_final, the BERT's and the ViT's ln_pre, each in bf16 and fp32;
     with per-call times (CUDA
     events, median of 25, the host's enqueue included) beside one PyTorch
     library call computing the same function (`library_ms`, a yardstick
     the port never calls) and the card's bound for the work (`bound_ms`);
     B11 and B12 also in bursts of 10 calls (`burst_ms`, device time a
     call) beside their library calls'; and the host µs of one call of
     `layer_norm`, `combiner_apply` and `launch_gemm` in fp32 and bf16
     (median of 2,000 calls, no synchronisation between them);
  3. the slice: first the port's BPE tokenizer (merges learned from the
     phases' captions, the table every phase tokenizes with): the native
     core's ids against the Python path's, ASCII and non-ASCII captions,
     and its host time at b = 1 and 32; then ViT-B-16 at full width with
     seeded weights under the bf16 serve policy, a RetrievalService over
     a 512-item synthetic gallery, 8 single queries and one 32-query
     batch at k=10, launch counts of every kernel on that run (B10 in
     each text-tower block, B1-B3 in the image tower's, B7 and B8 in the
     DVR query tower, B11 at every standalone LayerNorm), and the card's
     embeddings held against the port's fp32 plain run on the CPU;
  4. timings: gallery embed + index refine in img/s (bench.py's
     definition: bf16, B=128, best of 3 windows of 20) and query P50
     latency at b=1 and b=32;
  5. int8 kernels: B5 (int8 MLP sub-block) and B6 (int8 attention
     sub-block) against their plain versions at vit_b32, text_b32 and
     text_b1 in bf16 and fp32 and at vit_b1024 and text_b1024 in bf16,
     each kernel's LN + quantize prologue counted for flipped int8 codes,
     and a control (the plain version with its activations rounded to
     bf16 before quantizing) that the same check must reject, with the
     same timings; the library yardstick is LN + quantize + `torch._int_mm` +
     rescale (with SDPA for B6's attention), and the bound counts int8
     operations at 1,979 TOPS, attention FLOPs at the float peak and bytes
     at 3.35 TB/s;
  6. the int8 serve slice: the same ViT-B-16 with `quantize_mlp=True`
     (phase 3's seeded weights), bf16, `quantize_gallery=True`, the same
     gallery and queries, launch counts (B5 and B6 on every block, B1-B3
     none), embed + refine img/s and query P50 as in phase 4, the card's
     embeddings against the port's plain int8 run on the CPU in fp32, and
     the top-10 overlap with phase 3's bf16 service;
  7. kernel B4 (the BBC row loss) against its plain version at
     (1024, 512), (1000, 512), (13, 24) and (1024, 640), fp32, with the
     same timings, bursts beside `F.cross_entropy` over the logits (its
     library call), and a TF32 bound (3xTF32) beside the 67 TFLOP/s one;
  8. the int8 train slice: 2 steps of `Trainer.train()` at B = 1024 with
     `quantize_towers=True`, launch counts and step times;
  9. the train slice: ViT-B-16 at full width, seeded weights, the bf16
     train policy, B = 1024, lr 4e-5 (the recipe, `cli/main.py:64-65`):
     first one fp32 step at B = 16 on the card against the same step on
     the CPU with the plain versions (all-keep dropout on both), then 6
     optimizer steps through `Trainer.train()` over an in-memory
     FashionIQ-shaped dataset (uint8 224² images over a universe of
     2,048), one validation through the port's `evaluate_fiq_split`
     (Recall@10 and @50 over a 1,024-item gallery), launch counts of every kernel on the steps and on the
     validation apart, a frozen CLIP and a moving ERN, step times, and a
     `torch.profiler` split of one more step;
  10. the RN50x4 serve slice: the same run as phases 3 and 4 with RN50x4
      (modified ResNet at base width 80 on 288² images, attention pool
      with 40 heads of 64; text tower 12 x 640; DVR at d = 640 with 8
      heads of 80) over a gallery of 512 items with 13 x 640 patches:
      launch counts (B10 in the text tower, B8 once per gallery batch
      and once per query call, B7 twice per query call, B11 at ln_final
      and the BERT's LayerNorms), the tower's output norm, card against
      CPU, embed + refine img/s and query P50;
  11. the TME slice (`tme=True`), ViT-B-16 at full width (d = 512, TME's
      cross-attention 8 heads of 64), seeded weights: the serve run of
      phases 3 and 4 under the bf16 policy (TME in bf16), launch counts
      (B9 and one more B11 per query call, B12 three per query call and
      one per refine chunk), card against the CPU's fp32 plain run (the
      fused queries and TME's text globals, which TME must move from the
      tower's), query P50; then one fp32 train step at B = 16, card against CPU (loss
      rtol 1e-5, ERN and TME gradient cosine >= 0.99999), 3 steps of
      `Trainer.train()` at B = 1024 with step times and launch counts
      (B9 through its autograd Function and one more B11 a step), and a
      profiled step.
  12. the evaluators: `evaluate_fiq` (three dress types) and
      `evaluate_cirr` of ViT-B-16 at full width, seeded weights, over
      in-memory FashionIQ- and CIRR-shaped loaders (galleries of 512,
      256 queries each, batches of 32), on the card under the bf16 serve
      policy and, for the first 64 queries of every evaluator over a
      gallery cut to the images they name, on the CPU in fp32 with the
      plain versions: launch counts on the card, every CPU query's
      prediction card against CPU at cosine >= 0.99, and the recall dicts
      of both;
  13. the attention experiment (X1-X4, `ops/attn_experiment.py`, the
      port of `benchmarks/attn_experiment.py`) at its full shapes (the
      ViT-B-16 attention layer at B = 128: 12 heads of 64, 197 tokens,
      padded to 208 / 256 rows and 128 lanes for X1, 208 rows for X2):
      X1 at every G of its sweep and X2 at every gb, X3 and X4, each in
      fp32 and bf16 against its plain version, timed beside it and
      beside a library composition (SDPA with the bias as `attn_mask`,
      with `F.linear` / `F.layer_norm` around it for X3 and X4); B9
      (`multi_head_attention`) through the grouped kernel at 300, 512
      and 1024 keys, head dims 128 and 64, biased and causal cases (with
      the bias gradient of `MHAFunction`); then the experiment's runner
      (`python -m fashionern_aaai2024_tpu_torch.benchmarks.attn_experiment
      --all`, its fp32 checks, its bf16 G / gb sweeps and library
      times) with launch counts set to 0 just before and held to
      `experiment_launches` just after;
  14. a `torch.profiler` split by kernel of one embed + refine call of
      each tier (phases 4, 6 and 10), of one ViT-B-16 and one RN50x4
      query at b=1, and of one RN50x4 and one TME query at b=32, with the device time of the `record_function` spans (image
      tower, its trunk and attention pool, index refine; text tower, DVR
      query tower, search). Every profile runs after every host-clock and
      event timing: the profiler slows later launches.

Phase 2 also holds B9 (`multi_head_attention`) at TME's shapes (b = 32
and 1024, head dim 64 and 80, fp32 and bf16, and one biased case, whose
bias gradient is held card against plain too) and B12 (`combiner_apply`)
at d = 512 and 640, M = 1, 32, 128 and 1024, fp32 and bf16, against
their plain versions, with the same timings (library calls: SDPA with
the bias as `attn_mask`; the `F.linear` composition). B12's fp32
products run by 3xTF32 on the tensor cores, so its fp32 bound is the
larger of its bytes and three times its FLOPs at the 495 TFLOP/s TF32
peak (the 67 TFLOP/s CUDA-core bound is printed beside it). Every eval
combiner of every phase runs B12: three per query call, one per index
refine chunk. Last in phase 2, B10 (`transformer_block`, the whole
block in one launch) against its plain version and bit for bit against
the B1 + B2 pair it replaces, at the query text towers of ViT-B-16 and
RN50x4 (b = 1 and 32, bf16 and fp32), the train path's text tower and
the ViT-B-16 trunk (bf16), timed beside the pair (the A/B its dispatch
rule reads) and the pair's library compositions; then its autograd
Function's 13 gradients against the plain version's (fp32, B = 2).
Then the bf16 GEMM that B1, B2, B7 and B12 run (warpgroup MMA on TMA-fed
tiles, `csrc/gemm.cu`): at its tiles' edges (M in 1-6,305, N in 8-2,304,
K in 8-3,072, both tile widths, every epilogue, `out=` column slices)
against `a.float() @ w.float().T` through the same epilogue, a
misaligned operand that must raise, and one line per product of B1 and
B2 at ViT-B-16 M = 6,304 and 25,216 and of the RN50x4 text c_fc at
M = 2,464: ms (bursts of 10 calls), TFLOP/s, each tile width and
`F.linear`'s time beside it. The fp32 GEMM that B1, B2, B7 and B12 run
in fp32 (3xTF32 warpgroup MMA on TMA-fed tiles, `csrc/gemm_tf32.cu`) at
its tiles' edges too (M in 1-1,024 around 64 and 128, N in 8-1,920, K in
8-3,072, each tile width and the rule's, which must give the same bits,
every epilogue, `out=` column slices) against an fp32 product at the fp32
tolerance, with a misaligned operand that must raise. B7 and B4 also run
in bursts beside their library calls, with a TF32 bound (three passes at
495 TFLOP/s) beside the 67 TFLOP/s one, and B7 is split into its
projection and its attention core (bursts; the core beside SDPA on the
same qkv and its own bound). Every fp32 attention row (B1 and B3 in the
towers, B7-B9, X1-X4) runs on 3xTF32 tensor-core tiles, so its bound is
the TF32 one too.

The attention kernels run 16-row warp tiles on the tensor cores (bf16:
16-key tiles; fp32: 3xTF32 8-key tiles in 32-key groups), staged by
16-byte (else 4-byte or, in bf16, element) copies, so each phase that
holds one also holds it, untimed, at the tiles' ragged edges
(`EDGE_LENGTHS`: 1, 15, 16, 17, 63, 65, 197 rows and keys): phase 2 B3
(causal, an arbitrary and a -inf left-padding shared bias, two images a
block), B8 and B9 on the core (head views and contiguous, biased, head
dims 64 and 80, one view two elements off a 16-byte boundary), each in
bf16 and fp32; phase 5 the core's fp32-output instance that B6 runs;
phase 13 X2 (unpadded, with a -inf padding bias, gb of 1 and 2) and B9
on the grouped kernel at 1, 63, 64, 65, 300 and 1024 keys, head dims
128 and 96 (16-byte staging) and 34 (4-byte), causal and with -inf
padding, in bf16 and fp32.

The line before the last is the kernel summary as one JSON object (the
fp32 instances of B3, B7, B8, B9 and X1 under `fp32_rows`, each with its
plain, library and TF32 bound times); the last line is `{"ok": true,
"device": {...}}`. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import json
import random
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

import torch.nn.functional as F
from torch.profiler import record_function

from fashionern_aaai2024_tpu_torch.benchmarks import attn_experiment as XD
from fashionern_aaai2024_tpu_torch.data.captions import join_fiq_captions
from fashionern_aaai2024_tpu_torch.models.clip.config import get_clip_config
from fashionern_aaai2024_tpu_torch.models.clip.model import CLIP_MEAN, CLIP_STD
from fashionern_aaai2024_tpu_torch.models.clip.tokenizer import SimpleTokenizer, learn_merges
from fashionern_aaai2024_tpu_torch.models.composed import (
    ComposedCIRModel,
    apply_precision,
    random_init_,
)
from fashionern_aaai2024_tpu_torch.ops import attention as A
from fashionern_aaai2024_tpu_torch.ops import attn_experiment as XA
from fashionern_aaai2024_tpu_torch.ops import block as TB
from fashionern_aaai2024_tpu_torch.ops import combiner as Cb
from fashionern_aaai2024_tpu_torch.ops import common
from fashionern_aaai2024_tpu_torch.ops import dropout as Dr
from fashionern_aaai2024_tpu_torch.ops import layernorm as LN
from fashionern_aaai2024_tpu_torch.ops import losses as L
from fashionern_aaai2024_tpu_torch.ops import mlp as M
from fashionern_aaai2024_tpu_torch.ops import qmlp as Q
from fashionern_aaai2024_tpu_torch.ops.qmatmul import quantize_rowwise
from fashionern_aaai2024_tpu_torch.retrieval import evaluate as E
from fashionern_aaai2024_tpu_torch.retrieval.evaluate import InferenceAPI
from fashionern_aaai2024_tpu_torch.retrieval.server import RetrievalService
from fashionern_aaai2024_tpu_torch.train.schedule import cosine_annealing_schedule
from fashionern_aaai2024_tpu_torch.train.state import create_train_state
from fashionern_aaai2024_tpu_torch.train.step import build_train_step
from fashionern_aaai2024_tpu_torch.train.trainer import (
    DatasetPlugin,
    TrainConfig,
    Trainer,
    _fiq_captions,
)

# tolerances of tests/test_torch_cuda.py: fp32 at the module tolerance;
# bf16 at three significant digits
TOL = {torch.float32: dict(atol=2e-5, rtol=0.0),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
VIT = dict(b=32, s=197, w=768, heads=12, causal=False)
TEXT = dict(s=77, w=512, heads=8, causal=True)
# the serve path's shapes, in bf16 and fp32
SHAPES = [("vit_b32", VIT), ("text_b32", dict(TEXT, b=32)), ("text_b1", dict(TEXT, b=1))]
# the train path's: the frozen towers at the recipe's B = 1024, in bf16
TRAIN_SHAPES = [("vit_b1024", dict(VIT, b=1024)), ("text_b1024", dict(TEXT, b=1024))]
# the RN50x4 text tower (W = 640, 10 heads of 64): serve shapes in bf16
# and fp32, B = 1024 in bf16
RN_TEXT = dict(s=77, w=640, heads=10, causal=True)
RN_SHAPES = [("rn_text_b32", dict(RN_TEXT, b=32)), ("rn_text_b1", dict(RN_TEXT, b=1))]
RN_TRAIN_SHAPES = [("rn_text_b1024", dict(RN_TEXT, b=1024))]
# B7: the DVR BERT (S = 1 + 13 + 77) at d = 640 (8 heads of 80) and 512,
# at the query batches b = 32 and 1
BERT_SHAPES = [("bert640", dict(b=32, s=91, w=640, heads=8)),
               ("bert512", dict(b=32, s=91, w=512, heads=8)),
               ("bert640_b1", dict(b=1, s=91, w=640, heads=8)),
               ("bert512_b1", dict(b=1, s=91, w=512, heads=8))]
# B8: the RN50x4 attention pool (40 heads of 64) and the MR cross-attention
CROSS_SHAPES = [("attnpool", dict(b=128, sq=1, sk=82, w=2560, heads=40)),
                ("mr640", dict(b=32, sq=77, sk=13, w=640, heads=8)),
                ("mr512", dict(b=32, sq=77, sk=13, w=512, heads=8))]
# B11: RN50x4 ln_final, the BERT's LNs at d = 640, the ViT's ln_pre at B=128
LN_SHAPES = [("ln_final", dict(rows=32 * 77, w=640, eps=1e-5)),
             ("bert_ln", dict(rows=32 * 91, w=640, eps=1e-12)),
             ("vit_ln_pre", dict(rows=128 * 197, w=768, eps=1e-5))]
# the DVR query tower's mini-BERT: layers, and its LayerNorms per forward
# (the embedding LN and two post-LNs a layer)
BERT_LAYERS = 2
BERT_LNS = 1 + 2 * BERT_LAYERS
GALLERY, BATCH, K, LAYERS = 512, 32, 10, 12
CTX = 77
CAPTIONS = ["is darker and has longer sleeves", "make it red", "more formal",
            "has a floral print", "is shorter and lighter", "with a collar",
            "less casual and in blue", "has stripes and no logo"]
B1, B2, B3, B4 = ("attention_subblock (B1)", "mlp_subblock (B2)",
                  "packed_qkv_self_attention (B3)", "bbc_rowloss (B4)")
B5, B6 = "int8_mlp_subblock (B5)", "int8_attention_subblock (B6)"
B7, B8, B11 = ("fused_qkv_self_attention (B7)", "packed_kv_cross_attention (B8)",
               "layer_norm (B11)")
B9, B12 = "multi_head_attention (B9)", "combiner_apply (B12)"
B10 = "transformer_block (B10)"
X1, X2, X3, X4 = ("mha_grouped (X1)", "mha_packed (X2)", "qkvattn (X3)", "attnblock (X4)")
KERNELS = {  # name -> (wrapper, source, TPU kernel it replaces)
    B1: (A.attention_subblock, "fashionern_aaai2024_tpu_torch/csrc",
         "fashionern_aaai2024_tpu/ops/attention.py:520"),
    B2: (M.mlp_subblock, "fashionern_aaai2024_tpu_torch/csrc",
         "fashionern_aaai2024_tpu/ops/mlp.py:121"),
    B3: (A.packed_qkv_self_attention, "fashionern_aaai2024_tpu_torch/csrc/attention.cu",
         "fashionern_aaai2024_tpu/ops/attention.py:147"),
    B4: (L.bbc_rowloss, "fashionern_aaai2024_tpu_torch/csrc/bbc_loss.cu",
         "fashionern_aaai2024_tpu/ops/losses.py:55"),
    B5: (Q.int8_mlp_subblock, "fashionern_aaai2024_tpu_torch/csrc",
         "fashionern_aaai2024_tpu/ops/qmlp.py:85"),
    B6: (Q.int8_attention_subblock, "fashionern_aaai2024_tpu_torch/csrc",
         "fashionern_aaai2024_tpu/ops/qmlp.py:213"),
    B7: (A.fused_qkv_self_attention, "fashionern_aaai2024_tpu_torch/csrc",
         "fashionern_aaai2024_tpu/ops/attention.py:388"),
    B8: (A.packed_kv_cross_attention, "fashionern_aaai2024_tpu_torch/csrc/attention.cu",
         "fashionern_aaai2024_tpu/ops/attention.py:264"),
    B11: (LN.layer_norm, "fashionern_aaai2024_tpu_torch/csrc/layernorm.cu",
          "fashionern_aaai2024_tpu/ops/layernorm.py:46"),
    B9: (A.multi_head_attention, "fashionern_aaai2024_tpu_torch/csrc",
         "fashionern_aaai2024_tpu/ops/attention.py:84"),
    B12: (Cb.combiner_apply, "fashionern_aaai2024_tpu_torch/csrc",
          "fashionern_aaai2024_tpu/ops/combiner.py:63"),
    B10: (TB.transformer_block, "fashionern_aaai2024_tpu_torch/csrc/block.cu",
          "fashionern_aaai2024_tpu/ops/block.py:99"),
    X1: (XA.mha_grouped, "fashionern_aaai2024_tpu_torch/csrc/attention_grouped.cu",
         "benchmarks/attn_experiment.py:50"),
    X2: (XA.mha_packed, "fashionern_aaai2024_tpu_torch/csrc/attention.cu",
         "benchmarks/attn_experiment.py:168"),
    X3: (XA.qkvattn, "fashionern_aaai2024_tpu_torch/csrc", "benchmarks/attn_experiment.py:257"),
    X4: (XA.attnblock, "fashionern_aaai2024_tpu_torch/csrc", "benchmarks/attn_experiment.py:364"),
}
# the attention core: attention.cu (fp32 and the C entry), the bf16 kernel
# in attention_bf16.cuh compiled per head dim, the bodies and the tiles
CORE = ["attention.cu", "attention_bf16_d64.cu", "attention_bf16_d80.cu", "attention_bf16.cuh",
        "attention_core.cuh", "attention_mma.cuh"]
# the GEMM: gemm.cu (bf16, on gemm_wgmma.cuh's body) and gemm_tf32.cu
# (fp32, on gemm_tf32.cuh's 3xTF32 body), both fed by tma.cuh's ring
TF32 = ["gemm_tf32.cuh", "gemm_wgmma.cuh", "tma.cuh"]
GEMM = ["gemm.cu", "gemm_tf32.cu", *TF32]
LN_SRC = ["layernorm.cu", "layernorm_row.cuh"]
SOURCES = {B1: [*LN_SRC, *GEMM, *CORE], B2: [*LN_SRC, *GEMM],
           B3: CORE, B4: ["bbc_loss.cu", *TF32], B5: ["quant.cu", "qgemm.cu"],
           B6: ["quant.cu", "qgemm.cu", *CORE], B7: [*GEMM, *CORE],
           B8: CORE, B11: LN_SRC,
           B9: [*CORE, "attention_grouped.cu"],
           B12: [*GEMM, "combiner.cu"],
           B10: ["block.cu", *TF32[:2], "attention_core.cuh", "attention_mma.cuh",
                 "layernorm_row.cuh"],
           X1: ["attention_grouped.cu", "attention_mma.cuh"], X2: CORE,
           X3: [*GEMM, *CORE], X4: [*LN_SRC, *GEMM, *CORE]}
TOWER_KERNELS = (B1, B2, B3)
INT8_KERNELS = (B5, B6)
NEW_KERNELS = (B7, B8, B11)
EXPERIMENT_KERNELS = (X1, X2, X3, X4)
# int8 kernels against their plain versions: an int8 code that the two
# summation orders round to neighbouring values moves the outputs that
# depend on it by about one quantization step of a product, at most
# INT8_STEP beyond the float tolerance (fp32: largest excess read 8.1e-3;
# bf16: every reading inside the bf16 tolerance, by 1.2e-2 at least); a
# flip in a key or value token moves every query row of its image a
# little, so the mean error is held to INT8_MEAN, set per dtype between
# the kernels' largest reading (fp32 1.2e-5, bf16 6.1e-6, here and in
# tests/test_torch_cuda.py) and the smallest of a control that rounds its
# activations to bf16 before quantizing them (fp32 1.3e-4, bf16 1.4e-4;
# every run checks that the control fails); the LN + quantize prologue
# alone may flip at most 0.1% of its codes, by one (read: 1.0e-6; the
# control flips 5%)
INT8_STEP = {torch.float32: 1.2e-2, torch.bfloat16: 0.0}
INT8_MEAN = {torch.float32: 4e-5, torch.bfloat16: 3e-5}
INT8_CODE_SHARE = 1e-3
INT8_SHAPES = [(torch.bfloat16, s) for s in SHAPES] + [(torch.float32, s) for s in SHAPES]
INT8_SHAPES += [(torch.bfloat16, s) for s in TRAIN_SHAPES]
# int8 tensor-core peak of the H100 SXM (dense), NVIDIA data sheet
PEAK_INT8_OPS = 1979e12
# the card's int8 bf16 embeddings against the port's plain int8 fp32 run
# on the CPU (predicted before the first run: min above 0.97; measured
# min 0.99960 over five runs, so held at 0.999)
INT8_COSINE_MIN = 0.999
INT8_TRAIN_STEPS = 2
# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core and fp32
# CUDA-core rates, HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# dense TF32 tensor-core peak (NVIDIA data sheet): the fp32 products (the
# fp32 GEMM of B1, B2, B7 and B12, B10's fp32 phases, B4's scores) run as
# three TF32 passes (3xTF32)
PEAK_TF32_FLOPS = 495e12
# B4 at the train path's shape first: its timings go into the kernels line
BBC_SHAPES = [(1024, 512), (1000, 512), (13, 24), (1024, 640)]
BBC_TOL = dict(atol=5e-4, rtol=1e-5)
# the train slice: the recipe's batch and lr (cli/main.py:64-65)
TRAIN_BATCH, TRAIN_LR, TRAIN_STEPS = 1024, 4e-5, 6
UNIVERSE, VAL_GALLERY, VAL_QUERIES, CHECK_BATCH = 2048, 1024, 256, 16
# B9 at TME's cross-attention: 77 text tokens against 13 patches, 8 heads
# (64 at d = 512, 80 at d = 640), at the serve batch and the train batch;
# one case with a causal + arbitrary bias (Sq != Sk)
MHA_SHAPES = [("tme512_b32", dict(b=32, d=512)), ("tme640_b32", dict(b=32, d=640)),
              ("tme512_b1024", dict(b=1024, d=512)), ("tme640_b1024", dict(b=1024, d=640))]
MHA_BIASED = ("biased512_b32", dict(b=32, d=512, causal=True, bias=True))
# B12 at the combiners' rows: a query (1, 32), an index refine batch (128),
# the validation's and a large refine chunk's (1024)
COMBINER_SHAPES = [(d, m) for d in (512, 640) for m in (1, 32, 128, 1024)]
# the TME slice: train steps at B = 1024
TME_TRAIN_STEPS = 3
FIQ_CAPTIONS = [("is darker", "has longer sleeves"), ("is red", "more formal"),
                ("has a floral print", "is shorter"), ("with a collar", "less casual"),
                ("in blue", "has stripes and no logo"), ("is lighter", "is tighter")]
# B10 against its plain version and the B1 + B2 pair: the query text
# towers of both backbones at b = 1 and 32 in bf16 and fp32, the train
# path's text tower and the ViT-B-16 trunk in bf16
BLOCK_SHAPES = [(dtype, shape) for dtype in (torch.bfloat16, torch.float32)
                for shape in (("text_b1", dict(TEXT, b=1)), ("text_b32", dict(TEXT, b=32)),
                              *RN_SHAPES[::-1])]
BLOCK_SHAPES += [(torch.bfloat16, TRAIN_SHAPES[1]), (torch.bfloat16, SHAPES[0])]
# BlockFunction's 13 gradients against autograd of the plain version, fp32:
# the same formula summed in another order
BLOCK_GRAD_COSINE_MIN = 0.99999
# B9's biased case: the bias gradient of MHAFunction (autograd of the
# `_mha_ref` formula) against autograd of the plain version: fp32 differs
# in summation order only; bf16 scores round to bf16 in `_mha_ref`
MHA_BIAS_GRAD_COSINE_MIN = {torch.float32: 0.99999, torch.bfloat16: 0.99}
# the evaluation phase: ViT-B-16 over in-memory FashionIQ- and CIRR-shaped
# loaders (three dress types and CIRR, each a gallery and its queries)
FIQ_TYPES = ("dress", "shirt", "toptee")
# the CPU leg of the evaluation phase (fp32 plain versions, the run's
# slowest phase) runs every evaluator on its first CPU_QUERIES queries
# over a gallery cut to the images they name (`cpu_loaders`): the image
# embeds (~35 GFLOP an image against ~6 a query) take most of its time
CPU_QUERIES = 64
EVAL_GALLERY, EVAL_QUERIES, CIRR_GROUP = 512, 256, 6
CIRR_CAPTIONS = ["has two dogs instead of one", "the same bag but in black leather",
                 "show it from the side", "make the background a beach",
                 "add a person wearing it", "remove the logo and shorten it"]
# captions beyond ASCII: the native tokenizer core flags them and the
# Python path encodes them
NON_ASCII_CAPTIONS = ["a naïve café-style blouse", "Ⅻ² größer und dunkler",
                      "更正式 and darker"]
BPE_MERGES = 200
# B9 through the grouped kernel (head dims other than 64 / 80, more than
# 256 keys): TME-like cross-attention (8 heads, 77 queries) against 300,
# 512 and 1024 keys at head dim 128 and 64, and causal self-attention at
# 512 and 1024 tokens; biased cases also hold the bias gradient
MHA_LONG_SHAPES = [
    ("sk300_dh128", dict(b=32, h=8, sq=77, sk=300, dh=128, bias=True)),
    ("sk512_dh128", dict(b=32, h=8, sq=77, sk=512, dh=128)),
    ("sk1024_dh128", dict(b=8, h=8, sq=77, sk=1024, dh=128, bias=True)),
    ("sk300_dh64", dict(b=32, h=8, sq=77, sk=300, dh=64, bias=True)),
    ("self512_dh64_causal", dict(b=8, h=8, sq=512, sk=512, dh=64, causal=True)),
    ("self1024_dh128_causal", dict(b=4, h=8, sq=1024, sk=1024, dh=128, causal=True,
                                   bias=True))]


# the bf16 attention kernels' ragged edges: rows and keys one short of,
# at, and one past a 16-row / 16-key tile, and the ViT's 197
EDGE_LENGTHS = (1, 15, 16, 17, 63, 65, 197)
# (sq, sk) of the cross layouts: the attention pool's 1 x 82 first
EDGE_CROSS = [(1, 82), (15, 17), (16, 16), (17, 63), (63, 65), (65, 1), (197, 13), (5, 256)]
# the grouped kernel's chunk edges and head dims: 16-byte staging at 128
# and 96, 4-byte at 34 (D % 8 != 0)
EDGE_GROUPED = [(sk, dh) for sk in (1, 63, 64, 65, 300, 1024) for dh in (128, 96, 34)]
# the bf16 GEMM's tile edges (warpgroup MMA on TMA-fed 128 x 128 / 128 x
# 256 tiles, 64-deep K tiles): rows around a warpgroup's 64 and the ViT's
# 197 and 32 x 197 + 1, columns inside and past a tile, K short of, one
# past and at multiples of a K tile; epilogues cycle through (bias,
# residual, activation) as B1, B2, B7 and B12 use them
GEMM_EDGE_M = (1, 15, 63, 64, 65, 197, 6305)
GEMM_EDGE_N = (8, 72, 200, 640, 2304)
GEMM_EDGE_K = (8, 40, 776, 3072)
GEMM_EPILOGUES = ((True, False, None), (False, True, None), (True, True, None),
                  (True, False, "quick_gelu"), (True, False, "relu"), (False, False, None))
# the products of B1 and B2 at the ViT-B-16 gallery batch (32 x 197) and
# the embed batch (128 x 197), and the RN50x4 text tower's c_fc at a
# query batch of 32: (name, M, K, N, bias, residual, activation)
GEMM_PRODUCTS = [(f"vit_{name}_m{m}", m, k, n, True, res, act)
                 for m in (32 * 197, 128 * 197)
                 for name, k, n, res, act in (("qkv", 768, 2304, False, None),
                                              ("out_proj", 768, 768, True, None),
                                              ("c_fc", 768, 3072, False, "quick_gelu"),
                                              ("c_proj", 3072, 768, True, None))]
GEMM_PRODUCTS.append(("rn_text_c_fc_m2464", 32 * 77, 640, 2560, True, False, "quick_gelu"))


def log(msg: str) -> None:
    print(msg, flush=True)


@functools.lru_cache(maxsize=None)
def tokenizer() -> SimpleTokenizer:
    """The port's CLIP BPE over merges learned from every caption the
    phases tokenize (`learn_merges`, as `tools/make_fixture.py` writes
    the tests' table): the CLIP table is not in the repository. Its EOT
    is the largest id, so the text tower's argmax pooling finds it."""
    words = CAPTIONS + [c for pair in FIQ_CAPTIONS for c in pair] + CIRR_CAPTIONS
    return SimpleTokenizer(merges=learn_merges(words + NON_ASCII_CAPTIONS, BPE_MERGES))


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
        B1: (t(b, s, w, scale=1.0), t(w, scale=0.1, offset=1.0), t(w, scale=0.1),
             t(3 * w, w), t(3 * w), t(w, w), t(w)),
        B2: (t(b, s, w, scale=1.0), t(w, scale=0.1, offset=1.0), t(w, scale=0.1),
             t(f, w), t(f), t(w, f), t(w)),
        B3: (t(b, s, 3 * w, scale=1.0),),
    }


def bound(flops: float, nbytes: float, dtype: torch.dtype) -> dict:
    """Least time of the work on an H100 SXM: the larger of its operations
    at the peak rate of their type and its bytes at the HBM rate."""
    ops_ms, bytes_ms = 1e3 * flops / PEAK_FLOPS[dtype], 1e3 * nbytes / PEAK_BYTES
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def tf32_bound(flops: float, nbytes: float) -> dict:
    """Least time of fp32 work whose products run at fp32 accuracy on the
    tensor cores: three TF32 passes (3xTF32) of its FLOPs at the TF32
    peak, or its bytes at the HBM rate; the same FLOPs at the CUDA cores'
    67 TFLOP/s stay beside it (`bound_simt_ms`)."""
    ops_ms, bytes_ms = 1e3 * 3 * flops / PEAK_TF32_FLOPS, 1e3 * nbytes / PEAK_BYTES
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                bound_simt_ms=bound(flops, nbytes, torch.float32)["bound_ms"])


def dtype_bound(flops: float, nbytes: float, dtype: torch.dtype) -> dict:
    """`tf32_bound` for fp32 work (its products run by 3xTF32 on the
    tensor cores), `bound` for other types."""
    return tf32_bound(flops, nbytes) if dtype == torch.float32 else bound(flops, nbytes, dtype)


def tower_work(name: str, b: int, s: int, w: int, heads: int, causal: bool,
               dtype: torch.dtype) -> tuple[float, float]:
    """(flops, bytes) of one B1 / B2 / B3 call: every input read once and
    the output written once; causal attention needs s(s+1)/2 scores."""
    e = torch.finfo(dtype).bits // 8
    m = b * s
    pairs = s * (s + 1) // 2 if causal else s * s
    attn = 4 * b * heads * pairs * (w // heads)
    if name == B1:
        return 8 * m * w * w + attn, e * (2 * m * w + 4 * w * w + 6 * w)
    if name == B2:
        return 16 * m * w * w, e * (2 * m * w + 8 * w * w + 7 * w)
    return attn, e * 4 * m * w


def library_call(name: str, args: tuple, heads: int, causal: bool):
    """One PyTorch library composition computing the kernel's function
    (B2 with quick_gelu, as phase 2 runs it): a yardstick for
    `library_ms`, never called by the port."""
    def sdpa(qkv):
        b, s, w3 = qkv.shape
        q, k, v = qkv.view(b, s, 3, heads, w3 // (3 * heads)).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        return o.transpose(1, 2).reshape(b, s, w3 // 3)

    if name == B3:
        return lambda: sdpa(args[0])
    x, g, b_, w1, b1, w2, b2 = args
    w = x.shape[-1]
    if name == B1:
        return lambda: x + F.linear(sdpa(F.linear(F.layer_norm(x, (w,), g, b_), w1, b1)),
                                    w2, b2)

    def quick_gelu(h):
        return h * torch.sigmoid(1.702 * h)

    return lambda: x + F.linear(quick_gelu(F.linear(F.layer_norm(x, (w,), g, b_), w1, b1)),
                                w2, b2)


def phase_kernels() -> tuple[dict, list]:
    plain = {B1: A.attention_subblock_plain, B2: M.mlp_subblock_plain,
             B3: A.packed_qkv_self_attention_plain}
    rows, worst = [], {name: 0.0 for name in TOWER_KERNELS}
    cases = [(dtype, shape) for dtype in (torch.bfloat16, torch.float32)
             for shape in SHAPES + RN_SHAPES]
    cases += [(torch.bfloat16, shape) for shape in TRAIN_SHAPES + RN_TRAIN_SHAPES]
    for dtype, (label, shp) in cases:
        inputs = kernel_inputs(shp["b"], shp["s"], shp["w"], dtype, seed=len(rows))
        for name in TOWER_KERNELS:
            wrapper = KERNELS[name][0]
            args = inputs[name]
            kw = {"activation": "quick_gelu"} if name == B2 else {"causal": shp["causal"]}
            pos = () if name == B2 else (shp["heads"],)
            got = wrapper(*args, *pos, **kw)
            want = plain[name](*args, *pos, **kw)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
            err = (got.float() - want.float()).abs().max().item()
            worst[name] = max(worst[name], err)
            del got, want
            flops, nbytes = tower_work(name, shp["b"], shp["s"], shp["w"], shp["heads"],
                                       shp["causal"], dtype)
            row = dict(kernel=name, shape=label, dtype=str(dtype).split(".")[1],
                       max_abs_err=err,
                       ms=median_ms(lambda: wrapper(*args, *pos, **kw)),
                       plain_ms=median_ms(lambda: plain[name](*args, *pos, **kw)),
                       library_ms=median_ms(library_call(name, args, shp["heads"],
                                                         shp["causal"])),
                       **dtype_bound(flops, nbytes, dtype))
            rows.append(row)
            log(f"  {name:32s} {label:10s} {row['dtype']:9s} err {err:.3e}  "
                f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
                f"library {row['library_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms")
        del inputs
    return worst, rows


def block_inputs(b: int, s: int, w: int, dtype: torch.dtype, seed: int) -> tuple:
    """B10's 13 operands: x [b, s, w], both LNs' parameters near (1, 0),
    the four weights in the torch layout and their biases at std 0.02."""
    g = torch.Generator().manual_seed(seed)

    def t(*shape, scale=0.02, offset=0.0):
        return (offset + scale * torch.randn(shape, generator=g)).to(dtype).cuda()

    f = 4 * w
    ln = lambda: (t(w, scale=0.1, offset=1.0), t(w, scale=0.1))  # noqa: E731
    return (t(b, s, w, scale=1.0), *ln(), t(3 * w, w), t(3 * w), t(w, w), t(w), *ln(),
            t(f, w), t(f), t(w, f), t(w))


def block_calls(args: tuple, heads: int, causal: bool) -> dict:
    """B10 (launched whatever the dispatch rule says), its plain version,
    the B1 + B2 kernel pair it replaces (the A/B the rule reads) and the
    B1 + B2 library compositions (`library_ms`, never called by the
    port); quick_gelu, as phase 2 runs B2."""
    act = "quick_gelu"
    attn_library = library_call(B1, args[:7], heads, causal)

    def library():
        return library_call(B2, (attn_library(), *args[7:]), heads, causal)()

    return dict(
        kernel=lambda: TB._launch_block(*args, heads, causal, act, None, 1e-5),
        plain=lambda: TB.transformer_block_plain(*args, heads, causal=causal, activation=act),
        pair=lambda: M.mlp_subblock(A.attention_subblock(*args[:7], heads, causal=causal),
                                    *args[7:], activation=act),
        library=library)


def phase_block_kernel() -> tuple[float, list, dict]:
    """B10 against its plain version at BLOCK_SHAPES, and equal to B1 + B2
    (the same device code), with the timings of each and of the pair;
    then `BlockFunction`'s gradients against autograd of the plain
    version."""
    rows, worst = [], 0.0
    for dtype, (label, shp) in BLOCK_SHAPES:
        args = block_inputs(shp["b"], shp["s"], shp["w"], dtype, seed=400 + len(rows))
        calls = block_calls(args, shp["heads"], shp["causal"])
        got, want, pair = calls["kernel"](), calls["plain"](), calls["pair"]()
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
        if not torch.equal(got, pair):
            raise AssertionError(f"{B10} {label} {dtype}: differs from B1 + B2 by "
                                 f"{(got.float() - pair.float()).abs().max().item():.3e}")
        err = (got.float() - want.float()).abs().max().item()
        worst = max(worst, err)
        del got, want, pair
        f1, n1 = tower_work(B1, shp["b"], shp["s"], shp["w"], shp["heads"], shp["causal"], dtype)
        f2, _ = tower_work(B2, shp["b"], shp["s"], shp["w"], shp["heads"], shp["causal"], dtype)
        e, m, w = torch.finfo(dtype).bits // 8, shp["b"] * shp["s"], shp["w"]
        row = dict(kernel=B10, shape=label, dtype=str(dtype).split(".")[1], max_abs_err=err,
                   ms=median_ms(calls["kernel"]), plain_ms=median_ms(calls["plain"]),
                   pair_ms=median_ms(calls["pair"]), library_ms=median_ms(calls["library"]),
                   rule_takes_b10=TB.use_block_kernel(m),
                   **bound(f1 + f2, e * (2 * m * w + 12 * w * w + 13 * w), dtype))
        rows.append(row)
        log(f"  {B10:32s} {label:11s} {row['dtype']:9s} err {err:.3e}  "
            f"kernel {row['ms']:.4f} ms  B1 + B2 {row['pair_ms']:.4f} ms  "
            f"plain {row['plain_ms']:.4f} ms  library {row['library_ms']:.4f} ms  "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); the rule takes "
            f"{'B10' if row['rule_takes_b10'] else 'B1 + B2'}")
        del args, calls
        torch.cuda.empty_cache()

    args = block_inputs(2, 77, 512, torch.float32, seed=450)
    up = torch.randn((2, 77, 512), generator=torch.Generator().manual_seed(451)).cuda()
    ours = [t.detach().clone().requires_grad_() for t in args]
    plain = [t.detach().clone().requires_grad_() for t in args]
    (TB.BlockFunction.apply(*ours, 8, True, "quick_gelu", None, 1e-5) * up).sum().backward()
    (TB.transformer_block_plain(*plain, 8, causal=True) * up).sum().backward()
    cos = [F.cosine_similarity(a.grad.flatten().double(), b.grad.flatten().double(),
                               dim=0).item() for a, b in zip(ours, plain)]
    log(f"  {B10} BlockFunction fp32 B=2: 13 gradient cosines against the plain "
        f"version's autograd, min {min(cos):.8f}")
    if min(cos) < BLOCK_GRAD_COSINE_MIN:
        raise AssertionError(f"{B10}: BlockFunction gradients {cos}")
    return worst, rows, dict(gradient_cosines=cos)


def left_padding_bias(sq: int, sk: int) -> torch.Tensor:
    """fp32 [sq, sk] on the card: -inf on the keys before a row's index
    (the last key always kept), 0 elsewhere."""
    keep = torch.ones((sq, sk), dtype=torch.bool, device="cuda").triu()
    keep[:, -1] = True
    return torch.zeros((sq, sk), device="cuda").masked_fill(~keep, float("-inf"))


def edge_check(worst: dict, name: str, got: torch.Tensor, want: torch.Tensor,
               dtype: torch.dtype = torch.bfloat16) -> None:
    """One untimed edge case: finite, and at the tolerance of its operands'
    `dtype` (bf16 unless said), not of its output's: B6's core takes bf16
    operands, rounds p to bf16 and writes fp32, and is held to bf16's."""
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output at an edge case")
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    worst[name] = max(worst.get(name, 0.0), (got.float() - want.float()).abs().max().item())


def view_rows(g: torch.Generator, b: int, s: int, h: int, dh: int, layout: str,
              offset: int = 0, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """A [b, h, s, dh] operand on the card, bf16 unless `dtype` says: a head
    view of [b, s, h*dh] rows (`offset` elements into wider rows), or
    contiguous."""
    t = torch.randn((b, s, h * dh + offset), generator=g).to(dtype).cuda()
    t = t[..., offset:].view(b, s, h, dh).transpose(1, 2)
    return t.contiguous() if layout == "contiguous" else t


def phase_edge_kernels() -> dict:
    """B3, B8 and B9 on the attention core at the tiles' ragged edges, in
    bf16 and fp32 (its 3xTF32 tiles), against their plain versions
    (untimed); returns the largest error of each."""
    worst, g, n = {}, torch.Generator().manual_seed(600), 0
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            for s in EDGE_LENGTHS:
                for dh in (64, 80):
                    qkv = torch.randn((4, s, 3 * 2 * dh), generator=g).to(dtype).cuda()
                    arbitrary = (2 * torch.randn((s, s), generator=g)).cuda()
                    for causal, bias, gb in ((False, None, 1), (True, None, 1),
                                             (False, arbitrary, 1),
                                             (False, left_padding_bias(s, s), 2)):
                        edge_check(worst, B3,
                                   A.packed_qkv_self_attention(qkv, 2, causal=causal,
                                                               attn_bias=bias,
                                                               images_per_block=gb),
                                   A.packed_qkv_self_attention_plain(qkv, 2, causal=causal,
                                                                     attn_bias=bias), dtype)
                        n += 1
            for sq, sk in EDGE_CROSS:
                for dh in (64, 80):
                    q = torch.randn((2, sq, 3 * dh), generator=g).to(dtype).cuda()
                    kv = torch.randn((2, sk, 6 * dh), generator=g).to(dtype).cuda()
                    edge_check(worst, B8, A.packed_kv_cross_attention(q, kv, 3),
                               A.packed_kv_cross_attention_plain(q, kv, 3), dtype)
                    n += 1
                    bias = (2 * torch.randn((sq, sk), generator=g)).cuda()
                    for layout, offset in (("rows", 0), ("contiguous", 0), ("rows", 2)):
                        q, k, v = (view_rows(g, 2, t, 3, dh, layout, offset, dtype)
                                   for t in (sq, sk, sk))
                        edge_check(worst, B9, A.multi_head_attention(q, k, v, bias=bias),
                                   A.mha_plain(q, k, v, bias), dtype)
                        n += 1
    log(f"  edges: {n} cases of B3, B8 and B9 on the core (bf16 and fp32) at Sq / Sk in "
        f"{EDGE_LENGTHS} and {EDGE_CROSS}, max errors "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return worst


def gemm_reference(a: torch.Tensor, w: torch.Tensor, bias, res, activation) -> torch.Tensor:
    """The bf16 GEMM's function on an fp32 product: bias and activation in
    fp32, the cast, then the residual added in bf16."""
    v = a.float() @ w.float().T
    if bias is not None:
        v = v + bias.float()
    if activation == "relu":
        v = torch.relu(v)
    elif activation is not None:
        v = M.act_f32(v, activation)
    v = v.to(torch.bfloat16)
    return v if res is None else res + v


def gemm_operands(g: torch.Generator, m: int, k: int, n: int, with_bias: bool,
                  with_res: bool) -> tuple:
    def t(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).to(torch.bfloat16).cuda()

    return (t(m, k), t(n, k, scale=0.02), t(n, scale=0.02) if with_bias else None,
            t(m, n) if with_res else None)


def phase_gemm_edges() -> float:
    """The bf16 GEMM (`launch_gemm`, both tile widths) against
    `a.float() @ w.float().T` through the same epilogue at every
    GEMM_EDGE_M x GEMM_EDGE_N x GEMM_EDGE_K (untimed), an `out=` column
    slice at ldc > N, and a misaligned operand view that must raise;
    returns the largest error."""
    g, worst, n = torch.Generator().manual_seed(700), 0.0, 0
    for i, m in enumerate(GEMM_EDGE_M):
        for nn in GEMM_EDGE_N:
            for j, k in enumerate(GEMM_EDGE_K):
                with_bias, with_res, act = GEMM_EPILOGUES[(i + j) % len(GEMM_EPILOGUES)]
                a, w, bias, res = gemm_operands(g, m, k, nn, with_bias, with_res)
                want = gemm_reference(a, w, bias, res, act)
                for tile in (128, 256):
                    got = common._gemm(a, w, bias, res, act, None, tile)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(got.float(), want.float(), **TOL[torch.bfloat16])
                    worst = max(worst, (got.float() - want.float()).abs().max().item())
                    n += 1
    for m, k, nn in ((1, 512, 640), (128, 640, 640), (1024, 512, 512)):
        a, w, bias, _ = gemm_operands(g, m, k, nn, True, False)
        cat = torch.full((m, 2 * nn + 8), 7.0, dtype=torch.bfloat16, device="cuda")
        common.launch_gemm(a, w, bias, activation="relu", out=cat[:, nn:2 * nn])
        torch.cuda.synchronize()
        want = gemm_reference(a, w, bias, None, "relu")
        torch.testing.assert_close(cat[:, nn:2 * nn].float(), want.float(), **TOL[torch.bfloat16])
        if not ((cat[:, :nn] == 7).all() and (cat[:, 2 * nn:] == 7).all()):
            raise AssertionError("gemm: an out= column slice wrote outside its columns")
        worst = max(worst, (cat[:, nn:2 * nn].float() - want.float()).abs().max().item())
        n += 1
    flat = torch.zeros(197 * 512 + 8, dtype=torch.bfloat16, device="cuda")
    try:
        common.launch_gemm(flat[1:197 * 512 + 1].view(197, 512), w[:, :512].contiguous(), None)
    except ValueError as err:
        refused = str(err)
    else:
        raise AssertionError("gemm: a misaligned operand view was launched")
    log(f"  bf16 GEMM edges: {n} cases (M in {GEMM_EDGE_M}, N in {GEMM_EDGE_N}, K in "
        f"{GEMM_EDGE_K}, tiles 128 and 256, column slices), max error {worst:.3e}; a "
        f"misaligned view raises: {refused}")
    return worst


# the fp32 GEMM's tile edges (3xTF32 warpgroup MMA on TMA-fed 128 x 32 /
# 64 / 128 tiles, 32-deep K tiles): rows around a warpgroup's 64 and a
# block tile's 128, B7's 91 and 1,024; columns inside and past each
# width and B7's 1,920; K short of, one past and at multiples of a K tile
F32_EDGE_M = (1, 63, 64, 65, 91, 127, 128, 129, 1024)
F32_EDGE_N = (8, 72, 200, 640, 1920)
F32_EDGE_K = (8, 40, 776, 3072)
F32_EPILOGUES = GEMM_EPILOGUES + ((True, False, "gelu"),)


def f32_gemm_reference(a: torch.Tensor, w: torch.Tensor, bias, res, activation):
    """The fp32 GEMM's function in full fp32: bias, activation, residual."""
    v = a @ w.T
    if bias is not None:
        v = v + bias
    if activation == "relu":
        v = torch.relu(v)
    elif activation is not None:
        v = M.act_f32(v, activation)
    return v if res is None else res + v


def phase_f32_gemm_edges() -> float:
    """The fp32 GEMM (`launch_gemm` on fp32 operands, the rule's tile and
    each width forced) against an fp32 product through the same epilogue
    at every F32_EDGE_M x F32_EDGE_N x F32_EDGE_K (untimed), the two
    widths equal bit for bit, an `out=` column slice at ldc > N, and a
    misaligned operand view that must raise; returns the largest error."""
    g, worst, n = torch.Generator().manual_seed(703), 0.0, 0

    def t(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).cuda()

    for i, m in enumerate(F32_EDGE_M):
        for nn in F32_EDGE_N:
            for j, k in enumerate(F32_EDGE_K):
                with_bias, with_res, act = F32_EPILOGUES[(i + j) % len(F32_EPILOGUES)]
                a, w = t(m, k), t(nn, k, scale=0.02)
                bias = t(nn, scale=0.02) if with_bias else None
                res = t(m, nn) if with_res else None
                want = f32_gemm_reference(a, w, bias, res, act)
                got = [common.launch_gemm(a, w, bias, residual=res, activation=act)]
                got += [common._gemm(a, w, bias, res, act, None, tile) for tile in (32, 64, 128)]
                torch.cuda.synchronize()
                torch.testing.assert_close(got[0], want, **TOL[torch.float32])
                if not all(torch.equal(got[0], other) for other in got[1:]):
                    raise AssertionError(f"fp32 gemm M={m} N={nn} K={k}: the tile widths "
                                         "differ")
                worst = max(worst, (got[0] - want).abs().max().item())
                n += 1
    for m, k, nn in ((1, 512, 640), (91, 640, 1920), (1024, 512, 512)):
        a, w, bias = t(m, k), t(nn, k, scale=0.02), t(nn, scale=0.02)
        cat = torch.full((m, 2 * nn + 8), 7.0, device="cuda")
        common.launch_gemm(a, w, bias, activation="relu", out=cat[:, nn:2 * nn])
        torch.cuda.synchronize()
        want = f32_gemm_reference(a, w, bias, None, "relu")
        torch.testing.assert_close(cat[:, nn:2 * nn], want, **TOL[torch.float32])
        if not ((cat[:, :nn] == 7).all() and (cat[:, 2 * nn:] == 7).all()):
            raise AssertionError("fp32 gemm: an out= column slice wrote outside its columns")
        worst = max(worst, (cat[:, nn:2 * nn] - want).abs().max().item())
        n += 1
    flat = torch.zeros(91 * 640 + 4, device="cuda")
    try:
        common.launch_gemm(flat[1:91 * 640 + 1].view(91, 640), t(1920, 640), None)
    except ValueError as err:
        refused = str(err)
    else:
        raise AssertionError("fp32 gemm: a misaligned operand view was launched")
    log(f"  fp32 GEMM edges: {n} cases (M in {F32_EDGE_M}, N in {F32_EDGE_N}, K in "
        f"{F32_EDGE_K}, tiles 32, 64, 128 and the rule's, equal bit for bit, column slices), max "
        f"error {worst:.3e}; a misaligned view raises: {refused}")
    return worst


def burst_ms(fn, windows: int = 20, calls: int = 10) -> float:
    """Median over windows of the CUDA-event time of `calls` back-to-back
    calls, divided by `calls`: the device's time per call where the host
    keeps ahead of it (a per-call window would time the host's enqueue
    of a short kernel)."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def row_extras(row: dict) -> str:
    """A row's burst times (device time a call), its bound at the CUDA
    cores' fp32 rate and B7's split, where it has them."""
    text = ""
    if "burst_ms" in row:
        text += (f"; bursts: kernel {row['burst_ms']:.4f} ms, library "
                 f"{row['library_burst_ms']:.4f} ms")
    if "bound_simt_ms" in row:
        text += f"; bound at 67 TFLOP/s {row['bound_simt_ms']:.4f} ms"
    if "gemm_burst_ms" in row:
        text += (f"; split (bursts): projection {row['gemm_burst_ms']:.4f} ms, attention core "
                 f"{row['core_burst_ms']:.4f} ms (SDPA {row['core_library_burst_ms']:.4f} ms, "
                 f"bound {row['core_bound_ms']:.4f} ms)")
    return text


def phase_gemm_products(card: str) -> list[dict]:
    """Each product of B1 and B2 at GEMM_PRODUCTS through `launch_gemm`
    (its own epilogue) and each tile width, beside `F.linear` with the
    bias (the yardstick, never called by the port), with TFLOP/s: one
    line a product."""
    g, rows = torch.Generator().manual_seed(701), []
    for name, m, k, n, with_bias, with_res, act in GEMM_PRODUCTS:
        a, w, bias, res = gemm_operands(g, m, k, n, with_bias, with_res)
        flops = 2.0 * m * n * k
        row = dict(product=name, m=m, k=k, n=n,
                   ms=burst_ms(lambda: common.launch_gemm(a, w, bias, residual=res,
                                                          activation=act)),
                   tile128_ms=burst_ms(lambda: common._gemm(a, w, bias, res, act, None, 128)),
                   tile256_ms=burst_ms(lambda: common._gemm(a, w, bias, res, act, None, 256)),
                   linear_ms=burst_ms(lambda: F.linear(a, w, bias)))
        row.update(tflops=flops / row["ms"] / 1e9, linear_tflops=flops / row["linear_ms"] / 1e9)
        rows.append(row)
        log(f"  gemm {name:22s} M={m} K={k} N={n}: {row['ms']:.4f} ms "
            f"({row['tflops']:.1f} TFLOP/s; tile 128 {row['tile128_ms']:.4f}, tile 256 "
            f"{row['tile256_ms']:.4f}); F.linear {row['linear_ms']:.4f} ms "
            f"({row['linear_tflops']:.1f} TFLOP/s) ({card})")
        del a, w, bias, res
    return rows


def host_us(fn, calls: int = 2000) -> float:
    """Median host time of one call over `calls` calls with no device
    synchronisation between them (after 100 warm-up calls), in µs."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * statistics.median(times)


def phase_host_us(card: str) -> dict:
    """Host µs of one call of `layer_norm` ([8, 640]), `combiner_apply`
    (M = 1, d = 64: three launches in fp32, four in bf16) and
    `launch_gemm` (M = 8, K = N = 512; bf16 encodes two tensor maps a
    call) in fp32 and bf16, at shapes whose device time stays below the
    host's so that the queue never fills."""
    from fashionern_aaai2024_tpu_torch.models.ern.fusion import CombinerSimple

    g, out = torch.Generator().manual_seed(702), {}
    for dtype in (torch.float32, torch.bfloat16):
        x, w, b = (torch.randn(shape, generator=g).to(dtype).cuda()
                   for shape in ((8, 640), (640,), (640,)))
        module = random_init_(CombinerSimple(64), g).to("cuda", dtype).eval()
        image, text = (torch.randn((1, 64), generator=g).to(dtype).cuda() for _ in range(2))
        a, wt = (torch.randn(shape, generator=g).to(dtype).cuda() for shape in ((8, 512),
                                                                              (512, 512)))
        with torch.no_grad():
            out[str(dtype).split(".")[1]] = dict(
                layer_norm=host_us(lambda: LN.layer_norm(x, w, b, 1e-5)),
                combiner_apply=host_us(lambda: Cb.combiner_apply(image, text, module)),
                launch_gemm=host_us(lambda: common.launch_gemm(a, wt, None)))
    for dtype, us in out.items():
        log(f"  host time a call, median of 2000 ({dtype}): layer_norm "
            f"{us['layer_norm']:.2f} us, combiner_apply {us['combiner_apply']:.2f} us, "
            f"launch_gemm {us['launch_gemm']:.2f} us ({card})")
    return out


def new_kernel_inputs(name: str, shp: dict, dtype: torch.dtype, seed: int) -> tuple:
    """B7: x [b, s, w], weight [3w, w] and bias at std 0.02; B8: q
    [b, sq, w], kv [b, sk, 2w]; B11: x [rows, w] around 2, LN weight and
    bias near (1, 0)."""
    g = torch.Generator().manual_seed(seed)

    def t(*shape, scale=0.02, offset=0.0):
        return (offset + scale * torch.randn(shape, generator=g)).to(dtype).cuda()

    w = shp["w"]
    if name == B7:
        return t(shp["b"], shp["s"], w, scale=1.0), t(3 * w, w), t(3 * w)
    if name == B8:
        return t(shp["b"], shp["sq"], w, scale=1.0), t(shp["b"], shp["sk"], 2 * w, scale=1.0)
    return t(shp["rows"], w, scale=1.0, offset=2.0), t(w, scale=0.1, offset=1.0), t(w, scale=0.1)


def new_kernel_work(name: str, shp: dict, dtype: torch.dtype) -> dict:
    """Bound of one B7 / B8 / B11 call: every input read once and the
    output written once. B7: the projection's 6·m·w² and the attention's
    4·b·s²·w FLOPs at the dtype's peak (fp32: `tf32_bound`, the 67
    TFLOP/s bound beside it); B8: 4·b·sq·sk·w; B11: its ~8 fp32
    operations an element, on the CUDA cores (67 TFLOP/s)."""
    e = torch.finfo(dtype).bits // 8
    w = shp["w"]
    if name == B7:
        b, s = shp["b"], shp["s"]
        work = (6 * b * s * w * w + 4 * b * s * s * w, e * (2 * b * s * w + 3 * w * w + 3 * w))
        return dtype_bound(*work, dtype)
    if name == B8:
        b, sq, sk = shp["b"], shp["sq"], shp["sk"]
        return dtype_bound(4 * b * sq * sk * w, e * (2 * b * sq * w + 2 * b * sk * w), dtype)
    rows = shp["rows"]
    return bound(8 * rows * w, e * (2 * rows * w + 2 * w), torch.float32)


def sdpa_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
               causal: bool = False) -> torch.Tensor:
    """SDPA over [B, S, W] head views (`library_ms` only)."""
    def split(t):
        b, s, w = t.shape
        return t.view(b, s, heads, w // heads).transpose(1, 2)

    o = F.scaled_dot_product_attention(split(q), split(k), split(v), is_causal=causal)
    return o.transpose(1, 2).reshape(q.shape)


def new_kernel_calls(name: str, args: tuple, shp: dict):
    """(kernel, plain version, library call) of B7 / B8 / B11; the library
    calls are F.linear + SDPA, SDPA and F.layer_norm, never called by the
    port."""
    if name == B7:
        heads, w = shp["heads"], shp["w"]
        x, wt, bias = args

        def library():
            qkv = F.linear(x, wt, bias)
            return sdpa_heads(qkv[..., :w], qkv[..., w:2 * w], qkv[..., 2 * w:], heads)
        return (lambda: A.fused_qkv_self_attention(*args, heads),
                lambda: A.fused_qkv_self_attention_plain(*args, heads), library)
    if name == B8:
        heads, w = shp["heads"], shp["w"]
        q, kv = args
        return (lambda: A.packed_kv_cross_attention(q, kv, heads),
                lambda: A.packed_kv_cross_attention_plain(q, kv, heads),
                lambda: sdpa_heads(q, kv[..., :w], kv[..., w:], heads))
    x, g, b_ = args
    eps = shp["eps"]
    return (lambda: LN.layer_norm(x, g, b_, eps), lambda: LN.layer_norm_plain(x, g, b_, eps),
            lambda: F.layer_norm(x, (shp["w"],), g, b_, eps))


def b7_split(args: tuple, shp: dict) -> dict:
    """B7's time split into its two launches, in bursts: the projection
    (`launch_gemm` + bias into packed qkv) and the attention core on that
    qkv, the core beside SDPA on the same qkv (its library call) and its
    bound (4·b·s²·w FLOPs; qkv read once, the output written once)."""
    x, wt, bias = args
    b, s, w = x.shape
    heads = shp["heads"]
    qkv = common.launch_gemm(x.view(b * s, w), wt, bias).view(b, s, 3 * w)
    core_bound = dtype_bound(4 * b * s * s * w, x.element_size() * 4 * b * s * w, x.dtype)
    return dict(gemm_burst_ms=burst_ms(lambda: common.launch_gemm(x.view(b * s, w), wt, bias)),
                core_burst_ms=burst_ms(lambda: A.launch_attention_core(
                    qkv, heads, causal=False, scale=None, out_dtype=x.dtype, bias=None)),
                core_library_burst_ms=burst_ms(lambda: sdpa_heads(
                    qkv[..., :w], qkv[..., w:2 * w], qkv[..., 2 * w:], heads)),
                core_bound_ms=core_bound["bound_ms"], core_bound_by=core_bound["bound_by"])


def phase_new_kernels() -> tuple[dict, list]:
    """B7, B8 and B11 against their plain versions, bf16 and fp32."""
    rows, worst = [], {name: 0.0 for name in NEW_KERNELS}
    cases = [(B7, s) for s in BERT_SHAPES] + [(B8, s) for s in CROSS_SHAPES]
    cases += [(B11, s) for s in LN_SHAPES]
    for name, (label, shp) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = new_kernel_inputs(name, shp, dtype, seed=200 + len(rows))
            kernel, plain, library = new_kernel_calls(name, args, shp)
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
            err = (got.float() - want.float()).abs().max().item()
            worst[name] = max(worst[name], err)
            del got, want
            row = dict(kernel=name, shape=label, dtype=str(dtype).split(".")[1],
                       max_abs_err=err, ms=median_ms(kernel), plain_ms=median_ms(plain),
                       library_ms=median_ms(library), **new_kernel_work(name, shp, dtype))
            if name in (B7, B11):
                row.update(burst_ms=burst_ms(kernel), library_burst_ms=burst_ms(library))
            if name == B7:
                row.update(b7_split(args, shp))
            rows.append(row)
            log(f"  {name:32s} {label:10s} {row['dtype']:9s} err {err:.3e}  "
                f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
                f"library {row['library_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']})" + row_extras(row))
            del args
    return worst, rows


def mha_case(shp: dict, dtype: torch.dtype, seed: int):
    """B9 operands as TME builds them: head views [B, 8, S, Dh] of
    [B, S, d] projections (77 queries, 13 keys and values), and the
    shared fp32 [77, 13] bias of the biased case."""
    g = torch.Generator().manual_seed(seed)
    b, d, heads = shp["b"], shp["d"], 8

    def view(s):
        t = torch.randn((b, s, d), generator=g).to(dtype).cuda()
        return t.view(b, s, heads, d // heads).transpose(1, 2)

    bias = (2 * torch.randn((77, 13), generator=g)).cuda() if shp.get("bias") else None
    return view(77), view(13), view(13), bias


def mha_work(shp: dict, dtype: torch.dtype) -> dict:
    """Bound of one B9 call: 4·B·Sq·Sk·d FLOPs (scores and P·V) at the
    dtype's peak; q, k, v and the bias read once, the output written once
    (causal: only the unmasked pairs)."""
    e = torch.finfo(dtype).bits // 8
    b, d, sq, sk = shp["b"], shp["d"], 77, 13
    pairs = sum(min(i + 1, sk) for i in range(sq)) if shp.get("causal") else sq * sk
    return dtype_bound(4 * b * pairs * d, e * (2 * b * sq * d + 2 * b * sk * d)
                       + (4 * sq * sk if shp.get("bias") else 0), dtype)


def mha_bias_grad_cosine(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor, causal: bool) -> float:
    """Cosine between B9's bias gradient on the card (`MHAFunction`: the
    kernel forward, the `_mha_ref` VJP backward) and autograd of the
    plain version's, under one seeded upstream gradient."""
    up = torch.randn(q.shape, generator=torch.Generator().manual_seed(7)).cuda()
    sq, sk = q.shape[2], k.shape[2]
    grads = []
    for fn in (lambda b: A.multi_head_attention(q, k, v, causal=causal, bias=b),
               lambda b: A.mha_plain(q, k, v, A.shared_bias(causal, b, sq, sk, "cuda"))):
        b = bias.detach().clone().requires_grad_()
        (fn(b).float() * up).sum().backward()
        grads.append(b.grad.flatten().double())
    return F.cosine_similarity(grads[0], grads[1], dim=0).item()


def combiner_module(d: int, dtype: torch.dtype, seed: int):
    """A CombinerSimple with the seeded init of `random_init_`."""
    from fashionern_aaai2024_tpu_torch.models.ern.fusion import CombinerSimple

    return random_init_(CombinerSimple(d), torch.Generator().manual_seed(seed)).to(
        "cuda", dtype).eval()


def combiner_work(d: int, m: int, dtype: torch.dtype) -> dict:
    """Bound of one B12 call: the weights (2 x [4d, d], [8d, 8d], [8d],
    biases), the two input rows and the output row once each, and
    2·M·(8d² + 64d² + 8d) FLOPs. bf16: at the bf16 peak. fp32: the least
    time for fp32-accurate products on the tensor cores, three TF32
    passes (3xTF32) at the TF32 peak; the same FLOPs at the CUDA cores'
    67 TFLOP/s stay beside it (`bound_simt_ms`)."""
    e = torch.finfo(dtype).bits // 8
    weights = 8 * d * d + 8 * d + 64 * d * d + 8 * d + 8 * d + 1
    flops, nbytes = 2 * m * (8 * d * d + 64 * d * d + 8 * d), e * (weights + 3 * m * d)
    return tf32_bound(flops, nbytes) if dtype == torch.float32 else bound(flops, nbytes, dtype)


def combiner_library(image: torch.Tensor, text: torch.Tensor, module) -> torch.Tensor:
    """The combiner as one `F.linear` composition (`library_ms` only)."""
    tp = F.relu(F.linear(text, module.text_projection_layer[0].weight,
                         module.text_projection_layer[0].bias))
    ip = F.relu(F.linear(image, module.image_projection_layer[0].weight,
                         module.image_projection_layer[0].bias))
    h = F.relu(F.linear(torch.cat([tp, ip], dim=-1), module.dynamic_scalar[0].weight,
                        module.dynamic_scalar[0].bias))
    sigma = torch.sigmoid(F.linear(h, module.dynamic_scalar[3].weight,
                                   module.dynamic_scalar[3].bias))
    return F.normalize(sigma * text + (1.0 - sigma) * image, dim=-1)


def phase_tme_kernels() -> tuple[dict, list]:
    """B9 and B12 against their plain versions, fp32 and bf16."""
    rows, worst = [], {B9: 0.0, B12: 0.0}
    cases = [(B9, label, shp, dtype) for label, shp in MHA_SHAPES + [MHA_BIASED]
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(B12, f"d{d}_m{m}", dict(d=d, m=m), dtype) for d, m in COMBINER_SHAPES
              for dtype in (torch.float32, torch.bfloat16)]
    for name, label, shp, dtype in cases:
        seed = 300 + len(rows)
        if name == B9:
            q, k, v, bias = mha_case(shp, dtype, seed)
            causal = shp.get("causal", False)
            bias32 = A.shared_bias(causal, bias, 77, 13, "cuda")
            kernel = lambda: A.multi_head_attention(q, k, v, causal=causal, bias=bias)
            plain = lambda: A.mha_plain(q, k, v, bias32)
            library = lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=None if bias32 is None else bias32.to(dtype))
            work = mha_work(shp, dtype)
        else:
            module = combiner_module(shp["d"], dtype, seed)
            g = torch.Generator().manual_seed(seed)
            image, text = (torch.randn((shp["m"], shp["d"]), generator=g).to(dtype).cuda()
                           for _ in range(2))
            kernel = lambda: Cb.combiner_apply(image, text, module)
            plain = lambda: Cb.combiner_apply_plain(image, text, module)
            library = lambda: combiner_library(image, text, module)
            work = combiner_work(shp["d"], shp["m"], dtype)
        with torch.no_grad():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
            err = (got.float() - want.float()).abs().max().item()
            worst[name] = max(worst[name], err)
            del got, want
            row = dict(kernel=name, shape=label, dtype=str(dtype).split(".")[1],
                       max_abs_err=err, ms=median_ms(kernel), plain_ms=median_ms(plain),
                       library_ms=median_ms(library), **work)
            if name == B12:
                row.update(burst_ms=burst_ms(kernel), library_burst_ms=burst_ms(library))
        if name == B9 and bias is not None:
            cos = row["bias_grad_cosine"] = mha_bias_grad_cosine(q, k, v, bias, causal)
            log(f"  {name} {label} {row['dtype']}: bias gradient, card against plain, "
                f"cosine {cos:.8f}")
            if cos < MHA_BIAS_GRAD_COSINE_MIN[dtype]:
                raise AssertionError(f"{name}: the bias gradient disagrees (cosine {cos})")
        rows.append(row)
        log(f"  {name:32s} {label:13s} {row['dtype']:9s} err {err:.3e}  "
            f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
            f"library {row['library_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})" + row_extras(row))
    return worst, rows


# --- the attention experiment: X1-X4, and B9 through the grouped kernel ---


def experiment_inputs(name: str, dtype: torch.dtype, seed: int) -> tuple:
    """X1-X4's operands at the experiment's full shapes (B = 128, 12 heads
    of 64): X1 padded q [1536, 208, 128], k and v [1536, 256, 128], zero
    past 197 rows and 64 lanes, its fp32 [208, 256] bias masking the
    padded keys and, in row 3, every key; X2 packed qkv [128, 208, 2304]
    (zero past 197 rows) with its [208, 208] padding bias; X3 / X4 x
    [128, 197, 768], the torch-layout weights at std 0.02 (LN near
    (1, 0)) and an arbitrary fp32 [197, 197] bias."""
    g = torch.Generator().manual_seed(seed)

    def t(*shape, scale=1.0, offset=0.0):
        return (offset + scale * torch.randn(shape, generator=g)).to(dtype).cuda()

    def padding_bias(sk):
        bias = torch.zeros((XA.SP, sk))
        bias[:, XA.S:] = A.NEG_INF
        return bias

    b, w = XA.B, XA.W
    if name == X1:
        ops = []
        for rows in (XA.SP, XA.SKP, XA.SKP):
            x = torch.zeros((b * XA.H, rows, XA.DP))
            x[:, :XA.S, :XA.DH] = torch.randn((b * XA.H, XA.S, XA.DH), generator=g)
            ops.append(x.to(dtype).cuda())
        bias = padding_bias(XA.SKP)
        bias[3] = A.NEG_INF
        return (*ops, bias.cuda())
    if name == X2:
        qkv = t(b, XA.SP, 3 * w)
        qkv[:, XA.S:] = 0
        return qkv, padding_bias(XA.SP).cuda()
    x = t(b, XA.S, w)
    bias = torch.randn((XA.S, XA.S), generator=g).cuda()
    if name == X3:
        return x, t(3 * w, w, scale=0.02), t(3 * w, scale=0.02), bias
    return (x, t(w, scale=0.1, offset=1.0), t(w, scale=0.1), t(3 * w, w, scale=0.02),
            t(3 * w, scale=0.02), t(w, w, scale=0.02), t(w, scale=0.02), bias)


def experiment_work(name: str, dtype: torch.dtype) -> dict:
    """Bound of one X1-X4 call at the experiment's shapes: every input
    read once (the fp32 bias too) and the output written once; FLOPs:
    4·N·Sq·Sk·D for the attention (X1 on its padded operands, as the
    kernel is asked), plus 6·m·W² (X3) or 8·m·W² (X4) for the
    projections, at the dtype's peak."""
    e = torch.finfo(dtype).bits // 8
    b, h, s, w = XA.B, XA.H, XA.S, XA.W
    if name == X1:
        bh = b * h
        return dtype_bound(4 * bh * XA.SP * XA.SKP * XA.DP,
                           e * bh * XA.DP * (2 * XA.SP + 2 * XA.SKP) + 4 * XA.SP * XA.SKP,
                           dtype)
    if name == X2:
        return dtype_bound(4 * b * XA.SP * XA.SP * w,
                           e * b * XA.SP * 4 * w + 4 * XA.SP * XA.SP, dtype)
    m, attn, bias_bytes = b * s, 4 * b * s * s * w, 4 * s * s
    if name == X3:
        return dtype_bound(6 * m * w * w + attn,
                           e * (2 * m * w + 3 * w * w + 3 * w) + bias_bytes, dtype)
    return dtype_bound(8 * m * w * w + attn, e * (2 * m * w + 4 * w * w + 6 * w) + bias_bytes,
                       dtype)


def experiment_calls(name: str, args: tuple, per_program: int):
    """(kernel, plain version, library call) of X1-X4; X1 and X2 with
    `per_program` pairs / images a program. The library calls (SDPA with
    the bias as `attn_mask`, with `F.linear` / `F.layer_norm` around it)
    are never called by the port."""
    scale = XA.DH ** -0.5
    sdpa = XD.sdpa_with_bias
    if name == X1:
        q, k, v, bias = args
        return (lambda: XA.mha_grouped(q, k, v, bias, scale, per_program),
                lambda: XA.mha_grouped_plain(q, k, v, bias, scale, per_program),
                lambda: sdpa(q, k, v, bias, scale))
    if name == X2:
        qkv, bias = args
        return (lambda: XA.mha_packed(qkv, bias, scale, per_program),
                lambda: XA.mha_packed_plain(qkv, bias, scale, per_program),
                lambda: sdpa(*qkv.split(XA.W, dim=-1), bias, scale, heads=XA.H))
    if name == X3:
        x, wq, bq, bias = args

        def library():
            return sdpa(*F.linear(x, wq, bq).split(XA.W, dim=-1), bias, scale, heads=XA.H)
        return (lambda: XA.qkvattn(x, wq, bq, bias, scale),
                lambda: XA.qkvattn_plain(x, wq, bq, bias, scale), library)
    x, g_, be, wq, bq, wo, bo, bias = args

    def library():
        y = F.layer_norm(x, (XA.W,), g_, be, XA.LN_EPS)
        o = sdpa(*F.linear(y, wq, bq).split(XA.W, dim=-1), bias, scale, heads=XA.H)
        return x + F.linear(o, wo, bo)
    return (lambda: XA.attnblock(x, g_, be, wq, bq, wo, bo, bias, scale),
            lambda: XA.attnblock_plain(x, g_, be, wq, bq, wo, bo, bias, scale), library)


def mha_long_case(shp: dict, dtype: torch.dtype, seed: int):
    """B9 operands for the grouped kernel: head views [B, H, S, Dh] of
    [B, S, H*Dh] projections, and a shared fp32 [Sq, Sk] bias when the
    case has one."""
    g = torch.Generator().manual_seed(seed)
    b, h, dh = shp["b"], shp["h"], shp["dh"]

    def view(s):
        t = torch.randn((b, s, h * dh), generator=g).to(dtype).cuda()
        return t.view(b, s, h, dh).transpose(1, 2)

    bias = 2 * torch.randn((shp["sq"], shp["sk"]), generator=g) if shp.get("bias") else None
    return view(shp["sq"]), view(shp["sk"]), view(shp["sk"]), (
        None if bias is None else bias.cuda())


def mha_long_work(shp: dict, dtype: torch.dtype) -> dict:
    """Bound of one B9 call on the grouped kernel: 4·B·H·pairs·Dh FLOPs
    (causal: only the unmasked pairs), q, k, v, the bias and the output
    once each."""
    e = torch.finfo(dtype).bits // 8
    b, h, sq, sk, dh = shp["b"], shp["h"], shp["sq"], shp["sk"], shp["dh"]
    pairs = sum(min(i + 1, sk) for i in range(sq)) if shp.get("causal") else sq * sk
    return dtype_bound(4 * b * h * pairs * dh, e * 2 * b * h * dh * (sq + sk)
                       + (4 * sq * sk if shp.get("bias") else 0), dtype)


def check_row(name: str, label: str, dtype: torch.dtype, kernel, plain, library,
              work: dict) -> dict:
    """The kernel against its plain version at the dtype's tolerance, and
    the kernel's, the plain version's and the library call's times."""
    with torch.no_grad():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
        err = (got.float() - want.float()).abs().max().item()
        del got, want
        row = dict(kernel=name, shape=label, dtype=str(dtype).split(".")[1], max_abs_err=err,
                   ms=median_ms(kernel), plain_ms=median_ms(plain),
                   library_ms=median_ms(library), **work)
    log(f"  {name:32s} {label:21s} {row['dtype']:9s} err {err:.3e}  "
        f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
        f"library {row['library_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']})")
    return row


def phase_experiment_kernels() -> tuple[dict, list]:
    """X1 (at every G of the experiment's sweep), X2 (at every gb), X3 and
    X4 at the experiment's shapes, then B9 through the grouped kernel
    (`MHA_LONG_SHAPES`, with the bias gradient of the biased cases),
    each in fp32 and bf16 against its plain version."""
    rows, worst = [], {name: 0.0 for name in (*EXPERIMENT_KERNELS, B9)}
    bh = XA.B * XA.H
    for dtype in (torch.float32, torch.bfloat16):
        for name, sweep in ((X1, [g for g in XD.GROUPS if bh % g == 0]),
                            (X2, [g for g in XD.IMAGE_GROUPS if XA.B % g == 0]),
                            (X3, [1]), (X4, [1])):
            args = experiment_inputs(name, dtype, seed=400 + len(rows))
            _, plain, library = experiment_calls(name, args, sweep[0])
            work = experiment_work(name, dtype)
            with torch.no_grad():
                want = plain().float()
                # the plain version and the library call do not depend on G / gb
                plain_ms, library_ms = median_ms(plain), median_ms(library)
                for per_program in sweep:
                    kernel = experiment_calls(name, args, per_program)[0]
                    got = kernel()
                    torch.cuda.synchronize()
                    torch.testing.assert_close(got.float(), want, **TOL[dtype])
                    err = (got.float() - want).abs().max().item()
                    del got
                    label = {X1: f"G={per_program}",
                             X2: f"gb={per_program}"}.get(name, f"B={XA.B}")
                    row = dict(kernel=name, shape=label, dtype=str(dtype).split(".")[1],
                               max_abs_err=err, ms=median_ms(kernel), plain_ms=plain_ms,
                               library_ms=library_ms, **work)
                    log(f"  {name:32s} {label:21s} {row['dtype']:9s} err {err:.3e}  "
                        f"kernel {row['ms']:.4f} ms  plain {plain_ms:.4f} ms  "
                        f"library {library_ms:.4f} ms  bound {row['bound_ms']:.4f} ms "
                        f"({row['bound_by']})")
                    worst[name] = max(worst[name], err)
                    rows.append(row)
            del args, want
    for label, shp in MHA_LONG_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, bias = mha_long_case(shp, dtype, seed=500 + len(rows))
            causal = shp.get("causal", False)
            bias32 = A.shared_bias(causal, bias, shp["sq"], shp["sk"], "cuda")
            row = check_row(
                B9, label, dtype,
                lambda: A.multi_head_attention(q, k, v, causal=causal, bias=bias),
                lambda: A.mha_plain(q, k, v, bias32),
                lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=None if bias32 is None else bias32.to(dtype)),
                mha_long_work(shp, dtype))
            if bias is not None:
                cos = row["bias_grad_cosine"] = mha_bias_grad_cosine(q, k, v, bias, causal)
                log(f"  {B9} {label} {row['dtype']}: bias gradient, card against plain, "
                    f"cosine {cos:.8f}")
                if cos < MHA_BIAS_GRAD_COSINE_MIN[dtype]:
                    raise AssertionError(f"{B9}: the bias gradient disagrees (cosine {cos})")
            worst[B9] = max(worst[B9], row["max_abs_err"])
            rows.append(row)
            del q, k, v, bias, bias32
    edge, g, scale = {}, torch.Generator().manual_seed(800), XA.DH ** -0.5
    with torch.no_grad():
        # X2 unpadded at the core's edges, with a -inf padding bias
        for s in EDGE_LENGTHS:
            qkv = torch.randn((4, s, 3 * XA.W), generator=g).to(torch.bfloat16).cuda()
            bias = left_padding_bias(s, s)
            for gb in (1, 2):
                edge_check(edge, X2, XA.mha_packed(qkv, bias, scale, gb),
                           XA.mha_packed_plain(qkv, bias, scale, gb))
        # B9 on the grouped kernel at its chunk edges, both staging widths,
        # bf16 and fp32
        for dtype in (torch.bfloat16, torch.float32):
            for sk, dh in EDGE_GROUPED:
                sq = min(sk, 77)
                q, k, v = (view_rows(g, 2, t, 2, dh, "contiguous", dtype=dtype)
                           for t in (sq, sk, sk))
                bias = left_padding_bias(sq, sk)
                edge_check(edge, B9, A.multi_head_attention(q, k, v, bias=bias),
                           A.mha_plain(q, k, v, bias), dtype)
                q, k, v = (view_rows(g, 2, sk, 2, dh, "rows", dtype=dtype)
                           for _ in range(3))
                edge_check(edge, B9, A.multi_head_attention(q, k, v, causal=True),
                           A.mha_plain(q, k, v, A.shared_bias(True, None, sk, sk, "cuda")),
                           dtype)
    log(f"  edges: X2 at S in {EDGE_LENGTHS} (gb 1, 2), B9's grouped route at (Sk, Dh) in "
        f"{EDGE_GROUPED} (bf16 and fp32): max errors "
        + ", ".join(f"{k} {v:.3e}" for k, v in edge.items()))
    for name, err in edge.items():
        worst[name] = max(worst[name], err)
    return worst, rows


def experiment_launches() -> dict:
    """Launches of `python -m ...benchmarks.attn_experiment --all` at the
    experiment's shapes: each kernel once in its fp32 check (X2 once
    more in X3's two-stage comparison), then two warm-up calls and
    WINDOWS x ITERS timed calls at every G / gb that divides its count
    (X1, X2) or once (X3, X4). X2-X4 run B3, B7 and B1 with the bias, so
    each of their launches counts one of those too (and B1's one of B3)."""
    timed = 2 + XD.WINDOWS * XD.ITERS
    bh = XA.B * XA.H
    want = {X1: 1 + timed * sum(bh % g == 0 for g in XD.GROUPS),
            X2: 2 + timed * sum(XA.B % g == 0 for g in XD.IMAGE_GROUPS),
            X3: 1 + timed, X4: 1 + timed}
    return {**want, B3: want[X2] + want[X4], B7: want[X3], B1: want[X4]}


def phase_experiment(card: str) -> dict:
    """The attention experiment's runner, `--all`, at its full shapes (the
    main path of X1-X4): every launch count set to 0 just before, read
    just after, and held to `experiment_launches`."""
    reset_launches()
    results = XD.main(["--all"])
    torch.cuda.synchronize()
    launches = launch_counts()
    check_launches("attention experiment", launches, experiment_launches())
    log(f"  launches {dict((n, launches[n]) for n in EXPERIMENT_KERNELS)} ({card})")
    return dict(results=results, launches=launches)


def make_gallery(side: int = 224, dim: int = 512, seed: int = 0):
    g = np.random.default_rng(seed)
    raw = g.random((GALLERY, side, side, 3), dtype=np.float32)
    images = ((raw - CLIP_MEAN) / CLIP_STD).astype(np.float32)
    patches = g.standard_normal((GALLERY, 13, dim)).astype(np.float32)
    names = [f"item{i:04d}" for i in range(GALLERY)]
    batches = [{"name": names[i:i + BATCH], "image": images[i:i + BATCH],
                "patch": patches[i:i + BATCH]} for i in range(0, GALLERY, BATCH)]
    return names, images, patches, batches


def cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.cosine_similarity(a.float().cpu(), b.float().cpu(), dim=-1)


def serve_launches(cfg, gallery_batches: list[int], query_batches: list[int],
                   refine_chunks: int = 1) -> dict:
    """Expected launches of a serve run, from the batch sizes of its
    gallery and query calls: per gallery batch the image tower (ViT: each
    block B10 or B1-B3 by `use_block_kernel`, or B5-B6 int8, and B11 at
    ln_pre and ln_post; ResNet: B8 at the attention pool); per index
    refine chunk the index tower's combiner (B12); per query call the text
    tower (each block the same way, B11 at ln_final), TME on a TME model
    (B11 at its LN, B9) and the DVR query tower (B7 in each BERT layer,
    B11 at the BERT's LNs, B8 at MR, B12 in its three combiners)."""
    vit = cfg.vision.kind == "vit"
    tme = int(cfg.text.tme)
    tower = INT8_KERNELS if cfg.quantize_mlp else TOWER_KERNELS
    want = dict.fromkeys((*tower, B10), 0)

    def tower_blocks(layers: int, rows: int) -> None:
        for name in ((B10,) if not cfg.quantize_mlp and TB.use_block_kernel(rows) else tower):
            want[name] += layers

    for b in query_batches:
        tower_blocks(cfg.text.layers, b * cfg.text.context_length)
    tokens = (cfg.vision.image_size // cfg.vision.patch_size) ** 2 + 1
    for b in gallery_batches if vit else ():
        tower_blocks(cfg.vision.layers, b * tokens)
    q, gal = len(query_batches), len(gallery_batches)
    want[B7] = BERT_LAYERS * q
    want[B8] = q + (0 if vit else gal)
    want[B11] = (1 + tme + BERT_LNS) * q + (2 * gal if vit else 0)
    want[B9] = tme * q
    want[B12] = 3 * q + refine_chunks
    return want


def phase_slice(card_label: str, model_name: str = "ViT-B-16", quantize: bool = False,
                tme: bool = False) -> tuple[dict, RetrievalService, InferenceAPI]:
    """The serve slice of `model_name`, float (phases 3 and 10), with TME
    (phase 11) or int8 towers and gallery (phase 6); each from seeded
    weights."""
    cfg = get_clip_config(model_name, activation="quick_gelu", quantize_mlp=quantize,
                          tme=tme)
    model = random_init_(ComposedCIRModel(cfg), torch.Generator().manual_seed(0))
    reference = copy.deepcopy(model).eval()          # fp32, plain versions, CPU
    apply_precision(model, "bf16")
    api = InferenceAPI(model, tokenizer=tokenizer(), device="cuda", batch_size=BATCH,
                       quantize_gallery=quantize)
    names, images, patches, batches = make_gallery(cfg.vision.image_size, cfg.feature_dim)
    refs = [names[2 * i] for i in range(8)]          # inside the 16 checked items

    reset_launches()
    t0 = time.perf_counter()
    service = RetrievalService(api, batches)
    singles = [service.query([r], [c], k=K)[0][0] for r, c in zip(refs, CAPTIONS)]
    batch_refs = [names[(7 * i) % GALLERY] for i in range(32)]
    batch_caps = [CAPTIONS[i % 8] for i in range(32)]
    batch_results, _ = service.query(batch_refs, batch_caps, k=K)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = launch_counts()

    want = serve_launches(cfg, [BATCH] * (GALLERY // BATCH), [1] * len(refs) + [32])
    log(f"  main path {run_s:.2f} s; launches {launches} (expected {want}: "
        f"{GALLERY // BATCH} gallery batches, {len(refs) + 1} query calls)")
    tier = "int8 " if quantize else "TME " if tme else ""
    check_launches(f"{model_name} {tier}serve path", launches, want)
    norms = service.gallery.features.float().norm(dim=-1)
    log(f"  image tower output norm: min {norms.min().item():.4f}, median "
        f"{norms.median().item():.4f}, max {norms.max().item():.4f}")
    if not torch.isfinite(norms).all() or norms.max() > 1e4 or norms.min() < 1e-4:
        raise AssertionError("the seeded image tower saturates or vanishes")
    for res in singles + batch_results:
        scores = [r["score"] for r in res]
        if len(res) != K or not np.all(np.isfinite(scores)) or scores != sorted(
                scores, reverse=True):
            raise AssertionError(f"bad result list: {res}")

    # the card's final embeddings against the fp32 plain run on the CPU
    ref_api = InferenceAPI(reference, tokenizer=tokenizer(), device="cpu", batch_size=16)
    g16, _ = ref_api.encode_image(images[:16])
    cpu_gallery = ref_api.refine_gallery(g16, patches[:16])
    card_gallery = service.index.features[:16]
    rows = [service.rows[r] for r in refs]
    ids = tokenizer()(CAPTIONS)
    tg, ts = ref_api.encode_text(ids, visual_emb=patches[rows])
    cpu_query = ref_api.query(g16[rows], patches[rows], tg, ts)
    ctg, cts = api.encode_text(ids, visual_emb=service.gallery.local_features[rows])
    card_query = api.query(service.gallery.features[rows], service.gallery.local_features[rows],
                           ctg, cts)
    cos_g, cos_q = cosine(card_gallery, cpu_gallery), cosine(card_query, cpu_query)
    _, top_card = service.index.search(card_query, k=K)
    _, top_cpu = service.index.search(cpu_query, k=K)
    overlap = float(np.mean([len(set(a) & set(b)) / K for a, b in zip(top_card, top_cpu)]))
    log(f"  card bf16 vs CPU fp32: gallery cosine min {cos_g.min().item():.5f} "
        f"(median {cos_g.median().item():.5f}), query cosine min {cos_q.min().item():.5f} "
        f"(median {cos_q.median().item():.5f}), top-{K} overlap {overlap:.3f} ({card_label})")
    limit = INT8_COSINE_MIN if quantize else 0.99
    if cos_g.min() < limit or cos_q.min() < limit:
        raise AssertionError(f"card embeddings disagree with the fp32 CPU run (limit {limit})")
    tme_info = {}
    if tme:
        # TME's own output, which the fused query blends with the image
        # side: the card's enhanced text globals against the CPU's, and how
        # far TME moves them from the tower's (it must not be the identity)
        with torch.no_grad():
            tower_g, _ = reference.clip.encode_text(torch.as_tensor(ids, dtype=torch.long))
        cos_t, shift = cosine(ctg, tg), 1 - cosine(tg, tower_g)
        tme_info = dict(text_cosine_min=cos_t.min().item(), tme_shift_min=shift.min().item())
        log(f"  TME text globals: card vs CPU cosine min {cos_t.min().item():.5f}; "
            f"1 - cosine to the tower's globals: min {shift.min().item():.4f}, max "
            f"{shift.max().item():.4f} ({card_label})")
        if cos_t.min() < limit or shift.min() < 1e-3:
            raise AssertionError("TME's text globals disagree with the CPU's, or TME did not "
                                 "move them")
    return dict(main_path_seconds=run_s, launches=launches, **tme_info,
                gallery_cosine_min=cos_g.min().item(), query_cosine_min=cos_q.min().item(),
                gallery_cosine_median=cos_g.median().item(),
                query_cosine_median=cos_q.median().item(), topk_overlap=overlap,
                startup_seconds=service.startup_seconds,
                image_norm_min=norms.min().item(), image_norm_median=norms.median().item(),
                image_norm_max=norms.max().item(),
                results=[[r["name"] for r in res] for res in singles + batch_results]
                ), service, api


def kernel_split(fn, top: int = 6, spans: tuple = ()) -> dict:
    """Device time of one call of `fn` by kernel name (`torch.profiler`),
    the call's wall time, the card's idle share over it, and the device
    time of the `record_function` spans named in `spans` (the kernels
    each launched). The second of two profiled calls is kept: the first
    pays the profiler's start-up."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(2):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        # the spans' own windows on the card carry the span names
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in ALL_SPANS:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    device = sum(ms for ms, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    span_ms = {e.key: e.device_time_total / 1e3 for e in prof.key_averages() if e.key in spans}
    return dict(wall_ms=wall, device_ms=device, idle_share=1.0 - device / wall if wall else None,
                top=[dict(kernel=k[:90], ms=ms, launches=n) for k, (ms, n) in ranked],
                spans_device_ms={k: span_ms.get(k) for k in spans})


EMBED_SPANS = ("embed/image_tower", "image_tower/trunk", "image_tower/attnpool",
               "embed/index_refine")
QUERY_SPANS = ("query/text_tower", "query/dvr", "query/search")
ALL_SPANS = frozenset(EMBED_SPANS + QUERY_SPANS)


def phase_timings(service: RetrievalService, api: InferenceAPI) -> tuple[dict, object, object]:
    """Embed + refine img/s and query P50s; also returns the embed +
    refine call and a query call of a given batch size (its steps in
    `record_function` spans) for `kernel_split`, which runs after every
    host-clock measurement of the script (the profiler slows later
    launches)."""
    g = np.random.default_rng(1)
    b = 128
    cfg = api.model.clip_config
    side = cfg.vision.image_size
    images = torch.from_numpy(g.random((b, side, side, 3), dtype=np.float32)).to(
        "cuda", torch.bfloat16)
    patches = torch.from_numpy(
        g.standard_normal((b, 13, cfg.feature_dim)).astype(np.float32)).cuda()
    bench_api = InferenceAPI(api.model, tokenizer=tokenizer(), device="cuda", batch_size=b)

    def embed_and_refine():
        with record_function("embed/image_tower"):
            feats, _ = bench_api.encode_image(images)
        with record_function("embed/index_refine"):
            return bench_api.refine_gallery(feats, patches)

    def query(qb: int = 32):
        rows = torch.arange(qb, device="cuda")
        with record_function("query/text_tower"):
            tg, ts = api.encode_text(api.tokenize([CAPTIONS[i % 8] for i in range(qb)]),
                                     visual_emb=service.gallery.local_features[rows])
        with record_function("query/dvr"):
            q = api.query(service.gallery.features[rows], service.gallery.local_features[rows],
                          tg, ts)
        with record_function("query/search"):
            return service.index.search(q, k=K)

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
    return dict(embed_refine_img_per_s=img_s, **lat), embed_and_refine, query


def reset_launches() -> None:
    for fn, _, _ in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, (fn, _, _) in KERNELS.items()}


def check_launches(path: str, launches: dict, want: dict) -> None:
    """The run's launch counts equal `want` (kernel -> count; 0 for every
    kernel it leaves out)."""
    want = {name: want.get(name, 0) for name in KERNELS}
    if launches != want:
        raise AssertionError(f"{path}: launches {launches}, expected {want}")


def train_launches(steps: int, int8: bool = False, tme: bool = False) -> dict:
    """Expected launches of `steps` train steps: 3 frozen tower passes a
    step (B1-B3, or B5-B6, in each block), B11 at the ViT's ln_pre and
    ln_post (2 image passes), the text tower's ln_final, TME's LN on a TME
    model and the train-mode BERT's LNs; B9 at TME's cross-attention; B4
    once. The train-mode BERT and MR attention are `mha_ref` with
    probability dropout, as in JAX: no B7, no B8, no B9; the train-mode
    combiners drop out too: no B12."""
    want = dict.fromkeys(INT8_KERNELS if int8 else TOWER_KERNELS, steps * 3 * LAYERS)
    want[B4] = steps
    want[B11] = steps * (2 * 2 + 1 + int(tme) + BERT_LNS)
    want[B9] = steps * int(tme)
    return want


def unit_rows(b: int, d: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """pred, tar [b, d]: unit rows around one shared direction, as the
    fusion stack's normalized outputs are early in training, each target
    a little closer to its own query (scores near 75, row losses of a few
    units)."""
    g = np.random.default_rng(seed)
    c = g.standard_normal(d)
    n1, n2 = (g.standard_normal((b, d)) / np.sqrt(d) for _ in range(2))
    pred, tar = c / np.linalg.norm(c) + 0.6 * n1, c / np.linalg.norm(c) + 0.6 * n2 + 0.1 * n1
    unit = lambda a: torch.tensor(a / np.linalg.norm(a, axis=1, keepdims=True),
                                  dtype=torch.float32, device="cuda")
    return unit(pred), unit(tar)


def phase_bbc() -> list[dict]:
    rows = []
    for b, d in BBC_SHAPES:
        pred, tar = unit_rows(b, d, seed=b + d)
        got = L.bbc_rowloss(pred, tar)
        want = L.bbc_rowloss_plain(pred, tar)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **BBC_TOL)
        labels = torch.arange(b, device="cuda")
        kernel = lambda: L.bbc_rowloss(pred, tar)  # noqa: E731
        library = lambda: F.cross_entropy(100.0 * pred @ tar.t(), labels,  # noqa: E731
                                          reduction="none")
        row = dict(shape=[b, d], max_abs_err=(got - want).abs().max().item(),
                   ms=median_ms(kernel),
                   plain_ms=median_ms(lambda: L.bbc_rowloss_plain(pred, tar)),
                   library_ms=median_ms(library), burst_ms=burst_ms(kernel),
                   library_burst_ms=burst_ms(library), **tf32_bound(*L.bbc_flops_bytes(b, d)))
        rows.append(row)
        log(f"  {B4} B={b:5d} d={d:4d} err {row['max_abs_err']:.3e}  kernel "
            f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  library "
            f"{row['library_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
            + row_extras(row))
    return rows


class SyntheticFashionIQ:
    """FashionIQ-shaped triplets (ref / tar names, two captions, uint8
    224² images, 13 x 512 patches) over a universe of images."""

    def __init__(self, images: np.ndarray, patches: np.ndarray, n: int, seed: int):
        g = np.random.default_rng(seed)
        u = len(images)
        self.images, self.patches = images, patches
        self.ref = g.integers(0, u, n)
        self.tar = (self.ref + g.integers(1, u, n)) % u
        self.caps = g.integers(0, len(FIQ_CAPTIONS), n)

    def __len__(self) -> int:
        return len(self.ref)

    def __getitem__(self, i: int) -> dict:
        r, t = int(self.ref[i]), int(self.tar[i])
        return {"ref_name": f"img{r:04d}", "tar_name": f"img{t:04d}",
                "captions": list(FIQ_CAPTIONS[self.caps[i]]),
                "ref_image": self.images[r], "tar_image": self.images[t],
                "ref_patch": self.patches[r], "tar_patch": self.patches[t]}


@contextlib.contextmanager
def recorded_predictions():
    """`evaluate.generate_predictions` as the evaluators call it, with
    each call's predictions kept on the host in fp32."""
    preds: list[torch.Tensor] = []
    real = E.generate_predictions

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        preds.append(out[0].float().cpu())
        return out

    with mock.patch.object(E, "generate_predictions", spy):
        yield preds


def make_validator(images: np.ndarray, patches: np.ndarray, record: list):
    """Recall@10 and @50 of 256 composed queries over a 1,024-item gallery
    through the port's `evaluate_fiq_split`, over FashionIQ-shaped
    in-memory loaders in batches of 128; the kernel launches it makes are
    recorded apart."""
    names = [f"img{i:04d}" for i in range(VAL_GALLERY)]
    g = np.random.default_rng(3)
    refs = g.integers(0, VAL_GALLERY, VAL_QUERIES)
    targets = (refs + g.integers(1, VAL_GALLERY, VAL_QUERIES)) % VAL_GALLERY
    step = 128
    classic = [{"name": names[i:i + step], "image": images[i:i + step],
                "patch": patches[i:i + step]} for i in range(0, VAL_GALLERY, step)]
    relative = [{"ref_name": [names[j] for j in refs[i:i + step]],
                 "tar_name": [names[j] for j in targets[i:i + step]],
                 "captions": [FIQ_CAPTIONS[j % 6] for j in range(i, i + step)],
                 "ref_patch": patches[refs[i:i + step]]} for i in range(0, VAL_QUERIES, step)]

    def validator(api: InferenceAPI):
        before = launch_counts()
        with recorded_predictions() as preds:
            r = E.evaluate_fiq_split(api, classic, relative)
        after = launch_counts()
        record.append({name: after[name] - before[name] for name in after})
        if not all(torch.isfinite(p).all() for p in preds):
            raise AssertionError("non-finite validation queries")
        return r["recall_at10"], r

    return validator


def _keep_all(shape, keep, generator, device):
    return torch.ones(shape, dtype=torch.bool, device=device)


def check_fp32_step(cfg, dataset: SyntheticFashionIQ, card: str) -> dict:
    """One fp32 step at B = 16 on the card (kernels B1-B4, and B9 and B11
    in TME on a TME model) against the same step on the CPU (plain
    versions), same weights and batch, all-keep dropout on both sides (the
    two devices' generators draw different masks). Loss at rtol 1e-5 and
    ERN gradient cosine >= 0.99999, TME's alone too: both are fp32
    throughout and differ only in summation order (a first run on an H100
    gave 8.2e-8 and 0.9999989)."""
    from fashionern_aaai2024_tpu_torch.data.loader import default_collate

    cpu_model = random_init_(ComposedCIRModel(cfg), torch.Generator().manual_seed(1))
    models = {"cpu": cpu_model, "cuda": copy.deepcopy(cpu_model).cuda()}
    raw = default_collate([dataset[i] for i in range(CHECK_BATCH)])
    caps = _fiq_captions(raw, random.Random(0))
    out = {}
    with mock.patch.object(Dr, "dropout_mask", _keep_all):
        for dev, model in models.items():
            state = create_train_state(model, seed=0)
            step = build_train_step(model, cosine_annealing_schedule(TRAIN_LR, 100))
            batch = {"ref_image": torch.from_numpy(raw["ref_image"]),
                     "tar_image": torch.from_numpy(raw["tar_image"]),
                     "text_ids": torch.from_numpy(tokenizer()(caps)).long(),
                     "ref_patch": torch.from_numpy(raw["ref_patch"]),
                     "tar_patch": torch.from_numpy(raw["tar_patch"])}
            _, loss = step(state, {k: v.to(state.device) for k, v in batch.items()})

            def grads(prefix: str = "") -> torch.Tensor:
                return torch.cat([p.grad.flatten().double().cpu()
                                  for n, p in model.ern.named_parameters()
                                  if p.grad is not None and n.startswith(prefix)])
            out[dev] = (loss.item(), grads(), grads("TME.") if cfg.text.tme else None)
    (l_cpu, g_cpu, t_cpu), (l_card, g_card, t_card) = out["cpu"], out["cuda"]
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    cos = F.cosine_similarity(g_card, g_cpu, dim=0).item()
    tme_cos = None if t_cpu is None else F.cosine_similarity(t_card, t_cpu, dim=0).item()
    log(f"  fp32 step B={CHECK_BATCH}: loss card {l_card:.6f} cpu {l_cpu:.6f} "
        f"(rel {rel:.3e}); ERN gradient cosine {cos:.8f}"
        + ("" if tme_cos is None else f", TME's {tme_cos:.8f}") + f" ({card})")
    if not rel <= 1e-5 or not cos >= 0.99999 or not (tme_cos is None or tme_cos >= 0.99999):
        raise AssertionError("the card's fp32 train step disagrees with the CPU's")
    return dict(loss_card=l_card, loss_cpu=l_cpu, loss_rel=rel, grad_cosine=cos,
                tme_grad_cosine=tme_cos)


SPANS = ("train_step/towers", "train_step/tme", "train_step/fusion_forward",
         "train_step/bbc_loss", "train_step/adam")


def profile_step(trainer: Trainer, step_fn) -> dict:
    """Device time of one more step, split by phase. The `record_function`
    spans of the main thread (train/step.py, models/composed.py) sum the
    kernel time of what they launched; the backward runs on autograd's
    own thread, outside every span, so its time is the step's kernel time
    less the other spans'."""
    batch = next(iter(trainer.loader))
    db = trainer._device_batch(batch, step=trainer.global_step)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        trainer.state, loss = step_fn(trainer.state, db)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not np.isfinite(loss.item()):
        raise AssertionError("non-finite loss in the profiled step")
    # kernels, copies and sets on the card; the spans' own windows there
    # carry the span names and are left out
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in SPANS]
    total = sum(e.device_time_total for e in on_card) / 1e3
    spans = {e.key: e.device_time_total / 1e3 for e in prof.key_averages() if e.key in SPANS}
    parts = [k.split("/")[1] for k in SPANS] + ["backward"]
    split = dict.fromkeys(parts)
    if spans and total > 0:
        split = {k.split("/")[1]: spans.get(k, 0.0) for k in SPANS}
        split["backward"] = total - sum(spans.values())
    return dict(wall_ms=wall * 1e3, device_ms=total,
                bbc_kernels_ms=sum(e.device_time_total for e in on_card
                                   if "bbc_" in e.name) / 1e3,
                spans_device_ms=split)


def phase_train(card: str, tme: bool = False) -> dict:
    """The train slice (phase 9: 6 steps and a validation) or its TME
    variant (phase 11: 3 steps, no validation)."""
    cfg = get_clip_config("ViT-B-16", activation="quick_gelu", tme=tme)
    steps = TME_TRAIN_STEPS if tme else TRAIN_STEPS
    g = np.random.default_rng(2)
    side = cfg.vision.image_size
    images = g.integers(0, 256, (UNIVERSE, side, side, 3), dtype=np.uint8)
    patches = g.standard_normal((UNIVERSE, 13, cfg.feature_dim), dtype=np.float32)
    dataset = SyntheticFashionIQ(images, patches, TRAIN_BATCH * steps, seed=4)
    fp32 = check_fp32_step(cfg, dataset, card)

    model = random_init_(ComposedCIRModel(cfg), torch.Generator().manual_seed(0))
    val_launches: list = []
    common.BUILD_ROOT.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=common.BUILD_ROOT.parent) as ckpt_dir:
        tcfg = TrainConfig(dataset="fashioniq", clip_model_name="ViT-B-16",
                           activation="quick_gelu", batch_size=TRAIN_BATCH, lr=TRAIN_LR,
                           num_epochs=1, validation_frequency=1, print_frequency=1,
                           max_steps_per_epoch=steps, num_workers=0, precision="bf16",
                           image_dtype="uint8", eval_batch_size=128, ckpt_dir=ckpt_dir,
                           seed=0, tme=tme)
        trainer = Trainer(tcfg, device="cuda", model=model, train_dataset=dataset,
                          validator=None if tme else make_validator(images, patches,
                                                                    val_launches),
                          plugin=DatasetPlugin("synthetic-fashioniq", lambda c: dataset,
                                               _fiq_captions),
                          tokenizer=tokenizer())
        clip_before = {k: v.clone() for k, v in model.clip.state_dict().items()}
        ern_before = {n: p.detach().clone() for n, p in model.ern.named_parameters()}
        times, losses = [], []
        inner = trainer.step_fn

        def timed_step(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = inner(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss.item())
            return state, loss

        trainer.step_fn = timed_step
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        total = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        if len(val_launches) != (0 if tme else 1):
            raise AssertionError(f"{len(val_launches)} validations")
        launches = dict(total)
        if val_launches:
            launches = {name: total[name] - val_launches[0][name] for name in total}
            check_launches("validation", val_launches[0],
                           serve_launches(cfg, [128] * (VAL_GALLERY // 128),
                                          [128] * (VAL_QUERIES // 128)))
        check_launches(f"{'TME ' if tme else ''}train path", launches,
                       train_launches(steps, tme=tme))
        if len(losses) != steps or not np.all(np.isfinite(losses)):
            raise AssertionError(f"train losses {losses}")
        for k, v in model.clip.state_dict().items():
            if not torch.equal(v, clip_before[k]):
                raise AssertionError(f"frozen CLIP tensor {k} changed")
        moved = [n for n, p in model.ern.named_parameters()
                 if not torch.equal(p.detach(), ern_before[n])]
        still = sorted(set(ern_before) - set(moved))
        # the BERT pooler feeds no output of the DVR tower: no gradient
        if any("pooler" not in n for n in still):
            raise AssertionError(f"ERN tensors that did not move: {still}")
        clip_sum = sum(v.double().sum().item() for v in model.clip.state_dict().values())
        step_ms = statistics.median(times[1:]) * 1e3
        info = dict(losses=losses, step_seconds=times, median_step_ms_from_2=step_ms,
                    samples_per_s=TRAIN_BATCH / step_ms * 1e3, run_seconds=run_s,
                    launches=launches,
                    validation_launches=val_launches[0] if val_launches else None,
                    recall_at10=trainer.best.best_metric, peak_memory_gib=peak_gb,
                    ern_moved=len(moved), ern_unmoved=still, clip_checksum=clip_sum,
                    fp32_check=fp32)
        log(f"  {steps} steps at B={TRAIN_BATCH}{' with TME' if tme else ''}: losses "
            f"{[round(x, 4) for x in losses]}; step times "
            f"{[round(1e3 * t, 2) for t in times]} ms, median (2-{steps}) {step_ms:.2f} ms = "
            f"{info['samples_per_s']:.1f} samples/s; peak memory {peak_gb:.2f} GiB ({card})")
        log(f"  launches on the steps {launches}; on the validation {info['validation_launches']}; "
            f"Recall@10 {info['recall_at10']:.3f}; CLIP unchanged (checksum {clip_sum:.6e}); "
            f"{len(moved)} ERN tensors moved, unmoved (no gradient): {still}")
        info["profile"] = profile_step(trainer, inner)
    prof = info["profile"]
    spans = ", ".join(f"{k} not measured" if v is None else f"{k} {v:.2f} ms"
                      for k, v in prof["spans_device_ms"].items())
    log(f"  profiled step: wall {prof['wall_ms']:.2f} ms, device {prof['device_ms']:.2f} ms, "
        f"B4 kernels {prof['bbc_kernels_ms']:.4f} ms; device time by span: {spans} ({card})")
    return info


def int8_inputs(b, s, w, dtype, seed):
    """B5 and B6 operands: float activations, LN parameters and biases in
    `dtype`, weights drawn at std 0.02 in `dtype` and quantized as the
    towers' cache does (int8 [out, in], fp32 scale per output row)."""
    g = torch.Generator().manual_seed(seed)

    def t(*shape, scale=0.02, offset=0.0):
        return (offset + scale * torch.randn(shape, generator=g)).to(dtype).cuda()

    def q(out_f, in_f):
        values, scale = quantize_rowwise(t(out_f, in_f))
        return values, scale.reshape(-1)

    f = 4 * w
    x, ln = t(b, s, w, scale=1.0), (t(w, scale=0.1, offset=1.0), t(w, scale=0.1))
    return {B5: (x, *ln, *q(f, w), t(f), *q(w, f), t(w)),
            B6: (x, *ln, *q(3 * w, w), t(3 * w), *q(w, w), t(w))}


def int8_work(name: str, b: int, s: int, w: int, heads: int, causal: bool,
              dtype: torch.dtype) -> tuple[float, float, float]:
    """(int8 operations, float attention FLOPs, bytes) of one B5 / B6
    call: x read and the output written once in `dtype`, the int8
    weights, their fp32 scales and the biases read once."""
    e = torch.finfo(dtype).bits // 8
    m = b * s
    if name == B5:
        return 16 * m * w * w, 0.0, e * (2 * m * w + 7 * w) + 8 * w * w + 4 * 5 * w
    pairs = s * (s + 1) // 2 if causal else s * s
    attn = 4 * b * heads * pairs * (w // heads)
    return 8 * m * w * w, attn, e * (2 * m * w + 6 * w) + 4 * w * w + 4 * 4 * w


def int8_bound(ops: float, flops: float, nbytes: float, dtype: torch.dtype) -> dict:
    """Least time on an H100 SXM: the larger of the operations' time (int8
    at 1,979 TOPS plus attention FLOPs at the dtype's peak) and the bytes'
    at 3.35 TB/s."""
    ops_ms = 1e3 * (ops / PEAK_INT8_OPS + flops / PEAK_FLOPS[dtype])
    bytes_ms = 1e3 * nbytes / PEAK_BYTES
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def int8_library_call(name: str, args: tuple, heads: int, causal: bool):
    """A PyTorch library composition of B5 / B6's function: LN, row
    quantization, `torch._int_mm`, rescale (and SDPA for B6's attention).
    A yardstick for `library_ms`, never called by the port."""
    def quant(y):
        scale = y.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
        return torch.clamp(torch.round(y / scale), -127, 127).to(torch.int8), scale

    def qmm(aq, a_s, wq, w_s):
        return torch._int_mm(aq, wq.t()).float() * a_s * w_s

    x, g, b_, w1q, w1s, b1, w2q, w2s, b2 = args
    bsz, s, w = x.shape
    x2 = x.view(-1, w)

    def ln_quant():
        return quant(F.layer_norm(x2.float(), (w,), g.float(), b_.float()))

    if name == B5:
        f = w1q.shape[0]
        c = f // Q.hidden_groups(f, "quick_gelu")

        def b5():
            h = qmm(*ln_quant(), w1q, w1s) + b1.float()
            h = h * torch.sigmoid(1.702 * h)
            acc = sum(qmm(*quant(h[:, i:i + c]), w2q[:, i:i + c].contiguous(), w2s)
                      for i in range(0, f, c))
            return x2 + (acc + b2.float()).to(x.dtype)
        return b5

    def b6():
        qkv = (qmm(*ln_quant(), w1q, w1s) + b1.float()).to(x.dtype)
        q, k, v = qkv.view(bsz, s, 3, heads, w // heads).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        o = o.transpose(1, 2).reshape(-1, w).float()
        return x2 + (qmm(*quant(o), w2q, w2s) + b2.float()).to(x.dtype)
    return b6


def int8_errors(got: torch.Tensor, want: torch.Tensor, dtype: torch.dtype) -> dict:
    """Share of elements off the float tolerance, largest and mean error,
    and whether they pass the float tolerance + INT8_STEP and INT8_MEAN."""
    err = (got.float() - want.float()).abs()
    limit = TOL[dtype]["atol"] + TOL[dtype]["rtol"] * want.float().abs()
    mean = err.mean().item()
    return dict(elements_off_share=(err > limit).float().mean().item(),
                max_abs_err=err.max().item(), mean_abs_err=mean,
                passes=bool((err <= limit + INT8_STEP[dtype]).all()) and mean <= INT8_MEAN[dtype])


def bf16_control(plain_fn, *args, **kwargs) -> torch.Tensor:
    """`plain_fn` with one fault of precision: every activation rounded to
    bf16 before its row quantization (LN output, hidden, attention output),
    as a kernel that kept them in bf16 would compute."""
    def quantize_bf16(y):
        return quantize_rowwise(y.to(torch.bfloat16).float())

    with mock.patch.object(Q, "quantize_rowwise", quantize_bf16):
        return plain_fn(*args, **kwargs)


def ln_quant_flips(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> float:
    """Share of the LN + quantize kernel's int8 codes that differ from the
    plain version's (by one step at most; raises otherwise)."""
    x2 = x.view(-1, x.shape[-1])
    q, _ = common.launch_ln_quant(x2, g, b, 1e-5)
    want, _ = Q.ln_quantize(x2, g, b, 1e-5)
    diff = (q.int() - want.int()).abs()
    share = diff.float().mean().item()
    if diff.max().item() > 1 or share > INT8_CODE_SHARE:
        raise AssertionError(f"LN + quantize: codes off by {diff.max().item()}, share {share}")
    return share


def phase_int8_kernels() -> tuple[dict, list]:
    plain = {B5: Q.int8_mlp_subblock_plain, B6: Q.int8_attention_subblock_plain}
    rows, worst = [], {name: 0.0 for name in INT8_KERNELS}
    for dtype, (label, shp) in INT8_SHAPES:
        inputs = int8_inputs(shp["b"], shp["s"], shp["w"], dtype, seed=100 + len(rows))
        flips = ln_quant_flips(*inputs[B5][:3])
        for name in INT8_KERNELS:
            wrapper, args = KERNELS[name][0], inputs[name]
            kw = {"activation": "quick_gelu"} if name == B5 else {"causal": shp["causal"]}
            pos = () if name == B5 else (shp["heads"],)
            got = wrapper(*args, *pos, **kw)
            want = plain[name](*args, *pos, **kw)
            control = bf16_control(plain[name], *args, *pos, **kw)
            torch.cuda.synchronize()
            close = int8_errors(got, want, dtype)
            ctl = int8_errors(control, want, dtype)
            if not close.pop("passes"):
                raise AssertionError(f"{name} {label} {dtype}: off its plain version {close}")
            if ctl.pop("passes"):
                raise AssertionError(f"{name} {label} {dtype}: the check passes the bf16 "
                                     f"control {ctl}")
            worst[name] = max(worst[name], close["max_abs_err"])
            del got, want, control
            ops, flops, nbytes = int8_work(name, shp["b"], shp["s"], shp["w"], shp["heads"],
                                           shp["causal"], dtype)
            row = dict(kernel=name, shape=label, dtype=str(dtype).split(".")[1],
                       ln_quant_code_flip_share=flips, **close,
                       control_max_abs_err=ctl["max_abs_err"],
                       control_mean_abs_err=ctl["mean_abs_err"],
                       ms=median_ms(lambda: wrapper(*args, *pos, **kw)),
                       plain_ms=median_ms(lambda: plain[name](*args, *pos, **kw)),
                       library_ms=median_ms(int8_library_call(name, args, shp["heads"],
                                                              shp["causal"])),
                       **int8_bound(ops, flops, nbytes, dtype))
            rows.append(row)
            log(f"  {name:32s} {label:10s} {row['dtype']:9s} err {row['max_abs_err']:.3e} "
                f"mean {row['mean_abs_err']:.2e} off float tol {row['elements_off_share']:.4f} "
                f"LN codes flipped {flips:.2e} (bf16 control: mean "
                f"{row['control_mean_abs_err']:.2e})  "
                f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
                f"library {row['library_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms")
        del inputs
        torch.cuda.empty_cache()
    # B6's attention core (bf16 operands, fp32 output) at the tiles' edges
    edge, g = {}, torch.Generator().manual_seed(700)
    with torch.no_grad():
        for s in EDGE_LENGTHS:
            qkv = torch.randn((3, s, 3 * 4 * 64), generator=g).to(torch.bfloat16).cuda()
            for causal in (False, True):
                edge_check(edge, B6, A.launch_attention_core(qkv, 4, causal=causal, scale=None,
                                                             out_dtype=torch.float32),
                           A.packed_qkv_self_attention_plain(qkv, 4, causal=causal,
                                                             out_dtype=torch.float32),
                           torch.bfloat16)
    log(f"  edges: B6's attention core, bf16 in, fp32 out, S in {EDGE_LENGTHS}, causal and "
        f"not: max error {edge[B6]:.3e}")
    worst[B6] = max(worst[B6], edge[B6])
    return worst, rows


def topk_overlap(a: list, b: list) -> float:
    return float(np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(a, b)]))


def phase_int8_train(card: str) -> dict:
    """2 steps of Trainer.train() at B = 1024 with int8 frozen towers."""
    cfg = get_clip_config("ViT-B-16", activation="quick_gelu", quantize_mlp=True)
    g = np.random.default_rng(5)
    side = cfg.vision.image_size
    images = g.integers(0, 256, (UNIVERSE, side, side, 3), dtype=np.uint8)
    patches = g.standard_normal((UNIVERSE, 13, cfg.feature_dim), dtype=np.float32)
    dataset = SyntheticFashionIQ(images, patches, TRAIN_BATCH * INT8_TRAIN_STEPS, seed=6)
    common.BUILD_ROOT.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=common.BUILD_ROOT.parent) as ckpt_dir:
        tcfg = TrainConfig(dataset="fashioniq", clip_model_name="ViT-B-16",
                           activation="quick_gelu", batch_size=TRAIN_BATCH, lr=TRAIN_LR,
                           num_epochs=1, print_frequency=1,
                           max_steps_per_epoch=INT8_TRAIN_STEPS, num_workers=0,
                           precision="bf16", image_dtype="uint8", ckpt_dir=ckpt_dir, seed=0,
                           quantize_towers=True)
        trainer = Trainer(tcfg, device="cuda", train_dataset=dataset,
                          plugin=DatasetPlugin("synthetic-fashioniq", lambda c: dataset,
                                               _fiq_captions),
                          tokenizer=tokenizer())
        if not trainer.model.clip_config.quantize_mlp:
            raise AssertionError("quantize_towers did not build int8 towers")
        times, losses = [], []
        inner = trainer.step_fn

        def timed_step(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = inner(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss.item())
            return state, loss

        trainer.step_fn = timed_step
        reset_launches()
        trainer.train()
        torch.cuda.synchronize()
        launches = launch_counts()
    check_launches("int8 train path", launches, train_launches(INT8_TRAIN_STEPS, int8=True))
    if len(losses) != INT8_TRAIN_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"int8 train losses {losses}")
    log(f"  {INT8_TRAIN_STEPS} steps at B={TRAIN_BATCH}, int8 towers: losses "
        f"{[round(x, 4) for x in losses]}; step times "
        f"{[round(1e3 * t, 2) for t in times]} ms (the second: "
        f"{TRAIN_BATCH / times[-1]:.1f} samples/s); launches {launches} ({card})")
    return dict(losses=losses, step_seconds=times, launches=launches,
                samples_per_s_step2=TRAIN_BATCH / times[-1])


def phase_tokenizer() -> dict:
    """The port's BPE on this machine: the native core's ids equal the
    Python path's on every phase's captions and on NON_ASCII_CAPTIONS
    (rows the core flags for the Python path), each row SOT ... EOT; and
    the host time of one call at b = 1 and 32 (median of 200 after a
    warm-up call, the core's word cache warm, as a serving host runs)."""
    tok = tokenizer()
    texts = (CAPTIONS + [join_fiq_captions(*p) for p in FIQ_CAPTIONS] + CIRR_CAPTIONS
             + NON_ASCII_CAPTIONS)
    native, python = tok(texts, CTX), tok.python_ids(texts, CTX)
    _, flagged = tok._core().encode_batch(NON_ASCII_CAPTIONS, CTX)
    ends = (native != 0).sum(axis=1) - 1
    if (not np.array_equal(native, python) or not flagged.all()
            or (native[:, 0] != tok.sot_token).any()
            or (native[np.arange(len(texts)), ends] != tok.eot_token).any()):
        raise AssertionError("the native tokenizer disagrees with the Python path")
    out = dict(vocab_size=tok.vocab_size, rows_checked=len(texts))
    for b in (1, 32):
        caps = [CAPTIONS[i % len(CAPTIONS)] for i in range(b)]
        tok(caps, CTX)
        times = []
        for _ in range(200):
            t0 = time.perf_counter()
            tok(caps, CTX)
            times.append(time.perf_counter() - t0)
        out[f"tokenize_us_b{b}"] = statistics.median(times) * 1e6
    log(f"  tokenizer: native ids equal the Python path's on {len(texts)} captions "
        f"({len(NON_ASCII_CAPTIONS)} non-ASCII, flagged); host time of one call "
        f"{out['tokenize_us_b1']:.1f} us at b=1, {out['tokenize_us_b32']:.1f} us at b=32 "
        f"(vocabulary {tok.vocab_size})")
    return out


def eval_loaders(side: int, dim: int, prefix: str, seed: int, cirr: bool) -> tuple[list, list]:
    """In-memory loaders of one evaluator, as lists of batches of BATCH: a
    gallery of EVAL_GALLERY seeded images (CLIP-normalized) with 13 x dim
    patches, and EVAL_QUERIES queries whose targets differ from their
    references, FashionIQ-shaped (two captions) or CIRR-shaped (one
    caption and six group members: the reference, the target and four
    others)."""
    g = np.random.default_rng(seed)
    names = [f"{prefix}{i:04d}" for i in range(EVAL_GALLERY)]
    raw = g.random((EVAL_GALLERY, side, side, 3), dtype=np.float32)
    images = ((raw - CLIP_MEAN) / CLIP_STD).astype(np.float32)
    patches = g.standard_normal((EVAL_GALLERY, 13, dim)).astype(np.float32)
    refs = g.integers(0, EVAL_GALLERY, EVAL_QUERIES)
    tars = (refs + g.integers(1, EVAL_GALLERY, EVAL_QUERIES)) % EVAL_GALLERY
    classic = [{"name": names[i:i + BATCH], "image": images[i:i + BATCH],
                "patch": patches[i:i + BATCH]} for i in range(0, EVAL_GALLERY, BATCH)]
    relative = []
    for i in range(0, EVAL_QUERIES, BATCH):
        r, t = refs[i:i + BATCH], tars[i:i + BATCH]
        batch = {"ref_name": [names[j] for j in r], "tar_name": [names[j] for j in t],
                 "ref_patch": patches[r]}
        if cirr:
            batch["caption"] = [CIRR_CAPTIONS[j % len(CIRR_CAPTIONS)]
                                for j in range(i, i + len(r))]
            groups = []
            for a, b in zip(r, t):
                others = [j for j in g.permutation(EVAL_GALLERY)[:CIRR_GROUP] if j not in (a, b)]
                groups.append([names[j] for j in g.permutation([a, b, *others[:CIRR_GROUP - 2]])])
            batch["group_members"] = groups
        else:
            batch["captions"] = [FIQ_CAPTIONS[j % len(FIQ_CAPTIONS)] for j in range(i, i + len(r))]
        relative.append(batch)
    return classic, relative


def cpu_loaders(classic: list, relative: list, queries: int) -> tuple[list, list]:
    """An evaluator's loaders cut for the CPU leg: its first `queries`
    queries (whole batches) and its gallery cut to the images they name
    (references, targets, CIRR group members), in gallery order, in
    batches of BATCH. A query's prediction reads only its reference's
    gallery row, so it is the one the card makes on the whole loaders."""
    relative = relative[:queries // BATCH]
    named = {n for batch in relative for key in ("ref_name", "tar_name") for n in batch[key]}
    named |= {n for batch in relative for group in batch.get("group_members", ())
              for n in group}
    keep = [np.array([n in named for n in batch["name"]]) for batch in classic]
    names = [n for batch in classic for n in batch["name"] if n in named]
    images = np.concatenate([batch["image"][k] for batch, k in zip(classic, keep)])
    patches = np.concatenate([batch["patch"][k] for batch, k in zip(classic, keep)])
    cut = [{"name": names[i:i + BATCH], "image": images[i:i + BATCH],
            "patch": patches[i:i + BATCH]} for i in range(0, len(names), BATCH)]
    return cut, relative


def phase_eval(card: str) -> dict:
    """`evaluate_fiq` (three dress types) and `evaluate_cirr` of ViT-B-16
    at full width, seeded weights, bf16 serve policy on the card and the
    same weights in fp32 on the CPU (plain versions; every evaluator on
    its first CPU_QUERIES queries, `cpu_loaders`): launch counts on the card
    (B10 in every text-tower block at the eval batch of 32), every CPU
    query's prediction card against CPU at cosine >= 0.99 (phase 3's
    limit), the recall dicts of both."""
    cfg = get_clip_config("ViT-B-16", activation="quick_gelu")
    model = random_init_(ComposedCIRModel(cfg), torch.Generator().manual_seed(0))
    reference = copy.deepcopy(model).eval()
    apply_precision(model, "bf16")
    side, dim = cfg.vision.image_size, cfg.feature_dim
    fiq = {dt: eval_loaders(side, dim, dt, seed=20 + i, cirr=False)
           for i, dt in enumerate(FIQ_TYPES)}
    cirr = eval_loaders(side, dim, "cirr", seed=30, cirr=True)
    cpu_fiq = {dt: cpu_loaders(*fiq[dt], CPU_QUERIES) for dt in FIQ_TYPES}
    cpu_cirr = cpu_loaders(*cirr, CPU_QUERIES)
    log(f"  CPU leg: {CPU_QUERIES} queries of each evaluator over galleries of "
        f"{[sum(len(b['name']) for b in c) for c, _ in (*cpu_fiq.values(), cpu_cirr)]}")
    runs = {}
    for dev, m, fiq_l, cirr_l in (("cuda", model, fiq, cirr),
                                  ("cpu", reference, cpu_fiq, cpu_cirr)):
        api = InferenceAPI(m, tokenizer=tokenizer(), device=dev, batch_size=BATCH)
        reset_launches()
        t0 = time.perf_counter()
        with recorded_predictions() as preds:
            fiq_r = E.evaluate_fiq(api, fiq_l)
            cirr_r = E.evaluate_cirr(api, *cirr_l)
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[dev] = dict(fiq=fiq_r, cirr=cirr_r, preds=preds, launches=launch_counts(),
                         seconds=time.perf_counter() - t0)
        log(f"  {dev}: {runs[dev]['seconds']:.1f} s; evaluate_fiq {fiq_r}; "
            f"evaluate_cirr {cirr_r}")
    per_eval = serve_launches(cfg, [BATCH] * (EVAL_GALLERY // BATCH),
                              [BATCH] * (EVAL_QUERIES // BATCH))
    evaluators = len(FIQ_TYPES) + 1
    check_launches("evaluation", runs["cuda"]["launches"],
                   {name: evaluators * n for name, n in per_eval.items()})
    card_preds, cpu_preds = runs["cuda"].pop("preds"), runs["cpu"].pop("preds")
    if (len(card_preds) != evaluators or len(cpu_preds) != evaluators
            or any(len(b) != CPU_QUERIES for b in cpu_preds)):
        raise AssertionError(f"{len(card_preds)} / {len(cpu_preds)} prediction passes")
    # each evaluator's first CPU_QUERIES predictions, card against CPU
    cos = torch.cat([cosine(a[:CPU_QUERIES], b) for a, b in zip(card_preds, cpu_preds)])
    log(f"  predictions card bf16 vs CPU fp32 over {len(cos)} queries: cosine min "
        f"{cos.min().item():.5f} (median {cos.median().item():.5f}); launches "
        f"{runs['cuda']['launches']} ({card})")
    if not torch.isfinite(cos).all() or cos.min() < 0.99:
        raise AssertionError("the card's evaluator predictions disagree with the CPU's")
    return dict(card=runs["cuda"], cpu=runs["cpu"], launches=runs["cuda"]["launches"],
                prediction_cosine_min=cos.min().item(),
                prediction_cosine_median=cos.median().item())


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
    new_worst, new_rows = phase_new_kernels()
    tme_worst, tme_rows = phase_tme_kernels()
    block_worst, block_rows, block_grad = phase_block_kernel()
    edge_worst = phase_edge_kernels()
    gemm_worst = phase_gemm_edges()
    f32_gemm_worst = phase_f32_gemm_edges()
    gemm_rows = phase_gemm_products(card)
    host = phase_host_us(card)
    log(f"phase 3: the serve slice, ViT-B-16 bf16 ({card})")
    tokenizer_info = phase_tokenizer()
    slice_info, service, api = phase_slice(card)
    log(f"phase 4: timings ({card})")
    timings, embed_fn, query_fn = phase_timings(service, api)
    log(f"  embed + refine {timings['embed_refine_img_per_s']:.2f} img/s (B=128 bf16); "
        f"query P50 {timings['query_p50_ms_b1']:.3f} ms at b=1, "
        f"{timings['query_p50_ms_b32']:.3f} ms at b=32 ({card})")
    log(f"phase 5: int8 kernels B5 and B6 against their plain versions ({card})")
    int8_worst, int8_rows = phase_int8_kernels()
    log(f"phase 6: the int8 serve slice, ViT-B-16 bf16, int8 towers and gallery ({card})")
    int8_info, int8_service, int8_api = phase_slice(card, quantize=True)
    int8_info["bf16_topk_overlap"] = topk_overlap(slice_info["results"], int8_info["results"])
    int8_timings, int8_embed_fn, _ = phase_timings(int8_service, int8_api)
    log(f"  top-{K} overlap with the bf16 service {int8_info['bf16_topk_overlap']:.3f}; "
        f"embed + refine {int8_timings['embed_refine_img_per_s']:.2f} img/s (B=128 bf16, "
        f"int8 towers); query P50 {int8_timings['query_p50_ms_b1']:.3f} ms at b=1, "
        f"{int8_timings['query_p50_ms_b32']:.3f} ms at b=32 ({card})")
    del int8_service, int8_api
    log(f"phase 7: {B4} against its plain version ({card})")
    bbc_rows = phase_bbc()
    log(f"phase 8: the int8 train slice, B={TRAIN_BATCH}, quantize_towers ({card})")
    int8_train = phase_int8_train(card)
    log(f"phase 9: the train slice, ViT-B-16, bf16 towers, B={TRAIN_BATCH} ({card})")
    train = phase_train(card)
    log(f"phase 10: the RN50x4 serve slice, bf16 towers ({card})")
    rn_info, rn_service, rn_api = phase_slice(card, model_name="RN50x4")
    rn_timings, rn_embed_fn, rn_query_fn = phase_timings(rn_service, rn_api)
    log(f"  embed + refine {rn_timings['embed_refine_img_per_s']:.2f} img/s (B=128 bf16, "
        f"RN50x4); query P50 {rn_timings['query_p50_ms_b1']:.3f} ms at b=1, "
        f"{rn_timings['query_p50_ms_b32']:.3f} ms at b=32 ({card})")
    log(f"phase 11: the TME slice, ViT-B-16, tme=True, bf16 serve policy ({card})")
    tme_info, tme_service, tme_api = phase_slice(card, tme=True)
    tme_timings, _, tme_query_fn = phase_timings(tme_service, tme_api)
    log(f"  TME query P50 {tme_timings['query_p50_ms_b1']:.3f} ms at b=1, "
        f"{tme_timings['query_p50_ms_b32']:.3f} ms at b=32 ({card})")
    tme_train = phase_train(card, tme=True)
    log(f"phase 12: evaluate_fiq and evaluate_cirr, ViT-B-16, card bf16 and CPU fp32 ({card})")
    eval_info = phase_eval(card)
    log(f"phase 13: the attention experiment: X1-X4 and B9's grouped route against their "
        f"plain versions, then its runner, --all, at B={XA.B} ({card})")
    exp_worst, exp_rows = phase_experiment_kernels()
    experiment = phase_experiment(card)
    log(f"phase 14: profiles of embed + refine, B=128, of ViT-B-16 and RN50x4 queries at b=1, "
        f"and of an RN50x4 and a TME query at b=32 ({card})")
    vit_spans = ("embed/image_tower", "embed/index_refine")
    profiles = (("ViT-B-16 bf16 embed + refine", embed_fn, timings, "embed_refine_profile",
                 vit_spans),
                ("ViT-B-16 int8 embed + refine", int8_embed_fn, int8_timings,
                 "embed_refine_profile", vit_spans),
                ("RN50x4 bf16 embed + refine", rn_embed_fn, rn_timings, "embed_refine_profile",
                 EMBED_SPANS),
                ("ViT-B-16 bf16 query b=1", lambda: query_fn(1), timings, "query_b1_profile",
                 QUERY_SPANS),
                ("RN50x4 bf16 query b=1", lambda: rn_query_fn(1), rn_timings,
                 "query_b1_profile", QUERY_SPANS),
                ("RN50x4 bf16 query b=32", rn_query_fn, rn_timings, "query_b32_profile",
                 QUERY_SPANS),
                ("ViT-B-16 TME bf16 query b=32", tme_query_fn, tme_timings, "query_b32_profile",
                 QUERY_SPANS))
    for label, fn, out, key, spans in profiles:
        split = out[key] = kernel_split(fn, spans=spans)
        span_text = "".join(f"; span {k} " + ("not measured" if v is None else f"{v:.3f} ms")
                            for k, v in split["spans_device_ms"].items())
        log(f"  {label}: wall {split['wall_ms']:.3f} ms, device "
            f"{split['device_ms']:.3f} ms, idle share {split['idle_share']:.3f}; "
            + "; ".join(f"{t['kernel'][:48]} {t['ms']:.3f} ms x{t['launches']}"
                        for t in split["top"]) + span_text + f" ({card})")
    log(f"  build {common.LIBRARY.build_seconds:.1f} s; total {time.perf_counter() - t0:.1f} s "
        f"({card})")

    timed = {r["kernel"]: r for r in rows + int8_rows
             if r["shape"] == "vit_b32" and r["dtype"] == "bfloat16"}
    # B7, B8 and B11 at one RN50x4 site each, in that site's dtype
    for name, shape, dtype in ((B7, "bert640", "float32"), (B8, "attnpool", "bfloat16"),
                               (B11, "ln_final", "bfloat16")):
        timed[name] = next(r for r in new_rows if r["kernel"] == name and
                           r["shape"] == shape and r["dtype"] == dtype)
    # B9 at TME's serve site (bf16, b = 32, d = 512), B12 at an index
    # refine batch (fp32, M = 128, d = 512)
    for name, shape, dtype in ((B9, "tme512_b32", "bfloat16"), (B12, "d512_m128", "float32")):
        timed[name] = next(r for r in tme_rows if r["kernel"] == name and
                           r["shape"] == shape and r["dtype"] == dtype)
    # B10 at the query text tower of ViT-B-16, b = 32, bf16
    timed[B10] = next(r for r in block_rows
                      if r["shape"] == "text_b32" and r["dtype"] == "bfloat16")
    worst[B10] = block_worst
    timed[B4] = bbc_rows[0]
    worst[B4] = max(r["max_abs_err"] for r in bbc_rows)
    worst.update(int8_worst)
    worst.update(new_worst)
    worst.update(tme_worst)
    worst[B9] = max(worst[B9], exp_worst.pop(B9))
    worst.update(exp_worst)
    for name, err in edge_worst.items():
        worst[name] = max(worst[name], err)
    # the GEMMs' edge cases: the device code of B1's and B2's products (and
    # of B7's projection in fp32)
    for name in (B1, B2):
        worst[name] = max(worst[name], gemm_worst, f32_gemm_worst)
    worst[B7] = max(worst[B7], f32_gemm_worst)
    # X1 and X2 at their fastest G / gb, X3 and X4, in bf16 at B = 128
    for name in EXPERIMENT_KERNELS:
        timed[name] = min((r for r in exp_rows if r["kernel"] == name and
                           r["dtype"] == "bfloat16"), key=lambda r: r["ms"])
    by_path = {name: {"serve": slice_info["launches"][name], "train": train["launches"][name],
                      "int8_serve": int8_info["launches"][name],
                      "int8_train": int8_train["launches"][name],
                      "rn50x4_serve": rn_info["launches"][name],
                      "tme_serve": tme_info["launches"][name],
                      "tme_train": tme_train["launches"][name],
                      "eval": eval_info["launches"][name],
                      "attn_experiment": experiment["launches"][name]}
               for name in KERNELS}
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=sum(by_path[name].values()), launches_by_path=by_path[name],
                    max_abs_err=worst[name], ms=timed[name]["ms"],
                    plain_ms=timed[name]["plain_ms"], bound_ms=timed[name]["bound_ms"],
                    bound_by=timed[name]["bound_by"], library_ms=timed[name]["library_ms"],
                    at=timed[name]["shape"], files=SOURCES[name])
               for name, (_, src, rep) in KERNELS.items()]
    # the fp32 instances of the attention kernels (3xTF32 tiles) at their
    # sites: B3 at ViT-B-16 B=32, B7 at the DVR BERT (with its core apart),
    # B8 at the MR rows and the pool, B9 at TME, X1 at every G
    fp32_sites = {B3: [r for r in rows if r["kernel"] == B3 and r["shape"] == "vit_b32"],
                  B7: [r for r in new_rows if r["kernel"] == B7 and "640" in r["shape"]],
                  B8: [r for r in new_rows if r["kernel"] == B8],
                  B9: [r for r in tme_rows if r["kernel"] == B9],
                  X1: [r for r in exp_rows if r["kernel"] == X1]}
    fp32_keys = ("shape", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                 "bound_by", "core_burst_ms", "core_library_burst_ms", "core_bound_ms")
    for entry in kernels:
        if entry["name"] in fp32_sites:
            entry["fp32_rows"] = [{k: r[k] for k in fp32_keys if k in r}
                                  for r in fp32_sites[entry["name"]] if r["dtype"] == "float32"]
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(dict(card=card, kernel_rows=rows, new_kernel_rows=new_rows,
                           tme_kernel_rows=tme_rows, tme_slice=tme_info,
                           tme_timings=tme_timings, tme_train=tme_train,
                           bbc_rows=bbc_rows, slice=slice_info, timings=timings, train=train,
                           int8_kernel_rows=int8_rows, int8_slice=int8_info,
                           int8_timings=int8_timings, int8_train=int8_train,
                           rn50x4_slice=rn_info, rn50x4_timings=rn_timings,
                           block_kernel_rows=block_rows, block_gradients=block_grad,
                           tokenizer=tokenizer_info, evaluation=eval_info,
                           experiment_kernel_rows=exp_rows, experiment=experiment,
                           gemm_products=gemm_rows, gemm_edge_max_err=gemm_worst,
                           f32_gemm_edge_max_err=f32_gemm_worst,
                           host_us_per_call=host,
                           build_seconds=common.LIBRARY.build_seconds), f, indent=1)
    print(f"{card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
