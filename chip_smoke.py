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
     events, median of 25, the host's enqueue included; the plain
     versions' median of `PLAIN_RUNS`) beside one PyTorch
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
     batch at k=10 through the service's one-dispatch serve program (one
     CUDA graph per bucket 1, 8 and 32, captured at startup after one
     eager warm-up call each; a query is one replay; each capture checks
     the graph's kernel nodes, read through libcuda, against the launches
     it recorded, and a replay adds those), launch counts of
     every kernel on that run (the warm-ups and the replays: B10 in each
     text-tower block, B1-B3 in the image tower's, B7 and B8 in the DVR
     query tower, B11 at every standalone LayerNorm), and the card's
     embeddings held against the port's fp32 plain run on the CPU;
  4. timings: gallery embed + index refine in img/s (bench.py's
     definition: bf16, B=128, best of 3 windows of 20) and query P50
     latency at b=1 and b=32; then both query routes side by side in one
     process, in turns, `ROUTE_SAMPLES` host-clock samples each at b=1
     and b=32: the serve program (`service.query`, one graph replay) and
     the multi-dispatch route (text tower, DVR, search: the service's
     large-k path), P50 and P99;
  5. int8 kernels: B5 (int8 MLP sub-block) and B6 (int8 attention
     sub-block) against their plain versions at vit_b32, text_b32 and
     text_b1 in bf16 and fp32 and at vit_b1024 and text_b1024 in bf16,
     each kernel's LN + quantize prologue counted for flipped int8 codes,
     and a control (the plain version with its activations rounded to
     bf16 before quantizing) that the same check must reject, with the
     same timings; the library yardstick is LN + quantize + `torch._int_mm` +
     rescale (with SDPA for B6's attention), and the bound counts int8
     operations at 1,979 TOPS, attention FLOPs at the float peak and bytes
     at 3.35 TB/s; the C entry points of each call in order (B5 four:
     LN + quantize, c_fc, the hidden quantized in groups, one c_proj over
     every group; B6 five); then the int8 GEMM (`launch_qgemm`) at its
     tiles' edges, the rule's width and the other, bf16 and fp32, bit for
     bit against the exact product through the same epilogue with the
     identity activation (B5's two groups in one launch included), a
     misaligned view refused; and each int8 product of B5 and B6 at
     ViT-B-16 B = 32 and 128 and the text tower at b = 1 and 32, at the
     rule's width, in bursts,
     beside `torch._int_mm`, with TOPS; and the quantize passes alone at
     ViT-B-16 B = 32 and 128 in bursts beside their bytes bound;
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
  8. the seeded init, then the int8 train slice: the package's default
     init (the JAX package's `ComposedCIRModel.init` under
     `PRNGKey(seed)`, `models/composed.py jax_init_`) of ViT-B-16 with
     TME drawn on the card and timed, a sample of its variables (one of
     each initializer, a few million values) drawn again on the CPU and
     held to the card's within 4 float32 ulps; then a default Trainer
     (its own seeded init, built on the card, held tensor for tensor to
     that draw) takes 2 steps of `Trainer.train()` at B = 1024 with
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
      policy and, for the first 8 queries of every evaluator over a
      gallery cut to the images they name, on the CPU in fp32 with the
      plain versions: launch counts on the card, every CPU query's
      prediction card against CPU at cosine >= 0.99, and the recall dicts
      of both; then `embed_gallery` over one of those galleries on the
      card at prefetch 0 and 2, tokens kept: equal bit for bit, tokens on
      the host, every batch copied from page-locked memory on the stage's
      copy stream and none again inside the encode, each depth's seconds;
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
      query at b=1, and of one RN50x4 and one TME query at b=32 (the
      multi-dispatch route), and of one ViT-B-16 query through the serve
      program at b=1 and 32 (a graph replay), with the device time of the `record_function` spans (image
      tower, its trunk and attention pool, index refine; text tower, DVR
      query tower, search). Every profile runs after every host-clock and
      event timing: the profiler slows later launches.
  15. the dataset and CLI path, through the port's CLI
      (`python -m fashionern_aaai2024_tpu_torch.cli.main`, run as `-m`
      runs it, in subprocesses that write their kernel launch counts at
      exit): soak legs B (learnable FashionIQ) and C (learnable CIRR) of
      `benchmarks/accuracy_soak.py`, each from the CLI's default init (the
      JAX package's seeded init, seed 7, drawn on the card in every CLI
      process), each `make-fixture --learnable` (64
      images a type, 128 triplets) -> untrained `eval --seed 7` -> `train`
      at ViT-B-16, B = 16, 11 epochs (the soak's 15, cut to keep the run
      under 900 s), validation every epoch, the uint8
      feed -> `eval` with the best checkpoint; the trained eval must equal
      the sidecar's best validation metric exactly and beat the untrained
      eval by 20 points (the two legs' chains run side by side). Then the
      host time of `load_and_preprocess` per decode route (a fixture PNG
      and the same pixels as a JPEG), and `extract-patches` on 4 fixture
      images: the CLI on the card (fp32), and the tool's extractor with
      the CLI's model (drawn on the card) under the bf16 policy and a copy
      of it on the CPU in fp32 (plain versions), each card crop's feature
      at cosine >= 0.99
      against the CPU's. Every kernel the legs run (B1-B4, B7, B8, B10-B12)
      must have launched; their counts go into the kernels line
      (`launches_by_path["cli_legs"]`). The legs skip the soak's steps
      5-6 here (export, the artifact against the live service): phase 18
      covers artifacts, and the soak run alone runs them.
  16. the serving front: a ViT-B-16 service (bf16, phase 3's seeded
      weights and gallery) at capacity 1,024: each bucket's graph replay
      against the serve program's body run eagerly on the same inputs
      (equal rows, scores within 1e-6: cuBLAS may take another algorithm
      under capture, the port's kernels give the same bits; whether the
      bits are equal is printed); one replay of each bucket under the
      profiler, in a process of its own (`--replay-trace`), whose port
      kernels must be the graph's kernel nodes, one event each;
      `add_items` of 16 items, then answers
      equal to a service rebuilt over the 528 items (rows equal, scores
      within 1e-4: the grown gallery's products run at other shapes);
      `quantize_refs` with `approx_recall` 0.95 on the same gallery
      (startup `calibrate_approx`), its answers against a plain
      re-computation (the int8 rows dequantized in numpy, the towers,
      the fp32 product); the approximate tier's fold where it folds, a
      200,000-row clustered synthetic gallery (`calibrate_approx`'s
      recall, and the serve program by features against the plain towers,
      product and a numpy fold; the top-50 selection of its [b, 200,000]
      scores at b = 1 and 32, exact against the fold, eager and as a
      graph replay); 64 concurrent b=1 HTTP clients through
      the micro-batcher (answers equal to `service.query`, fewer batches
      than requests); the native front over the same service (answers
      equal); and `fashionern-torch serve` in a subprocess over a
      learnable FashionIQ fixture (soak leg B's sizes): /healthz, /query
      (single and batch), /add, /stats, then interrupted. Launch counts:
      the phase's own (`launches_by_path["serving_front"]`) and the
      serve process's (`["cli_serve"]`).
  17. the RN50x4 tiers (run after phase 14, before phase 15): RN50x4 at
      full width through `Trainer.train()`, 3 bf16 steps at B = 1024 (the
      frozen ResNet and its BatchNorm statistics in bf16), 2 with int8
      towers (B5 and B6 on the W = 640 text tower, the hidden in 2
      groups of 1,280), and TME: queries through the serve program (the
      serve slice of phase 10 with tme=True, card against the CPU's fp32
      run) and 2 train steps with B9's backward at head dim 80 in
      `MHAFunction`; B9's backward at d = 640 against the plain
      version's autograd. Launch counts `rn50x4_train`,
      `rn50x4_int8_train`, `rn50x4_tme` (serve and train). B4 at d = 640,
      B5 / B6 at W = 640 and B9 at head dim 80 are held against their
      plain versions in phases 7, 5 and 2.
  18. serve artifacts (after phase 17): phase 3's ViT-B-16 service (bf16
      serve policy, the 512-item gallery) and phase 6's int8 one exported
      (`retrieval/artifact.py`: `torch.export` of the serve program over
      the kernels as registered ops, the consts apart), then loaded in a
      fresh process that imports no module of `models/` or `data/`: each
      bucket one CUDA graph whose kernel nodes its capture checked
      against its recorded launches; queries of 1, 5, 20 and 32 rows
      against the live serve programs (equal top-k rows, scores within
      1e-5, bit for bit or not) and query P50 at b = 1 and 32 beside
      the live programs', 200 samples each; then `serve-artifact` over
      the bf16 artifact, `refresh_consts` from a service whose ERN has
      new seeded weights, `POST /reload`, and the daemon's answers must
      become the new service's. Launch counts of the loading process
      (`launches_by_path["artifact"]`).
  19. data parallel (`parallel/mesh.py`, last): (a) an NCCL process group
      of world size 1 in this process (the card's machine holds one GPU,
      and NCCL refuses two ranks on one): one full-width ViT-B-16 train
      step at B = 1,024 (bf16 towers) with negatives="global" (B4 over
      the all-gathered targets, one flat all-reduce) against the
      unsharded step on the same weights, batch and dropout masks (loss
      rtol 1e-5, ERN gradient cosine >= 0.99999, launch counts of one
      train step); `sharded_search` against `blocked_top_k_similarity`
      on a 512-item gallery (rows equal); the gallery-sharded serve
      program (bf16 serve policy, buckets 1, 8, 32, each one CUDA graph
      with its NCCL collectives inside) at b = 1 and 32 against the
      single-device program (rows equal, scores within 1e-6, the same
      launches), with each bucket's graph's kernel nodes (NCCL's
      counted apart); the group destroyed. (b) a 2-rank gang on the one
      card, two spawned processes over gloo (which takes CUDA tensors
      there): one full-width step, B = 256 a rank, global negatives,
      every dropout unit kept, against this process's step on the whole
      512-row batch as one process standing for two shards
      (`parallel/multiprocess.py one_process_step`: the same shards;
      loss rtol 1e-4, ERN gradient cosine >= 0.99999).
      Each rank times its second step; (a) times both steps after a
      warm-up step.
      Phase 7 holds B4's offset case (pred [512, 512] against tar
      [1,024, 512] at offset 512, the data-parallel loss's call) against
      its plain version.
  20. the comparison zoo (`models/zoo/`, last): B8's wide route
      (csrc/attention_wide.cu, the head dims the core does not take)
      against its plain version at CaLa's single heads (B = 128: 13
      tokens at head dim 512 and 640, 32 at 256) and at [3, 5, 16], fp32
      and bf16, timed beside SDPA on the same [B, 1, S, dh] operands, a
      call and in bursts (both carry the host's launch) and in device time
      (`torch.profiler` in a process of its own, `--wide-trace`: late in
      the long run the profiler drops kernel events; with the kernel's
      share of its bound); its own
      launch at `WIDE_EDGES` (Sq 1-33, Sk 1-256, head dims 1-1,024, two
      heads, more blocks than SMs) within TOL; its 16 instances in the
      library's SASS (fp32: HMMA.1688.F32.TF32 only, bf16: bf16 HMMA
      only, each on LDGSTS) with no local memory (no spill); then
      every model of the zoo's registry at ViT-B-16 width, drawn on the
      card by the JAX package's seeded init (`models/zoo jax_init_`, seed
      40 + its index; every state tensor equal to the draw, and each
      drawn variable's first and last `DRAW_SAMPLE` values drawn again
      on the CPU, 0 float32 ulps apart; the values drawn, the card's and
      the CPU's seconds), over the seeded
      ViT-B-16's fp32 features of 128 reference and target images and 128
      captions (image globals, tower tokens 1-13, text globals and 77 token
      features; seeded [128, 1,024] inputs for Clip4Cir and VTF at
      projection 2,048 and hidden 4,096; CompoDiff at dim 768, depth 4, 8
      heads of 64, text 77 x 1,280, mask 64 x 64, B = 32, guided at (1.5,
      7.5)), card against the port's CPU run on a host copy of the
      card's draw in fp32 at cosine >= 0.99999 a row, each head's card
      ms, launch counts
      (`launches_by_path["zoo"]`: CaLa's 8 attentions on B8's wide route,
      one B4); the registry's "bbc" on CaLa's card queries against the
      target globals, card against CPU at rel 1e-5; the registry's
      "text_relevance" with a bank that `TextRelevanceBank.create` made
      without `device=` (so on the card), two calls (CaLa's queries, then
      the target globals, against the text globals), card against CPU at
      rel 1e-5. Then the gradients of
      the kernels' autograd Functions (B1, B2, B3, B7, B8 on the core and
      on the wide route) at their PERF.md sites (B1-B3 ViT-B-16 B = 32,
      B7 the DVR BERT at d = 640, B8 the RN50x4 pool, the wide route at
      CaLa's [128, 13, 512]), in fp32 and bf16: the forward equal to the
      grad-free call bit for bit with the same launches, the backward
      launching nothing, every gradient against the plain version's
      autograd on the card at cosine >= 0.99999 (fp32) / 0.99 (bf16);
      forward + backward timed in the site's dtype beside the plain
      version's and a library composition's (SDPA, `F.linear`,
      `F.layer_norm`), with the bound of the work. Last, CaLa trains on
      the card: a `TwinAttentionCompositor` drawn on the card by the JAX
      package's seeded init at seed 60 + d (held as the heads' draw; the
      CPU's step on a host copy of it) at ViT-B-16 width
      (d = 512, the tower's 13 patch tokens of 128 reference and target
      images) and at RN50x4 width (d = 640, seeded tokens), the registry's
      bbc on its queries against the target globals, Adam at lr 4e-5:
      step 1 card against the CPU in fp32 (loss rtol 1e-5, every
      parameter gradient at cosine >= 0.99999), 8 wide-route launches a
      forward and none in a backward, 3 steps with the loss finite and
      falling (`launches_by_path["cala_train"]`), a step's ms, and (in
      the `--wide-trace` process, on seeded tokens, with nothing else
      running) one profiled step's device split (the wide route, B4,
      forward, backward, Adam) and idle share. The run ends with each
      phase's seconds.

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
import collections
import concurrent.futures
import contextlib
import copy
import functools
import json
import math
import os
import random
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from unittest import mock

import numpy as np
import torch

import torch.nn.functional as F
from torch.profiler import record_function

from fashionern_aaai2024_tpu_torch.benchmarks import accuracy_soak as Soak
from fashionern_aaai2024_tpu_torch.benchmarks import attn_experiment as XD
from fashionern_aaai2024_tpu_torch.cli import main as Cli
from fashionern_aaai2024_tpu_torch.data.captions import join_fiq_captions
from fashionern_aaai2024_tpu_torch.models.clip.config import get_clip_config
from fashionern_aaai2024_tpu_torch.models.clip.resnet import FrozenBatchNorm2d
from fashionern_aaai2024_tpu_torch.data import transforms
from fashionern_aaai2024_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD
from fashionern_aaai2024_tpu_torch.models.clip.tokenizer import (
    SimpleTokenizer,
    learn_merges,
    write_bpe_table,
)
from fashionern_aaai2024_tpu_torch.native import image as native_image
from fashionern_aaai2024_tpu_torch.models import convert as Conv
from fashionern_aaai2024_tpu_torch.models import init as Init
from fashionern_aaai2024_tpu_torch.models import zoo as TZ
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
from fashionern_aaai2024_tpu_torch.ops import graphs as GR
from fashionern_aaai2024_tpu_torch.ops import layernorm as LN
from fashionern_aaai2024_tpu_torch.ops import losses as L
from fashionern_aaai2024_tpu_torch.ops import mlp as M
from fashionern_aaai2024_tpu_torch.ops import qmlp as Q
from fashionern_aaai2024_tpu_torch.ops import similarity as S
from fashionern_aaai2024_tpu_torch.ops.extra_losses import (
    LOGIT_SCALE_INIT,
    TextRelevanceBank,
    get_loss,
)
from fashionern_aaai2024_tpu_torch.ops.qmatmul import int8_product, quantize_rowwise
from fashionern_aaai2024_tpu_torch.parallel import mesh as PM
from fashionern_aaai2024_tpu_torch.parallel import multiprocess as MP
from fashionern_aaai2024_tpu_torch.retrieval import artifact as ART
from fashionern_aaai2024_tpu_torch.retrieval import evaluate as E
from fashionern_aaai2024_tpu_torch.retrieval.engine import (
    RetrievalIndex,
    embed_gallery,
    sharded_search,
)
from fashionern_aaai2024_tpu_torch.retrieval.evaluate import InferenceAPI
from fashionern_aaai2024_tpu_torch.retrieval.server import RetrievalService, serve
from fashionern_aaai2024_tpu_torch.train.schedule import cosine_annealing_schedule
from fashionern_aaai2024_tpu_torch.train.state import cast_frozen_clip_bf16, create_train_state
from fashionern_aaai2024_tpu_torch.train.step import build_train_step
from fashionern_aaai2024_tpu_torch.tools import extract_patches as Extract
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
# host-clock samples of each query route at b = 1 and 32 (phase 4): 1,000
# until phase 20 came in (the routes took ~21 s), 500 until phase 20's
# profiled readings moved to a process of their own (~5 s more saved)
ROUTE_SAMPLES = 250
# timed calls of a plain version (after 3 warm-ups): a plain version
# repeats its kernel's arithmetic and is no yardstick of speed; 25 until
# phase 20 came in (a round of every row's plain version took 556 ms)
PLAIN_RUNS = 5
# phase 16: the live-add service's rows, the items it adds, the HTTP
# clients, the synthetic gallery the approximate tier folds
FRONT_CAPACITY, FRONT_ADDS, HTTP_CLIENTS, FOLD_GALLERY = 1024, 16, 64, 200_000
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
B8W = "packed_kv_cross_attention wide (B8)"
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
    # B8 at the head dims the core does not take (CaLa's single heads)
    B8W: (A.wide_cross_attention, "fashionern_aaai2024_tpu_torch/csrc/attention_wide.cu",
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
# the int8 tier: quant.cu (on layernorm_row.cuh's vector rows) and
# qgemm.cu (int8 wgmma on tma.cuh's ring, gemm_wgmma.cuh's descriptors)
INT8 = ["quant.cu", "layernorm_row.cuh", "qgemm.cu", "gemm_wgmma.cuh", "tma.cuh"]
SOURCES = {B1: [*LN_SRC, *GEMM, *CORE], B2: [*LN_SRC, *GEMM],
           B3: CORE, B4: ["bbc_loss.cu", *TF32], B5: INT8,
           B6: [*INT8, *CORE], B7: [*GEMM, *CORE],
           B8: CORE, B8W: ["attention_wide.cu", "attention_tf32.cuh", "attention_mma.cuh",
                           "common.cuh"], B11: LN_SRC,
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
# the C entry points one call of B5 / B6 launches, in order: B5's c_proj
# takes every hidden group in one launch
INT8_SEQUENCE = {B5: ["fern_ln_quant", "fern_qgemm", "fern_quant_groups", "fern_qgemm"],
                 B6: ["fern_ln_quant", "fern_qgemm", "fern_attention", "fern_quant_groups",
                      "fern_qgemm"]}
# the int8 GEMM's tile edges (csrc/qgemm.cu: s8 warpgroup MMA on TMA-fed
# 128 x 64 / 128 tiles, 128-deep K tiles): the text tower's 77 rows
# at b = 1, one row, one short of and one past a 128-row tile; columns
# inside and past each width and ViT's 768; K of one k32 step, one k32
# step past a K tile and 768; epilogues (bias, residual, activation, fp32
# output) as B5 and B6 use them
INT8_EDGE_M = (1, 77, 127, 129)
INT8_EDGE_N = (8, 200, 264, 768)
INT8_EDGE_K = (16, 144, 768)
INT8_EPILOGUES = ((True, False, None, False), (True, True, None, False),
                  (True, False, "quick_gelu", True), (False, False, None, True))
# each int8 product of B5 and B6 (name, M, K, N, groups, residual,
# activation): ViT-B-16 at the gallery batch (32 x 197) and the embed
# batch (128 x 197), the text tower at b = 1 and 32
INT8_PRODUCTS = [(f"{tower}_{name}_m{m}", m, k, n, groups, res, act)
                 for tower, w, rows in (("vit", 768, (32 * 197, 128 * 197)),
                                        ("text", 512, (77, 32 * 77)))
                 for m in rows
                 for name, k, n, groups, res, act in (
                     ("qkv", w, 3 * w, 1, False, None), ("out_proj", w, w, 1, True, None),
                     ("c_fc", w, 4 * w, 1, False, "quick_gelu"),
                     ("c_proj", 4 * w, w, Q.hidden_groups(4 * w, "quick_gelu"), True, None))]
INT8_SHAPES = [(torch.bfloat16, s) for s in SHAPES] + [(torch.float32, s) for s in SHAPES]
INT8_SHAPES += [(torch.bfloat16, s) for s in TRAIN_SHAPES]
# RN50x4's text tower (W = 640: B5's hidden in 2 groups of 1,280; the
# int8 GEMM at K = 640, N = 1,920 and 2,560), serve and train shapes
INT8_SHAPES += [(torch.bfloat16, s) for s in RN_SHAPES + RN_TRAIN_SHAPES]
# int8 tensor-core peak of the H100 SXM (dense), NVIDIA data sheet
PEAK_INT8_OPS = 1979e12
# the card's int8 bf16 embeddings against the port's plain int8 fp32 run
# on the CPU (predicted before the first run: min above 0.97; measured
# min 0.99960 over five runs, so held at 0.999)
INT8_COSINE_MIN = 0.999
INT8_TRAIN_STEPS = 2
# phase 8's seeded init: the seed (also its Trainers'), and the largest
# variable of the sample drawn again on the CPU
INIT_SEED = 0
INIT_SAMPLE_MAX = 2_500_000
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
# the data-parallel loss's call: a rank's 512 rows against 1,024 gathered targets
BBC_OFFSET_CASE = dict(b=512, n=1024, d=512, offset=512)
DP_GANG_RANKS, DP_GANG_BATCH = 2, 256     # phase 19 (b): rows a rank
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
# embeds (~35 GFLOP an image against ~6 a query) take most of its time;
# 64 queries took 130.77 s of a 1,079.4 s run, 32 took 67.6 s of a 940.4 s
# run once phase 19 came in (H100, PERF.md): 8 since
CPU_QUERIES = 8
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
                       plain_ms=median_ms(lambda: plain[name](*args, *pos, **kw), PLAIN_RUNS),
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
                   ms=median_ms(calls["kernel"]), plain_ms=median_ms(calls["plain"], PLAIN_RUNS),
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


def cross_work(name: str, shp: dict, dtype: torch.dtype) -> tuple[float, float]:
    """(flops, bytes) of one B7 or B8 call: every input read once and the
    output written once; B7 the projection's 6·m·w² and the attention's
    4·b·s²·w FLOPs, B8 4·b·sq·sk·w."""
    e = torch.finfo(dtype).bits // 8
    w = shp["w"]
    if name == B7:
        b, s = shp["b"], shp["s"]
        return 6 * b * s * w * w + 4 * b * s * s * w, e * (2 * b * s * w + 3 * w * w + 3 * w)
    b, sq, sk = shp["b"], shp["sq"], shp["sk"]
    return 4 * b * sq * sk * w, e * (2 * b * sq * w + 2 * b * sk * w)


def new_kernel_work(name: str, shp: dict, dtype: torch.dtype) -> dict:
    """Bound of one B7 / B8 / B11 call (`cross_work` for B7 and B8) at the
    dtype's peak (fp32: `tf32_bound`, the 67 TFLOP/s bound beside it);
    B11: its ~8 fp32 operations an element, on the CUDA cores (67
    TFLOP/s), every input read once and the output written once."""
    if name in (B7, B8):
        return dtype_bound(*cross_work(name, shp, dtype), dtype)
    e = torch.finfo(dtype).bits // 8
    w = shp["w"]
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
                       max_abs_err=err, ms=median_ms(kernel), plain_ms=median_ms(plain, PLAIN_RUNS),
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
                       max_abs_err=err, ms=median_ms(kernel), plain_ms=median_ms(plain, PLAIN_RUNS),
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
                   ms=median_ms(kernel), plain_ms=median_ms(plain, PLAIN_RUNS),
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
                plain_ms, library_ms = median_ms(plain, PLAIN_RUNS), median_ms(library)
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

    # the serve program's calls: one eager warm-up call a bucket before its
    # capture, then one replay a query call
    buckets = list(service._serve_fn.buckets)
    want = serve_launches(cfg, [BATCH] * (GALLERY // BATCH), buckets + [1] * len(refs) + [32])
    log(f"  main path {run_s:.2f} s; launches {launches} (expected {want}: "
        f"{GALLERY // BATCH} gallery batches, warm-up calls at buckets {buckets}, "
        f"{len(refs) + 1} query calls as graph replays)")
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


def multi_dispatch_query(service: RetrievalService, refs: list, caps: list, k: int = K):
    """The multi-dispatch route of a query (the service's large-k path):
    tokenize, text tower, DVR query tower, `RetrievalIndex.search`."""
    with service._lock:
        ids = service.api.tokenize(caps)
        return service.multi_dispatch(ids, np.asarray([service.rows[r] for r in refs]), k)


def route_latencies(service: RetrievalService, samples: int = ROUTE_SAMPLES) -> dict:
    """Host-clock latency of a query by each route, in turns (serve
    program, multi-dispatch, multi-dispatch, serve program, ...), each
    sample ending in its host copy of the results: P50 and P99 in ms at
    b = 1 and 32. Both routes must give the same rows."""
    names = service.gallery.names
    routes = {"serve_program": lambda r, c: service.query(r, c, k=K)[0],
              "multi_dispatch": lambda r, c: multi_dispatch_query(service, r, c)}
    out = {}
    for qb in (1, 32):
        caps = [CAPTIONS[j % 8] for j in range(qb)]
        first = {name: fn(names[:qb], caps) for name, fn in routes.items()}
        rows = [[service.rows[x["name"]] for x in res] for res in first["serve_program"]]
        if rows != first["multi_dispatch"][1].tolist():
            raise AssertionError(f"b={qb}: the serve program and the multi-dispatch route "
                                 "rank differently")
        times = {name: [] for name in routes}
        for i in range(samples):
            refs = [names[(i + j) % GALLERY] for j in range(qb)]
            order = list(routes) if i % 2 == 0 else list(routes)[::-1]
            for name in order:
                t = time.perf_counter()
                routes[name](refs, caps)
                times[name].append((time.perf_counter() - t) * 1e3)
        for name, ts in times.items():
            ts.sort()
            out[f"{name}_b{qb}"] = dict(p50_ms=statistics.median(ts),
                                        p99_ms=ts[min(len(ts) - 1, int(0.99 * len(ts)))],
                                        samples=len(ts))
    return out


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


def train_launches(steps: int, int8: bool = False, tme: bool = False,
                   resnet: bool = False) -> dict:
    """Expected launches of `steps` train steps: 3 frozen tower passes a
    step (B1-B3, or B5-B6, in each block), B11 at the ViT's ln_pre and
    ln_post (2 image passes), the text tower's ln_final, TME's LN on a TME
    model and the train-mode BERT's LNs; B9 at TME's cross-attention; B4
    once. The train-mode BERT and MR attention are `mha_ref` with
    probability dropout, as in JAX: no B7, no B8, no B9; the train-mode
    combiners drop out too: no B12. With the ResNet image tower (RN50x4)
    only the text pass runs blocks, and each image pass ends in its
    attention pool (B8) with no LN."""
    passes = 1 if resnet else 3
    want = dict.fromkeys(INT8_KERNELS if int8 else TOWER_KERNELS, steps * passes * LAYERS)
    want[B4] = steps
    want[B11] = steps * ((0 if resnet else 2 * 2) + 1 + int(tme) + BERT_LNS)
    want[B9] = steps * int(tme)
    if resnet:
        want[B8] = steps * 2
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
                   plain_ms=median_ms(lambda: L.bbc_rowloss_plain(pred, tar), PLAIN_RUNS),
                   library_ms=median_ms(library), burst_ms=burst_ms(kernel),
                   library_burst_ms=burst_ms(library), **tf32_bound(*L.bbc_flops_bytes(b, d)))
        rows.append(row)
        log(f"  {B4} B={b:5d} d={d:4d} err {row['max_abs_err']:.3e}  kernel "
            f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  library "
            f"{row['library_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
            + row_extras(row))
    c = BBC_OFFSET_CASE
    pred, tar = unit_rows(c["n"], c["d"], seed=7)
    pred = pred[c["offset"]:c["offset"] + c["b"]].contiguous()
    got = L.bbc_rowloss(pred, tar, offset=c["offset"])
    want = L.bbc_rowloss_plain(pred, tar, offset=c["offset"])
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **BBC_TOL)
    labels = c["offset"] + torch.arange(c["b"], device="cuda")
    kernel = lambda: L.bbc_rowloss(pred, tar, offset=c["offset"])  # noqa: E731
    library = lambda: F.cross_entropy(100.0 * pred @ tar.t(), labels,  # noqa: E731
                                      reduction="none")
    row = dict(shape=[c["b"], c["d"]], n=c["n"], offset=c["offset"],
               max_abs_err=(got - want).abs().max().item(), ms=median_ms(kernel),
               plain_ms=median_ms(lambda: L.bbc_rowloss_plain(pred, tar, offset=c["offset"]),
                                  PLAIN_RUNS),
               library_ms=median_ms(library), burst_ms=burst_ms(kernel),
               library_burst_ms=burst_ms(library),
               **tf32_bound(*L.bbc_flops_bytes(c["b"], c["d"], c["n"])))
    rows.append(row)
    log(f"  {B4} B={c['b']} N={c['n']} d={c['d']} offset={c['offset']} err "
        f"{row['max_abs_err']:.3e}  kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
        f"library {row['library_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']})" + row_extras(row))
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


def phase_train(card: str, tme: bool = False, model_name: str = "ViT-B-16",
                steps: int | None = None) -> dict:
    """The train slice (phase 9: 6 steps and a validation), its TME variant
    (phase 11: 3 steps, no validation), or RN50x4's (phase 17: `steps`
    steps, no validation and no fp32 check against the CPU, which
    `tests/test_torch_rn50x4_train.py` holds against JAX)."""
    cfg = get_clip_config(model_name, activation="quick_gelu", tme=tme)
    vit = cfg.vision.kind == "vit"
    steps = steps or (TME_TRAIN_STEPS if tme else TRAIN_STEPS)
    g = np.random.default_rng(2)
    side = cfg.vision.image_size
    images = g.integers(0, 256, (UNIVERSE, side, side, 3), dtype=np.uint8)
    patches = g.standard_normal((UNIVERSE, 13, cfg.feature_dim), dtype=np.float32)
    dataset = SyntheticFashionIQ(images, patches, TRAIN_BATCH * steps, seed=4)
    fp32 = check_fp32_step(cfg, dataset, card) if vit else None
    validate = vit and not tme

    model = random_init_(ComposedCIRModel(cfg), torch.Generator().manual_seed(0))
    val_launches: list = []
    common.BUILD_ROOT.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=common.BUILD_ROOT.parent) as ckpt_dir:
        tcfg = TrainConfig(dataset="fashioniq", clip_model_name=model_name,
                           activation="quick_gelu", batch_size=TRAIN_BATCH, lr=TRAIN_LR,
                           num_epochs=1, validation_frequency=1, print_frequency=1,
                           max_steps_per_epoch=steps, num_workers=0, precision="bf16",
                           image_dtype="uint8", eval_batch_size=128, ckpt_dir=ckpt_dir,
                           seed=0, tme=tme)
        trainer = Trainer(tcfg, device="cuda", model=model, train_dataset=dataset,
                          validator=make_validator(images, patches, val_launches)
                          if validate else None,
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
        if len(val_launches) != int(validate):
            raise AssertionError(f"{len(val_launches)} validations")
        launches = dict(total)
        if val_launches:
            launches = {name: total[name] - val_launches[0][name] for name in total}
            check_launches("validation", val_launches[0],
                           serve_launches(cfg, [128] * (VAL_GALLERY // 128),
                                          [128] * (VAL_QUERIES // 128)))
        check_launches(f"{model_name} {'TME ' if tme else ''}train path", launches,
                       train_launches(steps, tme=tme, resnet=not vit))
        if not vit:
            bns = [m for m in model.clip.visual.modules() if isinstance(m, FrozenBatchNorm2d)]
            if not bns or any(m.running_mean.dtype != torch.bfloat16 for m in bns):
                raise AssertionError("the bf16 train policy left ResNet BatchNorm statistics "
                                     "in fp32")
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
        log(f"  {model_name}, {steps} steps at B={TRAIN_BATCH}{' with TME' if tme else ''}: losses "
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


def int8_launch_sequence(wrapper, *args, **kwargs) -> tuple[torch.Tensor, list[str]]:
    """One call of `wrapper` and the C entry points it launched, in order."""
    seen, launch = [], common.launch

    def spy(entry, *entry_args):
        seen.append(entry)
        return launch(entry, *entry_args)

    with mock.patch.object(common, "launch", spy):
        out = wrapper(*args, **kwargs)
    return out, seen


def int8_gemm_operands(g: torch.Generator, m: int, k: int, n: int, groups: int,
                       dtype: torch.dtype) -> tuple:
    """int8 operands in [-127, 127], row scales near an absmax of 4 / 127
    per group, column scales near 0.05 / 127, a bias and a residual."""
    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8).cuda()

    return (codes(m, k), (0.03 + 0.01 * torch.rand((m, groups), generator=g)).cuda(),
            codes(n, k), (4e-4 + 1e-4 * torch.rand(n, generator=g)).cuda(),
            (0.5 * torch.randn(n, generator=g)).to(dtype).cuda(),
            torch.randn((m, n), generator=g).to(dtype).cuda())


def int8_gemm_reference(a, a_scale, w, w_scale, bias, res, activation, out_dtype,
                        groups=1) -> torch.Tensor:
    """The int8 GEMM's function on the exact product (`int8_product`):
    each group's sums times its row scale, times the column scale, added in
    group order; then bias, activation, the cast and the residual."""
    c, acc = a.shape[1] // groups, None
    for i in range(groups):
        lo = c * i
        o = int8_product(a[:, lo:lo + c], w[:, lo:lo + c]) * a_scale[:, i:i + 1] * w_scale
        acc = o if acc is None else acc + o
    if bias is not None:
        acc = acc + bias.float()
    if activation is not None:
        acc = M.act_f32(acc, activation)
    return acc.to(out_dtype) if res is None else res + acc.to(res.dtype)


def phase_int8_gemm_edges() -> float:
    """The int8 GEMM (`launch_qgemm` at the rule's width and the other
    width) against `int8_gemm_reference` at every INT8_EDGE_M x
    INT8_EDGE_N x INT8_EDGE_K in bf16 and fp32 (untimed): bit for bit
    with the identity activation, at the fp32 tolerance with quick_gelu;
    B5's c_proj over both hidden groups in one launch, bit for bit; a
    misaligned operand view that must raise. Returns the largest
    error."""
    g, worst, n, exact = torch.Generator().manual_seed(704), 0.0, 0, 0

    def check(got, want, bitwise, what):
        nonlocal worst, n, exact
        torch.cuda.synchronize()
        if bitwise and not torch.equal(got, want):
            raise AssertionError(f"int8 gemm {what}: not bit for bit its plain version (max "
                                 f"error {(got.float() - want.float()).abs().max().item()})")
        if not bitwise:
            torch.testing.assert_close(got, want, **TOL[torch.float32])
        worst = max(worst, (got.float() - want.float()).abs().max().item())
        n, exact = n + 1, exact + bitwise

    for dtype in (torch.bfloat16, torch.float32):
        for i, m in enumerate(INT8_EDGE_M):
            for nn in INT8_EDGE_N:
                for j, k in enumerate(INT8_EDGE_K):
                    with_bias, with_res, act, out_f32 = INT8_EPILOGUES[(i + j) % len(
                        INT8_EPILOGUES)]
                    a, a_s, w, w_s, bias, res = int8_gemm_operands(g, m, k, nn, 1, dtype)
                    bias, res = bias if with_bias else None, res if with_res else None
                    out_dtype = torch.float32 if out_f32 else dtype
                    want = int8_gemm_reference(a, a_s, w, w_s, bias, res, act, out_dtype)
                    rule = common.int8_tile(m, nn, common.sm_count(0))
                    for tile in (0, 64 if rule == 128 else 128):
                        check(common.launch_qgemm(a, a_s, w, w_s, bias=bias, residual=res,
                                                  activation=act, out_dtype=out_dtype,
                                                  tile=tile),
                              want, act is None, f"M={m} N={nn} K={k} tile {tile} {dtype}")
        for m in (77, 129, 6304):
            for f in (3072, 2048):
                a, a_s, w, w_s, bias, res = int8_gemm_operands(g, m, f, 768, 2, dtype)
                want = int8_gemm_reference(a, a_s, w, w_s, bias, res, None, dtype, groups=2)
                check(common.launch_qgemm(a, a_s, w, w_s, groups=2, bias=bias, residual=res,
                                          out_dtype=dtype),
                      want, True, f"two groups M={m} F={f} {dtype}")
    flat = torch.zeros(77 * 512 + 16, dtype=torch.int8, device="cuda")
    try:
        common.launch_qgemm(flat[1:77 * 512 + 1].view(77, 512), a_s[:77, :1],
                            w[:, :512].contiguous(), w_s, out_dtype=torch.float32)
    except ValueError as err:
        refused = str(err)
    else:
        raise AssertionError("int8 gemm: a misaligned operand view was launched")
    log(f"  int8 GEMM edges: {n} cases (M in {INT8_EDGE_M}, N in {INT8_EDGE_N}, K in "
        f"{INT8_EDGE_K}, the rule's width and the other, bf16 and fp32; two groups in one "
        f"launch at F = 3072 and 2048), {exact} of them bit "
        f"for bit, max error {worst:.3e}; a misaligned view raises: {refused}")
    return worst


def phase_int8_products(card: str) -> list[dict]:
    """Each int8 product of B5 and B6 at INT8_PRODUCTS through
    `launch_qgemm` (its own epilogue: bias, residual, quick_gelu with an
    fp32 output, c_proj over its hidden groups) at the rule's width,
    beside `torch._int_mm` (int8 x int8 -> int32 on the same operands: the
    yardstick, never called by the port), in bursts, with TOPS: one line
    a product. `ab_attention.py --int8` times a checkout's products for
    an A/B."""
    g, rows = torch.Generator().manual_seed(705), []
    for name, m, k, n, groups, with_res, act in INT8_PRODUCTS:
        a, a_s, w, w_s, bias, res = int8_gemm_operands(g, m, k, n, groups, torch.bfloat16)
        res = res if with_res else None
        out_dtype = torch.float32 if act else torch.bfloat16

        def run():
            return common.launch_qgemm(a, a_s, w, w_s, groups=groups, bias=bias, residual=res,
                                       activation=act, out_dtype=out_dtype)

        wt = w.t()
        ops = 2.0 * m * n * k
        row = dict(product=name, m=m, k=k, n=n, groups=groups,
                   tile=64 if groups > 1 else common.int8_tile(m, n, common.sm_count(0)),
                   ms=burst_ms(run), int_mm_ms=burst_ms(lambda: torch._int_mm(a, wt)))
        row.update(tops=ops / row["ms"] / 1e9, int_mm_tops=ops / row["int_mm_ms"] / 1e9)
        rows.append(row)
        log(f"  int8 gemm {name:20s} M={m} K={k} N={n} groups={groups}: {row['ms']:.4f} ms "
            f"({row['tops']:.1f} TOPS; tile {row['tile']}); torch._int_mm "
            f"{row['int_mm_ms']:.4f} ms ({row['int_mm_tops']:.1f} TOPS) ({card})")
        del a, w, res
    return rows


def phase_int8_quantize(card: str) -> list[dict]:
    """The quantize passes of B5 and B6 at ViT-B-16 B = 32 and 128 (bf16
    towers), in bursts, beside their bytes bound (each input read once,
    the codes and scales written once): LN + quantize of x [M, 768] bf16,
    B5's hidden [M, 3072] fp32 in its two groups, B6's attention output
    [M, 768] fp32 in one."""
    g, rows = torch.Generator().manual_seed(706), []
    for m in (32 * 197, 128 * 197):
        x = torch.randn((m, 768), generator=g).to(torch.bfloat16).cuda()
        gamma, beta = (torch.randn(768, generator=g).to(torch.bfloat16).cuda()
                       for _ in range(2))
        hidden = torch.randn((m, 3072), generator=g).cuda()
        attn = torch.randn((m, 768), generator=g).cuda()
        for name, fn, nbytes in (
                ("ln_quant_w768", lambda: common.launch_ln_quant(x, gamma, beta, 1e-5),
                 m * 768 * 3 + 4 * m + 4 * 768),
                ("quant_groups_f3072_g2", lambda: common.launch_quant_groups(hidden, 2),
                 m * 3072 * 5 + 8 * m),
                ("quant_groups_w768_g1", lambda: common.launch_quant_groups(attn, 1),
                 m * 768 * 5 + 4 * m)):
            row = dict(name=f"{name}_m{m}", ms=burst_ms(fn), bound_ms=1e3 * nbytes / PEAK_BYTES)
            rows.append(row)
            log(f"  quantize {row['name']:28s} {row['ms']:.4f} ms (bytes bound "
                f"{row['bound_ms']:.4f} ms) ({card})")
        del x, hidden, attn
    return rows


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
            got, sequence = int8_launch_sequence(wrapper, *args, *pos, **kw)
            if sequence != INT8_SEQUENCE[name]:
                raise AssertionError(f"{name} {label}: launched {sequence}, expected "
                                     f"{INT8_SEQUENCE[name]}")
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
                       plain_ms=median_ms(lambda: plain[name](*args, *pos, **kw), PLAIN_RUNS),
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


def init_sample(table: list) -> list:
    """The variables whose CPU draw phase 8 holds the card's to: for each
    initializer of `table`, its largest variable of at most
    INIT_SAMPLE_MAX values."""
    by_kind: dict = {}
    for v in table:
        kind = json.dumps(v.init, sort_keys=True)
        if math.prod(v.shape) <= INIT_SAMPLE_MAX and (
                kind not in by_kind or math.prod(v.shape) > math.prod(by_kind[kind].shape)):
            by_kind[kind] = v
    return list(by_kind.values())


def tree_leaf(tree: dict, v) -> torch.Tensor:
    node = tree[v.collection]
    for name in v.path:
        node = node[name]
    return node


def phase_seeded_init(card: str) -> tuple[dict, dict]:
    """The package's seeded init (the JAX package's `ComposedCIRModel.init`,
    `models/composed.py jax_init_`) of ViT-B-16 with TME at INIT_SEED,
    drawn on the card and timed; a sample of its variables (every
    initializer) drawn again on the CPU, held to the card's draw within 4
    float32 ulps. Returns the phase's numbers and the card's tree, which
    phase 8's Trainer (without TME, seed INIT_SEED) must hold."""
    cfg = get_clip_config("ViT-B-16", activation="quick_gelu", tme=True)
    with torch.device("meta"):
        table = ComposedCIRModel(cfg).flax_variables()
    values = sum(math.prod(v.shape) for v in table)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree = Init.variables(table, INIT_SEED, "cuda")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    rows, cpu_s = [], 0.0
    for v in init_sample(table):
        t0 = time.perf_counter()
        want = Init.initialize(v.init, Init.variable_key(INIT_SEED, v), v.shape, "cpu").numpy()
        cpu_s += time.perf_counter() - t0
        got = tree_leaf(tree, v).cpu().numpy()
        ulps = np.where(got == want, 0.0, np.abs(got.astype(np.float64) - want)
                        / np.spacing(np.abs(want)))
        rows.append(dict(path=f"{v.collection}/{'/'.join(v.path)}", init=v.init,
                         values=int(want.size), max_ulps=float(ulps.max()),
                         equal=float(np.mean(got == want))))
        if not ulps.max() <= 4:
            raise AssertionError(f"seeded init: {rows[-1]['path']} drawn on the card is "
                                 f"{ulps.max():.1f} ulps from the CPU's draw (> 4)")
    sample = sum(r["values"] for r in rows)
    log(f"  seeded init of ViT-B-16 + TME (the JAX package's, seed {INIT_SEED}): {values:,} "
        f"values in {len(table)} variables drawn on the card in {draw_s:.3f} s ({card}); "
        f"{len(rows)} variables ({sample:,} values, every initializer) drawn again on the "
        f"CPU in {cpu_s:.2f} s: max {max(r['max_ulps'] for r in rows):.0f} ulps, "
        f"{np.mean([r['equal'] for r in rows]):.6f} of them equal")
    return dict(model="ViT-B-16+TME", seed=INIT_SEED, variables=len(table), values=values,
                draw_seconds=draw_s, sample=rows, sample_values=sample,
                cpu_sample_seconds=cpu_s), tree


def hold_trainer_init(model: ComposedCIRModel, tree: dict) -> int:
    """Every weight of a default Trainer's model (the card's draw, then its
    casts) equals the card's draw of the same variables, cast alike;
    returns the count of tensors held."""
    want = Conv.state_dict_from_variables(tree, model.clip_config)   # TME's entries unread
    got = model.state_dict()
    held = 0
    for k, t in got.items():
        if k.endswith("num_batches_tracked"):
            continue
        if not torch.equal(t, want[k].to(t.device, t.dtype)):
            raise AssertionError(f"the default Trainer's {k} is not the seeded init's")
        held += 1
    return held


def phase_int8_train(card: str, model_name: str = "ViT-B-16",
                     expect_init: dict | None = None) -> dict:
    """2 steps of Trainer.train() at B = 1024 with int8 frozen towers (the
    Trainer's own seeded init, held to `expect_init`'s draw where
    given)."""
    cfg = get_clip_config(model_name, activation="quick_gelu", quantize_mlp=True)
    g = np.random.default_rng(5)
    side = cfg.vision.image_size
    images = g.integers(0, 256, (UNIVERSE, side, side, 3), dtype=np.uint8)
    patches = g.standard_normal((UNIVERSE, 13, cfg.feature_dim), dtype=np.float32)
    dataset = SyntheticFashionIQ(images, patches, TRAIN_BATCH * INT8_TRAIN_STEPS, seed=6)
    common.BUILD_ROOT.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=common.BUILD_ROOT.parent) as ckpt_dir:
        tcfg = TrainConfig(dataset="fashioniq", clip_model_name=model_name,
                           activation="quick_gelu", batch_size=TRAIN_BATCH, lr=TRAIN_LR,
                           num_epochs=1, print_frequency=1,
                           max_steps_per_epoch=INT8_TRAIN_STEPS, num_workers=0,
                           precision="bf16", image_dtype="uint8", ckpt_dir=ckpt_dir,
                           seed=INIT_SEED, quantize_towers=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer = Trainer(tcfg, device="cuda", train_dataset=dataset,
                          plugin=DatasetPlugin("synthetic-fashioniq", lambda c: dataset,
                                               _fiq_captions),
                          tokenizer=tokenizer())
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if not trainer.model.clip_config.quantize_mlp:
            raise AssertionError("quantize_towers did not build int8 towers")
        held = hold_trainer_init(trainer.model, expect_init) if expect_init else 0
        log(f"  {model_name} Trainer built with its seeded init on the card in {build_s:.2f} s"
            + (f"; its {held} tensors equal the phase's draw (CLIP cast to bf16)"
               if held else ""))
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
    check_launches(f"{model_name} int8 train path", launches,
                   train_launches(INT8_TRAIN_STEPS, int8=True, resnet=cfg.vision.kind != "vit"))
    if len(losses) != INT8_TRAIN_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"int8 train losses {losses}")
    log(f"  {model_name}, {INT8_TRAIN_STEPS} steps at B={TRAIN_BATCH}, int8 towers: losses "
        f"{[round(x, 4) for x in losses]}; step times "
        f"{[round(1e3 * t, 2) for t in times]} ms (the second: "
        f"{TRAIN_BATCH / times[-1]:.1f} samples/s); launches {launches} ({card})")
    return dict(losses=losses, step_seconds=times, launches=launches,
                samples_per_s_step2=TRAIN_BATCH / times[-1], build_seconds=build_s,
                init_tensors_held=held)


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
    queries and its gallery cut to the images they name (references,
    targets, CIRR group members), in gallery order, in batches of BATCH.
    A query's prediction reads only its reference's gallery row, so it is
    the one the card makes on the whole loaders."""
    relative = [{k: v[:queries] for k, v in relative[0].items()}] + relative[1:queries // BATCH]
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
    runs, apis = {}, {}
    for dev, m, fiq_l, cirr_l in (("cuda", model, fiq, cirr),
                                  ("cpu", reference, cpu_fiq, cpu_cirr)):
        api = apis[dev] = InferenceAPI(m, tokenizer=tokenizer(), device=dev, batch_size=BATCH)
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
    pipeline = phase_gallery_pipeline(apis["cuda"], fiq[FIQ_TYPES[0]][0], card)
    return dict(card=runs["cuda"], cpu=runs["cpu"], launches=runs["cuda"]["launches"],
                prediction_cosine_min=cos.min().item(),
                prediction_cosine_median=cos.median().item(), gallery_pipeline=pipeline)


def phase_gallery_pipeline(api: InferenceAPI, classic: list, card: str) -> dict:
    """`embed_gallery` over one FashionIQ gallery (EVAL_GALLERY images in
    batches of BATCH) on the card, serial (prefetch 0) and three deep
    (prefetch 2), tokens kept: names equal; features, patches and tokens
    bit for bit (the same kernels on the same batches), the tokens on the
    host; the stage's counters (every batch's images and patches copied
    from page-locked memory while the placer's stream, not the compute
    stream, was current); and no second copy of an image batch to the
    card inside the encode (each `InferenceAPI._to_device` call of the
    encode takes a tensor already on the card). Each depth's seconds
    (host clock, ending in a synchronize) are printed with no limit."""
    real = api._to_device
    inputs = collections.Counter()

    def spy(a, dtype=None):
        inputs["card" if isinstance(a, torch.Tensor) and a.is_cuda else "host"] += 1
        return real(a, dtype)

    runs = {}
    for depth in (0, 2):
        fn = api.gallery_encode_fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mock.patch.object(api, "_to_device", spy):
            gallery = embed_gallery(fn, classic, api.batch_size, keep_tokens=True,
                                    prefetch=depth)
        torch.cuda.synchronize()
        runs[depth] = (gallery, time.perf_counter() - t0, fn.place)
    (serial, s0, p0), (deep, s2, p2) = runs[0], runs[2]
    if serial.names != deep.names or len(deep.names) != EVAL_GALLERY:
        raise AssertionError(f"gallery names differ between depths ({len(deep.names)} rows)")
    for key in ("features", "local_features", "token_features"):
        a, b = getattr(serial, key), getattr(deep, key)
        if not torch.equal(a, b):
            raise AssertionError(f"embed_gallery {key}: prefetch 2 differs from prefetch 0 by "
                                 f"{(a.float() - b.float()).abs().max().item():.3e}")
    if (deep.token_features.device.type != "cpu" or deep.features.device.type != "cuda"
            or deep.local_features.device.type != "cuda"):
        raise AssertionError("tokens must come to the host, features and patches stay on "
                             "the card")
    batches = len(classic)
    compute = torch.cuda.current_stream()
    for depth, place in ((0, p0), (2, p2)):
        if place.batches != batches or place.copies != 2 * batches or place.stream == compute:
            raise AssertionError(f"prefetch {depth}: the stage placed {place.batches} batches "
                                 f"with {place.copies} page-locked copies on its stream "
                                 f"(want {batches} and {2 * batches}, on a copy stream)")
    if inputs["host"] or inputs["card"] != 2 * batches:
        raise AssertionError(f"the encode copied {inputs['host']} host arrays to the card "
                             f"(and took {inputs['card']} placed ones)")
    log(f"  embed_gallery over {EVAL_GALLERY} images at B={BATCH}, tokens kept "
        f"{tuple(deep.token_features.shape)} {deep.token_features.dtype}: prefetch 0 "
        f"{s0:.3f} s, prefetch 2 {s2:.3f} s; equal bit for bit; {2 * batches} page-locked "
        f"copies on the copy stream a depth, none in the encode ({card})")
    return dict(seconds_prefetch0=s0, seconds_prefetch2=s2, batches=batches,
                copies=p2.copies, token_shape=list(deep.token_features.shape))


# --- phase 15: the dataset and CLI path ------------------------------------

# the legs' limits: the trained CLI eval equals the sidecar's best
# validation metric, which beats the untrained eval by this many points
LEG_MIN_GAIN = 20.0
# phase 15's legs run 11 of the soak's 15 epochs: the whole run passed
# 900 s of its 1,200 once phases 17 and 18 came in (then 12 epochs), and
# again with phase 19; both legs' validation curves peaked by epoch 11 in
# those runs (PERF.md, ROADMAP C3)
LEG_EPOCHS = 11
# the kernels a leg runs at the CLI's defaults (ViT-B-16, fp32): the
# towers' sub-blocks (B1-B3; B10 in the eval text towers), B4 in the train
# step, the DVR query tower's B7 and B8, B11 at the standalone LNs, B12 at
# the eval combiners
LEG_KERNELS = (B1, B2, B3, B4, B7, B8, B10, B11, B12)
EXTRACT_IMAGES = 2     # 8 until phase 19 came in (the CPU run of 8 took ~14.5 s), 4 until
                       # phase 20's profiled readings moved to a process of their own
ROUTE_LOADS = 64


def counting_cli(counts_path: str):
    """The `command` argument of `accuracy_soak.run_leg`: the port's CLI module
    run as `python -m` runs it (`runpy`, `__main__`), with each process's
    kernel launch counts appended to `counts_path` at its exit."""
    wrappers = {name: [fn.__module__, fn.__name__] for name, (fn, _, _) in KERNELS.items()}
    code = (
        "import atexit, importlib, json, runpy, sys\n"
        f"WRAPPERS = {json.dumps(wrappers)}\n"
        "def dump():\n"
        "    counts = {n: getattr(importlib.import_module(m), a).launches\n"
        "              for n, (m, a) in WRAPPERS.items()}\n"
        f"    with open({counts_path!r}, 'a') as f:\n"
        "        f.write(json.dumps(counts) + '\\n')\n"
        "atexit.register(dump)\n"
        f"runpy.run_module({Soak.CLI_MODULE!r}, run_name='__main__', alter_sys=True)\n")
    return lambda args: [sys.executable, "-c", code, *args]


def summed_counts(counts_path: str) -> dict[str, int]:
    total = dict.fromkeys(KERNELS, 0)
    with open(counts_path) as f:
        for line in f:
            for name, n in json.loads(line).items():
                total[name] += n
    return total


def route_ms(paths: list[str], dim: int) -> dict:
    """Host ms an item of `load_and_preprocess` (the uint8 feed) per file
    kind, with the route each took (median of ROUTE_LOADS loads)."""
    out = {}
    for kind, path in paths:
        before = dict(transforms.ROUTES)
        times = []
        for _ in range(ROUTE_LOADS):
            t = time.perf_counter()
            transforms.load_and_preprocess(path, dim, as_uint8=True)
            times.append((time.perf_counter() - t) * 1e3)
        route = next(r for r in transforms.ROUTES if transforms.ROUTES[r] != before.get(r, 0))
        out[kind] = {"route": route, "ms_per_item": statistics.median(times)}
    return out


def phase_extract(root: str, work: str, command) -> dict:
    """`extract-patches` on EXTRACT_IMAGES of a fixture's images: the CLI
    on the card (fp32), and the tool's `PatchExtractor` with the CLI's
    model on the card under the bf16 policy and on the CPU in fp32 (the
    plain versions); every crop's feature card against CPU at cosine
    >= 0.99."""
    images = os.path.join(work, "images")
    os.makedirs(images)
    for name in sorted(os.listdir(os.path.join(root, "images")))[:EXTRACT_IMAGES]:
        os.symlink(os.path.join(root, "images", name), os.path.join(images, name))
    out_dir = os.path.join(work, "cuda")
    feats, seconds = {}, {}
    _, seconds["cli_cuda"] = Soak.run_cli(
        ["extract-patches", "--data-root", work, "--clip-model-name", "ViT-B-16", "--out-dir",
         out_dir, "--batch-images", str(EXTRACT_IMAGES), "--device", "cuda"],
        "extract-patches --device cuda", command=command)
    feats["cli_cuda"] = np.load(os.path.join(out_dir, "pack.npy"))
    paths = [p for p, _ in Extract.enumerate_image_dir(work)]
    # the CLI's model (seed 42's init, drawn on the card), and a copy on the CPU
    seeded = Cli.load_model_variables(get_clip_config("ViT-B-16"), None, None, 13,
                                      device="cuda")
    for label, device, precision in (("cpu", "cpu", "fp32"), ("cuda_bf16", "cuda", "bf16")):
        model = copy.deepcopy(seeded).cpu() if device == "cpu" else seeded
        model = apply_precision(model, precision).eval()

        @torch.inference_mode()
        def encode(crops):
            return model.encode_image(torch.from_numpy(crops).to(device))[0].float().cpu()

        t = time.perf_counter()
        feats[label] = Extract.PatchExtractor(encode, 224, EXTRACT_IMAGES).extract_batch(paths)
        seconds[label] = time.perf_counter() - t
        del model
    del seeded
    want = torch.from_numpy(feats["cpu"]).reshape(-1, feats["cpu"].shape[-1])
    cos = {k: float(cosine(torch.from_numpy(feats[k]).reshape(want.shape), want).min())
           for k in ("cli_cuda", "cuda_bf16")}
    for k, c in cos.items():
        if not c >= 0.99:
            raise AssertionError(f"extract-patches: {k} crops against the CPU's fp32 run: "
                                 f"min cosine {c:.5f} < 0.99")
    return {"images": len(paths), "crops": int(want.shape[0]), "min_cosine": cos,
            "seconds": seconds}


def phase_cli(card: str) -> dict:
    """Phase 15, the dataset and CLI path, through the port's CLI in
    subprocesses (`benchmarks/accuracy_soak.py run_leg`): soak legs B
    (learnable FashionIQ) and C (learnable CIRR) at ViT-B-16, B = 16,
    LEG_EPOCHS epochs, the two legs' process chains side by side (the card and the
    host's 8 cores hold both; the results do not depend on it, the
    seconds do), then `extract-patches`; launch counts summed over every
    CLI process."""
    t0 = time.perf_counter()
    common.BUILD_ROOT.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=common.BUILD_ROOT.parent) as work:
        counts_path = os.path.join(work, "launches.jsonl")
        open(counts_path, "w").close()
        command = counting_cli(counts_path)
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            runs = {leg: pool.submit(Soak.run_leg, leg, os.path.join(work, f"leg_{leg}"),
                                     epochs=LEG_EPOCHS, min_gain=LEG_MIN_GAIN,
                                     artifact=False, command=command)
                    for leg in ("B", "C")}
            legs = {leg: f.result() for leg, f in runs.items()}
        legs_seconds = time.perf_counter() - t0
        for leg, res in legs.items():
            k, tr = res["metric_key"], res["train"]
            log(f"  leg {leg} ({res['dataset']}): untrained {k} "
                f"{res['untrained_eval'][k]:.2f}; val curve {tr['first_metric']:.2f} -> best "
                f"{tr['best_metric']:.2f} over {tr['steps']} steps; trained CLI eval {k} "
                f"{res['trained_eval'][k]:.2f} (== best); seconds "
                + ", ".join(f"{s} {v:.1f}" for s, v in res["seconds"].items()) + f" ({card})")
        log(f"  legs B and C side by side: {legs_seconds:.1f} s ({card})")
        fiq = os.path.join(work, "leg_B", "fixture")
        routes = route_ms([("png", os.path.join(fiq, "images", "dress0.png")),
                           ("jpeg", jpeg_copy(os.path.join(fiq, "images", "dress0.png"),
                                              work))], 224)
        log("  decode routes: " + "; ".join(
            f"{kind} -> {r['route']} {r['ms_per_item']:.3f} ms an item (224, uint8)"
            for kind, r in routes.items())
            + f"; JPEG decoder built in: {native_image.has_decoder()} (host)")
        extract = phase_extract(fiq, os.path.join(work, "extract"), command)
        log(f"  extract-patches: {extract['images']} images, {extract['crops']} crops, min "
            "cosine against the CPU's fp32 run: " + ", ".join(
                f"{k} {v:.5f}" for k, v in extract["min_cosine"].items())
            + "; seconds " + ", ".join(f"{k} {v:.1f}" for k, v in extract["seconds"].items())
            + f" ({card})")
        launches = summed_counts(counts_path)
    missing = [name for name in LEG_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"phase 15: kernels never launched by the CLI runs: {missing}")
    seconds = time.perf_counter() - t0
    log(f"  phase 15 took {seconds:.1f} s; launches " + ", ".join(
        f"{n.split(' ')[-1]} {c}" for n, c in launches.items() if c) + f" ({card})")
    return {"legs": legs, "legs_seconds": legs_seconds, "routes": routes, "extract": extract,
            "launches": launches, "seconds": seconds}


def fold_twin(s: np.ndarray, k: int, recall: float) -> tuple[np.ndarray, np.ndarray]:
    """The approximate tier's fold in numpy (`ops/similarity.py
    folded_top_k`): -inf padding to L * 2^r columns, strided bins, the
    first maximal slot a bin, the stable top-k of the bin maxima."""
    q, n = s.shape
    bins, r = S.reduction_output_size(n, k, recall)
    if r == 0:
        order = np.argsort(-s, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(s, order, 1), order
    padded = np.full((q, bins << r), -np.inf, np.float32)
    padded[:, :n] = s
    folded = padded.reshape(q, 1 << r, bins)
    slot, best = folded.argmax(axis=1), folded.max(axis=1)
    chosen = np.argsort(-best, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(best, chosen, 1), np.take_along_axis(slot, chosen, 1) * bins + chosen


def same_answers(got: list, want: list, atol: float, what: str) -> float:
    """Equal names in each result list, scores within `atol`; -> the
    largest score difference."""
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        if [x["name"] for x in g] != [x["name"] for x in w]:
            raise AssertionError(f"{what}: {[x['name'] for x in g]} != "
                                 f"{[x['name'] for x in w]}")
        worst = max(worst, max(abs(a["score"] - b["score"]) for a, b in zip(g, w)))
    if worst > atol:
        raise AssertionError(f"{what}: scores differ by {worst:.3e} > {atol}")
    return worst


def http_json(url: str, payload: dict | None = None, timeout: float = 120) -> dict:
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"},
                                 method="GET" if payload is None else "POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def front_replays(service: RetrievalService, names: list) -> dict:
    """Each bucket's graph replay against the serve program's body run
    eagerly on the same inputs."""
    fn, out = service._serve_fn, {}
    for b in fn.buckets:
        ids = service.api.tokenize([CAPTIONS[i % 8] for i in range(b)])
        rows = np.asarray([service.rows[names[(5 * i + b) % GALLERY]] for i in range(b)])
        got_s, got_i = fn(ids, rows, k=fn.k_max)
        want_s, want_i = (t.cpu().numpy() for t in fn.body(torch.from_numpy(ids).to(fn.device),
                                                            torch.from_numpy(rows).to(fn.device)))
        diff = float(np.abs(got_s - want_s).max())
        if not np.array_equal(got_i, want_i) or diff > 1e-6:
            raise AssertionError(f"bucket {b}: graph replay against the eager body: rows "
                                 f"equal {np.array_equal(got_i, want_i)}, max diff {diff}")
        out[b] = dict(bitwise=bool(np.array_equal(got_s, want_s)), max_abs_diff=diff)
    return out


def front_quantized_refs(api: InferenceAPI, model, batches: list, names: list) -> dict:
    """`quantize_refs` with `approx_recall` 0.95 over the phase's gallery:
    startup calibration, and 8 answers against a plain re-computation
    (the int8 rows dequantized in numpy, the eager towers, the fp32
    product, the numpy fold)."""
    api_q = InferenceAPI(model, tokenizer=tokenizer(), device=api.device, batch_size=BATCH,
                         quantize_refs=True, approx_recall=0.95)
    service = RetrievalService(api_q, batches)
    fn = service._serve_fn
    (fv, fs), (pv, ps) = fn.ref_f, fn.ref_p
    if fv.dtype != torch.int8 or pv.dtype != torch.int8:
        raise AssertionError("quantize_refs: the resident reference rows are not int8")
    ids = api_q.tokenize(CAPTIONS)
    rows = np.asarray([service.rows[names[(11 * i) % GALLERY]] for i in range(8)])
    got_s, got_i = fn(ids, rows, k=fn.k_max)
    rf = fv.cpu().numpy()[rows].astype(np.float32) * fs.cpu().numpy()[rows][:, None]
    rp = pv.cpu().numpy()[rows].astype(np.float32) * ps.cpu().numpy()[rows][:, :, None]
    tg, ts = api_q.encode_text(ids, visual_emb=rp)
    scores = (api_q.query(rf, rp, tg, ts) @ fn.gallery.t()).cpu().numpy()
    want_s, want_i = fold_twin(scores, fn.k_max, 0.95)
    diff = float(np.abs(got_s - want_s).max())
    if not np.array_equal(got_i, want_i) or diff > 1e-5:
        raise AssertionError(f"quantize_refs: serve program against the plain re-computation: "
                             f"rows equal {np.array_equal(got_i, want_i)}, max diff {diff}")
    return dict(measured_topk_recall=service.measured_topk_recall, max_abs_diff=diff,
                folds=S.reduction_output_size(fn.capacity or len(names), fn.k_max, 0.95)[1] > 0)


def front_fold(api: InferenceAPI, service: RetrievalService, names: list) -> dict:
    """The approximate tier where it folds: a clustered 200,000-row
    gallery (1,000 centres, unit rows), `calibrate_approx`'s recall on
    the card, and the serve program by features (8 queries, bucket 8)
    against the plain towers, the fp32 product and the numpy fold, with
    its overlap with the exact top-50."""
    g = np.random.default_rng(200)
    d = api.model.clip_config.feature_dim
    centres = g.standard_normal((1000, d)).astype(np.float32)
    gal = centres[g.integers(0, 1000, FOLD_GALLERY)] + 0.5 * g.standard_normal(
        (FOLD_GALLERY, d)).astype(np.float32)
    gal /= np.linalg.norm(gal, axis=1, keepdims=True)
    gal_t = torch.from_numpy(gal).to(api.device)
    index = RetrievalIndex([str(i) for i in range(FOLD_GALLERY)], gal_t, approx_recall=0.95)
    measured = index.calibrate_approx(k=51)
    api_a = InferenceAPI(api.model, tokenizer=tokenizer(), device=api.device, batch_size=BATCH,
                         approx_recall=0.95)
    fn = api_a.build_serve_fn(gal_t, k_max=50)
    rows = torch.as_tensor([service.rows[names[(13 * i) % GALLERY]] for i in range(8)],
                           device=api.device)
    rf = service.gallery.features[rows].cpu().numpy()
    rp = service.gallery.local_features[rows].cpu().numpy()
    ids = api_a.tokenize(CAPTIONS)
    got_s, got_i = fn(ids, rf, rp, k=50)
    tg, ts = api_a.encode_text(ids, visual_emb=rp)
    scores = api_a.query(rf, rp, tg, ts) @ gal_t.t()
    want_s, want_i = fold_twin(scores.cpu().numpy(), 50, 0.95)
    diff = float(np.abs(got_s - want_s).max())
    if not np.array_equal(got_i, want_i) or diff > 1e-5:
        raise AssertionError(f"the fold: serve program against the plain re-computation: rows "
                             f"equal {np.array_equal(got_i, want_i)}, max diff {diff}")
    exact = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :50].cpu()
    overlap = float(np.mean([len(set(a.tolist()) & set(e.tolist())) / 50
                             for a, e in zip(got_i, exact.numpy())]))
    wide = [service.rows[names[(13 * i) % GALLERY]] for i in range(32)]
    rows32 = torch.as_tensor(wide, device=api.device)
    rf32, rp32 = service.gallery.features[rows32], service.gallery.local_features[rows32]
    tg, ts = api_a.encode_text(api_a.tokenize([CAPTIONS[i % 8] for i in range(32)]),
                               visual_emb=rp32)
    scores32 = api_a.query(rf32, rp32, tg, ts) @ gal_t.t()
    return dict(gallery=FOLD_GALLERY, reduction=S.reduction_output_size(FOLD_GALLERY, 50, 0.95),
                calibrate_approx_recall=measured, serve_recall_vs_exact=overlap,
                max_abs_diff=diff, selection={b: selection_times(scores32[:b].contiguous())
                                              for b in (1, 32)})


def plain_graph(fn) -> torch.cuda.CUDAGraph:
    """`fn` (plain PyTorch) captured into a CUDA graph after one call on a
    side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def selection_times(scores: torch.Tensor) -> dict:
    """The serve program's top-50 of [b, N] scores: the exact tier
    (`stable_top_k`) against the fold at recall 0.95 (`folded_top_k`),
    each called eagerly and replayed as a CUDA graph, as the serve
    program runs it; CUDA-event medians of 200 calls."""
    exact = lambda: S.stable_top_k(scores, 50)  # noqa: E731
    fold = lambda: S.folded_top_k(scores, 50, 0.95)  # noqa: E731
    return dict(exact_ms=median_ms(exact, 200), fold_ms=median_ms(fold, 200),
                exact_graph_ms=median_ms(plain_graph(exact).replay, 200),
                fold_graph_ms=median_ms(plain_graph(fold).replay, 200))


def front_replay_trace() -> dict:
    """`front_trace_process` in a process of its own: late in this one,
    after phase 14's profiles, the profiler drops kernel events of graph
    replays (a b=32 replay traced B10 3 times of 12)."""
    done = subprocess.run([sys.executable, os.path.abspath(__file__), "--replay-trace"],
                          capture_output=True, text=True, timeout=600)
    if done.returncode != 0:
        raise AssertionError(f"the replay trace exited {done.returncode}:\n{done.stderr[-3000:]}")
    return {int(b): r for b, r in json.loads(done.stdout.strip().splitlines()[-1]).items()}


def front_trace_process() -> None:
    """Phase 16's service, built in a fresh process, then one replay of
    each bucket's graph under the profiler: the port kernels that ran, by
    kernel, must equal the graph's kernel nodes, which its capture read
    through libcuda and checked against its recorded launches
    (`ops/graphs.py`). Prints the result as one JSON line."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _, _, _, _, service = front_service()
    out = {}
    for b, bucket in service._serve_fn._buckets.items():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            bucket.run()
            torch.cuda.synchronize()
        traced = collections.Counter()
        for e in prof.key_averages():
            kernel = GR.port_kernel(e.key)
            if kernel:
                traced[kernel] += e.count
        if traced != bucket.graph.kernel_nodes:
            raise AssertionError(f"bucket {b}: a replay ran the port kernels {dict(traced)}, "
                                 f"its graph holds {dict(bucket.graph.kernel_nodes)}")
        out[b] = dict(kernel_nodes=dict(traced),
                      launches={w.__name__: n for w, n in bucket.graph.launches.items()})
    print(json.dumps(out))


def front_service() -> tuple:
    """Phase 16's service: ViT-B-16 from phase 3's seed under the bf16
    serve policy, phase 3's gallery, capacity FRONT_CAPACITY. -> (cfg,
    model, api, (names, batches), service)."""
    cfg = get_clip_config("ViT-B-16", activation="quick_gelu")
    model = random_init_(ComposedCIRModel(cfg), torch.Generator().manual_seed(0))
    apply_precision(model, "bf16")
    api = InferenceAPI(model, tokenizer=tokenizer(), device="cuda", batch_size=BATCH)
    names, _, _, batches = make_gallery(cfg.vision.image_size, cfg.feature_dim)
    return cfg, model, api, (names, batches), RetrievalService(api, batches,
                                                                capacity=FRONT_CAPACITY)


def front_http(service: RetrievalService, names: list) -> dict:
    """HTTP_CLIENTS concurrent b=1 clients through the micro-batcher:
    answers equal to `service.query`, fewer batches than requests."""
    httpd = serve(service, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    reqs = [(names[(17 * i) % GALLERY], CAPTIONS[i % 8]) for i in range(HTTP_CLIENTS)]
    try:
        def post(rc):
            t = time.perf_counter()
            out = http_json(f"{url}/query", {"ref_name": rc[0], "caption": rc[1], "k": K})
            return out, (time.perf_counter() - t) * 1e3

        with concurrent.futures.ThreadPoolExecutor(HTTP_CLIENTS) as pool:
            outs = list(pool.map(post, reqs))
        stats = http_json(f"{url}/stats")
    finally:
        httpd.shutdown()
        service.batcher.close()
        service.batcher = None
    want = [service.query([r], [c], k=K)[0][0] for r, c in reqs]
    worst = same_answers([o["results"] for o, _ in outs], want, 1e-4, "HTTP clients")
    batches = stats["dynamic_batching"]["batches"]
    if batches >= HTTP_CLIENTS or stats["dynamic_batching"]["items"] != HTTP_CLIENTS:
        raise AssertionError(f"micro-batcher: {stats['dynamic_batching']}")
    ms = sorted(t for _, t in outs)
    return dict(batches_run=batches, items=HTTP_CLIENTS, max_abs_diff=worst,
                client_ms_p50=statistics.median(ms), client_ms_max=ms[-1])


def front_native(service: RetrievalService, names: list) -> dict:
    """The native front over the same service: a client batch and 16
    concurrent singles, answers equal to `service.query`."""
    from fashionern_aaai2024_tpu_torch.native import serve_frontend

    ns = serve_frontend.serve_native(service, port=0)
    url = f"http://127.0.0.1:{ns.port}"
    refs = [names[(29 * i) % GALLERY] for i in range(8)]
    try:
        batch = http_json(f"{url}/query", {"ref_names": refs, "captions": CAPTIONS, "k": K})
        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            singles = list(pool.map(lambda i: http_json(f"{url}/query", {
                "ref_name": refs[i % 8], "caption": CAPTIONS[(i + 3) % 8], "k": K}), range(16)))
        stats = http_json(f"{url}/stats")
    finally:
        ns.shutdown()
    worst = same_answers(batch["results"], service.query(refs, CAPTIONS, k=K)[0], 1e-4,
                         "native front, client batch")
    want = [service.query([refs[i % 8]], [CAPTIONS[(i + 3) % 8]], k=K)[0][0] for i in range(16)]
    worst = max(worst, same_answers([o["results"] for o in singles], want, 1e-4,
                                    "native front, singles"))
    return dict(requests=stats["requests"], batches=stats["dynamic_batching"]["batches"],
                max_abs_diff=worst)


def front_cli(work: str, card: str) -> dict:
    """`fashionern-torch serve` in a subprocess (launch counts at its exit)
    over a learnable FashionIQ fixture of soak leg B's sizes: /healthz,
    /query single and batch, /add, /stats; then interrupted, and it must
    exit 0."""
    from fashionern_aaai2024_tpu_torch.tools.make_fixture import make_fixture

    root = make_fixture(os.path.join(work, "fixture"), "fashioniq", n_images=64,
                        n_triplets=128, learnable=True)
    counts_path = os.path.join(work, "launches.jsonl")
    open(counts_path, "w").close()
    argv = counting_cli(counts_path)(
        ["serve", "--dataset", "fashioniq", "--data-root", root, "--clip-model-name",
         "ViT-B-16", "--bpe-path", os.path.join(root, "bpe.txt.gz"), "--num-workers", "0",
         "--port", "0", "--capacity", "1024", "--device", "cuda"])
    env = dict(os.environ, PYTHONPATH=Soak.REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    err_path = os.path.join(work, "serve.stderr")
    with open(err_path, "w") as err:
        proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=err, text=True, env=env)

    def stderr_tail() -> str:
        with open(err_path) as f:
            return f.read()[-3000:]

    try:
        url = None
        for line in proc.stdout:
            if line.startswith("serving "):
                url = line.split(" on ")[1].split()[0]
                break
        if url is None:
            raise AssertionError(f"serve printed no URL:\n{stderr_tail()}")
        startup = time.perf_counter() - t0
        health = http_json(f"{url}/healthz")
        n = health["gallery_size"]
        image = sorted(os.listdir(os.path.join(root, "images")))[0]
        ref = os.path.splitext(image)[0]
        one = http_json(f"{url}/query", {"ref_name": ref, "caption": "is red", "k": K})
        two = http_json(f"{url}/query", {"ref_names": [ref, ref], "captions": ["is red", "blue"],
                                         "k": K})
        same_answers(two["results"][:1], [one["results"]], 1e-4, "serve CLI, batch vs single")
        np.save(os.path.join(root, "added.npy"),
                np.random.default_rng(3).standard_normal((13, 512)).astype(np.float32))
        added = http_json(f"{url}/add", {"items": [{
            "name": "added-item", "image_path": os.path.join(root, "images", image),
            "patch_path": os.path.join(root, "added.npy")}]})
        if added["gallery_size"] != n + 1:
            raise AssertionError(f"serve CLI /add: {added}")
        found = http_json(f"{url}/query", {"ref_name": "added-item", "caption": "is red",
                                           "k": K})
        stats = http_json(f"{url}/stats")
        if stats["requests"] < 3 or stats["gallery_size"] != n + 1:
            raise AssertionError(f"serve CLI /stats: {stats}")
    finally:
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=120)
    if rc != 0:
        raise AssertionError(f"serve CLI exited {rc}: {stderr_tail()}")
    log(f"  serve CLI: up in {startup:.1f} s over {n} items; /query single, batch, /add "
        f"(gallery {n} -> {added['gallery_size']}), the added item answers "
        f"({len(found['results'])} results), /stats {stats['latency_ms']} ({card})")
    return dict(startup_seconds=startup, gallery_size=n, stats=stats,
                launches=summed_counts(counts_path))


def phase_serving_front(card: str) -> dict:
    """Phase 16, the serving front (module docstring)."""
    t0 = time.perf_counter()
    reset_launches()
    cfg, model, api, (names, batches), service = front_service()
    out = {"replay_vs_eager": front_replays(service, names)}
    log("  graph replay vs eager body: " + ", ".join(
        f"bucket {b}: rows equal, scores {'bit for bit' if r['bitwise'] else 'max diff %.2e' % r['max_abs_diff']}"
        for b, r in out["replay_vs_eager"].items()) + f" ({card})")
    out["replay_trace"] = front_replay_trace()
    for b, r in out["replay_trace"].items():
        log(f"  bucket {b}: one profiled replay (a fresh process) ran the graph's port "
            f"kernel nodes {r['kernel_nodes']}; it counts the wrappers {r['launches']}")

    g = np.random.default_rng(16)
    side = cfg.vision.image_size
    new = {"name": [f"new{i:02d}" for i in range(FRONT_ADDS)],
           "image": ((g.random((FRONT_ADDS, side, side, 3), dtype=np.float32) - CLIP_MEAN)
                     / CLIP_STD).astype(np.float32),
           "patch": g.standard_normal((FRONT_ADDS, 13, cfg.feature_dim)).astype(np.float32)}
    graphs = {b: bk.graph for b, bk in service._serve_fn._buckets.items()}
    added = service.add_items(new["name"], new["image"], new["patch"])
    if {b: bk.graph for b, bk in service._serve_fn._buckets.items()} != graphs:
        raise AssertionError("live adds recaptured a graph")
    rebuilt = RetrievalService(api, batches + [new])
    probe = ([new["name"][0], new["name"][-1], names[3], names[GALLERY // 5]], CAPTIONS[:4])
    out["live_adds"] = dict(added=added, max_abs_diff=same_answers(
        service.query(*probe, k=K)[0], rebuilt.query(*probe, k=K)[0], 1e-4,
        "live adds against a rebuilt service"))
    del rebuilt
    log(f"  add_items of {FRONT_ADDS}: {added}; answers equal to a service rebuilt over "
        f"{GALLERY + FRONT_ADDS} items (max score diff {out['live_adds']['max_abs_diff']:.2e}) "
        f"({card})")
    out["quantized_refs"] = front_quantized_refs(api, model, batches, names)
    out["fold"] = front_fold(api, service, names)
    log(f"  quantize_refs + topk-recall 0.95 over {GALLERY} items: calibrate_approx "
        f"{out['quantized_refs']['measured_topk_recall']}, plain re-computation max diff "
        f"{out['quantized_refs']['max_abs_diff']:.2e}; the fold over {FOLD_GALLERY} clustered "
        f"rows (L, r) = {out['fold']['reduction']}: calibrate_approx recall "
        f"{out['fold']['calibrate_approx_recall']:.4f}, serve program vs exact top-50 "
        f"{out['fold']['serve_recall_vs_exact']:.4f}, plain re-computation max diff "
        f"{out['fold']['max_abs_diff']:.2e} ({card})")
    for b, t in out["fold"]["selection"].items():
        log(f"  top-50 of [{b}, {FOLD_GALLERY}] scores: exact {t['exact_ms']:.4f} ms eager, "
            f"{t['exact_graph_ms']:.4f} ms in a graph; fold {t['fold_ms']:.4f} ms eager, "
            f"{t['fold_graph_ms']:.4f} ms in a graph ({card})")
    out["http"] = front_http(service, names)
    log(f"  HTTP: {HTTP_CLIENTS} concurrent b=1 clients in {out['http']['batches_run']} "
        f"batches, answers equal to service.query (max diff "
        f"{out['http']['max_abs_diff']:.2e}); client P50 {out['http']['client_ms_p50']:.2f} "
        f"ms, max {out['http']['client_ms_max']:.2f} ms ({card})")
    out["native"] = front_native(service, names)
    log(f"  native front: a client batch of 8 and 16 concurrent singles equal to "
        f"service.query (max diff {out['native']['max_abs_diff']:.2e}) ({card})")
    torch.cuda.synchronize()
    out["launches"] = launch_counts()
    del service
    torch.cuda.empty_cache()
    common.BUILD_ROOT.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=common.BUILD_ROOT.parent) as work:
        out["cli"] = front_cli(work, card)
    out["seconds"] = time.perf_counter() - t0
    missing = [n for n in (B7, B8, B10, B11, B12) if out["cli"]["launches"][n] == 0
               or out["launches"][n] == 0]
    if missing:
        raise AssertionError(f"phase 16: kernels never launched: {missing}")
    log(f"  phase 16 took {out['seconds']:.1f} s ({card})")
    return out


# --- phase 17: the RN50x4 tiers --------------------------------------------------

RN_TRAIN_STEPS, RN_TME_TRAIN_STEPS = 3, 2


def mha_grad_check(b: int = 64, d: int = 640) -> dict:
    """B9's backward at RN50x4's TME (8 heads of 80, 77 queries against
    13 patches, fp32), as `MHAFunction` takes it in a TME train step: the
    kernel forward and the plain version's VJP, against autograd of the
    plain version, every gradient at rtol 1e-4 and an atol of 1e-5 times
    its largest element (tests/test_torch_cuda.py's limits)."""
    q, k, v, _ = mha_case(dict(b=b, d=d), torch.float32, seed=801)
    up = torch.randn(q.shape, generator=torch.Generator().manual_seed(802)).cuda()
    grads = []
    for fn in (A.multi_head_attention, A.mha_plain):
        ops = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        (fn(*ops).float() * up).sum().backward()
        grads.append([t.grad for t in ops])
    worst = 0.0
    for name, got, want in zip("qkv", *grads):
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * scale,
                                   msg=lambda m, n=name: f"B9 backward d{d}, grad {n}: {m}")
        worst = max(worst, err / scale)
    return {"b": b, "d": d, "head_dim": d // 8, "max_err_over_scale": worst}


def phase_rn50x4_tiers(card: str) -> dict:
    """Phase 17 (ROADMAP A4b): RN50x4 at full width (ResNet 4-6-10-6, width
    80, 288 px, text 12 x 640) through `Trainer.train()` for
    RN_TRAIN_STEPS bf16 steps at B = 1024, with int8 towers for
    INT8_TRAIN_STEPS, and with TME for RN_TME_TRAIN_STEPS after TME
    queries through the serve program (the serve slice of phase 10 with
    tme=True); B9's backward at head dim 80 against its plain version.
    B4 at d = 640 (phase 7), B5 / B6 at W = 640 (phase 5) and B9's forward
    at d = 640 (phase 2) are held at these shapes in their phases."""
    out = {}
    log(f"  RN50x4 train, bf16 towers, B={TRAIN_BATCH}")
    out["train"] = phase_train(card, model_name="RN50x4", steps=RN_TRAIN_STEPS)
    log(f"  RN50x4 int8 train, B={TRAIN_BATCH}")
    out["int8_train"] = phase_int8_train(card, model_name="RN50x4")
    log("  RN50x4 TME: queries through the serve program, then train")
    out["tme_slice"], tme_service, tme_api = phase_slice(card, model_name="RN50x4", tme=True)
    del tme_service, tme_api
    out["tme_train"] = phase_train(card, tme=True, model_name="RN50x4",
                                   steps=RN_TME_TRAIN_STEPS)
    out["tme_launches"] = {name: out["tme_slice"]["launches"][name]
                           + out["tme_train"]["launches"][name] for name in KERNELS}
    out["b9_backward_d640"] = mha_grad_check()
    log(f"  B9 backward at head dim 80 (b=64, d=640, fp32) against the plain version's "
        f"autograd: max error / scale {out['b9_backward_d640']['max_err_over_scale']:.2e} "
        f"({card})")
    torch.cuda.empty_cache()
    return out


# --- phase 18: serve artifacts -----------------------------------------------------

ARTIFACT_SAMPLES = 200
ARTIFACT_QUERY_ROWS = (1, 5, 20, 32)     # buckets 1, 8, 32, 32

# The artifact's loading process: it imports the port's op library, the
# artifact module and the tokenizer only, and must import no module of
# `models/` or `data/`. It loads each artifact (each bucket captured as a
# CUDA graph, its kernel nodes checked against its recorded launches),
# answers the queries of the request, reads the launch counts, times
# `query` at b = 1 and 32, and writes the result as JSON.
ARTIFACT_PROCESS = r"""
import importlib, json, statistics, sys, time
import numpy as np
import torch
from fashionern_aaai2024_tpu_torch.retrieval.artifact import load_serve_artifact
req = json.load(open(sys.argv[1]))
wrappers = {n: getattr(importlib.import_module(m), a) for n, (m, a) in req["wrappers"].items()}
torch.backends.cuda.matmul.allow_tf32 = False
out = {}
for tag, path in req["artifacts"].items():
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    art = load_serve_artifact(path, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    answers = {}
    for key, q in req["queries"].items():
        s, i = art.query(np.asarray(q["ids"], np.int32), q["rows"], k=q["k"])
        answers[key] = {"scores": s.tolist(), "rows": i.tolist()}
    launches = {n: fn.launches for n, fn in wrappers.items()}
    graphs = {str(b): {"kernel_nodes": dict(art._buckets[b].graph.kernel_nodes),
                       "launches": {w.__name__: n for w, n in
                                    art._buckets[b].graph.launches.items()}}
              for b in art.buckets}
    p50 = {}
    for b in (1, 32):
        ids = np.asarray(req["queries"][f"q{b}"]["ids"], np.int32)
        rows = req["queries"][f"q{b}"]["rows"]
        times = []
        for _ in range(req["samples"]):
            t = time.perf_counter()
            art.query(ids, rows, k=10)
            times.append((time.perf_counter() - t) * 1e3)
        p50[str(b)] = statistics.median(times)
    out[tag] = dict(load_seconds=load_s, answers=answers, launches=launches, graphs=graphs,
                    p50_ms=p50, buckets=art.buckets)
out["port_modules"] = sorted(m for m in sys.modules if m.startswith("fashionern_aaai2024_tpu"))
json.dump(out, open(sys.argv[2], "w"))
"""


def artifact_queries(service: RetrievalService) -> dict:
    """Queries of 1, 5, 20 and 32 rows (buckets 1, 8, 32, 32) as token ids
    and gallery rows."""
    names = service.gallery.names
    out = {}
    for n in ARTIFACT_QUERY_ROWS:
        refs = [names[(11 * i + n) % len(names)] for i in range(n)]
        caps = [CAPTIONS[(i + n) % len(CAPTIONS)] for i in range(n)]
        out[f"q{n}"] = {"ids": tokenizer()(caps, CTX).tolist(),
                        "rows": [service.rows[r] for r in refs], "k": K}
    return out


def live_answers(service: RetrievalService, queries: dict) -> dict:
    fn = service._serve_fn
    return {key: fn(np.asarray(q["ids"], np.int32), q["rows"], k=q["k"])
            for key, q in queries.items()}


def compare_answers(got: dict, want: dict, what: str) -> dict:
    """Equal top-k rows, scores within 1e-5; whether bit for bit."""
    worst, bitwise = 0.0, True
    for key, (ws, wi) in want.items():
        gs, gi = np.asarray(got[key]["scores"], np.float32), np.asarray(got[key]["rows"])
        if not np.array_equal(gi, wi):
            raise AssertionError(f"{what} {key}: top-k rows {gi.tolist()} != live {wi.tolist()}")
        worst = max(worst, float(np.abs(gs - ws).max()))
        bitwise &= bool(np.array_equal(gs, ws))
    if worst > 1e-5:
        raise AssertionError(f"{what}: scores off the live program's by {worst}")
    return {"max_score_diff": worst, "bit_for_bit": bitwise}


def live_p50(service: RetrievalService, queries: dict) -> dict:
    fn, out = service._serve_fn, {}
    for b in (1, 32):
        q = queries[f"q{b}"]
        ids = np.asarray(q["ids"], np.int32)
        times = []
        for _ in range(ARTIFACT_SAMPLES):
            t = time.perf_counter()
            fn(ids, q["rows"], k=K)
            times.append((time.perf_counter() - t) * 1e3)
        out[str(b)] = statistics.median(times)
    return out


def artifact_daemon(path: str, bpe: str, work: str):
    """`fashionern-torch serve-artifact` over `path` in a process of its
    own: (process, URL)."""
    err = open(os.path.join(work, "serve-artifact.stderr"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", Soak.CLI_MODULE, "serve-artifact", "--artifact", path, "--port",
         "0", "--bpe-path", bpe, "--no-dynamic-batching"], stdout=subprocess.PIPE, stderr=err,
        text=True, env=dict(os.environ, PYTHONPATH=Soak.REPO + os.pathsep
                            + os.environ.get("PYTHONPATH", "")))
    for line in proc.stdout:
        if line.startswith("serving "):
            return proc, line.split(" on ")[1].split()[0]
    proc.wait(timeout=60)
    with open(err.name) as f:
        raise AssertionError(f"serve-artifact printed no URL:\n{f.read()[-3000:]}")


def daemon_query(service: RetrievalService, queries: dict) -> tuple[list, list]:
    """The 5-row query as gallery names and captions."""
    return ([service.gallery.names[r] for r in queries["q5"]["rows"]],
            [CAPTIONS[(i + 5) % len(CAPTIONS)] for i in range(5)])


def http_answers(url: str, service: RetrievalService, queries: dict) -> list:
    refs, caps = daemon_query(service, queries)
    return http_json(f"{url}/query", {"ref_names": refs, "captions": caps, "k": K})["results"]


def phase_artifacts(card: str, service: RetrievalService, int8_service: RetrievalService,
                    ) -> dict:
    """Phase 18 (ROADMAP A7): phase 3's ViT-B-16 service (bf16 serve policy,
    the 512-item gallery) and phase 6's int8 one (--quantize-gallery
    --quantize-towers) exported (`retrieval/artifact.py`); both loaded in a
    fresh process that imports no `models` module, each bucket captured as
    one CUDA graph; their answers against the live serve programs' (equal
    top-k rows, scores within 1e-5, bit for bit or not), and query P50 at
    b = 1 and 32 of each. Then `serve-artifact` over the bf16 artifact,
    `refresh_consts` (what `refresh-artifact` runs) from a service whose
    ERN has new seeded weights, and `POST /reload`: the daemon's answers
    become the new live service's."""
    t0 = time.perf_counter()
    queries = artifact_queries(service)
    wrappers = {name: [fn.__module__, fn.__name__] for name, (fn, _, _) in KERNELS.items()}
    out = {}
    common.BUILD_ROOT.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=common.BUILD_ROOT.parent) as work:
        paths = {"bf16": os.path.join(work, "vit_bf16"), "int8": os.path.join(work, "vit_int8")}
        lives = {"bf16": service, "int8": int8_service}
        for tag, svc in lives.items():
            t = time.perf_counter()
            manifest = ART.export_serve_artifact(svc._serve_fn, paths[tag],
                                                 model_name="ViT-B-16",
                                                 gallery_names=svc.gallery.names)
            size = {name: os.path.getsize(os.path.join(paths[tag], name))
                    for name in os.listdir(paths[tag])}
            out[tag] = dict(export_seconds=time.perf_counter() - t, file_bytes=size,
                            consts=len(manifest["consts_shapes"]))
            log(f"  export {tag}: {time.perf_counter() - t:.1f} s; files " + ", ".join(
                f"{n} {b / 2**20:.2f} MiB" for n, b in sorted(size.items())))
        req, res = os.path.join(work, "request.json"), os.path.join(work, "result.json")
        with open(req, "w") as f:
            json.dump(dict(artifacts=paths, queries=queries, wrappers=wrappers,
                           samples=ARTIFACT_SAMPLES), f)
        t = time.perf_counter()
        done = subprocess.run([sys.executable, "-c", ARTIFACT_PROCESS, req, res],
                              capture_output=True, text=True, timeout=600,
                              env=dict(os.environ, PYTHONPATH=Soak.REPO + os.pathsep
                                       + os.environ.get("PYTHONPATH", "")))
        if done.returncode != 0:
            raise AssertionError(f"the artifact process failed:\n{done.stderr[-3000:]}")
        with open(res) as f:
            loaded = json.load(f)
        out["process_seconds"] = time.perf_counter() - t
        imported = [m for m in loaded["port_modules"]
                    if m.startswith(("fashionern_aaai2024_tpu_torch.models",
                                     "fashionern_aaai2024_tpu_torch.data",
                                     "fashionern_aaai2024_tpu."))]
        if imported:
            raise AssertionError(f"the artifact process imported {imported}")
        launches = dict.fromkeys(KERNELS, 0)
        for tag, svc in lives.items():
            got = loaded[tag]
            buckets = got["buckets"]
            cmp = compare_answers(got["answers"], live_answers(svc, queries), f"artifact {tag}")
            calls = [next(b for b in buckets if b >= n) for n in ARTIFACT_QUERY_ROWS]
            want = serve_launches(svc.api.model.clip_config, [], buckets + calls,
                                  refine_chunks=0)
            check_launches(f"artifact {tag}", got["launches"], want)
            for name, n in got["launches"].items():
                launches[name] += n
            live = live_p50(svc, queries)
            out[tag].update(load_seconds=got["load_seconds"], graphs=got["graphs"],
                            launches=got["launches"], p50_ms=got["p50_ms"],
                            live_p50_ms=live, **cmp)
            log(f"  artifact {tag}: loaded and captured in {got['load_seconds']:.1f} s; "
                f"graph kernel nodes by bucket " + "; ".join(
                    f"b={b} {sum(g['kernel_nodes'].values())}"
                    for b, g in got["graphs"].items())
                + f"; answers == live (rows equal, max score diff {cmp['max_score_diff']:.2e}, "
                f"bit for bit {cmp['bit_for_bit']}); query P50 b=1 {got['p50_ms']['1']:.3f} "
                f"ms, b=32 {got['p50_ms']['32']:.3f} ms; live serve program b=1 "
                f"{live['1']:.3f} ms, b=32 {live['32']:.3f} ms ({ARTIFACT_SAMPLES} samples, "
                f"{card})")
        out["launches"] = launches
        out["imported_port_modules"] = loaded["port_modules"]

        # serve-artifact, a retrained ERN, refresh, /reload
        bpe = os.path.join(work, "bpe")
        os.makedirs(bpe)
        words = CAPTIONS + [c for pair in FIQ_CAPTIONS for c in pair] + CIRR_CAPTIONS
        table = write_bpe_table(bpe, words + NON_ASCII_CAPTIONS, BPE_MERGES)
        if not np.array_equal(SimpleTokenizer(table)(CAPTIONS, CTX),
                              tokenizer()(CAPTIONS, CTX)):
            raise AssertionError("the written BPE table tokenizes unlike the phases' table")
        proc, url = artifact_daemon(paths["bf16"], table, work)
        try:
            before = http_answers(url, service, queries)
            same_answers(before, service.query(*daemon_query(service, queries), k=K)[0], 1e-5,
                         "serve-artifact vs the live service")
            # the same towers, a new seeded ERN: a retrained checkpoint's shapes
            model = copy.deepcopy(service.api.model).float().cpu()
            random_init_(model.ern, torch.Generator().manual_seed(16))
            apply_precision(model, "bf16")
            new_api = InferenceAPI(model, tokenizer=tokenizer(), device="cuda",
                                   batch_size=BATCH)
            cfg = model.clip_config
            _, _, _, batches = make_gallery(cfg.vision.image_size, cfg.feature_dim)
            new_service = RetrievalService(new_api, batches)
            ART.refresh_consts(paths["bf16"], new_service._serve_fn)
            reload = http_json(f"{url}/reload", {})
            after = http_answers(url, new_service, queries)
            same_answers(after, new_service.query(*daemon_query(new_service, queries),
                                                  k=K)[0], 1e-5,
                         "serve-artifact after /reload vs the new service")
            if after == before:
                raise AssertionError("/reload changed nothing")
            del new_service, new_api, model
        finally:
            proc.send_signal(signal.SIGINT)
            proc.wait(timeout=120)
        out["reload"] = dict(seconds=reload["seconds"], gallery_size=reload["gallery_size"])
        log(f"  serve-artifact: answers == live; refresh_consts from a new seeded ERN, "
            f"/reload in {reload['seconds']:.3f} s, answers == the new live service's ({card})")
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 18 took {out['seconds']:.1f} s ({card})")
    return out


def dp_batch(cfg, b: int, seed: int) -> dict:
    """A train batch of b rows on the host: uint8 images, token ids of the
    phases' captions, patches."""
    g = np.random.default_rng(seed)
    side = cfg.vision.image_size
    caps = [CAPTIONS[i % len(CAPTIONS)] for i in range(b)]
    return {"ref_image": torch.from_numpy(g.integers(0, 256, (b, side, side, 3), dtype=np.uint8)),
            "tar_image": torch.from_numpy(g.integers(0, 256, (b, side, side, 3), dtype=np.uint8)),
            "text_ids": torch.from_numpy(tokenizer()(caps)).long(),
            "ref_patch": torch.from_numpy(g.standard_normal((b, 13, cfg.feature_dim),
                                                            dtype=np.float32)),
            "tar_patch": torch.from_numpy(g.standard_normal((b, 13, cfg.feature_dim),
                                                            dtype=np.float32))}


def dp_step(model, weights: dict, batch: dict, mesh, shards: int = 1) -> dict:
    """One train step (bf16 towers, global negatives) from `weights` on
    this rank's rows of `batch` (`shards` > 1: one process standing for
    that many shards): the loss, the flat ERN gradient (fp64, on the
    card), the step's ms and launches."""
    model.load_state_dict(weights)
    state = cast_frozen_clip_bf16(create_train_state(model, seed=0))
    if shards > 1:
        step = MP.one_process_step(model, lambda s: TRAIN_LR, shards, negatives="global")
    else:
        step = build_train_step(model, lambda s: TRAIN_LR, negatives="global", mesh=mesh)
    rows = PM.shard_batch(mesh, batch) if mesh is not None else {
        k: v.cuda() for k, v in batch.items()}
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, loss = step(state, rows)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    grads = torch.cat([p.grad.flatten().double() for p in model.ern.parameters()
                       if p.grad is not None])
    return dict(loss=loss.item(), grads=grads, ms=ms, launches=launch_counts())


def dp_gang_rank(mesh, weights_path: str, batch_path: str, out_dir: str) -> dict:
    """Phase 19 (b): one rank of the gloo gang on the card (spawned: it
    loads the built kernel library and phase 19's weights and batch)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    common.LIBRARY.load()
    cfg = get_clip_config("ViT-B-16", activation="quick_gelu")
    model = ComposedCIRModel(cfg).cuda()
    weights = torch.load(weights_path, weights_only=True)
    batch = torch.load(batch_path, weights_only=True)
    with mock.patch.object(Dr, "dropout_mask", _keep_all):
        dp_step(model, weights, batch, mesh)      # warm-up: the timed step is the second
        out = dp_step(model, weights, batch, mesh)
    if mesh.rank == 0:
        torch.save(out["grads"].cpu(), os.path.join(out_dir, "gang_grads.pt"))
    return dict(loss=out["loss"], ms=out["ms"], launches=out["launches"])


def graph_nodes(program) -> dict:
    """Kernel nodes of each bucket's graph of a serve program: all, and
    NCCL's."""
    out = {}
    for b, bucket in program._buckets.items():
        names = GR.graph_kernel_names(bucket.graph.graph.raw_cuda_graph())
        out[b] = dict(kernel_nodes=len(names), nccl_nodes=sum("nccl" in n.lower()
                                                              for n in names))
    return out


def phase_data_parallel(card: str) -> dict:
    """Phase 19 (module docstring)."""
    t0 = time.perf_counter()
    cfg = get_clip_config("ViT-B-16", activation="quick_gelu")
    model = random_init_(ComposedCIRModel(cfg), torch.Generator().manual_seed(5)).cuda()
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    batch = dp_batch(cfg, TRAIN_BATCH, seed=6)
    mesh = PM.initialize_distributed(device="cuda", timeout=300.0)
    if (mesh.backend, mesh.size) != ("nccl", 1):
        raise AssertionError(f"phase 19: a {mesh.backend} group of {mesh.size} ranks")
    out: dict = {"nccl_version": ".".join(map(str, torch.cuda.nccl.version()))}
    try:
        # (a) the world-1 NCCL step against the unsharded one, after a
        # warm-up step (the first call of a process builds cuBLAS handles)
        dp_step(model, weights, batch, None)
        ref = dp_step(model, weights, batch, None)
        got = dp_step(model, weights, batch, mesh)
        rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
        cos = F.cosine_similarity(got["grads"], ref["grads"], dim=0).item()
        check_launches("data-parallel step", got["launches"], train_launches(1))
        out["step"] = dict(loss=got["loss"], loss_unsharded=ref["loss"], loss_rel=rel,
                           grad_cosine=cos, ms=got["ms"], unsharded_ms=ref["ms"],
                           launches=got["launches"])
        log(f"  (a) NCCL {out['nccl_version']} world 1: ViT-B-16 step B={TRAIN_BATCH}, global "
            f"negatives: loss {got['loss']:.6f} vs unsharded {ref['loss']:.6f} (rel {rel:.3e}), "
            f"ERN gradient cosine {cos:.8f}; {got['ms']:.1f} ms vs {ref['ms']:.1f} ms ({card})")
        if not rel <= 1e-5 or not cos >= 0.99999:
            raise AssertionError("the world-1 data-parallel step disagrees with the unsharded one")
        del ref, got
        launches = dict(out["step"]["launches"])

        g = torch.Generator(device="cuda").manual_seed(8)
        gal = F.normalize(torch.randn(GALLERY, 512, generator=g, device="cuda"), dim=-1)
        q = F.normalize(torch.randn(BATCH, 512, generator=g, device="cuda"), dim=-1)
        s_got, i_got = sharded_search(mesh, q, gal, k=K)
        s_want, i_want = S.blocked_top_k_similarity(q, gal, k=K)
        if not np.array_equal(i_got, i_want.cpu().numpy()):
            raise AssertionError("sharded_search rows differ from blocked_top_k_similarity's")
        out["search_max_score_err"] = float(np.abs(s_got - s_want.cpu().numpy()).max())

        # the gallery-sharded serve program against the single-device one
        model.load_state_dict(weights)
        apply_precision(model, "bf16")
        api = InferenceAPI(model, tokenizer=tokenizer(), device="cuda", batch_size=BATCH,
                           context_length=CTX, mesh=mesh)
        hg = np.random.default_rng(9)
        arrays = dict(gallery_features=gal.cpu().numpy(),
                      ref_features=hg.standard_normal((GALLERY, 512), dtype=np.float32),
                      ref_patches=hg.standard_normal((GALLERY, 13, 512), dtype=np.float32))
        sharded = api.build_serve_fn(**arrays)
        api.mesh = None
        single = api.build_serve_fn(**arrays)
        serve = {}
        for b in (1, BATCH):
            ids = tokenizer()([CAPTIONS[i % len(CAPTIONS)] for i in range(b)])
            rows = hg.integers(0, GALLERY, b)
            before = launch_counts()
            s1, i1 = sharded(ids, rows, k=K)
            mid = launch_counts()
            s2, i2 = single(ids, rows, k=K)
            after = launch_counts()
            sharded_launches = {n: mid[n] - before[n] for n in mid}
            check_launches(f"sharded serve b={b}", sharded_launches,
                           {n: after[n] - mid[n] for n in mid})
            for name, n in sharded_launches.items():
                launches[name] += n
            err = float(np.abs(s1 - s2).max())
            if not np.array_equal(i1, i2) or err > 1e-6:
                raise AssertionError(f"sharded serve b={b}: rows equal {np.array_equal(i1, i2)}, "
                                     f"max score err {err}")
            serve[b] = dict(max_score_err=err,
                            ms=median_ms(lambda: sharded(ids, rows, k=K)),
                            single_ms=median_ms(lambda: single(ids, rows, k=K)))
        nodes = {"sharded": graph_nodes(sharded), "single": graph_nodes(single)}
        sharded.close()
        out["serve"] = dict(by_batch=serve, graph_nodes=nodes, per=sharded.per)
        log(f"  (a) sharded_search == blocked_top_k_similarity on {GALLERY} items; sharded serve "
            f"== single-device at b=1 and {BATCH} (max score err "
            f"{max(v['max_score_err'] for v in serve.values()):.2e}); per-call ms sharded / "
            f"single: " + ", ".join(f"b={b} {v['ms']:.3f} / {v['single_ms']:.3f}"
                                    for b, v in serve.items())
            + f"; graph kernel nodes (NCCL) by bucket: sharded "
            + ", ".join(f"{b}: {v['kernel_nodes']} ({v['nccl_nodes']})"
                        for b, v in nodes["sharded"].items())
            + "; single " + ", ".join(f"{b}: {v['kernel_nodes']}"
                                      for b, v in nodes["single"].items()) + f" ({card})")
        del api, sharded, single
    finally:
        PM.destroy(mesh)
    out["launches"] = launches

    # (b) two ranks on the one card over gloo against one process of two shards
    common.BUILD_ROOT.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=common.BUILD_ROOT.parent) as work:
        gang_batch = {k: v[:DP_GANG_RANKS * DP_GANG_BATCH] for k, v in batch.items()}
        torch.save(weights, os.path.join(work, "weights.pt"))
        torch.save(gang_batch, os.path.join(work, "batch.pt"))
        t1 = time.perf_counter()
        ranks = PM.spawn_cpu_gang(DP_GANG_RANKS, dp_gang_rank, os.path.join(work, "weights.pt"),
                                  os.path.join(work, "batch.pt"), work, timeout=300.0,
                                  store_dir=work, device="cuda")
        gang_s = time.perf_counter() - t1
        model = ComposedCIRModel(cfg).cuda()
        one_rank = PM.ProcessMesh(None, 0, 1, torch.device("cuda"))
        with mock.patch.object(Dr, "dropout_mask", _keep_all):
            one = dp_step(model, weights, gang_batch, one_rank, shards=DP_GANG_RANKS)
        gang_grads = torch.load(os.path.join(work, "gang_grads.pt")).cuda()
    rel = abs(ranks[0]["loss"] - one["loss"]) / abs(one["loss"])
    cos = F.cosine_similarity(gang_grads, one["grads"], dim=0).item()
    out["gang"] = dict(loss=ranks[0]["loss"], loss_one_rank=one["loss"], loss_rel=rel,
                       grad_cosine=cos, rank_ms=[r["ms"] for r in ranks], seconds=gang_s,
                       one_rank_ms=one["ms"], launches=ranks[0]["launches"])
    log(f"  (b) gloo gang of {DP_GANG_RANKS} ranks on the card, B={DP_GANG_BATCH} a rank, "
        f"global negatives, dropout kept: loss {ranks[0]['loss']:.6f} vs one process of two "
        f"shards {one['loss']:.6f} (rel {rel:.3e}), ERN gradient cosine {cos:.8f}; rank step "
        f"ms {[round(r['ms'], 1) for r in ranks]}, gang {gang_s:.1f} s ({card})")
    if ranks[0]["loss"] != ranks[1]["loss"] or not rel <= 1e-4 or not cos >= 0.99999:
        raise AssertionError("the 2-rank gang disagrees with one process of two shards")
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 19 took {out['seconds']:.1f} s ({card})")
    return out



# phase 20: the comparison zoo. B8's wide route against its plain version
# at CaLa's single heads on the ViT-B-16 tower's 13 patch tokens (512) and
# RN50x4's (640), a BLIP-2 Q-Former's 32 tokens (256, CaLa's own source)
# and a small case, one head each: (label, B, S, head dim)
WIDE_SHAPES = [("cala_vit_b16", 128, 13, 512), ("cala_rn50x4", 128, 13, 640),
               ("qformer", 128, 32, 256), ("small", 3, 5, 16)]
# the wide route's tile edges, its own launch (as tests/test_torch_cuda.py
# WIDE_EDGES): (B, Sq, Sk, heads, head dim) around its 16-row query tiles,
# 16-key chunks and 16-column units, element and 4-byte staging, the
# limits (1,024, 256 keys: K, then V streamed), two heads, more blocks
# than SMs
WIDE_EDGES = ([(2, sq, 13, 1, 512) for sq in (1, 15, 16, 17, 33)]
              + [(2, 17, sk, 1, 65) for sk in (1, 7, 8, 9, 17, 255, 256)]
              + [(2, 17, 33, 1, dh) for dh in (1, 6, 7, 63, 64, 65, 512, 640, 1023, 1024)]
              + [(2, 33, 256, 1, 1024), (3, 17, 13, 2, 192), (256, 13, 13, 1, 640)])
# profiled calls a device time reads (after 5 warm-up calls)
DEVICE_CALLS = 20
PROFILE_WINDOWS = 3
# the heads at ViT-B-16 width (d = 512), card against the port's CPU run in
# fp32: every row's cosine (both run fp32 and differ only in summation
# order); CompoDiff at JAX's defaults with dim 768 (ViT-L/14's, CompoDiff's
# own), B = 32, guided (the triple batch)
ZOO_BATCH, ZOO_WIDTH, ZOO_COSINE_MIN = 128, 512, 0.99999
COMPODIFF = dict(dim=768, depth=4, dim_head=64, heads=8, text_cond_dim=1280, mask_hw=64)
COMPODIFF_BATCH, COMPODIFF_SCALE = 32, (1.5, 7.5)
# CaLa's eight attentions a call are B8 on the wide route; the registry's
# "bbc" is one B4 launch
ZOO_LAUNCHES = {B8: 8, B8W: 8, B4: 1}
ZOO_BBC_RTOL = 1e-5
# phase 20's heads: label -> (registry name, constructor keywords), each
# drawn on the card by the JAX package's seeded init (`models/zoo
# jax_init_`) at seed 40 + its index
_COMBINER = dict(clip_feature_dim=ZOO_WIDTH, projection_dim=4 * ZOO_WIDTH,
                 hidden_dim=8 * ZOO_WIDTH)
ZOO_HEADS = {
    "clip4cir_combiner": ("clip4cir_combiner", _COMBINER),
    "vtf": ("vtf", _COMBINER),
    "attention_pooling": ("attention_pooling", dict(emb_dim=ZOO_WIDTH, emb_num=13)),
    "cala": ("cala", dict(embedding_dim=ZOO_WIDTH)),
    "artemis": ("artemis", dict(clip_feature_dim=ZOO_WIDTH)),
    "artemis_broadcast": ("artemis", dict(clip_feature_dim=ZOO_WIDTH)),
    "dqu_cir": ("dqu_cir", dict(clip_feature_dim=ZOO_WIDTH, hidden_dim=2 * ZOO_WIDTH)),
    "amc": ("amc", dict(embed_size=ZOO_WIDTH, hid_router=ZOO_WIDTH)),
    "amc_ensemble": ("amc_ensemble", dict(embed_size=ZOO_WIDTH)),
    "compodiff": ("compodiff", COMPODIFF),
}
# values at each end of every variable of a seeded draw on the card that
# are drawn again on the CPU (each value depends only on its key, its flat
# index and its initializer, so both ends hold the chunked draw's offsets)
DRAW_SAMPLE = 4096
# the registry's text_relevance after bbc: a bank of two batches' rows made
# without `device=` (so on the card), two calls (CaLa's queries, then the
# target globals, against the text globals), card against CPU at
# ZOO_BBC_RTOL
TEXT_BANK_ROWS = 2 * ZOO_BATCH
# the autograd Functions of B1, B2, B3, B7 and B8 (both routes) at the
# PERF.md §6 sites: (kernel, site, the dtype timed, shape); each site's
# gradients are checked in both dtypes against the plain version's
# autograd on the card, at B10's thresholds
GRAD_SITES = [(B1, "vit_b32", torch.bfloat16, VIT), (B2, "vit_b32", torch.bfloat16, VIT),
              (B3, "vit_b32", torch.bfloat16, VIT),
              (B7, "bert640", torch.float32, dict(BERT_SHAPES)["bert640"]),
              (B8, "attnpool", torch.bfloat16, dict(CROSS_SHAPES)["attnpool"]),
              (B8W, "cala_vit_b16", torch.float32, dict(b=128, sq=13, sk=13, w=512, heads=1))]
GRAD_COSINE_MIN = {torch.float32: 0.99999, torch.bfloat16: 0.99}
# CaLa's train step (the registry's bbc on CaLa's queries against the
# target globals, Adam at the train path's lr): card against the CPU in
# fp32 on step 1 (loss rtol, every parameter gradient's cosine), then
# CALA_STEPS steps whose loss must fall; every forward is CaLa's 8 B8
# calls on the wide route and one B4, every backward launches nothing
CALA_STEPS, CALA_LOSS_RTOL, CALA_GRAD_COSINE_MIN = 3, 1e-5, 0.99999
CALA_WIDTHS = (("vit_b16", ZOO_WIDTH), ("rn50x4", 640))


def device_pair_ms(kernel, library, calls: int = DEVICE_CALLS) -> tuple[float, float]:
    """Device ms of one call of `kernel` (the wide route's kernels) and of
    `library` (every other kernel of the window), from one
    `torch.profiler` window over `calls` calls of each, after 5 warm-up
    calls of each. A window in which the profiler recorded no kernel of
    either side is taken again, up to PROFILE_WINDOWS in all (even a fresh
    process has recorded none of the wide route's in one window), and
    then it raises."""
    for _ in range(5):
        kernel()
        library()
    torch.cuda.synchronize()
    for _ in range(PROFILE_WINDOWS):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                kernel()
            for _ in range(calls):
                library()
            torch.cuda.synchronize()
        times = [(e.key, e.device_time_total) for e in prof.key_averages()]
        wide = sum(t for key, t in times if "wide_" in key)
        other = sum(t for key, t in times if "wide_" not in key)
        if wide > 0 and other > 0:
            return wide / calls / 1e3, other / calls / 1e3
    raise RuntimeError(f"no profiler window of {PROFILE_WINDOWS} recorded kernels of both the "
                       f"wide route and the library (the last: {wide} and {other} us)")


def wide_instances() -> dict:
    """The wide route's kernel instances in the built library
    (`cuobjdump -res-usage`, then `-sass` of those functions alone): for
    each, its tensor-core products (the SASS's HMMA lines), whether it
    stages by LDGSTS, and its registers and local memory (spilled
    registers live in local memory). Fails unless every fp32 instance
    issues HMMA.1688.F32.TF32 only, every bf16 instance bf16 HMMA only,
    each on LDGSTS, none with local memory."""
    lib = str(common.LIBRARY.library_path())
    tool = "/usr/local/cuda/bin/cuobjdump"
    lines = subprocess.run([tool, "-res-usage", lib], capture_output=True, text=True,
                           check=True).stdout.splitlines()
    out = {}
    for line, nxt in zip(lines, lines[1:]):
        if "Function " in line and "wide_" in line:
            name = line.split("Function ", 1)[1].strip().rstrip(":")
            fields = dict(f.split(":", 1) for f in nxt.split() if ":" in f)
            out[name] = dict(hmma=set(), ldgsts=False, regs=int(fields.get("REG", -1)),
                             local=int(fields.get("LOCAL", -1)),
                             stack=int(fields.get("STACK", -1)))
    sass = subprocess.run([tool, "-sass", "-fun", ",".join(out), lib], capture_output=True,
                          text=True, check=True).stdout if out else ""
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
        elif name in out and "HMMA" in line:
            out[name]["hmma"].add(line.split("HMMA", 1)[1].split()[0])
        elif name in out and "LDGSTS" in line:
            out[name]["ldgsts"] = True
    bad = {fn: r for fn, r in out.items()
           if not r["ldgsts"] or r["local"] != 0
           or r["hmma"] != ({".1688.F32.TF32"} if "tf32" in fn else {".16816.F32.BF16"})}
    if len(out) != 16 or bad:
        raise AssertionError(f"wide route instances: {len(out)} (16 expected); at fault: {bad}")
    # fp32 (tf32) or bf16 (mma) instance and its units a warp: "tf32<4>"
    return {f"{'tf32' if 'tf32' in fn else 'mma'}<{fn.split('ILi', 1)[1][0]}>":
            dict(regs=r["regs"], local=r["local"], stack=r["stack"]) for fn, r in out.items()}


def wide_operands(i: int, b: int, s: int, dh: int, dtype: torch.dtype) -> tuple:
    """Row i of `WIDE_SHAPES` x dtype on the card: q [b, s, dh], packed kv
    [b, s, 2 dh], and kv's halves as [b, 1, s, dh] (SDPA's operands)."""
    g = torch.Generator().manual_seed(300 + i)
    q = torch.randn((b, s, dh), generator=g).to(dtype).cuda()
    kv = torch.randn((b, s, 2 * dh), generator=g).to(dtype).cuda()
    return q, kv, kv[..., :dh].contiguous()[:, None], kv[..., dh:].contiguous()[:, None]


def phase_wide_kernel() -> tuple[float, list]:
    """B8's wide route (csrc/attention_wide.cu) against its plain version
    at `WIDE_SHAPES` in fp32 and bf16, timed (a call, and in bursts of 10
    calls, both with the host's launch) beside SDPA on the same [B, 1, S,
    dh] operands (its library call, never called by the port); then its
    own launch at `WIDE_EDGES` against the plain version. The device times
    come from `wide_trace`."""
    rows, worst = [], 0.0
    t0 = time.perf_counter()
    for label, b, s, dh in WIDE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, kv, k, v = wide_operands(len(rows), b, s, dh, dtype)

            def kernel():
                return A.packed_kv_cross_attention(q, kv, 1)

            def plain():
                return A.packed_kv_cross_attention_plain(q, kv, 1)

            def library():
                return F.scaled_dot_product_attention(q[:, None], k, v)

            got, want = kernel(), plain()
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
            err = (got.float() - want.float()).abs().max().item()
            worst = max(worst, err)
            e = torch.finfo(dtype).bits // 8
            row = dict(kernel=B8W, shape=label, dtype=str(dtype).split(".")[1],
                       max_abs_err=err, ms=median_ms(kernel), plain_ms=median_ms(plain, PLAIN_RUNS),
                       library_ms=median_ms(library), burst_ms=burst_ms(kernel),
                       library_burst_ms=burst_ms(library),
                       **dtype_bound(4 * b * s * s * dh, e * 4 * b * s * dh, dtype))
            rows.append(row)
            log(f"  {B8W:36s} {label:12s} {row['dtype']:9s} err {err:.3e}  "
                f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
                f"SDPA {row['library_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']})" + row_extras(row))
    t1 = time.perf_counter()
    g = torch.Generator().manual_seed(14)
    edge_worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for b, sq, sk, heads, dh in WIDE_EDGES:
        for dtype in (torch.float32, torch.bfloat16):
            w = heads * dh
            q = torch.randn((b, sq, w), generator=g).to(dtype).cuda()
            kv = torch.randn((b, sk, 2 * w), generator=g).to(dtype).cuda()
            got = A.wide_cross_attention(q, kv, heads, None)
            want = A.packed_kv_cross_attention_plain(q, kv, heads)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
            edge_worst[dtype] = max(edge_worst[dtype],
                                    (got.float() - want.float()).abs().max().item())
    log(f"  {B8W}: {len(WIDE_EDGES)} edge cases x 2 dtypes within TOL (largest error fp32 "
        f"{edge_worst[torch.float32]:.3e}, bf16 {edge_worst[torch.bfloat16]:.3e}); seconds: "
        f"rows {t1 - t0:.1f}, edges {time.perf_counter() - t1:.1f}")
    return max(worst, *edge_worst.values()), rows


def wide_trace() -> dict:
    """`wide_trace_process` in a process of its own: late in this one the
    profiler drops kernel events (a whole run's phase 20 read no event of
    the wide route, as phase 16's replays lose theirs)."""
    done = subprocess.run([sys.executable, os.path.abspath(__file__), "--wide-trace"],
                          capture_output=True, text=True, timeout=600)
    if done.returncode != 0:
        raise AssertionError(f"the wide trace exited {done.returncode}:\n{done.stderr[-3000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def wide_trace_process() -> None:
    """Phase 20's profiled readings, in a fresh process: the wide route's
    and SDPA's device time at each `WIDE_SHAPES` row and dtype
    (`device_pair_ms`, the phase's operands) and one profiled CaLa train
    step at each of `CALA_WIDTHS` on seeded tokens (`cala_step_split`).
    Prints them as one JSON line."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for label, b, s, dh in WIDE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, kv, k, v = wide_operands(len(rows), b, s, dh, dtype)
            rows.append(device_pair_ms(lambda: A.packed_kv_cross_attention(q, kv, 1),
                                       lambda: F.scaled_dot_product_attention(q[:, None], k, v)))
    g = torch.Generator().manual_seed(22)
    splits = {}
    for label, d in CALA_WIDTHS:
        ref, tar, target = (torch.randn(shape, generator=g).cuda()
                            for shape in ((ZOO_BATCH, 13, d), (ZOO_BATCH, 13, d), (ZOO_BATCH, d)))
        model = cala_model(d)
        opt, loss_of, step = cala_setup(model, ref, tar, target)

        def forward_backward():
            opt.zero_grad(set_to_none=True)
            loss_of(model, ref, tar, target).backward()

        splits[label] = cala_step_split(lambda: loss_of(model, ref, tar, target),
                                        forward_backward, step)
    print(json.dumps(dict(rows=rows, splits=splits)))


def zoo_features(seed: int) -> dict:
    """The seeded ViT-B-16's fp32 features on the card: image globals and 13
    patch tokens (tower tokens 1-13) of `ZOO_BATCH` reference and target
    images, text globals and 77 token features of as many captions."""
    cfg = get_clip_config("ViT-B-16", activation="quick_gelu")
    model = random_init_(ComposedCIRModel(cfg), torch.Generator().manual_seed(seed)).cuda()
    g = np.random.default_rng(seed)
    side = cfg.vision.image_size
    images = torch.from_numpy(g.integers(0, 256, (2 * ZOO_BATCH, side, side, 3),
                                         dtype=np.uint8)).cuda()
    ids = torch.from_numpy(tokenizer()([CAPTIONS[i % len(CAPTIONS)] + f" {i}"
                                        for i in range(ZOO_BATCH)])).long().cuda()
    with torch.no_grad():
        img_g, tokens = model.encode_image(images)
        txt_g, txt_seq = model.encode_text(ids)
    n = ZOO_BATCH
    return dict(ref_g=img_g[:n], tar_g=img_g[n:], ref_tok=tokens[:n, 1:14],
                tar_tok=tokens[n:, 1:14], txt_g=txt_g, txt_seq=txt_seq)


def zoo_seeded() -> tuple[dict, float]:
    """label -> (each `ZOO_HEADS` model built on the card and drawn there by
    the JAX package's seeded init at seed 40 + its index, in eval mode; its
    seed); and the seconds it took (ending in a synchronize)."""
    t = time.perf_counter()
    models = {label: (TZ.seeded_zoo_model(name, 40 + i, "cuda", **ctor).eval(), 40 + i)
              for i, (label, (name, ctor)) in enumerate(ZOO_HEADS.items())}
    torch.cuda.synchronize()
    return models, time.perf_counter() - t


def f32_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The most float32 ulps between two tensors' elements (each bit pattern
    as an ordered integer: -0 and +0 are one)."""
    def ordered(x):
        i = x.float().contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def held_draw(models: dict) -> dict:
    """label -> (a zoo model drawn on the card by `jax_init_`, its seed):
    each model's draw made again on the card (`models/init.py variables`,
    as `jax_init_` makes it), every state tensor equal to it; then the
    first and last `DRAW_SAMPLE` values of every variable drawn on the CPU
    (`flat_values`), held to the card's at 0 float32 ulps. -> the values
    and variables drawn, the values drawn on the CPU and its seconds, the
    most ulps apart."""
    out = dict(values=0, variables=0, tensors=0, cpu_values=0, cpu_seconds=0.0, max_ulps=0)
    for label, (model, seed) in models.items():
        table = model.flax_variables()
        tree = Init.variables(table, seed, "cuda")
        want = TZ.state_dict_from_variables(model, tree)
        for k, t in model.state_dict().items():
            if not torch.equal(t, want[k]):
                raise AssertionError(f"{label}: {k} is not the seeded init's draw")
            out["tensors"] += 1
        for v in table:
            n = math.prod(v.shape)
            got = tree_leaf(tree, v).reshape(-1)
            key = Init.variable_key(seed, v)
            for start, stop in sorted({(0, min(n, DRAW_SAMPLE)), (max(0, n - DRAW_SAMPLE), n)}):
                t = time.perf_counter()
                cpu = Init.flat_values(v.init, key, v.shape, start, stop, "cpu")
                out["cpu_seconds"] += time.perf_counter() - t
                out["max_ulps"] = max(out["max_ulps"], f32_ulps(got[start:stop].cpu(), cpu))
                out["cpu_values"] += stop - start
            out["values"] += n
            out["variables"] += 1
        del tree, want
    if out["max_ulps"]:
        raise AssertionError(f"{sorted(models)}: the card's seeded draw is {out['max_ulps']} "
                             "ulps from the CPU's")
    return out


def zoo_heads(f: dict, models: dict) -> dict:
    """label -> (the card's seeded model, its call, args, keywords): every
    model of the zoo's registry at ViT-B-16 width (`models`, `zoo_seeded`'s
    label -> model); Clip4Cir and VTF on seeded [B, 2d] features (their
    inputs are 2d wide), CompoDiff on seeded conditioning (its dim is
    768)."""
    d, b = ZOO_WIDTH, ZOO_BATCH
    g = torch.Generator().manual_seed(21)

    def seeded(*shape):
        return torch.randn(shape, generator=g).cuda()

    pair = (seeded(b, 2 * d), seeded(b, 2 * d))
    amc = (f["ref_tok"], f["ref_g"], f["txt_seq"], f["txt_g"])
    cb = COMPODIFF_BATCH
    cd = COMPODIFF["dim"]
    mask = (torch.rand((cb, COMPODIFF["mask_hw"], COMPODIFF["mask_hw"]), generator=g) > 0.5)
    compodiff = (seeded(cb, 1, cd), seeded(cb, 1, cd), seeded(cb, 77, COMPODIFF["text_cond_dim"]),
                 mask.float().cuda(), torch.randint(0, 1000, (cb,), generator=g).float().cuda(),
                 seeded(cb, 77, COMPODIFF["text_cond_dim"]))
    calls = {
        "clip4cir_combiner": (pair, {}),
        "vtf": (pair, {}),
        "attention_pooling": ((f["ref_tok"],), {}),
        "cala": ((f["ref_tok"], f["tar_tok"]), {}),
        "artemis": ((f["ref_g"], f["txt_g"], f["tar_g"]), {}),
        "artemis_broadcast": ((f["ref_g"], f["txt_g"], f["tar_g"]), {"broadcast": True}),
        "dqu_cir": ((f["txt_g"], f["ref_g"]), {}),
        "amc": (amc, {}),
        "amc_ensemble": (amc, {}),
        "compodiff": (compodiff, {"cond_scale": COMPODIFF_SCALE}),
    }
    heads = {}
    for label, (args, kw) in calls.items():
        module = models[label]
        fn = module.forward_with_cond_scale if label == "compodiff" else module
        heads[label] = (module, fn, args, kw)
    return heads


def row_cosines(got, want) -> float:
    """The least cosine of a row (the last axis) over every output."""
    outs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    return min(cosine(a.reshape(-1, a.shape[-1]), w.reshape(-1, w.shape[-1])).min().item()
               for a, w in outs)


def grad_case(name: str, shp: dict, dtype: torch.dtype, seed: int):
    """(leaves, kernel, plain, library, flops, bytes) of one forward of
    `name` at `shp`: the operands as leaves that require grad, the
    wrapper (through its autograd Function), its plain version and a
    library composition (SDPA, `F.linear`, `F.layer_norm`; never called
    by the port) as functions of nothing, and the forward's work."""
    if name in TOWER_KERNELS:
        b, s, w, heads, causal = (shp[k] for k in ("b", "s", "w", "heads", "causal"))
        leaves = tuple(t.requires_grad_() for t in kernel_inputs(b, s, w, dtype, seed)[name])
        kw = {"activation": "quick_gelu"} if name == B2 else {"causal": causal}
        pos = () if name == B2 else (heads,)
        plain = {B1: A.attention_subblock_plain, B2: M.mlp_subblock_plain,
                 B3: A.packed_qkv_self_attention_plain}[name]
        return (leaves, lambda: KERNELS[name][0](*leaves, *pos, **kw),
                lambda: plain(*leaves, *pos, **kw), library_call(name, leaves, heads, causal),
                *tower_work(name, b, s, w, heads, causal, dtype))
    if name == B7:
        leaves = tuple(t.requires_grad_() for t in new_kernel_inputs(B7, shp, dtype, seed))
        return (leaves, *new_kernel_calls(B7, leaves, shp), *cross_work(B7, shp, dtype))
    leaves = tuple(t.requires_grad_() for t in new_kernel_inputs(B8, shp, dtype, seed))
    kernel, plain, library = new_kernel_calls(B8, leaves, shp)
    if name == B8W:    # one head: SDPA on [B, 1, S, dh]
        q, kv, w = *leaves, shp["w"]
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q[:, None], kv[..., :w][:, None], kv[..., w:][:, None])[:, 0]
    return (leaves, kernel, plain, library, *cross_work(B8, shp, dtype))


def phase_grad_functions(card: str) -> tuple[float, list]:
    """The autograd Functions of B1, B2, B3, B7 and B8 (the core and the
    wide route) at `GRAD_SITES`, each in fp32 and bf16: the forward equal
    to the grad-free call bit for bit with the same launches (one count
    of the wrapper), the backward launching nothing, and every gradient
    against the plain version's autograd on the card at
    `GRAD_COSINE_MIN`; in the site's dtype, forward + backward timed
    (`torch.autograd.grad` of the output against a seeded upstream
    gradient, CUDA events) beside the plain version's and the library
    composition's, with the bound of the work (3x the forward's FLOPs:
    each product's backward is two products; 2x its bytes: each input's
    gradient written once, the output's read once). Returns the least
    cosine and the rows."""
    rows, least = [], 1.0
    for name, label, timed, shp in GRAD_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            leaves, kernel, plain, library, flops, nbytes = grad_case(name, shp, dtype,
                                                                     seed=700 + len(rows))
            wrapper = KERNELS[B8 if name == B8W else name][0]
            with torch.no_grad(), common.recording() as free:
                want = kernel()
            n0 = wrapper.launches
            with common.recording() as forward:
                out = kernel()
            if (wrapper.launches != n0 + 1 or forward.entries != free.entries
                    or forward.wrappers != free.wrappers or not torch.equal(out, want)):
                raise AssertionError(f"{name} {label} {dtype}: the Function's forward "
                                     f"launched {dict(forward.entries)}, the grad-free call "
                                     f"{dict(free.entries)}, or their outputs differ")
            up = torch.randn(out.shape, generator=torch.Generator().manual_seed(701)).to(
                dtype).cuda()
            with common.recording() as backward:
                got = torch.autograd.grad(out, leaves, up)
                torch.cuda.synchronize()
            if backward.entries or backward.wrappers:
                raise AssertionError(f"{name} {label}: the backward launched "
                                     f"{dict(backward.entries)}")
            ref = torch.autograd.grad(plain(), leaves, up)
            cos = [F.cosine_similarity(a.double().flatten(), r.double().flatten(), dim=0).item()
                   for a, r in zip(got, ref)]
            least = min(least, *cos)
            if min(cos) < GRAD_COSINE_MIN[dtype]:
                raise AssertionError(f"{name} {label} {dtype}: gradient cosines {cos}")
            row = dict(kernel=name, shape=label, dtype=str(dtype).split(".")[1],
                       min_grad_cosine=min(cos))
            if dtype == timed:
                row.update(ms=median_ms(lambda: torch.autograd.grad(kernel(), leaves, up)),
                           plain_ms=median_ms(lambda: torch.autograd.grad(plain(), leaves, up),
                                              PLAIN_RUNS),
                           library_ms=median_ms(lambda: torch.autograd.grad(
                               library(), leaves, up)),
                           **dtype_bound(3 * flops, 2 * nbytes, dtype))
            rows.append(row)
            log(f"  {name:36s} {label:12s} {row['dtype']:9s} Function: {len(cos)} gradient "
                f"cosines against plain autograd, min {min(cos):.8f}; the backward launched "
                f"nothing" + (f"; forward + backward {row['ms']:.4f} ms, plain "
                              f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
                              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}) ({card})"
                              if "ms" in row else ""))
            del leaves, kernel, plain, library, out, want, got, ref, up
        torch.cuda.empty_cache()
    return least, rows


def cala_step_split(forward, forward_backward, step) -> dict:
    """One profiled CaLa train step (`kernel_split`: the card's idle share
    over it) and its device split: the wide route and B4 by kernel name;
    the forward, the backward (a forward and backward less the forward)
    and Adam (the step less both), each profiled on its own."""
    f = kernel_split(forward, top=1 << 30)
    fb = kernel_split(forward_backward, top=1 << 30)
    full = kernel_split(step, top=1 << 30)
    wide = [e for e in full["top"] if "wide_" in e["kernel"]]
    b4 = [e for e in full["top"] if "bbc_" in e["kernel"]]
    return dict(wall_ms=full["wall_ms"], device_ms=full["device_ms"],
                idle_share=full["idle_share"], wide_ms=sum(e["ms"] for e in wide),
                wide_launches=sum(e["launches"] for e in wide), b4_ms=sum(e["ms"] for e in b4),
                b4_launches=sum(e["launches"] for e in b4), forward_device_ms=f["device_ms"],
                backward_device_ms=fb["device_ms"] - f["device_ms"],
                adam_device_ms=full["device_ms"] - fb["device_ms"], top=full["top"][:6])


def cala_model(d: int) -> torch.nn.Module:
    """A `TwinAttentionCompositor(d)` drawn on the card by the JAX
    package's seeded init at seed 60 + d."""
    return TZ.seeded_zoo_model("cala", 60 + d, "cuda", embedding_dim=d)


def cala_setup(model: torch.nn.Module, ref: torch.Tensor, tar: torch.Tensor,
               target: torch.Tensor) -> tuple:
    """CaLa's train step on the card for `model` (`cala_model`): the
    registry's bbc on its normalized queries against the normalized
    `target`, Adam at `TRAIN_LR`. -> (optimizer, loss_of(model, ref, tar,
    target), step() -> loss)."""
    bbc = get_loss("bbc").fn

    def loss_of(m, r, t, y):
        return bbc(F.normalize(m(r, t), dim=-1), F.normalize(y, dim=-1))

    opt = torch.optim.Adam(model.parameters(), lr=TRAIN_LR)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = loss_of(model, ref, tar, target)
        loss.backward()
        opt.step()
        return loss

    return opt, loss_of, step


def cala_train(card: str, label: str, ref: torch.Tensor, tar: torch.Tensor,
               target: torch.Tensor) -> dict:
    """CaLa's train step at ref / tar [B, 13, d]: a seeded
    `TwinAttentionCompositor(d)` (the JAX package's seeded init at 60 + d,
    drawn on the card and held by `held_draw`), the registry's bbc on its
    normalized queries against the normalized `target`, Adam at
    `TRAIN_LR`. Step 1 card against the same step on a host copy of the
    card's draw (loss at `CALA_LOSS_RTOL`,
    every parameter gradient's cosine at `CALA_GRAD_COSINE_MIN`), the
    forward's launches (8 B8 on the wide route, 1 B4) and none in the
    backward; `CALA_STEPS` steps whose loss must be finite and falling,
    their launches (set to 0 just before, read just after); then a step's
    ms (CUDA events, median of 10)."""
    d = ref.shape[-1]
    t_draw = time.perf_counter()
    model = cala_model(d)
    torch.cuda.synchronize()
    t_draw = time.perf_counter() - t_draw
    draw = dict(held_draw({"cala": (model, 60 + d)}), card_seconds=t_draw)
    log(f"  CaLa {label} (d = {d}): the JAX package's seeded init at seed {60 + d}, "
        f"{draw['values']:,} values drawn on the card in {t_draw:.3f} s; {draw['tensors']} "
        f"tensors equal to it; {draw['cpu_values']:,} values of its {draw['variables']} "
        f"variables drawn again on the CPU in {draw['cpu_seconds']:.3f} s, at most "
        f"{draw['max_ulps']} float32 ulps apart ({card})")
    cpu = copy.deepcopy(model).cpu()
    opt, loss_of, step = cala_setup(model, ref, tar, target)

    reset_launches()
    loss = loss_of(model, ref, tar, target)
    torch.cuda.synchronize()
    check_launches(f"CaLa {label} forward", launch_counts(), ZOO_LAUNCHES)
    loss.backward()
    torch.cuda.synchronize()
    check_launches(f"CaLa {label} backward", launch_counts(), ZOO_LAUNCHES)
    t_cpu = time.perf_counter()
    want = loss_of(cpu, ref.cpu(), tar.cpu(), target.cpu())
    want.backward()
    t_cpu = time.perf_counter() - t_cpu
    rel = abs(loss.item() - want.item()) / abs(want.item())
    cos = {n: F.cosine_similarity(p.grad.double().flatten().cpu(), c.grad.double().flatten(),
                                  dim=0).item()
           for (n, p), c in zip(model.named_parameters(), cpu.parameters())}
    losses = [loss.item()]
    opt.step()
    for _ in range(CALA_STEPS - 1):
        losses.append(step().item())
    launches = launch_counts()
    check_launches(f"CaLa {label} train", launches,
                   {k: CALA_STEPS * v for k, v in ZOO_LAUNCHES.items()})
    with torch.no_grad():
        losses.append(loss_of(model, ref, tar, target).item())
    out = dict(loss_cpu=want.item(), rel=rel, grad_cosines=cos, losses=losses,
               launches=launches, step_ms=median_ms(step, runs=10), cpu_seconds=t_cpu,
               draw=draw)
    log(f"  CaLa train step {label} (d = {d}, B = {ref.shape[0]}, fp32): step-1 loss "
        f"{losses[0]:.6f} vs CPU {want.item():.6f} (rel {rel:.3e}); {len(cos)} parameter "
        f"gradients card vs CPU, min cosine {min(cos.values()):.8f}; losses over "
        f"{CALA_STEPS} Adam steps {', '.join(f'{v:.6f}' for v in losses)}; launches "
        f"{ {n: launches[n] for n in ZOO_LAUNCHES} } (8 B8 a forward on the wide route, "
        f"none in a backward); a step {out['step_ms']:.3f} ms; the CPU's step took "
        f"{t_cpu:.1f} s ({card})")
    if not rel <= CALA_LOSS_RTOL:
        raise AssertionError(f"CaLa {label}: step-1 loss {losses[0]} against CPU {want.item()}")
    if min(cos.values()) < CALA_GRAD_COSINE_MIN:
        raise AssertionError(f"CaLa {label}: gradient cosines {cos}")
    if not (np.isfinite(losses).all() and all(a > b for a, b in zip(losses, losses[1:]))):
        raise AssertionError(f"CaLa {label}: losses {losses} not finite and falling")
    return out


def zoo_text_relevance(card: str, pred: torch.Tensor, target: torch.Tensor,
                       txt_g: torch.Tensor) -> dict:
    """The registry's text_relevance, stateful: a bank made by
    `TextRelevanceBank.create` without `device=` (the card), two calls
    (CaLa's normalized queries, then the normalized target globals, each
    against the normalized text globals), each loss card against the same
    calls on a CPU bank at `ZOO_BBC_RTOL`."""
    fn = get_loss("text_relevance").fn
    text = F.normalize(txt_g, dim=-1)
    bank = TextRelevanceBank.create(TEXT_BANK_ROWS, ZOO_WIDTH)
    cpu_bank = TextRelevanceBank.create(TEXT_BANK_ROWS, ZOO_WIDTH, device="cpu")
    if bank.query.device != pred.device:
        raise AssertionError(f"TextRelevanceBank.create made its bank on {bank.query.device}, "
                             f"not on the card ({pred.device})")
    scale = torch.tensor(LOGIT_SCALE_INIT)
    losses, rels = [], []
    with torch.no_grad():
        for queries in (pred, target):
            got, bank = fn(bank, queries, text, scale.cuda())
            want, cpu_bank = fn(cpu_bank, queries.cpu(), text.cpu(), scale)
            losses.append((got.item(), want.item()))
            rels.append(abs(got.item() - want.item()) / abs(want.item()))
    log(f"  registry 'text_relevance' (a bank of {TEXT_BANK_ROWS} rows made on the card "
        f"without device=) on CaLa's card queries, then the target globals: "
        + ", ".join(f"{g:.6f} vs CPU {w:.6f}" for g, w in losses)
        + f" (rel up to {max(rels):.3e}); {bank.size} rows filled ({card})")
    if not max(rels) <= ZOO_BBC_RTOL:
        raise AssertionError(f"registry text_relevance: card against CPU {losses}")
    return dict(losses=losses, rel=max(rels), bank_rows=bank.size)


def phase_zoo(card: str) -> dict:
    """Phase 20 (module docstring)."""
    t0 = time.perf_counter()
    out: dict = {}
    # the library's SASS is read beside the phase (cuobjdump, ~14 s)
    sass = concurrent.futures.ThreadPoolExecutor(1).submit(wide_instances)
    out["wide_worst"], out["wide_rows"] = phase_wide_kernel()
    features = zoo_features(seed=20)
    models, card_s = zoo_seeded()
    out["draw"] = draw = dict(held_draw(models), card_seconds=card_s)
    log(f"  the zoo's {len(models)} heads by the JAX package's seeded init (seeds 40-"
        f"{39 + len(models)}): {draw['values']:,} values drawn on the card in {card_s:.3f} s; "
        f"{draw['tensors']} tensors equal to it; {draw['cpu_values']:,} values of its "
        f"{draw['variables']} variables drawn again on the CPU in {draw['cpu_seconds']:.3f} s, "
        f"at most {draw['max_ulps']} float32 ulps apart ({card})")
    heads = zoo_heads(features, {label: m for label, (m, _) in models.items()})
    cpu = {name: copy.deepcopy(module).cpu() for name, (module, _, _, _) in heads.items()}
    reset_launches()
    with torch.no_grad():
        card_out = {name: fn(*args, **kw) for name, (_, fn, args, kw) in heads.items()}
        pred = F.normalize(card_out["cala"], dim=-1)
        target = F.normalize(features["tar_g"], dim=-1)
        bbc = get_loss("bbc").fn(pred, target)
        torch.cuda.synchronize()
    out["launches"] = launches = launch_counts()
    check_launches("zoo", launches, ZOO_LAUNCHES)
    out["heads"] = {}
    for name, (module, fn, args, kw) in heads.items():
        cpu_fn = cpu[name].forward_with_cond_scale if name == "compodiff" else cpu[name]
        with torch.no_grad():
            want = cpu_fn(*(a.cpu() for a in args), **kw)
            cos = row_cosines(card_out[name], want)
            ms = median_ms(lambda: fn(*args, **kw))
        out["heads"][name] = dict(min_row_cosine=cos, card_ms=ms)
        log(f"  {name:18s} card vs CPU fp32: min row cosine {cos:.8f}; card {ms:.3f} ms a "
            f"call ({card})")
        if not cos >= ZOO_COSINE_MIN:
            raise AssertionError(f"zoo head {name}: card against CPU cosine {cos} < "
                                 f"{ZOO_COSINE_MIN}")
    want = get_loss("bbc").fn(pred.cpu(), target.cpu())
    rel = abs(bbc.item() - want.item()) / abs(want.item())
    out["bbc"] = dict(loss=bbc.item(), loss_cpu=want.item(), rel=rel)
    log(f"  registry 'bbc' (B4) on CaLa's card queries against the target globals: "
        f"{bbc.item():.6f} vs CPU {want.item():.6f} (rel {rel:.3e}); launches "
        f"{ {n: launches[n] for n in ZOO_LAUNCHES} } ({card})")
    if not rel <= ZOO_BBC_RTOL:
        raise AssertionError(f"registry bbc: card {bbc.item()} against CPU {want.item()}")
    out["text_relevance"] = zoo_text_relevance(card, pred, target, features["txt_g"])
    t1 = time.perf_counter()
    out["grad_least_cosine"], out["grad_rows"] = phase_grad_functions(card)
    out["grad_seconds"] = time.perf_counter() - t1
    del heads, models, cpu, card_out
    # ViT-B-16 width on the tower's features, RN50x4's on seeded ones
    g = torch.Generator().manual_seed(22)
    out["cala_train"] = {}
    for label, d in CALA_WIDTHS:
        inputs = ((features["ref_tok"], features["tar_tok"], features["tar_g"]) if d == ZOO_WIDTH
                  else tuple(torch.randn(shape, generator=g).cuda() for shape in (
                      (ZOO_BATCH, 13, d), (ZOO_BATCH, 13, d), (ZOO_BATCH, d))))
        out["cala_train"][label] = cala_train(card, label, *inputs)
    out["train_launches"] = {name: sum(r["launches"][name] for r in out["cala_train"].values())
                             for name in KERNELS}
    out["train_seconds"] = time.perf_counter() - t1
    log(f"  the Functions' gradients and CaLa's train steps took "
        f"{out['train_seconds']:.1f} s, the gradients {out['grad_seconds']:.1f} s of it "
        f"({card})")
    t2 = time.perf_counter()
    trace = wide_trace()
    for row, (ms, library_ms) in zip(out["wide_rows"], trace["rows"]):
        row.update(device_ms=ms, library_device_ms=library_ms,
                   device_share_of_bound=row["bound_ms"] / ms)
        log(f"  {B8W:36s} {row['shape']:12s} {row['dtype']:9s} device: kernel "
            f"{ms * 1e3:.2f} us ({row['device_share_of_bound']:.2f} of its bound), SDPA "
            f"{library_ms * 1e3:.2f} us ({card})")
    for label, split in trace["splits"].items():
        out["cala_train"][label]["split"] = split
        log(f"  CaLa train step {label}, profiled on seeded tokens: wall {split['wall_ms']:.3f} "
            f"ms, device {split['device_ms']:.3f} ms (idle share {split['idle_share']:.3f}): "
            f"wide route {split['wide_ms']:.4f} ms in {split['wide_launches']} launches, B4 "
            f"{split['b4_ms']:.4f} ms in {split['b4_launches']}; forward "
            f"{split['forward_device_ms']:.3f} ms, backward {split['backward_device_ms']:.3f}, "
            f"Adam {split['adam_device_ms']:.3f}; top kernels "
            + "; ".join(f"{e['kernel'][:60]} {e['ms']:.3f} ms x{e['launches']}"
                        for e in split["top"][:4]) + f" ({card})")
    out["trace_seconds"] = time.perf_counter() - t2
    instances = sass.result()
    log(f"  {B8W}: {len(instances)} instances in the library, HMMA.1688.F32.TF32 (fp32) / "
        f"HMMA.16816.F32.BF16 (bf16) on LDGSTS, no local memory; registers "
        + ", ".join(f"{k} {v['regs']}" for k, v in sorted(instances.items()))
        + f"; the profiled readings' process took {out['trace_seconds']:.1f} s ({card})")
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 20 took {out['seconds']:.1f} s ({card})")
    return out


# when each phase of this run began (host clock); `phase_seconds` turns
# them into each phase's seconds, in the order the phases ran
PHASE_STARTS: dict[int, float] = {}


def phase(number: int, text: str) -> None:
    """Log a phase's header and note when it began."""
    PHASE_STARTS[number] = time.perf_counter()
    log(f"phase {number}: {text}")


def phase_seconds(end: float) -> dict[int, float]:
    order = sorted(PHASE_STARTS.items(), key=lambda kv: kv[1])
    ends = [t for _, t in order[1:]] + [end]
    return {number: e - t for (number, t), e in zip(order, ends)}


def jpeg_copy(png: str, work: str) -> str:
    """The same pixels as a JPEG (PIL writes it), for the JPEG route's time."""
    from PIL import Image

    path = os.path.join(work, "route.jpg")
    Image.open(png).convert("RGB").save(path, quality=90)
    return path


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json-out", help="also write every measurement to this file")
    parser.add_argument("--replay-trace", action="store_true",
                        help="only phase 16's profiled replays (phase 16 runs this itself)")
    parser.add_argument("--wide-trace", action="store_true",
                        help="only phase 20's profiled readings (phase 20 runs this itself)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this run needs one GPU")
    if args.replay_trace:
        front_trace_process()
        return
    if args.wide_trace:
        wide_trace_process()
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    t0 = PHASE_STARTS[1] = time.perf_counter()
    common.LIBRARY.load()
    log(f"phase 1: kernels built in {common.LIBRARY.build_seconds:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s) at {common.LIBRARY.library_path()}")

    phase(2, f"kernels against their plain versions ({card})")
    worst, rows = phase_kernels()
    new_worst, new_rows = phase_new_kernels()
    tme_worst, tme_rows = phase_tme_kernels()
    block_worst, block_rows, block_grad = phase_block_kernel()
    edge_worst = phase_edge_kernels()
    gemm_worst = phase_gemm_edges()
    f32_gemm_worst = phase_f32_gemm_edges()
    gemm_rows = phase_gemm_products(card)
    host = phase_host_us(card)
    phase(3, f"the serve slice, ViT-B-16 bf16 ({card})")
    tokenizer_info = phase_tokenizer()
    slice_info, service, api = phase_slice(card)
    phase(4, f"timings ({card})")
    timings, embed_fn, query_fn = phase_timings(service, api)
    log(f"  embed + refine {timings['embed_refine_img_per_s']:.2f} img/s (B=128 bf16); "
        f"query P50 {timings['query_p50_ms_b1']:.3f} ms at b=1, "
        f"{timings['query_p50_ms_b32']:.3f} ms at b=32 ({card})")
    timings["routes"] = route_latencies(service)
    for key, r in timings["routes"].items():
        log(f"  route {key}: P50 {r['p50_ms']:.3f} ms, P99 {r['p99_ms']:.3f} ms over "
            f"{r['samples']} samples ({card})")
    phase(5, f"int8 kernels B5 and B6 against their plain versions ({card})")
    int8_worst, int8_rows = phase_int8_kernels()
    int8_gemm_worst = phase_int8_gemm_edges()
    int8_gemm_rows = phase_int8_products(card)
    int8_quant_rows = phase_int8_quantize(card)
    phase(6, f"the int8 serve slice, ViT-B-16 bf16, int8 towers and gallery ({card})")
    int8_info, int8_service, int8_api = phase_slice(card, quantize=True)
    int8_info["bf16_topk_overlap"] = topk_overlap(slice_info["results"], int8_info["results"])
    int8_timings, int8_embed_fn, _ = phase_timings(int8_service, int8_api)
    log(f"  top-{K} overlap with the bf16 service {int8_info['bf16_topk_overlap']:.3f}; "
        f"embed + refine {int8_timings['embed_refine_img_per_s']:.2f} img/s (B=128 bf16, "
        f"int8 towers); query P50 {int8_timings['query_p50_ms_b1']:.3f} ms at b=1, "
        f"{int8_timings['query_p50_ms_b32']:.3f} ms at b=32 ({card})")
    del int8_api
    phase(7, f"{B4} against its plain version ({card})")
    bbc_rows = phase_bbc()
    phase(8, f"the seeded init, then the int8 train slice, B={TRAIN_BATCH}, "
             f"quantize_towers ({card})")
    seeded_init, init_tree = phase_seeded_init(card)
    int8_train = phase_int8_train(card, expect_init=init_tree)
    del init_tree
    torch.cuda.empty_cache()
    phase(9, f"the train slice, ViT-B-16, bf16 towers, B={TRAIN_BATCH} ({card})")
    train = phase_train(card)
    phase(10, f"the RN50x4 serve slice, bf16 towers ({card})")
    rn_info, rn_service, rn_api = phase_slice(card, model_name="RN50x4")
    rn_timings, rn_embed_fn, rn_query_fn = phase_timings(rn_service, rn_api)
    log(f"  embed + refine {rn_timings['embed_refine_img_per_s']:.2f} img/s (B=128 bf16, "
        f"RN50x4); query P50 {rn_timings['query_p50_ms_b1']:.3f} ms at b=1, "
        f"{rn_timings['query_p50_ms_b32']:.3f} ms at b=32 ({card})")
    phase(11, f"the TME slice, ViT-B-16, tme=True, bf16 serve policy ({card})")
    tme_info, tme_service, tme_api = phase_slice(card, tme=True)
    tme_timings, _, tme_query_fn = phase_timings(tme_service, tme_api)
    log(f"  TME query P50 {tme_timings['query_p50_ms_b1']:.3f} ms at b=1, "
        f"{tme_timings['query_p50_ms_b32']:.3f} ms at b=32 ({card})")
    tme_train = phase_train(card, tme=True)
    phase(12, f"evaluate_fiq and evaluate_cirr, ViT-B-16, card bf16 and CPU fp32 ({card})")
    eval_info = phase_eval(card)
    phase(13, f"the attention experiment: X1-X4 and B9's grouped route against their "
          f"plain versions, then its runner, --all, at B={XA.B} ({card})")
    exp_worst, exp_rows = phase_experiment_kernels()
    experiment = phase_experiment(card)
    phase(14, f"profiles of embed + refine, B=128, of ViT-B-16 and RN50x4 queries at b=1, "
          f"of the ViT-B-16 serve program at b=1 and 32, "
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
                ("ViT-B-16 bf16 serve program b=1",
                 lambda: service.query(service.gallery.names[:1], CAPTIONS[:1], k=K), timings,
                 "serve_program_b1_profile", ()),
                ("ViT-B-16 bf16 serve program b=32",
                 lambda: service.query(service.gallery.names[:32],
                                       [CAPTIONS[i % 8] for i in range(32)], k=K), timings,
                 "serve_program_b32_profile", ()),
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
    del rn_service, rn_api, tme_service, tme_api, profiles, embed_fn, query_fn
    del int8_embed_fn, rn_embed_fn, rn_query_fn, tme_query_fn, fn
    torch.cuda.empty_cache()
    phase(17, f"the RN50x4 tiers: train, int8 train and TME at full width ({card})")
    rn_tiers = phase_rn50x4_tiers(card)
    phase(18, f"serve artifacts of phase 3's and phase 6's services: export, a fresh "
          f"loading process, graphs, answers against the live programs, serve-artifact, "
          f"refresh and /reload ({card})")
    artifacts = phase_artifacts(card, service, int8_service)
    # the CLI's processes get the card's memory that the services held
    del service, api, int8_service
    torch.cuda.empty_cache()
    phase(15, f"the dataset and CLI path through the port's CLI: soak legs B and C, "
          f"extract-patches ({card})")
    cli_info = phase_cli(card)
    phase(16, f"the serving front: graphs against the eager body, live adds, "
          f"quantize_refs and the approximate tier, HTTP, the native front, the serve CLI ({card})")
    front = phase_serving_front(card)
    phase(19, f"data parallel: an NCCL group of world size 1 (train step, sharded search, "
          f"the gallery-sharded serve program), then a 2-rank gloo gang on the card ({card})")
    dp = phase_data_parallel(card)
    phase(20, f"the comparison zoo: {B8W} against its plain version, every zoo head card "
              f"against CPU at ViT-B-16 width, the registry's bbc loss, the kernels' "
              f"autograd Functions, CaLa's train steps ({card})")
    zoo = phase_zoo(card)
    end = time.perf_counter()
    seconds = phase_seconds(end)
    log(f"  build {common.LIBRARY.build_seconds:.1f} s; total {end - t0:.1f} s; by phase "
        + ", ".join(f"{n}: {t:.1f}" for n, t in seconds.items()) + f" ({card})")

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
    # B8's wide route at CaLa's ViT-B-16 site in fp32, the zoo phase's dtype
    timed[B8W] = next(r for r in zoo["wide_rows"]
                      if r["shape"] == "cala_vit_b16" and r["dtype"] == "float32")
    worst[B8W] = zoo["wide_worst"]
    worst.update(int8_worst)
    # the int8 GEMM's edge cases: the device code of B5's and B6's products
    for name in INT8_KERNELS:
        worst[name] = max(worst[name], int8_gemm_worst)
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
                      "attn_experiment": experiment["launches"][name],
                      "cli_legs": cli_info["launches"][name],
                      "serving_front": front["launches"][name],
                      "cli_serve": front["cli"]["launches"][name],
                      "rn50x4_train": rn_tiers["train"]["launches"][name],
                      "rn50x4_int8_train": rn_tiers["int8_train"]["launches"][name],
                      "rn50x4_tme": rn_tiers["tme_launches"][name],
                      "artifact": artifacts["launches"][name],
                      "data_parallel": dp["launches"][name],
                      "data_parallel_gang": dp["gang"]["launches"][name],
                      "zoo": zoo["launches"][name],
                      "cala_train": zoo["train_launches"][name]}
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
    # forward + backward through the autograd Functions at their sites
    grad_keys = ("shape", "dtype", "min_grad_cosine", "ms", "plain_ms", "library_ms",
                 "bound_ms", "bound_by")
    # the wide route's device time (profiler) at every WIDE_SHAPES row
    wide_keys = ("shape", "dtype", "device_ms", "library_device_ms", "bound_ms",
                 "device_share_of_bound", "ms", "burst_ms", "library_burst_ms")
    for entry in kernels:
        entry["grad_rows"] = [{k: r[k] for k in grad_keys if k in r}
                              for r in zoo["grad_rows"] if r["kernel"] == entry["name"]]
        if entry["name"] == B8W:
            entry["device_rows"] = [{k: r[k] for k in wide_keys} for r in zoo["wide_rows"]]
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
                           seeded_init=seeded_init,
                           rn50x4_slice=rn_info, rn50x4_timings=rn_timings,
                           block_kernel_rows=block_rows, block_gradients=block_grad,
                           tokenizer=tokenizer_info, evaluation=eval_info,
                           experiment_kernel_rows=exp_rows, experiment=experiment,
                           gemm_products=gemm_rows, gemm_edge_max_err=gemm_worst,
                           int8_gemm_products=int8_gemm_rows,
                           int8_quantize_passes=int8_quant_rows,
                           int8_gemm_edge_max_err=int8_gemm_worst,
                           f32_gemm_edge_max_err=f32_gemm_worst,
                           host_us_per_call=host, cli=cli_info, serving_front=front,
                           rn50x4_tiers=rn_tiers, artifacts=artifacts, data_parallel=dp,
                           zoo=zoo, build_seconds=common.LIBRARY.build_seconds,
                           phase_seconds=seconds, total_seconds=end - t0), f, indent=1)
    print(f"{card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
