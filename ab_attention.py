"""Times the attention core (kernel B3, `packed_qkv_self_attention`),
the attention kernels beside it (X2, B8, B9's grouped route, X1), the
fp32 GEMM (`ops/common.py launch_gemm`, which the fp32 tiers of B1, B2
and B7 share), the fp32 kernels on it (B7, and B1, B2 and B10 in fp32),
kernel B4 and the whole-block kernel B10 against the B1 + B2 pair it
replaces, of the checkout in the current directory on one CUDA card.

    cd <checkout> && python3 <path>/ab_attention.py LABEL

Prints one line a group, each starting with LABEL: the median over 20
windows (after 5 warm-up calls) of the CUDA-event time of 10 back-to-back
calls, divided by 10 (a burst: the device's time per call where the host
keeps ahead of it), of B3 at ViT-B-16 B=32 (bf16 and fp32), text B=32
(causal, bf16) and ViT-B-16 B=1024 (bf16); in fp32, B8 at the MR
cross-attention (b = 32 and 1) and the RN50x4 attention pool, B9 at TME
with a bias and X1 at G=1, each beside SDPA; X2 (`mha_packed`, the padded
[128, 208, 2304] qkv with its padding bias, gb=1), B8 at the RN50x4
attention pool ([128, 1, 2560] against [128, 82, 5120], 40 heads), B9
through the grouped kernel at sk300_dh128 (head views [32, 8, 77, 128]
against [32, 8, 300, 128], an fp32 [77, 300] bias), X1 (`mha_grouped`,
G=1), all bf16, and SDPA on B3's ViT-B-16 B=32 bf16 operands (the
library yardstick, never called by the port); the fp32 GEMM with a bias
at the DVR BERT's fused QKV projection (B7: [32*91, 640] x [640, 1920],
[32*91, 512] x [512, 1536], and both at b = 1, 91 rows), the text
tower's c_proj at b = 1 and QKV at b = 32 and the ViT-B-16 c_fc (B2,
[32*197, 768] x [768, 3072]), each also at every tile width of the
3xTF32 GEMM where the checkout has one; B7 in fp32 at bert640 and
bert512, b = 32 and 1, per call and in bursts, beside F.linear + SDPA,
and its projection and attention core apart in bursts; B4 at (1024,
512), (1000, 512) and (1024, 640) per call and in bursts beside
`F.cross_entropy` over the logits; B1, B2 and B10 in fp32 in bursts at
`chip_smoke.py` phase 2's fp32 shapes (ViT-B-16 B=32 for B1 and B2; the
text towers of ViT-B-16 and RN50x4 at b = 32 and 1 for all three); the bf16 GEMM at
each product of B1 and B2 (QKV, out-projection + residual, c_fc +
quick_gelu, c_proj + residual) at ViT-B-16 M = 32 x 197 and 128 x 197
and at the RN50x4 text tower's c_fc (M = 32 x 77), with TFLOP/s and
`F.linear`'s time beside each (the yardstick, never called by the
port); kernel B11 (`layer_norm`) at the RN50x4 ln_final (bf16), the DVR
BERT's LNs (fp32) and the ViT-B-16 ln_pre at B=128 (bf16), and kernel
B12 (`combiner_apply`, fp32) at d = 512 and 640 and M = 1, 32, 128 and
1024, each per call (one call between CUDA events, the host's enqueue
included) and in bursts, beside `F.layer_norm` and the `F.linear`
combiner; the host µs of one call of `layer_norm`, `combiner_apply` and
`launch_gemm` in fp32 and bf16 (median of 2,000 calls, no
synchronisation between them); one transformer
block as B10 (one launch) and as B1 then B2, at the ViT-B-16 text tower
at b=1 and 32 and the RN50x4 text tower at b=32 (causal, bf16). To
compare two checkouts, run it in each in turns (parent, change, change,
parent) in one call on one card; the package is imported from the current
directory, so the script runs unchanged against an older checkout (one
without `ops/block.py` prints no B10 line, one without
`ops/attn_experiment.py` no attention line).

    cd <checkout> && python3 <path>/ab_attention.py LABEL --slices

runs instead the checkout's own `chip_smoke.py` serve slices of ViT-B-16
(bf16, then int8 towers and gallery) and of RN50x4 (bf16) with their
embed + refine img/s and query P50s (phases 3-4, 6, 10), and its train
slice's step time at B=1024 (phase 9), and prints them on one line.

    cd <checkout> && python3 <path>/ab_attention.py LABEL --bodies

times instead the two fp32 attention bodies of this checkout (the core's
kernel and the grouped kernel) side by side at the core's fp32 sites.
"""

import importlib.util
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.getcwd())
from fashionern_aaai2024_tpu_torch.ops import attention as A  # noqa: E402
from fashionern_aaai2024_tpu_torch.ops import common  # noqa: E402
from fashionern_aaai2024_tpu_torch.ops import mlp as M  # noqa: E402

SHAPES = (("vit_b32", (32, 197, 768, 12, False), torch.bfloat16),
          ("vit_b32", (32, 197, 768, 12, False), torch.float32),
          ("text_b32", (32, 77, 512, 8, True), torch.bfloat16),
          ("vit_b1024", (1024, 197, 768, 12, False), torch.bfloat16))
GEMMS = (("bert640_qkv", (32 * 91, 640, 1920)), ("bert512_qkv", (32 * 91, 512, 1536)),
         ("bert640_qkv_b1", (91, 640, 1920)), ("bert512_qkv_b1", (91, 512, 1536)),
         ("text_cproj_b1", (77, 2048, 512)), ("text_qkv_b32", (32 * 77, 512, 1536)),
         ("vit_cfc", (32 * 197, 768, 3072)))
# B7 in fp32: the DVR BERT at d = 640 (8 heads of 80) and 512, b = 32 and 1
BERTS = (("bert640", (32, 91, 640, 8)), ("bert512", (32, 91, 512, 8)),
         ("bert640_b1", (1, 91, 640, 8)), ("bert512_b1", (1, 91, 512, 8)))
# B4 at the train batch (d = 512 and 640) and a ragged one
BBCS = ((1024, 512), (1000, 512), (1024, 640))
# B1, B2 and B10 in fp32 at chip_smoke.py phase 2's fp32 shapes (b, s, w,
# heads, causal); B10 at the text towers only (its head dim and S)
F32_TOWERS = (("vit_b32", (32, 197, 768, 12, False)), ("text_b32", (32, 77, 512, 8, True)),
              ("text_b1", (1, 77, 512, 8, True)), ("rn_text_b32", (32, 77, 640, 10, True)),
              ("rn_text_b1", (1, 77, 640, 10, True)))
# the bf16 products of B1 and B2 (M, K, N, residual, activation): ViT-B-16
# at the gallery batch (32 x 197) and the embed batch (128 x 197), the
# RN50x4 text tower's c_fc at a query batch of 32
BF16_GEMMS = tuple((f"vit_{name}_m{m}", (m, k, n, res, act))
                   for m in (32 * 197, 128 * 197)
                   for name, k, n, res, act in (("qkv", 768, 2304, False, None),
                                                ("out_proj", 768, 768, True, None),
                                                ("c_fc", 768, 3072, False, "quick_gelu"),
                                                ("c_proj", 3072, 768, True, None)))
BF16_GEMMS += (("rn_text_c_fc_m2464", (32 * 77, 640, 2560, False, "quick_gelu")),)
BLOCKS = (("text_b1", (1, 77, 512, 8)), ("text_b32", (32, 77, 512, 8)),
          ("rn_text_b32", (32, 77, 640, 10)))
# B11 at RN50x4 ln_final (bf16), the DVR BERT's LNs (fp32) and the ViT's
# ln_pre at B = 128 (bf16): (rows, W, eps, dtype)
LNS = (("ln_final", (32 * 77, 640, 1e-5, torch.bfloat16)),
       ("bert_ln", (32 * 91, 640, 1e-12, torch.float32)),
       ("vit_ln_pre", (128 * 197, 768, 1e-5, torch.bfloat16)))
# B12 at a query's rows (1, 32), an index refine batch (128) and the
# validation's (1024), d = 512 and 640, fp32 (the ERN stack's type)
COMBINERS = tuple((d, m) for d in (512, 640) for m in (1, 32, 128, 1024))


def attention_cases(g: torch.Generator) -> dict:
    """name -> call of X2, B8, B9's grouped route and X1 on seeded bf16
    operands, and SDPA on B3's ViT-B-16 operands."""
    from fashionern_aaai2024_tpu_torch.ops import attn_experiment as XA

    def t(*shape):
        return torch.randn(shape, generator=g).to(torch.bfloat16).cuda()

    def padding_bias(sk):
        bias = torch.zeros((XA.SP, sk))
        bias[:, XA.S:] = -1e30
        return bias.cuda()

    scale = XA.DH ** -0.5
    qkv = t(XA.B, XA.SP, 3 * XA.W)
    qkv[:, XA.S:] = 0
    x2_bias = padding_bias(XA.SP)
    pool_q, pool_kv = t(128, 1, 2560), t(128, 82, 5120)
    b9 = [t(32, s, 8 * 128).view(32, s, 8, 128).transpose(1, 2) for s in (77, 300, 300)]
    b9_bias = (2 * torch.randn((77, 300), generator=g)).cuda()
    x1 = [torch.zeros((XA.B * XA.H, rows, XA.DP), dtype=torch.bfloat16, device="cuda")
          for rows in (XA.SP, XA.SKP, XA.SKP)]
    for op in x1:
        op[:, :XA.S, :XA.DH] = t(XA.B * XA.H, XA.S, XA.DH)
    x1_bias = padding_bias(XA.SKP)
    vit = t(32, 197, 3 * 768).view(32, 197, 3, 12, 64).permute(2, 0, 3, 1, 4)
    return {
        "x2_b128_gb1": lambda: XA.mha_packed(qkv, x2_bias, scale, 1),
        "b8_attnpool": lambda: A.packed_kv_cross_attention(pool_q, pool_kv, 40),
        "b9_grouped_sk300_dh128": lambda: A.multi_head_attention(*b9, bias=b9_bias),
        "x1_g1": lambda: XA.mha_grouped(*x1, x1_bias, scale, 1),
        "sdpa_vit_b32": lambda: torch.nn.functional.scaled_dot_product_attention(*vit),
    }


def fp32_attention(label: str, g: torch.Generator) -> None:
    """The fp32 attention sites in bursts, each beside SDPA on the same
    operands (the library yardstick): B8 at the MR cross-attention (b = 32
    and 1, 77 rows against 13 keys, 8 heads of 80) and the RN50x4
    attention pool, B9 at TME's [32, 8, 77, 64] x 13 keys with a bias, X1
    at G=1 on its padded operands."""
    from fashionern_aaai2024_tpu_torch.ops import attn_experiment as XA

    F = torch.nn.functional

    def t(*shape):
        return torch.randn(shape, generator=g).cuda()

    def heads(x, h):
        b, s, w = x.shape
        return x.view(b, s, h, w // h).transpose(1, 2)

    cases = {}
    for name, (b, sq, sk, w, h) in (("b8_mr640_b32", (32, 77, 13, 640, 8)),
                                    ("b8_mr640_b1", (1, 77, 13, 640, 8)),
                                    ("b8_attnpool", (128, 1, 82, 2560, 40))):
        q, kv = t(b, sq, w), t(b, sk, 2 * w)
        cases[name] = ((lambda q=q, kv=kv, h=h: A.packed_kv_cross_attention(q, kv, h)),
                       (lambda q=q, kv=kv, h=h, w=w: F.scaled_dot_product_attention(
                           heads(q, h), heads(kv[..., :w], h), heads(kv[..., w:], h))))
    q, k, v = (heads(t(32, s, 512), 8) for s in (77, 13, 13))
    bias = 2 * t(77, 13)
    cases["b9_tme512_b32"] = (lambda: A.multi_head_attention(q, k, v, bias=bias),
                              lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias))
    x1 = [torch.zeros((XA.B * XA.H, rows, XA.DP), device="cuda")
          for rows in (XA.SP, XA.SKP, XA.SKP)]
    for op in x1:
        op[:, :XA.S, :XA.DH] = t(XA.B * XA.H, XA.S, XA.DH)
    x1_bias = torch.zeros((XA.SP, XA.SKP), device="cuda")
    x1_bias[:, XA.S:] = -1e30
    scale = XA.DH ** -0.5
    cases["x1_g1"] = (lambda: XA.mha_grouped(*x1, x1_bias, scale, 1),
                      lambda: F.scaled_dot_product_attention(
                          *(o[:, None] for o in x1), attn_mask=x1_bias, scale=scale))
    print(label, "fp32 attention ms (bursts; SDPA):", "; ".join(
        f"{name}/float32 {median_ms(kernel):.4f} ({median_ms(library):.4f})"
        for name, (kernel, library) in cases.items()), flush=True)


# the fp32 sites of the attention core, as (name, (b, sq, sk, heads, dh,
# causal, bias, layout)): B3 at ViT-B-16 B=32, B7's core at bert640 b = 1
# and 32, B1's core (and B10's attention phase) at the text tower b = 1
# and 32, B8 at MR b = 32 and the RN50x4 pool, B9 at TME with a bias
CORE_F32_SITES = (("b3_vit_b32", (32, 197, 197, 12, 64, False, False, "packed")),
                  ("b7_core_bert640_b1", (1, 91, 91, 8, 80, False, False, "packed")),
                  ("b7_core_bert640_b32", (32, 91, 91, 8, 80, False, False, "packed")),
                  ("b1_core_text_b1", (1, 77, 77, 8, 64, True, False, "packed")),
                  ("b1_core_text_b32", (32, 77, 77, 8, 64, True, False, "packed")),
                  ("b8_mr640_b32", (32, 77, 13, 8, 80, False, False, "cross")),
                  ("b8_attnpool", (128, 1, 82, 40, 64, False, False, "cross")),
                  ("b9_tme512_b32", (32, 77, 13, 8, 64, False, True, "heads")))


def fp32_bodies(label: str, g: torch.Generator) -> None:
    """The two fp32 attention bodies at the core's fp32 sites, in bursts:
    the core's kernel (one pass over a whole staged head; `fern_attention`)
    and the grouped kernel (two passes over 32-key chunks, `split_rows`,
    one pair a block; `fern_attention_grouped`), each launched through its
    C entry point with no wrapper around it, on the same operands and
    layouts into a preallocated output (a causal row set: the core's
    causal flag, the grouped kernel's -1e30 bias); with the largest
    difference of their outputs."""
    code, dev = common.DTYPE_CODES[torch.float32], torch.cuda.current_device()
    stream = common.stream_of(torch.empty(0, device="cuda"))
    out = []
    for name, (b, sq, sk, heads, dh, causal, with_bias, layout) in CORE_F32_SITES:
        w = heads * dh
        if layout == "packed":
            qkv = torch.randn((b, sq, 3 * w), generator=g).cuda()
            q, k, v, q_ld, kv_ld = qkv, qkv[..., w:], qkv[..., 2 * w:], 3 * w, 3 * w
        elif layout == "cross":
            q, kv = (torch.randn(shape, generator=g).cuda() for shape in ((b, sq, w),
                                                                          (b, sk, 2 * w)))
            k, v, q_ld, kv_ld = kv, kv[..., w:], w, 2 * w
        else:
            q, k, v = (torch.randn((b, s, w), generator=g).cuda() for s in (sq, sk, sk))
            q_ld = kv_ld = w
        bias = (2 * torch.randn((sq, sk), generator=g)).cuda() if with_bias else None
        shared = A.shared_bias(True, None, sq, sk, "cuda") if causal else bias
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        got, want = (torch.empty((b, sq, w), device="cuda") for _ in range(2))
        core = lambda: common.launch(
            "fern_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(bias),
            got.data_ptr(), b, sq, sk, heads, dh, q_ld, kv_ld, int(causal), dh ** -0.5, code,
            code, 1, dev, stream)
        grouped = lambda: common.launch(
            "fern_attention_grouped", q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(shared),
            want.data_ptr(), b, sq, sk, heads, dh, q_ld, kv_ld, 1, 1, dh ** -0.5, code, dev,
            stream)
        core()
        grouped()
        diff = (got - want).abs().max().item()
        out.append(f"{name}/float32 core {median_ms(core):.4f} grouped {median_ms(grouped):.4f} "
                   f"(max diff {diff:.2e})")
    print(label, "fp32 attention bodies ms (bursts):", "; ".join(out), flush=True)


def median_ms(fn, windows: int = 20, calls: int = 10) -> float:
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


def call_ms(fn, runs: int = 25) -> float:
    """Median CUDA-event time of one call (its host enqueue included,
    as `chip_smoke.py median_ms` times a kernel)."""
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


def host_us(fn, calls: int = 2000) -> float:
    """Median host time of one call, no synchronisation between calls."""
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


def combiner(d: int, dtype: torch.dtype, g: torch.Generator):
    """A CombinerSimple with seeded weights (std in^-1/2, biases 0.02)."""
    from fashionern_aaai2024_tpu_torch.models.ern.fusion import CombinerSimple

    m = CombinerSimple(d)
    with torch.no_grad():
        for name, p in m.named_parameters():
            std = 0.02 if name.endswith("bias") else p.shape[1] ** -0.5
            p.copy_(torch.randn(p.shape, generator=g) * std)
    return m.to("cuda", dtype).eval()


def combiner_library(image, text, module):
    """The combiner as one `F.linear` composition (the yardstick)."""
    F = torch.nn.functional
    layers = (module.text_projection_layer[0], module.image_projection_layer[0],
              module.dynamic_scalar[0], module.dynamic_scalar[3])
    tp = F.relu(F.linear(text, layers[0].weight, layers[0].bias))
    ip = F.relu(F.linear(image, layers[1].weight, layers[1].bias))
    h = F.relu(F.linear(torch.cat([tp, ip], dim=-1), layers[2].weight, layers[2].bias))
    sigma = torch.sigmoid(F.linear(h, layers[3].weight, layers[3].bias))
    return F.normalize(sigma * text + (1.0 - sigma) * image, dim=-1)


def ln_and_combiner(label: str, g: torch.Generator) -> None:
    """B11 and B12: per call (enqueue included) and in bursts, beside
    their library calls; then the host µs of one call of `layer_norm`,
    `combiner_apply` and `launch_gemm`."""
    from fashionern_aaai2024_tpu_torch.ops import combiner as Cb
    from fashionern_aaai2024_tpu_torch.ops import layernorm as LN

    F = torch.nn.functional
    out = []
    for name, (rows, w, eps, dtype) in LNS:
        x = (2.0 + torch.randn((rows, w), generator=g)).to(dtype).cuda()
        gam = (1.0 + 0.1 * torch.randn(w, generator=g)).to(dtype).cuda()
        bet = (0.1 * torch.randn(w, generator=g)).to(dtype).cuda()
        kernel = lambda: LN.layer_norm(x, gam, bet, eps)
        library = lambda: F.layer_norm(x, (w,), gam, bet, eps)
        out.append(f"{name}/{str(dtype)[6:]} call {call_ms(kernel):.4f} burst "
                   f"{median_ms(kernel):.4f} (F.layer_norm call {call_ms(library):.4f} burst "
                   f"{median_ms(library):.4f})")
    print(label, "B11 ms:", "; ".join(out), flush=True)
    out = []
    with torch.no_grad():
        for d, m in COMBINERS:
            module = combiner(d, torch.float32, g)
            image, text = (torch.randn((m, d), generator=g).cuda() for _ in range(2))
            kernel = lambda: Cb.combiner_apply(image, text, module)
            library = lambda: combiner_library(image, text, module)
            out.append(f"d{d}_m{m}/float32 call {call_ms(kernel):.4f} burst "
                       f"{median_ms(kernel):.4f} (F.linear call {call_ms(library):.4f} burst "
                       f"{median_ms(library):.4f})")
            del module
        print(label, "B12 ms:", "; ".join(out), flush=True)
        out = []
        for dtype in (torch.float32, torch.bfloat16):
            x, w, b = (torch.randn(shape, generator=g).to(dtype).cuda()
                       for shape in ((8, 640), (640,), (640,)))
            module = combiner(64, dtype, g)
            image, text = (torch.randn((1, 64), generator=g).to(dtype).cuda() for _ in range(2))
            a, wt = (torch.randn(shape, generator=g).to(dtype).cuda()
                     for shape in ((8, 512), (512, 512)))
            out.append(f"{str(dtype)[6:]} layer_norm "
                       f"{host_us(lambda: LN.layer_norm(x, w, b, 1e-5)):.2f} combiner_apply "
                       f"{host_us(lambda: Cb.combiner_apply(image, text, module)):.2f} "
                       f"launch_gemm {host_us(lambda: common.launch_gemm(a, wt, None)):.2f}")
    print(label, "host us a call (median of 2000; LN [8, 640], combiner M=1 d=64, GEMM M=8 "
          "K=N=512):", "; ".join(out), flush=True)


def fp32_kernels(label: str, g: torch.Generator) -> None:
    """B7 and B4 per call and in bursts beside their library calls, B7's
    two launches apart, then B1, B2 and B10 in fp32 in bursts."""
    F = torch.nn.functional
    from fashionern_aaai2024_tpu_torch.ops import losses as L

    out = []
    for name, (b, s, w, heads) in BERTS:
        x = torch.randn((b, s, w), generator=g).cuda()
        wt, bias = ((0.02 * torch.randn(shape, generator=g)).cuda()
                    for shape in ((3 * w, w), (3 * w,)))
        kernel = lambda: A.fused_qkv_self_attention(x, wt, bias, heads)

        def library():
            qkv = F.linear(x, wt, bias).view(b, s, 3, heads, w // heads).permute(2, 0, 3, 1, 4)
            return F.scaled_dot_product_attention(*qkv).transpose(1, 2).reshape(b, s, w)

        qkv = common.launch_gemm(x.view(b * s, w), wt, bias).view(b, s, 3 * w)
        gemm = median_ms(lambda: common.launch_gemm(x.view(b * s, w), wt, bias))
        core = median_ms(lambda: A.packed_qkv_self_attention(qkv, heads))
        out.append(f"{name}/float32 call {call_ms(kernel):.4f} burst {median_ms(kernel):.4f} "
                   f"(projection {gemm:.4f}, core {core:.4f}; F.linear + SDPA call "
                   f"{call_ms(library):.4f} burst {median_ms(library):.4f})")
    print(label, "B7 ms:", "; ".join(out), flush=True)
    out = []
    for b, d in BBCS:
        pred, tar = (F.normalize(torch.randn((b, d), generator=g), dim=-1).cuda()
                     for _ in range(2))
        labels = torch.arange(b, device="cuda")
        kernel = lambda: L.bbc_rowloss(pred, tar)
        library = lambda: F.cross_entropy(100.0 * pred @ tar.t(), labels, reduction="none")
        out.append(f"b{b}_d{d}/float32 call {call_ms(kernel):.4f} burst {median_ms(kernel):.4f} "
                   f"(F.cross_entropy call {call_ms(library):.4f} burst "
                   f"{median_ms(library):.4f})")
    print(label, "B4 ms:", "; ".join(out), flush=True)
    from fashionern_aaai2024_tpu_torch.ops import block as B

    out = []
    for name, (b, s, w, heads, causal) in F32_TOWERS:
        f = 4 * w
        shapes = ((b, s, w), (w,), (w,), (3 * w, w), (3 * w,), (w, w), (w,), (w,), (w,),
                  (f, w), (f,), (w, f), (w,))
        args = [(0.02 * torch.randn(shape, generator=g)).cuda() for shape in shapes]
        args[0] = args[0] * 50.0
        b1 = median_ms(lambda: A.attention_subblock(*args[:7], heads, causal=causal))
        b2 = median_ms(lambda: M.mlp_subblock(args[0], *args[7:]))
        text = f"{name}/float32 B1 {b1:.4f} B2 {b2:.4f}"
        if causal:
            b10 = median_ms(lambda: B._launch_block(*args, heads, True, "quick_gelu", None, 1e-5))
            text += f" B10 {b10:.4f}"
        out.append(text)
        del args
    print(label, "fp32 towers ms (bursts):", "; ".join(out), flush=True)


def slices(label: str) -> None:
    """The checkout's chip_smoke.py phases 3-4, 6, 9 and 10."""
    import chip_smoke as cs

    card = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for tier, model, quantize in (("bf16", "ViT-B-16", False), ("int8", "ViT-B-16", True),
                                  ("rn50x4 bf16", "RN50x4", False)):
        _, service, api = cs.phase_slice(card, model_name=model, quantize=quantize)
        timings = cs.phase_timings(service, api)[0]
        out[tier] = (timings["embed_refine_img_per_s"], timings["query_p50_ms_b1"],
                     timings["query_p50_ms_b32"])
        del service, api
        torch.cuda.empty_cache()
    train = cs.phase_train(card)
    print(label, "slices:", "; ".join(f"{tier} embed+refine {img:.2f} img/s, query P50 "
                                      f"{p1:.3f} / {p32:.3f} ms (b=1 / 32)"
                                      for tier, (img, p1, p32) in out.items()),
          f"; train step {train['median_step_ms_from_2']:.2f} ms (B=1024) ({card})", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ab_attention: CUDA is not available")
    label = sys.argv[1] if len(sys.argv) > 1 else "checkout"
    if "--slices" in sys.argv[2:]:
        slices(label)
        return
    g = torch.Generator().manual_seed(0)
    if "--bodies" in sys.argv[2:]:
        fp32_bodies(label, g)
        return
    out = []
    for shape, (b, s, w, heads, causal), dtype in SHAPES:
        qkv = torch.randn((b, s, 3 * w), generator=g).to(dtype).cuda()
        ms = median_ms(lambda: A.packed_qkv_self_attention(qkv, heads, causal=causal))
        out.append(f"{shape}/{str(dtype)[6:]} {ms:.4f}")
    print(label, "B3 ms:", "; ".join(out), flush=True)
    out = []
    for name, (m, k, n) in GEMMS:
        a, w, b = (torch.randn(shape, generator=g).cuda() for shape in ((m, k), (n, k), (n,)))
        text = f"{name}/float32 {median_ms(lambda: common.launch_gemm(a, w, b)):.4f}"
        if hasattr(common, "f32_tile"):  # the 3xTF32 GEMM: each tile width apart
            widths = ", ".join(
                f"tile {t} {median_ms(lambda: common._gemm(a, w, b, None, None, None, t)):.4f}"
                for t in (32, 64, 128))
            text += f" ({widths}; the rule's {common.f32_tile(m, n, common.sm_count(0))})"
        out.append(text)
    print(label, "fp32 GEMM ms:", "; ".join(out), flush=True)
    fp32_kernels(label, g)
    fp32_attention(label, g)
    out = []
    for name, (m, k, n, with_res, act) in BF16_GEMMS:
        a, w, b, res = (None if shape is None else
                        (scale * torch.randn(shape, generator=g)).to(torch.bfloat16).cuda()
                        for shape, scale in (((m, k), 1.0), ((n, k), 0.02), ((n,), 0.02),
                                             ((m, n) if with_res else None, 1.0)))
        kernel = median_ms(lambda: common.launch_gemm(a, w, b, residual=res, activation=act))
        linear = median_ms(lambda: torch.nn.functional.linear(a, w, b))
        tflops = 2e-9 * m * n * k
        out.append(f"{name}/bfloat16 {kernel:.4f} ({tflops / kernel:.1f} TFLOP/s; F.linear "
                   f"{linear:.4f}, {tflops / linear:.1f})")
    print(label, "bf16 GEMM ms:", "; ".join(out), flush=True)
    ln_and_combiner(label, g)
    if importlib.util.find_spec("fashionern_aaai2024_tpu_torch.ops.attn_experiment") is not None:
        cases = attention_cases(g)
        print(label, "attention ms:", "; ".join(f"{name}/bfloat16 {median_ms(fn):.4f}"
                                                for name, fn in cases.items()), flush=True)
        del cases
    if importlib.util.find_spec("fashionern_aaai2024_tpu_torch.ops.block") is None:
        return
    from fashionern_aaai2024_tpu_torch.ops import block as B

    out = []
    for name, (b, s, w, heads) in BLOCKS:
        f = 4 * w
        shapes = ((b, s, w), (w,), (w,), (3 * w, w), (3 * w,), (w, w), (w,), (w,), (w,),
                  (f, w), (f,), (w, f), (w,))
        args = [(0.02 * torch.randn(shape, generator=g)).to(torch.bfloat16).cuda()
                for shape in shapes]
        block = median_ms(lambda: B._launch_block(*args, heads, True, "quick_gelu", None, 1e-5))
        pair = median_ms(lambda: M.mlp_subblock(A.attention_subblock(*args[:7], heads,
                                                                     causal=True), *args[7:]))
        out.append(f"{name}/bfloat16 B10 {block:.4f} B1+B2 {pair:.4f}")
    print(label, "block ms:", "; ".join(out), flush=True)


if __name__ == "__main__":
    main()
