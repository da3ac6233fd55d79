"""Times the attention core (kernel B3, `packed_qkv_self_attention`),
the attention kernels beside it (X2, B8, B9's grouped route, X1), the
fp32 SIMT GEMM (`ops/common.py launch_gemm`, which the fp32 tiers of
B1, B2 and B7 and kernel B12 share) and the whole-block kernel B10
against the B1 + B2 pair it replaces, of the checkout in the current
directory on one CUDA card.

    cd <checkout> && python3 <path>/ab_attention.py LABEL

Prints four lines: LABEL and the median over 20 windows (after 5 warm-up
calls) of the CUDA-event time of 10 back-to-back calls, divided by 10 (the
device's time per call where the host keeps ahead of it), of B3 at ViT-B-16 B=32 (bf16 and fp32), text B=32
(causal, bf16) and ViT-B-16 B=1024 (bf16); X2 (`mha_packed`, the padded
[128, 208, 2304] qkv with its padding bias, gb=1), B8 at the RN50x4
attention pool ([128, 1, 2560] against [128, 82, 5120], 40 heads), B9
through the grouped kernel at sk300_dh128 (head views [32, 8, 77, 128]
against [32, 8, 300, 128], an fp32 [77, 300] bias), X1 (`mha_grouped`,
G=1), all bf16, and SDPA on B3's ViT-B-16 B=32 bf16 operands (the
library yardstick, never called by the port); the GEMM with a bias at the
RN50x4 BERT's fused QKV projection (B7, [32*91, 640] x [640, 1920]) and
the ViT-B-16 c_fc (B2, [32*197, 768] x [768, 3072]); one transformer
block as B10 (one launch) and as B1 then B2, at the ViT-B-16 text tower
at b=1 and 32 and the RN50x4 text tower at b=32 (causal, bf16). To
compare two checkouts, run it in each in turns (parent, change, change,
parent) in one call on one card; the package is imported from the current
directory, so the script runs unchanged against an older checkout (one
without `ops/block.py` prints no B10 line, one without
`ops/attn_experiment.py` no attention line).

    cd <checkout> && python3 <path>/ab_attention.py LABEL --slices

runs instead the checkout's own `chip_smoke.py` serve slices of ViT-B-16
(bf16, then int8 towers and gallery) with their embed + refine img/s and
query P50s (phases 3-4, 6), and its train slice's step time at B=1024
(phase 9), and prints them on one line.
"""

import importlib.util
import os
import statistics
import sys

import torch

sys.path.insert(0, os.getcwd())
from fashionern_aaai2024_tpu_torch.ops import attention as A  # noqa: E402
from fashionern_aaai2024_tpu_torch.ops import common  # noqa: E402
from fashionern_aaai2024_tpu_torch.ops import mlp as M  # noqa: E402

SHAPES = (("vit_b32", (32, 197, 768, 12, False), torch.bfloat16),
          ("vit_b32", (32, 197, 768, 12, False), torch.float32),
          ("text_b32", (32, 77, 512, 8, True), torch.bfloat16),
          ("vit_b1024", (1024, 197, 768, 12, False), torch.bfloat16))
GEMMS = (("bert640_qkv", (32 * 91, 640, 1920)), ("vit_cfc", (32 * 197, 768, 3072)))
BLOCKS = (("text_b1", (1, 77, 512, 8)), ("text_b32", (32, 77, 512, 8)),
          ("rn_text_b32", (32, 77, 640, 10)))


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


def slices(label: str) -> None:
    """The checkout's chip_smoke.py phases 3-4, 6 and 9 (ViT-B-16)."""
    import chip_smoke as cs

    card = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for tier, quantize in (("bf16", False), ("int8", True)):
        _, service, api = cs.phase_slice(card, quantize=quantize)
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
    out = []
    for shape, (b, s, w, heads, causal), dtype in SHAPES:
        qkv = torch.randn((b, s, 3 * w), generator=g).to(dtype).cuda()
        ms = median_ms(lambda: A.packed_qkv_self_attention(qkv, heads, causal=causal))
        out.append(f"{shape}/{str(dtype)[6:]} {ms:.4f}")
    print(label, "B3 ms:", "; ".join(out), flush=True)
    out = []
    for name, (m, k, n) in GEMMS:
        a, w, b = (torch.randn(shape, generator=g).cuda() for shape in ((m, k), (n, k), (n,)))
        out.append(f"{name}/float32 {median_ms(lambda: common.launch_gemm(a, w, b)):.4f}")
    print(label, "fp32 GEMM ms:", "; ".join(out), flush=True)
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
