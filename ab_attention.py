"""Times the attention core (kernel B3, `packed_qkv_self_attention`),
the fp32 SIMT GEMM (`ops/common.py launch_gemm`, which the fp32 tiers of
B1, B2 and B7 and kernel B12 share) and the whole-block kernel B10
against the B1 + B2 pair it replaces, of the checkout in the current
directory on one CUDA card.

    cd <checkout> && python3 <path>/ab_attention.py LABEL

Prints three lines: LABEL and the median of 50 CUDA-event timings (after 5
warm-ups) of one call, B3 at ViT-B-16 B=32 (bf16 and fp32), text B=32
(causal, bf16) and ViT-B-16 B=1024 (bf16); the GEMM with a bias at the
RN50x4 BERT's fused QKV projection (B7, [32*91, 640] x [640, 1920]) and
the ViT-B-16 c_fc (B2, [32*197, 768] x [768, 3072]); one transformer
block as B10 (one launch) and as B1 then B2, at the ViT-B-16 text tower
at b=1 and 32 and the RN50x4 text tower at b=32 (causal, bf16). To
compare two checkouts, run it in each in turns (parent, change, change,
parent) in one call on one card; the package is imported from the current
directory, so the script runs unchanged against an older checkout (one
without `ops/block.py` prints no B10 line).
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


def median_ms(fn, runs: int = 50) -> float:
    for _ in range(5):
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ab_attention: CUDA is not available")
    g = torch.Generator().manual_seed(0)
    out = []
    for label, (b, s, w, heads, causal), dtype in SHAPES:
        qkv = torch.randn((b, s, 3 * w), generator=g).to(dtype).cuda()
        ms = median_ms(lambda: A.packed_qkv_self_attention(qkv, heads, causal=causal))
        out.append(f"{label}/{str(dtype)[6:]} {ms:.4f}")
    label = sys.argv[1] if len(sys.argv) > 1 else "checkout"
    print(label, "B3 ms:", "; ".join(out), flush=True)
    out = []
    for name, (m, k, n) in GEMMS:
        a, w, b = (torch.randn(shape, generator=g).cuda() for shape in ((m, k), (n, k), (n,)))
        out.append(f"{name}/float32 {median_ms(lambda: common.launch_gemm(a, w, b)):.4f}")
    print(label, "fp32 GEMM ms:", "; ".join(out), flush=True)
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
