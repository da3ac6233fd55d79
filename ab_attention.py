"""Times the attention core (kernel B3, `packed_qkv_self_attention`) of the
checkout in the current directory on one CUDA card.

    cd <checkout> && python3 <path>/ab_attention.py LABEL

Prints one line: LABEL and the median of 50 CUDA-event timings (after 5
warm-ups) of one call at ViT-B-16 B=32 (bf16 and fp32), text B=32
(causal, bf16) and ViT-B-16 B=1024 (bf16). To compare two checkouts,
run it in each in turns (parent, change, change, parent) in one call on
one card; the package is imported from the current directory, so the
script runs unchanged against an older checkout.
"""

import os
import statistics
import sys

import torch

sys.path.insert(0, os.getcwd())
from fashionern_aaai2024_tpu_torch.ops import attention as A  # noqa: E402

SHAPES = (("vit_b32", (32, 197, 768, 12, False), torch.bfloat16),
          ("vit_b32", (32, 197, 768, 12, False), torch.float32),
          ("text_b32", (32, 77, 512, 8, True), torch.bfloat16),
          ("vit_b1024", (1024, 197, 768, 12, False), torch.bfloat16))


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
    print(sys.argv[1] if len(sys.argv) > 1 else "checkout", "B3 ms:", "; ".join(out), flush=True)


if __name__ == "__main__":
    main()
