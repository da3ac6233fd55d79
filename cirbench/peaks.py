"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit): the benchmark's roofline and MFU yardstick.

fp32 products count at the TF32 rate, the fastest the chip multiplies
fp32 operands, so that no way of running them reads over its roof. MFU
is model FLOPs over the bf16 peak, the chip's rate for the served
towers.
"""

from __future__ import annotations

from cirbench.flops import Work

FLOPS = {"bf16": 989e12, "fp32": 495e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
MFU_PEAK = FLOPS["bf16"]


def least_time_s(work: Work) -> float:
    """The larger of the work's operations at their type's peak and its
    bytes at the HBM rate."""
    ops = sum(f / FLOPS[kind] for kind, f in work.flops.items())
    return max(ops, work.bytes / HBM_BYTES_PER_S)
