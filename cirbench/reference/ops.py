"""The products of the reference, and the lower-precision control.

`PLAIN` runs every matrix product and convolution in fp32 on fp32
operands (the caller turns TF32 off: `exact_fp32`). The controls put the
reference one precision step below what the configuration states, in the
program's place (`LOWER`: the parts stated in bf16 on `FP8` operands,
the parts stated in fp32 on `BF16` operands):
  * `FP8`: both operands rounded to float8 e4m3, each row (each output
    channel of a weight) scaled so that its largest magnitude maps to
    e4m3's largest finite value, 448, as an fp8 deployment quantizes;
  * `BF16`: both operands rounded to bfloat16.
The products themselves accumulate in fp32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def exact_fp32():
    """A context in which fp32 products and convolutions run in fp32
    (no TF32) on the card; on the CPU they always do."""
    stack = contextlib.ExitStack()
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def restore():
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    stack.callback(restore)
    return stack


class Ops:
    """fp32 products on fp32 operands; subclasses round the operands."""

    def round(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return t.float()

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None):
        """x @ w.T + b, w in nn.Linear's [out, in] layout."""
        out = self.round(x, -1) @ self.round(w, -1).t()
        return out if b is None else out + b.float()

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.round(a, -1) @ self.round(b, -2)

    def batch_norm(self, x: torch.Tensor, W: dict, pre: str) -> torch.Tensor:
        """Frozen BatchNorm over channel axis 1 and its running statistics
        (eps 1e-5)."""
        shape = (1, -1) + (1,) * (x.ndim - 2)
        scale = W[pre + "weight"].float() * torch.rsqrt(W[pre + "running_var"].float() + 1e-5)
        return ((x - W[pre + "running_mean"].float().reshape(shape)) * scale.reshape(shape)
                + W[pre + "bias"].float().reshape(shape))

    def conv2d(self, x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0):
        return F.conv2d(self.round(x, 1), self.round(w.reshape(w.shape[0], -1), -1)
                        .reshape(w.shape), stride=stride, padding=padding)


class FP8(Ops):
    def round(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        t = t.float()
        amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
        scale = E4M3_MAX / amax
        return (t * scale).to(torch.float8_e4m3fn).float() / scale


class BF16(Ops):
    def round(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return t.to(torch.bfloat16).float()


PLAIN = Ops()
# (the bf16 parts' products, the fp32 parts'): exact, and one step below
EXACT = (PLAIN, PLAIN)
LOWER = (FP8(), BF16())
