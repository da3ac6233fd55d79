"""The whole pre-LN transformer block for the port: kernel B10 and its
plain version.

JAX counterpart: `fashionern_aaai2024_tpu/ops/block.py` (`transformer_block`,
TPU kernel `_block_pallas` at `:99`):

    y = x + out_proj(attn(qkv(LN1(x))))
    z = y + c_proj(act(c_fc(LN2(y))))

On the TPU the whole block ran as one Pallas program with all four
weight matrices resident in VMEM, and the dispatch never picked it
(`pick = False`, `:210`: it tied the sub-block pair on v5e). On Hopper
the weights cannot stay on chip, and what one program per block buys is
one launch where the sub-block pair B1 + B2 takes seven (LN, GEMM,
core, GEMM; LN, GEMM, GEMM). `csrc/block.cu` is that launch: a
persistent cooperative kernel whose blocks run the seven phases between
grid-wide barriers, with the sub-block kernels' own device code, so its
results are B1 + B2's.

`transformer_block` dispatches by the tensor's device and one fixed rule
(`use_block_kernel`): a CPU tensor takes the plain version; a CUDA tensor
runs B10 where the rule says so, the B1 + B2 pair otherwise, and B10
through `BlockFunction` whenever autograd has to reach an operand. The
rule comes from the B10 against B1 + B2 timings of `chip_smoke.py` phase
2 and `ab_attention.py` (PERF.md, "Findings").

Weights are in the torch layout, as `attention_subblock` / `mlp_subblock`
take them: in_proj_weight [3W, W], out_proj weight [W, W], c_fc weight
[F, W], c_proj weight [W, F].
"""

from __future__ import annotations

import torch

from fashionern_aaai2024_tpu_torch.ops import common
from fashionern_aaai2024_tpu_torch.ops.attention import (
    attention_subblock,
    attention_subblock_plain,
)
from fashionern_aaai2024_tpu_torch.ops.mlp import mlp_subblock, mlp_subblock_plain

HEAD_DIM = 64
MAX_SEQ = 256
# B10 runs a block of at most this many rows (B*S): a query's text tower
# at b <= 32. On an H100 (PERF.md, "Findings") B10 beat or tied B1 + B2
# at 77 rows (b = 1) at both text widths and in both dtypes, and lost by
# 29-57% at 6,304 rows and more (the ViT-B-16 trunk at B = 32, the train
# path's text tower): one resident block per SM against B1 / B2's own
# grids, and phases that wait on their slowest tile. At 2,464 rows
# (b = 32) it trailed by 3-32% and runs there all the same, so that a
# query's text tower takes one launch per block. Width, mask and dtype
# do not enter the rule.
BLOCK_MAX_ROWS = 32 * 77

# one grid-barrier word per (device, stream): a launch flips its top bit
# and leaves the low bits zero, so the word is never reset
_BARRIERS: dict[tuple[int, int], torch.Tensor] = {}


def use_block_kernel(rows: int) -> bool:
    """The dispatch rule on CUDA tensors: B10 for a block of `rows` (B*S)
    rows, else B1 + B2."""
    return rows <= BLOCK_MAX_ROWS


def transformer_block_plain(x: torch.Tensor, ln1_w: torch.Tensor, ln1_b: torch.Tensor,
                            in_proj_w: torch.Tensor, in_proj_b: torch.Tensor,
                            out_w: torch.Tensor, out_b: torch.Tensor, ln2_w: torch.Tensor,
                            ln2_b: torch.Tensor, fc_w: torch.Tensor, fc_b: torch.Tensor,
                            proj_w: torch.Tensor, proj_b: torch.Tensor, heads: int, *,
                            causal: bool = False, activation: str = "quick_gelu",
                            scale: float | None = None, eps: float = 1e-5) -> torch.Tensor:
    """Plain version of B10: `_block_ref` (`:132-138`) with
    `_block_kernel`'s rounding points (`:48-93`), which are B1's then
    B2's: qkv, each head's output, y and the hidden cast to x.dtype;
    scores, softmax and every accumulator in fp32."""
    y = attention_subblock_plain(x, ln1_w, ln1_b, in_proj_w, in_proj_b, out_w, out_b, heads,
                                 causal=causal, scale=scale, eps=eps)
    return mlp_subblock_plain(y, ln2_w, ln2_b, fc_w, fc_b, proj_w, proj_b,
                              activation=activation, eps=eps)


def _barrier(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    if key not in _BARRIERS:
        _BARRIERS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _BARRIERS[key]


def _launch_block(x: torch.Tensor, ln1_w: torch.Tensor, ln1_b: torch.Tensor,
                  in_proj_w: torch.Tensor, in_proj_b: torch.Tensor, out_w: torch.Tensor,
                  out_b: torch.Tensor, ln2_w: torch.Tensor, ln2_b: torch.Tensor,
                  fc_w: torch.Tensor, fc_b: torch.Tensor, proj_w: torch.Tensor,
                  proj_b: torch.Tensor, heads: int, causal: bool, activation: str,
                  scale: float | None, eps: float) -> torch.Tensor:
    """Kernel B10 (csrc/block.cu) on CUDA operands: head dim 64, S <= 256,
    every operand of x's dtype (fp32 or bf16) and contiguous. Counts
    nothing: `transformer_block` does."""
    b, s, w = x.shape
    f = fc_w.shape[0]
    if heads * HEAD_DIM != w:
        raise ValueError(f"transformer_block: width {w} with {heads} heads; the kernel takes "
                         f"head dim {HEAD_DIM} only")
    if not 1 <= s <= MAX_SEQ:
        raise ValueError(f"transformer_block: S={s}; the kernel takes 1 to {MAX_SEQ} tokens")
    shapes = {"in_proj": (in_proj_w, (3 * w, w)), "out_proj": (out_w, (w, w)),
              "c_fc": (fc_w, (f, w)), "c_proj": (proj_w, (w, f))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"transformer_block: {name} weight {tuple(t.shape)}, expected "
                             f"{want} for width {w}")
    if f % 8:
        raise ValueError(f"transformer_block: hidden width {f} is not a multiple of 8")
    if activation not in ("quick_gelu", "gelu"):
        raise ValueError(f"unknown activation {activation!r}")
    common.check_cuda_operands("transformer_block", x, ln1_w, ln1_b, in_proj_w, in_proj_b,
                               out_w, out_b, ln2_w, ln2_b, fc_w, fc_b, proj_w, proj_b)
    if scale is None:
        scale = HEAD_DIM ** -0.5
    workspace = torch.empty(b * s * (3 * w + max(3 * w, f)), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    stream = common.stream_of(x)
    ptrs = [t.data_ptr() for t in (x, ln1_w, ln1_b, in_proj_w, in_proj_b, out_w, out_b,
                                   ln2_w, ln2_b, fc_w, fc_b, proj_w, proj_b)]
    common.launch("fern_block", *ptrs, workspace.data_ptr(),
                  _barrier(x.device, stream).data_ptr(), out.data_ptr(), b, s, w, f, heads,
                  int(causal), scale, eps, common.ACT_CODES[activation],
                  common.DTYPE_CODES[x.dtype], x.get_device(), stream)
    return out


class BlockFunction(torch.autograd.Function):
    """Forward: kernel B10. Backward: autograd of the plain composition,
    recomputed, with gradients for all 13 tensors (`_block_diff_bwd`,
    `:157-160`)."""

    @staticmethod
    def forward(ctx, x, ln1_w, ln1_b, in_proj_w, in_proj_b, out_w, out_b, ln2_w, ln2_b, fc_w,
                fc_b, proj_w, proj_b, heads: int, causal: bool, activation: str,
                scale: float | None, eps: float) -> torch.Tensor:
        tensors = (x, ln1_w, ln1_b, in_proj_w, in_proj_b, out_w, out_b, ln2_w, ln2_b, fc_w,
                   fc_b, proj_w, proj_b)
        ctx.save_for_backward(*tensors)
        ctx.config = (heads, causal, activation, scale, eps)
        return _launch_block(*tensors, heads, causal, activation, scale, eps)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        heads, causal, activation, scale, eps = ctx.config
        saved = [t.detach().requires_grad_(need)
                 for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[:13])]
        wanted = [t for t in saved if t.requires_grad]
        with torch.enable_grad():
            out = transformer_block_plain(*saved, heads, causal=causal, activation=activation,
                                          scale=scale, eps=eps)
        grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in saved),
                None, None, None, None, None)


def transformer_block(x: torch.Tensor, ln1_w: torch.Tensor, ln1_b: torch.Tensor,
                      in_proj_w: torch.Tensor, in_proj_b: torch.Tensor, out_w: torch.Tensor,
                      out_b: torch.Tensor, ln2_w: torch.Tensor, ln2_b: torch.Tensor,
                      fc_w: torch.Tensor, fc_b: torch.Tensor, proj_w: torch.Tensor,
                      proj_b: torch.Tensor, heads: int, *, causal: bool = False,
                      activation: str = "quick_gelu", scale: float | None = None,
                      eps: float = 1e-5) -> torch.Tensor:
    """One pre-LN transformer block, x [B, S, W] -> [B, S, W].

    CPU: the plain version. CUDA: kernel B10 (head dim 64, S <= 256)
    where `use_block_kernel` says so, through `BlockFunction` when
    autograd has to reach an operand; otherwise B1 then B2."""
    tensors = (x, ln1_w, ln1_b, in_proj_w, in_proj_b, out_w, out_b, ln2_w, ln2_b, fc_w, fc_b,
               proj_w, proj_b)
    if not common.is_cuda(x):
        return transformer_block_plain(*tensors, heads, causal=causal, activation=activation,
                                       scale=scale, eps=eps)
    b, s, _ = x.shape
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    if grad:
        out = BlockFunction.apply(*tensors, heads, causal, activation, scale, eps)
    elif use_block_kernel(b * s):
        out = _launch_block(*tensors, heads, causal, activation, scale, eps)
    else:
        y = attention_subblock(x, ln1_w, ln1_b, in_proj_w, in_proj_b, out_w, out_b, heads,
                               causal=causal, scale=scale, eps=eps)
        return mlp_subblock(y, ln2_w, ln2_b, fc_w, fc_b, proj_w, proj_b,
                            activation=activation, eps=eps)
    transformer_block.launches += 1
    return out


transformer_block.launches = 0
