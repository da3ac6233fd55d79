"""The sigma-gated combiner in eval: kernel B12 and its plain version.

JAX counterpart: `fashionern_aaai2024_tpu/ops/combiner.py` (`combiner_apply`,
TPU kernel `_combiner_pallas` at `:63`, body `_combiner_kernel` `:35-59`):

    text_p  = relu(text  @ W_t + b_t)          [M, 4d]
    image_p = relu(image @ W_i + b_i)          [M, 4d]
    h       = relu([text_p, image_p] @ W_h + b_h)   [M, 8d]
    sigma   = sigmoid(h @ w_o + b_o)           [M, 1]
    out     = normalize(sigma * text + (1 - sigma) * image)

`combiner_apply` is every eval `CombinerSimple` of the port
(`models/ern/fusion.py`): the index tower's and the DVR query tower's
three. On the TPU the JAX module never called the kernel, and at d = 640
its VMEM check refuses it (`:117-124`). Here a CUDA tensor launches it:
the two ReLU projections, written straight into the two halves of one
[M, 8d] concat buffer, the hidden layer, and the row kernel of
`csrc/combiner.cu` (gate dot product, sigmoid, blend, L2 norm). fp32 (the
ERN stack's type) runs its products on the tensor cores at fp32 accuracy
by 3xTF32 (`csrc/gemm_tf32.cu`: both projections in one launch, then the
hidden product, split over K into fp32 partial products that the row
kernel sums, adds the bias to and ReLUs where its tiles alone would leave
SMs idle, `hidden_k_slice`): three launches. bf16 takes the bf16 GEMM
(`csrc/gemm.cu`) with a bias + ReLU epilogue: four launches. A CPU tensor
takes `combiner_apply_plain`. Train mode keeps the module's plain path
with its dropout, as the JAX module does (`:16-18`).

`module` is a `CombinerSimple` (or any module with its four Linear
layers at `text_projection_layer[0]`, `image_projection_layer[0]`,
`dynamic_scalar[0]` and `dynamic_scalar[3]`), weights in the torch
layout [out, in].
"""

from __future__ import annotations

import functools
import operator

import torch
import torch.nn.functional as F

from fashionern_aaai2024_tpu_torch.ops import common

NORM_EPS = 1e-12
# gemm_tf32.cu's output tile (B12 runs the 128-wide one, without the
# K-tile fold: its products feed an L2-normalized row) and K tile; a K
# slice of the split hidden product is at least _MIN_SLICE_TILES K tiles
# deep
_TILE, _K_TILE, _MIN_SLICE_TILES = 128, 32, 8


def _weights(module) -> tuple[torch.Tensor, ...]:
    """(W_t, b_t, W_i, b_i, W_h, b_h, w_o, b_o) of a CombinerSimple,
    read from the module dicts (`Sequential[i]` costs microseconds a
    call)."""
    mods = module._modules
    hidden = mods["dynamic_scalar"]._modules
    layers = (mods["text_projection_layer"]._modules["0"],
              mods["image_projection_layer"]._modules["0"], hidden["0"], hidden["3"])
    return tuple(t for lin in layers for t in (lin._parameters["weight"],
                                                lin._parameters["bias"]))


def combiner_apply_plain(image: torch.Tensor, text: torch.Tensor, module) -> torch.Tensor:
    """The `_combiner_kernel` formula with its rounding points: each ReLU
    projection accumulated in fp32 with its bias, the concat cast to the
    input dtype, the hidden ReLU layer likewise, the gate logit in fp32,
    sigmoid, the blend in fp32, the L2 norm floored at 1e-12, the output
    cast to the input dtype."""
    wt, bt, wi, bi, wh, bh, wo, bo = (t.float() for t in _weights(module))
    dt = image.dtype
    tp = F.relu(F.linear(text.float(), wt, bt)).to(dt)
    ip = F.relu(F.linear(image.float(), wi, bi)).to(dt)
    h = F.relu(F.linear(torch.cat([tp, ip], dim=-1).float(), wh, bh)).to(dt)
    sigma = torch.sigmoid(F.linear(h.float(), wo, bo))
    out = sigma * text.float() + (1.0 - sigma) * image.float()
    norm = torch.sqrt(torch.sum(out * out, dim=-1, keepdim=True)).clamp_min(NORM_EPS)
    return (out / norm).to(dt)


def hidden_k_slice(m: int, n: int, k: int, sms: int) -> int:
    """K slice (k_per, a whole number of K tiles) of the fp32 hidden
    product [m, k] x [n, k]^T on a card of `sms` SMs; the product runs in
    ceil(k / k_per) slices. Split over K only where its 128 x 128 tiles
    alone would leave SMs idle (at M <= 128: 32-40 tiles, one block an
    SM): as many slices as the idle SMs allow, each at least
    _MIN_SLICE_TILES K tiles deep. At M = 1024 (256-320 tiles) k_per = k."""
    tiles = max(1, -(-m // _TILE) * -(-n // _TILE))  # an empty batch: one (empty) tile
    k_tiles = -(-k // _K_TILE)
    splits = max(1, min(sms // tiles, k_tiles // _MIN_SLICE_TILES))
    return -(-k_tiles // splits) * _K_TILE


def combiner_apply(image: torch.Tensor, text: torch.Tensor, module) -> torch.Tensor:
    """Eval CombinerSimple forward of image and text [M, d] (B12).

    CUDA: the products and the gate kernel, fp32 or bf16, every weight in
    the inputs' dtype; d a multiple of 8 and every operand but b_o at a
    16-byte aligned address, else it raises. CPU: the plain version."""
    if not common.is_cuda(image):
        return combiner_apply_plain(image, text, module)
    if image.ndim != 2 or text.shape != image.shape:
        raise ValueError(f"combiner_apply: image {tuple(image.shape)}, text "
                         f"{tuple(text.shape)}; expected two [M, d]")
    image, text = image.contiguous(), text.contiguous()
    weights = _weights(module)
    device = common.check_cuda_operands("combiner_apply", image, text, *weights)
    wt, bt, wi, bi, wh, bh, wo, bo = weights
    m, d = image.shape
    p, hd = wt.shape[0], wh.shape[0]
    if (wt.shape != (p, d) or wi.shape != (p, d) or wh.shape != (hd, 2 * p)
            or wo.shape != (1, hd) or bo.shape != (1,)):
        raise ValueError(f"combiner_apply: weights {[tuple(w.shape) for w in weights]} "
                         f"for d={d}")
    ptrs = [t.data_ptr() for t in (text, wt, bt, image, wi, bi, wh, bh, wo)]
    if d % 8 or p % 8 or hd % 8:
        raise ValueError(f"combiner_apply: d={d}, projection {p}, hidden {hd} must be "
                         "multiples of 8")
    if functools.reduce(operator.or_, ptrs) % 16:
        raise ValueError("combiner_apply: an operand starts at an address that is not a "
                         "multiple of 16 bytes")
    stream = common.stream_of(image)
    out = torch.empty_like(image)
    if image.dtype == torch.float32:
        k_per = hidden_k_slice(m, hd, 2 * p, common.sm_count(device))
        splits = -(-2 * p // k_per)
        # one buffer: the [M, 2p] concat, then h [M, hd] or the partials
        work = torch.empty(m * (2 * p + splits * hd), dtype=torch.float32, device=image.device)
        cat = work.data_ptr()
        h = cat + 4 * m * 2 * p
        relu = common.ACT_CODES["relu"]
        common.launch("fern_gemm_tf32", *ptrs[:6], None, cat, 2, m, p, d, 2 * p, relu,
                      -(-d // _K_TILE) * _K_TILE, _TILE, 0, device, stream)
        if splits == 1:
            common.launch("fern_gemm_tf32", cat, ptrs[6], ptrs[7], None, None, None, None, h, 1,
                          m, hd, 2 * p, hd, relu, k_per, _TILE, 0, device, stream)
            h_ptr, hp_ptr = h, None
        else:
            common.launch("fern_gemm_tf32", cat, ptrs[6], None, None, None, None, None, h, 1, m,
                          hd, 2 * p, hd, common.ACT_CODES[None], k_per, _TILE, 0, device, stream)
            h_ptr, hp_ptr = None, h
    else:
        cat = torch.empty((m, 2 * p), dtype=image.dtype, device=image.device)
        common.launch_gemm(text, wt, bt, activation="relu", out=cat[:, :p])
        common.launch_gemm(image, wi, bi, activation="relu", out=cat[:, p:])
        h = common.launch_gemm(cat, wh, bh, activation="relu")
        h_ptr, hp_ptr, splits = h.data_ptr(), None, 0
    common.launch("fern_combiner_gate", h_ptr, hp_ptr, splits, ptrs[7], ptrs[8], bo.data_ptr(),
                  ptrs[0], ptrs[3], out.data_ptr(), m, d, hd, common.DTYPE_CODES[image.dtype],
                  device, stream)
    combiner_apply.launches += 1
    return out


combiner_apply.launches = 0
