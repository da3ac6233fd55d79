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
three `csrc/gemm.cu` products (the two projections with a ReLU epilogue
written straight into the two halves of one [M, 8d] concat buffer, then
the hidden layer) and the row kernel of `csrc/combiner.cu` (gate dot
product, sigmoid, blend, L2 norm). fp32 takes `gemm.cu`'s SIMT path (the
ERN stack is fp32), with the hidden product split over K into fp32
partial products that the row kernel sums, adds the bias to and ReLUs
(`_split_k`); bf16 takes the WMMA path with a bias + ReLU epilogue. A CPU tensor takes
`combiner_apply_plain`. Train mode keeps the module's plain path with its
dropout, as the JAX module does (`:16-18`).

`module` is a `CombinerSimple` (or anything with its four Linear layers
at `text_projection_layer[0]`, `image_projection_layer[0]`,
`dynamic_scalar[0]` and `dynamic_scalar[3]`), weights in the torch
layout [out, in].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fashionern_aaai2024_tpu_torch.ops import common

NORM_EPS = 1e-12
_TILE, _K_TILE = 64, 16        # gemm.cu's fp32 block tile and k tile


def _weights(module) -> tuple[torch.Tensor, ...]:
    """(W_t, b_t, W_i, b_i, W_h, b_h, w_o, b_o) of a CombinerSimple."""
    layers = (module.text_projection_layer[0], module.image_projection_layer[0],
              module.dynamic_scalar[0], module.dynamic_scalar[3])
    return tuple(t for lin in layers for t in (lin.weight, lin.bias))


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


def _split_k(m: int, n: int, k: int, sms: int) -> tuple[int, int]:
    """(k_per, splits) of the fp32 [m, k] x [k, n] hidden product on a
    card of `sms` SMs: enough K slices for about four 64 x 64 tiles per SM
    (one SIMT tile leaves an SM waiting on memory, and at M <= 128 the row
    tiles are few), each slice at least 512 deep and a whole number of
    16-deep k tiles."""
    tiles = -(-m // _TILE) * -(-n // _TILE)
    splits = max(1, min(k // 512, -(-4 * sms // tiles)))
    k_per = -(-k // (splits * _K_TILE)) * _K_TILE
    return k_per, -(-k // k_per)


def combiner_apply(image: torch.Tensor, text: torch.Tensor, module) -> torch.Tensor:
    """Eval CombinerSimple forward of image and text [M, d] (B12).

    CUDA: three GEMMs and the gate kernel, fp32 or bf16, every weight in
    the inputs' dtype. CPU: the plain version."""
    if not common.is_cuda(image):
        return combiner_apply_plain(image, text, module)
    if image.ndim != 2 or text.shape != image.shape:
        raise ValueError(f"combiner_apply: image {tuple(image.shape)}, text "
                         f"{tuple(text.shape)}; expected two [M, d]")
    image, text = image.contiguous(), text.contiguous()
    weights = _weights(module)
    common.check_cuda_operands("combiner_apply", image, text, *weights)
    wt, bt, wi, bi, wh, bh, wo, bo = weights
    m, d = image.shape
    p, hd = wt.shape[0], wh.shape[0]
    if (wt.shape != (p, d) or wi.shape != (p, d) or wh.shape != (hd, 2 * p)
            or wo.shape != (1, hd) or bo.shape != (1,)):
        raise ValueError(f"combiner_apply: weights {[tuple(w.shape) for w in weights]} "
                         f"for d={d}")
    dev, stream = image.device, common.stream_of(image)
    cat = torch.empty((m, 2 * p), dtype=image.dtype, device=dev)
    common.launch_gemm(text, wt, bt, activation="relu", out=cat[:, :p])
    common.launch_gemm(image, wi, bi, activation="relu", out=cat[:, p:])
    if image.dtype == torch.float32:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        k_per, splits = _split_k(m, hd, 2 * p, sms)
        hp = torch.empty((splits, m, hd), dtype=torch.float32, device=dev)
        common.launch("fern_gemm_f32_partials", cat.data_ptr(), wh.data_ptr(), hp.data_ptr(),
                      m, hd, 2 * p, k_per, dev.index, stream)
        h_ptr, hp_ptr = None, hp.data_ptr()
    else:
        h = common.launch_gemm(cat, wh, bh, activation="relu")
        h_ptr, hp_ptr, splits = h.data_ptr(), None, 0
    out = torch.empty_like(image)
    common.launch("fern_combiner_gate", h_ptr, hp_ptr, splits, bh.data_ptr(), wo.data_ptr(),
                  bo.data_ptr(), text.data_ptr(), image.data_ptr(), out.data_ptr(), m, d, hd,
                  common.DTYPE_CODES[image.dtype], dev.index, stream)
    combiner_apply.launches += 1
    return out


combiner_apply.launches = 0
