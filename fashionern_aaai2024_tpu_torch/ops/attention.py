"""Attention for the port: kernels B1, B3, B7, B8 and B9, and the plain
formulas.

JAX counterpart: `fashionern_aaai2024_tpu/ops/attention.py`.

  * `attention_subblock` (B1, TPU kernel `_subblock_pallas`, `:520`):
    x + out_proj(attention(qkv_proj(LN(x)))). On a CUDA tensor it runs
    four hand-written kernels (csrc/): LN, GEMM + bias, the attention
    core, GEMM + bias + residual. The TPU held both weight matrices in
    VMEM for one program per image; 227 KB of shared memory cannot, so
    the program is split where the data reuse changes.
  * `packed_qkv_self_attention` (B3, TPU kernel `_packed_pallas`,
    `:147`): attention straight from packed [B, S, 3W] qkv
    (csrc/attention.cu). It is also B1's attention core: B1 calls it,
    so each B1 launch counts one B3 launch too.
  * `fused_qkv_self_attention` (B7, TPU kernel `_qkv_fused_pallas`,
    `:388`): the QKV projection (csrc/gemm.cu, GEMM + bias) and then the
    attention core on the packed result, for the DVR query tower's
    mini-BERT in eval.
  * `packed_kv_cross_attention` (B8, TPU kernel `_packed_cross_pallas`,
    `:264`): cross-attention of q [B, Sq, W] against packed kv
    [B, Sk, 2W], the attention core in its cross layout at head dim 64
    or 80 (the RN50x4 attention pool, the DVR query tower's MR
    cross-attention), and every other head dim up to 1,024 on the wide
    route (csrc/attention_wide.cu: CaLa's single heads of 512 and 640,
    `models/zoo/cala.py`), where JAX runs the same formula in XLA
    (`_packed_cross_ref`, `:286-296`).
  * `multi_head_attention` (B9, TPU kernel `_mha_pallas`, `:84`):
    [B, H, Sq, Dh] queries against [B, H, Sk, Dh] keys and values with
    an optional shared [Sq, Sk] fp32 bias (causal, padding). With
    probability dropout (the train-mode BERT and MR attention) it is the
    plain `_mha_ref` formula, as in JAX (`:742`); otherwise a CUDA tensor
    launches the attention core on the operands' own strides (a head view
    of [B, S, H*Dh] rows, or contiguous [B, H, S, Dh]), through
    `MHAFunction` when a gradient is wanted (TME trains through it; its
    backward is the `_mha_ref` VJP, bias included, as
    `_mha_pallas_diff_bwd`, `:679`).
    JAX's dispatch gates the kernel to Sk >= 512 or Dh % 128 == 0
    (`:739`), 128-lane padding on the TPU; Hopper has no such limit, so
    here it runs at TME's shapes. Head dims 64 and 80 at Sk <= 256 take
    the attention core; every other even head dim up to 128, and any Sk,
    takes the grouped kernel (csrc/attention_grouped.cu, two passes over
    64-key chunks), so the port runs every shape JAX sends to the Pallas
    kernel. Head dims above 128 raise. Both kernels run on the tensor
    cores (16-row warp tiles, `mma.sync`, `cp.async` staging): bf16
    products in bf16, fp32 products by 3xTF32 (csrc/attention_tf32.cuh:
    three tf32 passes over each operand's hi / lo split, every partial
    folded into the fp32 sum on the CUDA cores), within the fp32
    tolerance of the plain version.

On the TPU the dispatch chose XLA at the B7, B8 and B9 sites (`:353`,
`:739`, and the bf16-only gate at `:466` that the fp32 fusion stack never
passed).
Here a CUDA tensor launches the kernel or raises; the plain versions
follow the Pallas kernels' rounding, not `_mha_ref`'s bf16 scores, so in
bf16 they differ from JAX's XLA formula (ROADMAP C6); in fp32 they agree.

One core kernel (csrc/attention.cu) serves every layout, at head dim 64
or 80 and at most 256 keys, with an optional shared fp32 bias and several
images a block: B3, B7 and B1 take that bias as `attn_bias`, which is how
the attention experiment's X2-X4 (`ops/attn_experiment.py`) run them; the
grouped kernel (csrc/attention_grouped.cu) takes the rest of B9 and the
experiment's X1.

Weights are in the torch layout: in_proj_weight [3W, W] and Linear
weight [out, in].

Each kernel has a plain version beside it with the Pallas kernel's
rounding points (LN output cast to x.dtype, bias added to the fp32
accumulator before the cast, scores and softmax in fp32, probabilities
normalized in fp32 then cast, each head's output cast, the projection
cast before `x + proj`). A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.

Every entry here differentiates on the card, as the JAX package's custom
VJPs do (`_packed_diff`, `_packed_cross_diff`, `_qkv_fused_diff`,
`_subblock_diff`, `_mha_pallas_diff`): where grad mode is on and an
operand requires grad, the launches run inside an autograd Function
(B1 `SubblockFunction`, B3 `PackedQKVFunction`, B7 `FusedQKVFunction`,
B8 `PackedCrossFunction` on either route, B9 `MHAFunction`) whose
backward is autograd of the plain version (B9's: `mha_ref`), recomputed
from the saved inputs (`ops/common.py plain_vjp`). The JAX package has
no Pallas backward for any of them, so neither has the port: the
backward is plain PyTorch. A call without gradients launches exactly as
it would without the Functions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fashionern_aaai2024_tpu_torch.ops import common, library
from fashionern_aaai2024_tpu_torch.ops.dropout import dropout
from fashionern_aaai2024_tpu_torch.ops.layernorm import layer_norm_plain

NEG_INF = -1e30
_HEAD_DIMS = (64, 80)
_MAX_SEQ = 256
# the grouped kernel: even head dims up to this, any key count
MAX_GROUPED_HEAD_DIM = 128
# B8's wide route (csrc/attention_wide.cu): every head dim up to this
# that the core does not take, at most MAX_WIDE_KEYS keys
MAX_WIDE_HEAD_DIM = 1024
MAX_WIDE_KEYS = 256
# B9 on the grouped kernel: one (b, h) pair and one query row tile (128
# rows) a block, the most blocks for the card's 132
# SMs (X1's G sweep: time grows with G past 4, as blocks run out)
MHA_GROUP = 1


def causal_bias(s: int, device: torch.device | str) -> torch.Tensor:
    """[S, S] fp32: 0 on and below the diagonal, -1e30 above."""
    keep = torch.ones((s, s), dtype=torch.bool, device=device).tril()
    return torch.where(keep, 0.0, NEG_INF).to(torch.float32)


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, w = t.shape
    return t.reshape(b, s, heads, w // heads).transpose(1, 2)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    b, h, s, dh = t.shape
    return t.transpose(1, 2).reshape(b, s, h * dh)


# --- the attention core: plain version and kernel launch -----------------


def attention_core_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, *,
                         causal: bool = False, scale: float | None = None,
                         out_dtype: torch.dtype | None = None,
                         attn_bias: torch.Tensor | None = None) -> torch.Tensor:
    """q [B, Sq, W], k and v [B, Sk, W] -> [B, Sq, W] with the Pallas
    kernels' rounding points (`_packed_kernel` `:124-143`,
    `_packed_cross_kernel` `:240-259`): fp32 scores times the scale plus
    the optional shared fp32 [Sq, Sk] `attn_bias`, softmax in fp32,
    p / denom cast to the operand dtype, fp32 P.V, output cast to
    `out_dtype` (default: the operand dtype; B6 keeps it fp32)."""
    sq, w = q.shape[1], q.shape[2]
    if scale is None:
        scale = (w // heads) ** -0.5
    qh, kh, vh = (_split_heads(t, heads).float() for t in (q, k, v))
    sc = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    if causal:
        sc = sc + causal_bias(sq, q.device)
    if attn_bias is not None:
        sc = sc + attn_bias
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(q.dtype).float()
    return _merge_heads(torch.matmul(p, vh).to(out_dtype or q.dtype))


def check_shared_bias(name: str, bias: torch.Tensor | None, sq: int, sk: int,
                      device: torch.device) -> None:
    """A kernel's shared bias: None, or a contiguous fp32 [Sq, Sk] tensor
    on the operands' device."""
    if bias is not None and (bias.shape != (sq, sk) or bias.dtype != torch.float32
                             or bias.device != device or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias {bias.dtype} {tuple(bias.shape)} on {bias.device}; "
                         f"expected contiguous float32 [{sq}, {sk}] on {device}")


def _launch_core(name: str, q: torch.Tensor, kv: torch.Tensor, *, w: int, sk: int,
                 heads: int, q_ld: int, kv_ld: int, k_col: int, v_col: int, causal: bool,
                 scale: float | None, out_dtype: torch.dtype, bias: torch.Tensor | None = None,
                 images_per_block: int = 1) -> torch.Tensor:
    """The attention core kernel (csrc/attention.cu). q: a checked
    contiguous CUDA tensor whose [B, Sq] rows start with the W query
    columns, at row stride `q_ld`; kv: the same for the Sk key and value
    rows, at row stride `kv_ld`, keys from column `k_col`, values from
    `v_col` (q and kv may be one tensor); `bias`: a shared fp32 [Sq, Sk]
    added to every head's scores; `images_per_block` images a block,
    dividing B. Output [B, Sq, W] in `out_dtype`. Counts nothing: its
    callers do."""
    b, sq = q.shape[0], q.shape[1]
    dh = w // heads
    if dh * heads != w or dh not in _HEAD_DIMS:
        raise ValueError(f"{name}: width {w} with {heads} heads; the kernel takes head dim "
                         f"{' or '.join(map(str, _HEAD_DIMS))} only")
    if sk > _MAX_SEQ:
        raise ValueError(f"{name}: S={sk} > {_MAX_SEQ} keys")
    if images_per_block < 1 or b % images_per_block:
        raise ValueError(f"{name}: {images_per_block} images a block do not divide B={b}")
    check_shared_bias(name, bias, sq, sk, q.device)
    if scale is None:
        scale = dh ** -0.5
    out = torch.empty((b, sq, w), dtype=out_dtype, device=q.device)
    base, esize = kv.data_ptr(), kv.element_size()
    common.launch("fern_attention", q.data_ptr(), base + esize * k_col, base + esize * v_col,
                  None if bias is None else bias.data_ptr(), out.data_ptr(), b, sq, sk, heads,
                  dh, q_ld, kv_ld, int(causal), scale, common.DTYPE_CODES[q.dtype],
                  common.DTYPE_CODES[out_dtype], images_per_block, q.get_device(),
                  common.stream_of(q))
    return out


def launch_attention_core(qkv: torch.Tensor, heads: int, *, causal: bool,
                          scale: float | None, out_dtype: torch.dtype,
                          bias: torch.Tensor | None = None,
                          images_per_block: int = 1) -> torch.Tensor:
    """The attention core kernel on a checked CUDA packed qkv [B, S, 3W];
    output in the qkv dtype or fp32 (B6); an optional shared fp32 [S, S]
    bias and several images a block. Counts nothing: its callers (B3, B6,
    B7) do."""
    w3 = qkv.shape[-1]
    if w3 % 3:
        raise ValueError(f"packed_qkv_self_attention: qkv width {w3} is not 3W")
    w = w3 // 3
    return _launch_core("packed_qkv_self_attention", qkv, qkv, w=w, sk=qkv.shape[1],
                        heads=heads, q_ld=w3, kv_ld=w3, k_col=w, v_col=2 * w, causal=causal,
                        scale=scale, out_dtype=out_dtype, bias=bias,
                        images_per_block=images_per_block)


def launch_grouped_attention(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             bias: torch.Tensor | None, *, batch: int, heads: int, dh: int,
                             sq: int, sk: int, q_ld: int, kv_ld: int, group: int,
                             split_rows: bool, scale: float) -> torch.Tensor:
    """The grouped attention kernel (csrc/attention_grouped.cu): the
    batch * heads (image, head) pairs of q rows [batch, Sq, *] at row
    stride `q_ld` against k and v rows [batch, Sk, *] at `kv_ld`, head h
    at columns h*Dh .. h*Dh+Dh-1 (contiguous [BH, S, Dh]: heads 1, ld
    Dh), `group` pairs a block, each block over every query row of its
    pairs or, with `split_rows`, over one row tile of them (128 rows; a
    grid dimension more); an optional shared fp32
    [Sq, Sk] bias. Output [batch, Sq, heads * Dh] in the operands' dtype. The operands are
    checked CUDA tensors of one dtype. Counts nothing: its callers (B9,
    X1) do."""
    if dh % 2 or not 2 <= dh <= MAX_GROUPED_HEAD_DIM:
        raise ValueError(f"{name}: head dim {dh}; the kernel takes even head dims up to "
                         f"{MAX_GROUPED_HEAD_DIM}")
    if sk < 1:
        raise ValueError(f"{name}: Sk={sk} keys")
    if group < 1 or (batch * heads) % group:
        raise ValueError(f"{name}: group {group} does not divide the {batch * heads} "
                         "(batch, head) pairs")
    check_shared_bias(name, bias, sq, sk, q.device)
    out = torch.empty((batch, sq, heads * dh), dtype=q.dtype, device=q.device)
    common.launch("fern_attention_grouped", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  None if bias is None else bias.data_ptr(), out.data_ptr(), batch, sq, sk,
                  heads, dh, q_ld, kv_ld, group, int(split_rows), scale,
                  common.DTYPE_CODES[q.dtype], q.get_device(), common.stream_of(q))
    return out


# --- B9: [B, H, S, Dh] attention with a shared bias -----------------------


def shared_bias(causal: bool, bias: torch.Tensor | None, sq: int, sk: int,
                device: torch.device | str) -> torch.Tensor | None:
    """`multi_head_attention`'s fp32 [Sq, Sk] bias (`:712-717`): -1e30
    above the diagonal of [Sq, Sk] when causal, plus `bias`; None when
    there is neither."""
    out = None
    if causal:
        keep = torch.ones((sq, sk), dtype=torch.bool, device=device).tril()
        out = torch.where(keep, 0.0, NEG_INF).to(torch.float32)
    if bias is not None:
        b32 = bias.to(device, torch.float32)
        out = b32 if out is None else out + b32
    return out


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor | None,
            scale: float, dropout_rate: float = 0.0,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """The `_mha_ref` formula (`:636`): scores in the operand dtype, the
    bias added in that dtype, softmax in fp32, probabilities cast back,
    probability dropout when a generator is given (`:648-650`)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * torch.tensor(scale, dtype=q.dtype)
    if bias is not None:
        s = s + bias.to(s.dtype)
    p = torch.softmax(s.float(), dim=-1).to(v.dtype)
    p = dropout(p, dropout_rate, generator)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: torch.Tensor | None = None, scale: float | None = None) -> torch.Tensor:
    """Plain version of B9 with `_attn_kernel`'s rounding points
    (`:61-80`): fp32 scores times `scale` plus the fp32 [Sq, Sk] bias,
    softmax in fp32, p / denom cast to the operand dtype, fp32 P.V, the
    output cast to the operand dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(q.dtype).float()
    return torch.matmul(p, v.float()).to(q.dtype)


def _core_layout(t: torch.Tensor) -> tuple[int, int, int] | None:
    """How the attention core reads a [B, H, S, Dh] operand, as (batch,
    heads, row stride), or None. Heads side by side in the rows of a
    [B, S, >= H*Dh] tensor (a head view of a projection's output):
    (B, H, row stride); B*H blocks of S rows (contiguous [B, H, S, Dh]):
    (B*H, 1, row stride)."""
    b, h, s, dh = t.shape
    sb, sh, ss, sd = t.stride()
    if sd != 1 or ss < dh:
        return None
    if (h == 1 or sh == dh) and ss >= h * dh and (b == 1 or sb == s * ss):
        return b, h, ss
    if (h == 1 or sh == s * ss) and (b == 1 or sb == h * s * ss):
        return b * h, 1, ss
    return None


def _launch_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor | None,
                scale: float) -> torch.Tensor:
    """Kernel B9 on [B, H, S, Dh] operands read through their strides
    (`_core_layout`); operands in any other layout, or in two different
    ones, are copied to contiguous first. Head dim 64 or 80 with Sk <=
    256: the attention core; any other even head dim up to 128, or more
    keys: the grouped kernel, `MHA_GROUP` pairs and one row tile a
    block. Returns [B, H, Sq, Dh], a view of the kernel's [batch, Sq,
    heads * Dh] output. Counts nothing: `multi_head_attention` does."""
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, dh) or v.shape != k.shape:
        raise ValueError(f"multi_head_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; expected [B, H, S, Dh] with shared B, H, Dh")
    if dh % 2 or dh > MAX_GROUPED_HEAD_DIM:
        raise ValueError(f"multi_head_attention: head dim {dh}; the kernels take even head "
                         f"dims up to {MAX_GROUPED_HEAD_DIM}")
    if sk < 1:
        raise ValueError(f"multi_head_attention: Sk={sk} keys")
    common.check_no_grad("multi_head_attention", q, k, v, bias)
    if q.dtype not in common.DTYPE_CODES:
        raise TypeError(f"multi_head_attention: dtype {q.dtype} not supported "
                        "(the kernels take float32 or bfloat16)")
    for t in (k, v):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"multi_head_attention: operands {t.dtype} on {t.device} and "
                            f"{q.dtype} on {q.device}")
    check_shared_bias("multi_head_attention", bias, sq, sk, q.device)
    lq, lk, lv = (_core_layout(t) for t in (q, k, v))
    if None in (lq, lk, lv) or lq[:2] != lk[:2] or lk != lv:
        # dense [B, H, S, Dh]: B*H blocks of S rows of Dh. Not read back
        # through `_core_layout`: PyTorch leaves the stride of a length-1 S
        # as it was, which would make a one-row operand look like rows.
        q, k, v = (t.contiguous() for t in (q, k, v))
        lq = lk = (b * h, 1, dh)
    batch, heads, q_ld = lq
    if dh in _HEAD_DIMS and sk <= _MAX_SEQ:
        out = torch.empty((batch, sq, heads * dh), dtype=q.dtype, device=q.device)
        code = common.DTYPE_CODES[q.dtype]
        common.launch("fern_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      None if bias is None else bias.data_ptr(), out.data_ptr(), batch, sq,
                      sk, heads, dh, q_ld, lk[2], 0, scale, code, code, 1, q.get_device(),
                      common.stream_of(q))
    else:
        out = launch_grouped_attention("multi_head_attention", q, k, v, bias, batch=batch,
                                       heads=heads, dh=dh, sq=sq, sk=sk, q_ld=q_ld,
                                       kv_ld=lk[2], group=MHA_GROUP, split_rows=True,
                                       scale=scale)
    if heads == 1:
        return out.view(b, h, sq, dh)
    return out.view(b, sq, h, dh).transpose(1, 2)


class MHAFunction(torch.autograd.Function):
    """Forward: kernel B9. Backward: autograd of the `_mha_ref` formula
    with the scores recomputed (`_mha_pallas_diff_bwd`, `:679-685`),
    including the bias's gradient: dS summed over the batch and the
    heads, as the JAX VJP gives it."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                bias: torch.Tensor | None, scale: float) -> torch.Tensor:
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        return _launch_mha(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return common.plain_vjp(ctx, g, lambda q, k, v, bias: mha_ref(q, k, v, bias, ctx.scale))


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = False, bias: torch.Tensor | None = None,
                         scale: float | None = None, dropout_rate: float = 0.0,
                         generator: torch.Generator | None = None) -> torch.Tensor:
    """Attention over [B, H, S, Dh] tensors (B9), with an optional
    additive [Sq, Sk] `bias` shared by every batch row and head and a
    causal mask over [Sq, Sk] (`:690-744`).

    With `dropout_rate` > 0 and a generator: the `_mha_ref` formula with
    probability dropout. Otherwise `mha`: CUDA: the attention core (head
    dim 64 or 80, Sk <= 256) or the grouped kernel (other even head dims
    up to 128, any Sk), through `MHAFunction` when autograd has to reach
    an operand; CPU: the plain version."""
    if dropout_rate > 0.0 and generator is not None:
        sq, sk, dh = q.shape[2], k.shape[2], q.shape[3]
        return mha_ref(q, k, v, shared_bias(causal, bias, sq, sk, q.device),
                       dh ** -0.5 if scale is None else scale, dropout_rate, generator)
    return mha(q, k, v, causal, bias, scale)


multi_head_attention.launches = 0


def _mha_fake(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
              bias: torch.Tensor | None = None, scale: float | None = None) -> torch.Tensor:
    b, h, sq, dh = q.shape
    if q.is_cuda and h > 1:  # the kernels' output: a head view of [B, Sq, H * Dh]
        return q.new_empty((b, sq, h, dh)).transpose(1, 2)
    return q.new_empty((b, h, sq, dh))


@library.exportable(_mha_fake, name="multi_head_attention")
def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
        bias: torch.Tensor | None = None, scale: float | None = None) -> torch.Tensor:
    """B9 without dropout (`multi_head_attention`'s launches): the entry
    that `ops/library.py` registers."""
    sq, sk, dh = q.shape[2], k.shape[2], q.shape[3]
    if scale is None:
        scale = dh ** -0.5
    bias32 = shared_bias(causal, bias, sq, sk, q.device)
    if not common.is_cuda(q):
        return mha_plain(q, k, v, bias32, scale)
    if common.wants_grad(q, k, v, bias32):
        out = MHAFunction.apply(q, k, v, bias32, scale)
    else:
        out = _launch_mha(q, k, v, bias32, scale)
    common.count(multi_head_attention)
    return out


# --- B3: packed-qkv self-attention ---------------------------------------


def packed_qkv_self_attention_plain(qkv: torch.Tensor, heads: int, *,
                                    causal: bool = False, scale: float | None = None,
                                    out_dtype: torch.dtype | None = None,
                                    attn_bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of B3 with `_packed_kernel`'s rounding points
    (`:124-143`), output in `out_dtype` (default: the qkv dtype)."""
    q, k, v = qkv.split(qkv.shape[-1] // 3, dim=-1)
    return attention_core_plain(q, k, v, heads, causal=causal, scale=scale,
                                out_dtype=out_dtype, attn_bias=attn_bias)


def packed_qkv_self_attention(qkv: torch.Tensor, heads: int, *, causal: bool = False,
                              scale: float | None = None,
                              attn_bias: torch.Tensor | None = None,
                              images_per_block: int = 1) -> torch.Tensor:
    """Self-attention from packed qkv [B, S, 3W] -> [B, S, W] (B3), with
    an optional shared fp32 [S, S] `attn_bias` added to every head's
    scores.

    CUDA: csrc/attention.cu, head dim 64 or 80 and S <= 256 only,
    `images_per_block` images a block (dividing B), through
    `PackedQKVFunction` when autograd has to reach qkv or the bias. CPU:
    the plain version."""
    if not common.is_cuda(qkv):
        return packed_qkv_self_attention_plain(qkv, heads, causal=causal, scale=scale,
                                               attn_bias=attn_bias)
    if common.wants_grad(qkv, attn_bias):
        out = PackedQKVFunction.apply(qkv, attn_bias, heads, causal, scale, images_per_block)
    else:
        out = _launch_packed(qkv, attn_bias, heads, causal, scale, images_per_block)
    common.count(packed_qkv_self_attention)
    return out


packed_qkv_self_attention.launches = 0


def _launch_packed(qkv: torch.Tensor, attn_bias: torch.Tensor | None, heads: int,
                   causal: bool, scale: float | None, images_per_block: int) -> torch.Tensor:
    """B3's launch: the attention core on a CUDA qkv. Counts nothing."""
    common.check_cuda_operands("packed_qkv_self_attention", qkv)
    return launch_attention_core(qkv, heads, causal=causal, scale=scale, out_dtype=qkv.dtype,
                                 bias=attn_bias, images_per_block=images_per_block)


class PackedQKVFunction(torch.autograd.Function):
    """Forward: kernel B3. Backward: autograd of
    `packed_qkv_self_attention_plain`, recomputed (`_packed_diff_bwd`,
    `:190-193`), with the shared bias's gradient summed over the batch
    and the heads."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, attn_bias: torch.Tensor | None, heads: int,
                causal: bool, scale: float | None, images_per_block: int) -> torch.Tensor:
        ctx.save_for_backward(qkv, attn_bias)
        ctx.config = (heads, causal, scale)
        return _launch_packed(qkv, attn_bias, heads, causal, scale, images_per_block)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        heads, causal, scale = ctx.config
        return common.plain_vjp(ctx, g, lambda qkv, bias: packed_qkv_self_attention_plain(
            qkv, heads, causal=causal, scale=scale, attn_bias=bias))


# --- B8: cross-attention over packed kv ----------------------------------


def packed_kv_cross_attention_plain(q: torch.Tensor, kv: torch.Tensor, heads: int, *,
                                    scale: float | None = None) -> torch.Tensor:
    """Plain version of B8 with `_packed_cross_kernel`'s rounding points
    (`:240-259`)."""
    k, v = kv.split(q.shape[-1], dim=-1)
    return attention_core_plain(q, k, v, heads, scale=scale)


def _cross_on_core(w: int, heads: int, sk: int) -> bool:
    """B8's route for width `w` in `heads` heads over `sk` keys: True for
    the attention core (head dim 64 or 80, Sk <= 256), False for the wide
    route (any other head dim up to `MAX_WIDE_HEAD_DIM`, Sk up to
    `MAX_WIDE_KEYS`); anything else raises."""
    dh = w // heads
    if dh * heads == w and dh in _HEAD_DIMS and sk <= _MAX_SEQ:
        return True
    if dh * heads != w or not 1 <= dh <= MAX_WIDE_HEAD_DIM or not 1 <= sk <= MAX_WIDE_KEYS:
        raise ValueError(f"packed_kv_cross_attention: width {w} in {heads} heads at S={sk} "
                         f"keys; the kernels take head dim 64 or 80 at S <= {_MAX_SEQ} (the "
                         f"core) and any head dim up to {MAX_WIDE_HEAD_DIM} at S <= "
                         f"{MAX_WIDE_KEYS} (the wide route)")
    return False


def wide_cross_attention(q: torch.Tensor, kv: torch.Tensor, heads: int,
                         scale: float | None) -> torch.Tensor:
    """B8's wide route (csrc/attention_wide.cu: a block per image, head and
    16 query rows, each warp a run of 16-column units staged by
    `cp.async`, the products on the tensor cores, fp32 by 3xTF32) on
    checked contiguous CUDA q [B, Sq, W] and kv [B, Sk, 2W], within the
    limits `_cross_on_core` checks: any head dim up to
    `MAX_WIDE_HEAD_DIM`, any Sq, Sk up to `MAX_WIDE_KEYS`, fp32 or bf16.
    Counts its own launches; `packed_kv_cross_attention` counts B8's."""
    b, sq, w = q.shape
    sk = kv.shape[1]
    dh = w // heads
    out = torch.empty((b, sq, w), dtype=q.dtype, device=q.device)
    base = kv.data_ptr()
    common.launch("fern_attention_wide", q.data_ptr(), base, base + kv.element_size() * w,
                  out.data_ptr(), b, sq, sk, heads, dh, w, 2 * w,
                  dh ** -0.5 if scale is None else scale, common.DTYPE_CODES[q.dtype],
                  q.get_device(), common.stream_of(q))
    common.count(wide_cross_attention)
    return out


wide_cross_attention.launches = 0


@library.exportable(library.like)
def packed_kv_cross_attention(q: torch.Tensor, kv: torch.Tensor, heads: int, *,
                              scale: float | None = None) -> torch.Tensor:
    """q [B, Sq, W] against kv [B, Sk, 2W] (k | v) -> [B, Sq, W] (B8).

    CUDA: the attention core in its cross layout at head dim 64 or 80
    and Sk <= 256; every other head dim up to 1,024 at Sk <= 256 on the
    wide route (`wide_cross_attention`); anything else raises. Either
    route through `PackedCrossFunction` when autograd has to reach q or
    kv (CaLa's training). CPU: the plain version."""
    if not common.is_cuda(q):
        return packed_kv_cross_attention_plain(q, kv, heads, scale=scale)
    b, sq, w = q.shape
    if kv.ndim != 3 or kv.shape[0] != b or kv.shape[2] != 2 * w:
        raise ValueError(f"packed_kv_cross_attention: q {tuple(q.shape)} with kv "
                         f"{tuple(kv.shape)}; kv must be [B, Sk, 2W]")
    core = _cross_on_core(w, heads, kv.shape[1])
    if common.wants_grad(q, kv):
        out = PackedCrossFunction.apply(q, kv, heads, scale, core)
    else:
        out = _launch_cross(q, kv, heads, scale, core)
    common.count(packed_kv_cross_attention)
    return out


packed_kv_cross_attention.launches = 0


def _launch_cross(q: torch.Tensor, kv: torch.Tensor, heads: int, scale: float | None,
                  core: bool) -> torch.Tensor:
    """B8's launch on CUDA q and kv: the attention core, or the wide
    route where `core` is False. Counts nothing but the wide route's
    own count."""
    common.check_cuda_operands("packed_kv_cross_attention", q, kv)
    if not core:
        return wide_cross_attention(q, kv, heads, scale)
    w = q.shape[2]
    return _launch_core("packed_kv_cross_attention", q, kv, w=w, sk=kv.shape[1], heads=heads,
                        q_ld=w, kv_ld=2 * w, k_col=0, v_col=w, causal=False, scale=scale,
                        out_dtype=q.dtype)


class PackedCrossFunction(torch.autograd.Function):
    """Forward: kernel B8 on the route `_cross_on_core` chose. Backward:
    autograd of `packed_kv_cross_attention_plain`, recomputed, on both
    routes (`_packed_cross_diff_bwd`, `:309-314`; at the wide route's
    head dims JAX differentiates the same formula in XLA)."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, kv: torch.Tensor, heads: int, scale: float | None,
                core: bool) -> torch.Tensor:
        ctx.save_for_backward(q, kv)
        ctx.config = (heads, scale)
        return _launch_cross(q, kv, heads, scale, core)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        heads, scale = ctx.config
        return common.plain_vjp(ctx, g, lambda q, kv: packed_kv_cross_attention_plain(
            q, kv, heads, scale=scale))


# --- B7: QKV projection + self-attention ---------------------------------


def fused_qkv_self_attention_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                                   heads: int, *, causal: bool = False,
                                   scale: float | None = None,
                                   attn_bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of B7 with `_qkv_fused_kernel`'s rounding points
    (`:361-384`): the projection in fp32 (true fp32 for fp32 operands, the
    kernel's `Precision.HIGHEST`), the bias added in fp32, the sum cast to
    x.dtype, then the attention core's."""
    qkv = F.linear(x.float(), weight.float(), bias.float()).to(x.dtype)
    return packed_qkv_self_attention_plain(qkv, heads, causal=causal, scale=scale,
                                           attn_bias=attn_bias)


@library.exportable(library.like)
def fused_qkv_self_attention(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                             heads: int, *, causal: bool = False, scale: float | None = None,
                             attn_bias: torch.Tensor | None = None) -> torch.Tensor:
    """QKV projection + self-attention (B7). x [B, S, W], weight [3W, W]
    (torch layout), bias [3W], an optional shared fp32 [S, S] `attn_bias`
    on the scores -> [B, S, W].

    CUDA: csrc/gemm.cu (GEMM + bias into packed [B, S, 3W] qkv, in
    x.dtype) and then the attention core, head dim 64 or 80 and S <= 256
    only, through `FusedQKVFunction` when autograd has to reach an
    operand. CPU: the plain version."""
    if not common.is_cuda(x):
        return fused_qkv_self_attention_plain(x, weight, bias, heads, causal=causal,
                                              scale=scale, attn_bias=attn_bias)
    w = x.shape[2]
    if weight.shape != (3 * w, w) or bias.shape != (3 * w,):
        raise ValueError(f"fused_qkv_self_attention: weight {tuple(weight.shape)}, bias "
                         f"{tuple(bias.shape)} for width {w}")
    if common.wants_grad(x, weight, bias, attn_bias):
        out = FusedQKVFunction.apply(x, weight, bias, attn_bias, heads, causal, scale)
    else:
        out = _launch_fused_qkv(x, weight, bias, attn_bias, heads, causal, scale)
    common.count(fused_qkv_self_attention)
    return out


fused_qkv_self_attention.launches = 0


def _launch_fused_qkv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      attn_bias: torch.Tensor | None, heads: int, causal: bool,
                      scale: float | None) -> torch.Tensor:
    """B7's launches on CUDA operands: GEMM + bias, then the attention
    core. Counts nothing."""
    b, s, w = x.shape
    common.check_cuda_operands("fused_qkv_self_attention", x, weight, bias)
    qkv = common.launch_gemm(x.view(b * s, w), weight, bias).view(b, s, 3 * w)
    return launch_attention_core(qkv, heads, causal=causal, scale=scale, out_dtype=x.dtype,
                                 bias=attn_bias)


class FusedQKVFunction(torch.autograd.Function):
    """Forward: kernel B7. Backward: autograd of
    `fused_qkv_self_attention_plain`, recomputed, for x, the weight, the
    bias and the shared attention bias (`_qkv_fused_diff_bwd`,
    `:424-430`)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                attn_bias: torch.Tensor | None, heads: int, causal: bool,
                scale: float | None) -> torch.Tensor:
        ctx.save_for_backward(x, weight, bias, attn_bias)
        ctx.config = (heads, causal, scale)
        return _launch_fused_qkv(x, weight, bias, attn_bias, heads, causal, scale)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        heads, causal, scale = ctx.config
        return common.plain_vjp(ctx, g, lambda x, weight, bias, attn_bias: (
            fused_qkv_self_attention_plain(x, weight, bias, heads, causal=causal, scale=scale,
                                           attn_bias=attn_bias)))


# --- B1: the whole attention sub-block ----------------------------------


def attention_subblock_plain(x: torch.Tensor, ln_weight: torch.Tensor,
                             ln_bias: torch.Tensor, in_proj_weight: torch.Tensor,
                             in_proj_bias: torch.Tensor, out_weight: torch.Tensor,
                             out_bias: torch.Tensor, heads: int, *, causal: bool = False,
                             scale: float | None = None, eps: float = 1e-5,
                             attn_bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of B1 with `_subblock_kernel`'s rounding points
    (`:479-515`)."""
    y = layer_norm_plain(x, ln_weight, ln_bias, eps)
    qkv = F.linear(y.float(), in_proj_weight.float(), in_proj_bias.float()).to(x.dtype)
    o = packed_qkv_self_attention_plain(qkv, heads, causal=causal, scale=scale,
                                        attn_bias=attn_bias)
    proj = F.linear(o.float(), out_weight.float(), out_bias.float()).to(x.dtype)
    return x + proj


@library.exportable(library.like)
def attention_subblock(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                       in_proj_weight: torch.Tensor, in_proj_bias: torch.Tensor,
                       out_weight: torch.Tensor, out_bias: torch.Tensor, heads: int, *,
                       causal: bool = False, scale: float | None = None,
                       eps: float = 1e-5,
                       attn_bias: torch.Tensor | None = None) -> torch.Tensor:
    """x + out_proj(attention(in_proj(LN(x)))) for x [B, S, W] (B1), with
    an optional shared fp32 [S, S] `attn_bias` on the scores.

    in_proj_weight [3W, W], out_weight [W, W] (torch layout). CUDA:
    LN kernel -> GEMM + bias -> B3 core -> GEMM + bias + residual, all
    in x.dtype (fp32 or bf16) with every weight in the same dtype,
    through `SubblockFunction` when autograd has to reach an operand.
    CPU: the plain version."""
    tensors = (x, ln_weight, ln_bias, in_proj_weight, in_proj_bias, out_weight, out_bias,
               attn_bias)
    if not common.is_cuda(x):
        return attention_subblock_plain(*tensors[:7], heads, causal=causal, scale=scale,
                                        eps=eps, attn_bias=attn_bias)
    w = x.shape[2]
    if in_proj_weight.shape != (3 * w, w) or out_weight.shape != (w, w):
        raise ValueError(f"attention_subblock: weights {tuple(in_proj_weight.shape)}, "
                         f"{tuple(out_weight.shape)} for width {w}")
    if common.wants_grad(*tensors):
        out = SubblockFunction.apply(*tensors, heads, causal, scale, eps)
    else:
        out = _launch_subblock(*tensors, heads, causal, scale, eps)
    common.count(attention_subblock)
    return out


attention_subblock.launches = 0


def _launch_subblock(x: torch.Tensor, ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                     in_proj_weight: torch.Tensor, in_proj_bias: torch.Tensor,
                     out_weight: torch.Tensor, out_bias: torch.Tensor,
                     attn_bias: torch.Tensor | None, heads: int, causal: bool,
                     scale: float | None, eps: float) -> torch.Tensor:
    """B1's launches on CUDA operands: LN, GEMM + bias, B3 (which counts
    its own launch), GEMM + bias + residual. Counts nothing else."""
    b, s, w = x.shape
    common.check_cuda_operands("attention_subblock", x, ln_weight, ln_bias, in_proj_weight,
                               in_proj_bias, out_weight, out_bias)
    x2 = x.view(b * s, w)
    y = common.launch_layer_norm(x2, ln_weight, ln_bias, eps)
    qkv = common.launch_gemm(y, in_proj_weight, in_proj_bias)
    o = packed_qkv_self_attention(qkv.view(b, s, 3 * w), heads, causal=causal, scale=scale,
                                  attn_bias=attn_bias)
    out = common.launch_gemm(o.view(b * s, w), out_weight, out_bias, residual=x2)
    return out.view(b, s, w)


class SubblockFunction(torch.autograd.Function):
    """Forward: kernel B1 (grad mode is off inside, so its B3 launch
    takes no Function of its own). Backward: autograd of
    `attention_subblock_plain`, recomputed, for the seven tensors and the
    shared attention bias (`_subblock_diff_bwd`, `:572-575`)."""

    @staticmethod
    def forward(ctx, x, ln_weight, ln_bias, in_proj_weight, in_proj_bias, out_weight, out_bias,
                attn_bias, heads: int, causal: bool, scale: float | None,
                eps: float) -> torch.Tensor:
        tensors = (x, ln_weight, ln_bias, in_proj_weight, in_proj_bias, out_weight, out_bias,
                   attn_bias)
        ctx.save_for_backward(*tensors)
        ctx.config = (heads, causal, scale, eps)
        return _launch_subblock(*tensors, heads, causal, scale, eps)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        heads, causal, scale, eps = ctx.config
        return common.plain_vjp(ctx, g, lambda *t: attention_subblock_plain(
            *t[:7], heads, causal=causal, scale=scale, eps=eps, attn_bias=t[7]))
