"""TME: the trainable text-enhancement module.

JAX counterpart: `fashionern_aaai2024_tpu/models/ern/tme.py` (`TMEModule`,
`:29-52`). The text tower's token features cross-attend the reference
image's patch features:

    enhanced = text_seq + CrossAttn(LN(text_seq), visual_proj(visual_emb))

It lives in the ERN subtree (`ERN.TME`), outside the frozen CLIP towers,
so it trains, checkpoints and serves with the fusion stack.

Parameter names are the port's own (the reference has no TME; its fork
is closed source), under `ern.TME.`:

    visual_proj.{weight,bias}     Linear d -> d (flax Dense "visual_proj")
    ln.{weight,bias}              LayerNorm, eps 1e-6 (flax "ln")
    cross_attn.{query,key,value}.{weight,bias}
                                  Linear d -> H*Dh: the flax DenseGeneral
                                  kernel [d, H, Dh] reshaped to [d, H*Dh]
                                  and transposed, its bias [H, Dh] flattened
    cross_attn.out.{weight,bias}  Linear H*Dh -> d: the flax kernel
                                  [H, Dh, d] reshaped to [H*Dh, d] and
                                  transposed

Computed as flax computes it, with the port's kernels: the LayerNorm is
kernel B11 with flax's eps of 1e-6 (flax takes the variance as
E[x^2] - E[x]^2 in fp32, B11 as the mean of squared deviations: the two
agree to fp32 rounding at the centred scales of token features); the
attention (8 heads, no dropout, scale Dh^-0.5) is kernel B9
(`ops.attention.multi_head_attention`) on head views of the projections,
with no copy; the projections are `F.linear`.

Dtypes follow flax's promotion: the module computes in the promotion of
`text_seq`'s dtype and its parameters' (`tme.py:44-45` first rounds the
patches to `text_seq`'s dtype). Training feeds bf16 token features from
the bf16 towers to fp32 parameters: fp32, from bf16-rounded patches. The
bf16 serve policy casts TME to bf16 (`models/composed.py
apply_precision`): all bf16, where B9 keeps fp32 scores and flax rounds
them (ROADMAP C8).

JAX zero-initializes the out-projection (`tme.py:18-20`), so that a new
TME computes the vanilla function, and so does the package's seeded init
(`models/composed.py jax_init_`); `random_init_` draws it like every
Linear, so that the smoke run's seeded models exercise the module.
"""

from __future__ import annotations

import torch
from torch import nn

from fashionern_aaai2024_tpu_torch.models import init as I
from fashionern_aaai2024_tpu_torch.ops.attention import multi_head_attention
from fashionern_aaai2024_tpu_torch.ops.layernorm import layer_norm

TME_HEADS = 8        # the fusion stack's MR cross-attention heads
TME_LN_EPS = 1e-6    # flax nn.LayerNorm's default


class _CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def flax_variables(self) -> list[I.Variable]:
        """flax `MultiHeadDotProductAttention`'s variables: the
        `DenseGeneral`s query, key, value (kernel [d, H, Dh], bias [H, Dh])
        and out (kernel [H, Dh, d], zero-initialized, `tme.py:49`)."""
        d, h = self.query.weight.shape[1], self.heads
        heads = (h, d // h)
        out = []
        for name in ("query", "key", "value"):
            out += I.scope(name, [
                I.param("kernel", (d, *heads), I.dense_general_kernel(I.LECUN_NORMAL, 1, 2), 1),
                I.param("bias", heads, I.dense_general_bias(I.ZEROS, 2), 2)])
        return out + I.scope("out", [
            I.param("kernel", (*heads, d), I.dense_general_kernel(I.ZEROS, 2, 1), 1),
            I.param("bias", (d,), I.dense_general_bias(I.ZEROS, 1), 2)])

    def forward(self, x: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        b, sq, d = x.shape
        sk = kv.shape[1]
        dh = d // self.heads

        def heads(lin: nn.Linear, t: torch.Tensor, s: int) -> torch.Tensor:
            return lin(t).view(b, s, self.heads, dh).transpose(1, 2)

        o = multi_head_attention(heads(self.query, x, sq), heads(self.key, kv, sk),
                                 heads(self.value, kv, sk))
        return self.out(o.transpose(1, 2).reshape(b, sq, d))


class TMEModule(nn.Module):
    """text_seq [B, L, d] and visual_emb [B, P, d] -> enhanced [B, L, d]."""

    def __init__(self, dim: int, heads: int = TME_HEADS):
        super().__init__()
        self.visual_proj = nn.Linear(dim, dim)
        self.ln = nn.LayerNorm(dim, eps=TME_LN_EPS)
        self.cross_attn = _CrossAttention(dim, heads)

    def flax_variables(self) -> list[I.Variable]:
        """The JAX module's variables (`tme.py:43-50`)."""
        d = self.visual_proj.weight.shape[0]
        return [*I.dense("visual_proj", d, d), *I.layer_norm("ln", d),
                *I.scope("cross_attn", self.cross_attn.flax_variables())]

    def forward(self, text_seq: torch.Tensor, visual_emb: torch.Tensor) -> torch.Tensor:
        dtype = torch.promote_types(text_seq.dtype, self.visual_proj.weight.dtype)
        v = self.visual_proj(visual_emb.to(text_seq.dtype).to(dtype))
        x = text_seq.to(dtype)
        q = layer_norm(x, self.ln.weight, self.ln.bias, TME_LN_EPS)
        return x + self.cross_attn(q, v)
