"""CompoDiff diffusion-prior network
(`models/others/CompoDiff_Model.py:13-498`).

JAX counterpart: `fashionern_aaai2024_tpu/models/zoo/compodiff.py`. A
cross-attention transformer that denoises a CLIP image embedding
conditioned on text tokens, reference-image tokens and a 64×64 spatial
mask, with classifier-free guidance (`forward_with_cond_scale`). Plain
torch ops, as JAX computes them in XLA.

Quirks kept from the reference, as the JAX module keeps them:
  * the self-attention is multi-query: K and V are one head
    (`to_kv = Linear(dim, dim_head * 2)`);
  * cosine-sim attention (scale 16), q and k each times sqrt(scale);
  * a learned null K/V slot, placed ahead of the keys before any mask;
  * DALLE2's scale-only LayerNorm (biased variance, no bias), with the
    `stable` variant (x / amax(x), no gradient through the amax) on the
    output norm;
  * T5 relative position buckets over (n, n + 1), the null slot
    included, computed in integers from a float32 log truncated toward
    zero, as `jnp.astype(int32)` truncates;
  * rotary embeddings on the first min(32, dim_head) dims of q and k,
    rotating adjacent pairs (rotary_embedding_torch's layout);
  * masked scores take `finfo.min`, not -inf.

The JAX tree has no reference names (the JAX package has no converter
for it), so the port names the parameters after flax's tree:
`to_text_embeds`, `time_mlp` / `mask_mlp` (`proj_in`, `mid.{i}`,
`proj_out`), `transformer.rel_pos_bias.relative_attention_bias`,
`transformer.{attn,cross,ff}.{i}.*`, `transformer.norm.g`,
`transformer.project_out`; `models/convert.py compodiff_state_dict`
carries flax's params over.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fashionern_aaai2024_tpu_torch.models import init as I


class DalleLayerNorm(nn.Module):
    def __init__(self, dim: int, stable: bool = False, eps: float = 1e-5):
        super().__init__()
        self.stable = stable
        self.eps = eps
        self.g = nn.Parameter(torch.ones(dim))

    def flax_variables(self) -> list[I.Variable]:
        return [I.param("g", self.g.shape, I.ONES, 1)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stable:
            x = x / x.amax(dim=-1, keepdim=True).detach()
        var = x.var(dim=-1, unbiased=False, keepdim=True)
        mean = x.mean(dim=-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.g


def sinusoidal_pos_emb(x: torch.Tensor, dim: int) -> torch.Tensor:
    """[B] float positions -> [B, dim]: sin | cos of x · 10000^(-i / (dim/2 - 1))."""
    half = dim // 2
    emb = math.log(10000) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=x.device) * -emb)
    ang = x[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class MLP(nn.Module):
    """SiLU MLP of `depth` layers at hidden `expansion_factor`·dim_out."""

    def __init__(self, dim_in: int, dim_out: int, expansion_factor: float = 2.0,
                 depth: int = 2):
        super().__init__()
        hidden = int(expansion_factor * dim_out)
        self.proj_in = nn.Linear(dim_in, hidden)
        self.mid = nn.ModuleList(nn.Linear(hidden, hidden) for _ in range(depth - 1))
        self.proj_out = nn.Linear(hidden, dim_out)

    def flax_variables(self) -> list[I.Variable]:
        """flax's `in`, `mid_{i}`, `out`."""
        return [*I.dense_like("in", self.proj_in),
                *(v for i, layer in enumerate(self.mid) for v in I.dense_like(f"mid_{i}", layer)),
                *I.dense_like("out", self.proj_out)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.proj_in(x.float()))
        for layer in self.mid:
            x = F.silu(layer(x))
        return self.proj_out(x)


def rel_pos_bucket(rel_pos: torch.Tensor, num_buckets: int = 32,
                   max_distance: int = 128) -> torch.Tensor:
    """T5's bucket of each relative position (int64 in, int64 out)."""
    n = torch.clamp(-rel_pos, min=0)
    max_exact = num_buckets // 2
    large = (torch.log(torch.clamp(n, min=1).float() / max_exact)
             / math.log(max_distance / max_exact) * (num_buckets - max_exact))
    val_large = torch.clamp(max_exact + large.to(torch.int32), max=num_buckets - 1)
    return torch.where(n < max_exact, n, val_large.to(n.dtype))


class RelPosBias(nn.Module):
    def __init__(self, heads: int = 8, num_buckets: int = 32, max_distance: int = 128):
        super().__init__()
        self.num_buckets = num_buckets
        self.max_distance = max_distance
        self.relative_attention_bias = nn.Embedding(num_buckets, heads)

    def flax_variables(self) -> list[I.Variable]:
        return [I.param("relative_attention_bias", self.relative_attention_bias.weight.shape,
                        I.normal(1.0), 1)]

    def forward(self, i: int, j: int) -> torch.Tensor:
        """[heads, i, j] bias of query position q against key position k."""
        device = self.relative_attention_bias.weight.device
        rel = (torch.arange(j, device=device)[None, :]
               - torch.arange(i, device=device)[:, None])
        bucket = rel_pos_bucket(rel, self.num_buckets, self.max_distance)
        return self.relative_attention_bias(bucket).permute(2, 0, 1)


def rotate_queries_or_keys(t: torch.Tensor, rot_dim: int) -> torch.Tensor:
    """Rotary embedding of t [..., n, d] over its first `rot_dim` dims:
    theta 10000, adjacent pairs (x0, x1) -> (x0 cos - x1 sin, x1 cos +
    x0 sin), positions the sequence index."""
    n = t.shape[-2]
    freqs = 1.0 / (10000 ** (torch.arange(0, rot_dim, 2, dtype=torch.float32,
                                          device=t.device) / rot_dim))
    ang = torch.arange(n, dtype=torch.float32, device=t.device)[:, None] * freqs[None, :]
    ang = torch.repeat_interleave(ang, 2, dim=-1)                     # [n, rot]
    head, rest = t[..., :rot_dim], t[..., rot_dim:]
    rot_half = torch.stack([-head[..., 1::2], head[..., 0::2]], dim=-1).reshape(head.shape)
    return torch.cat([head * torch.cos(ang) + rot_half * torch.sin(ang), rest], dim=-1)


def _l2(t: torch.Tensor) -> torch.Tensor:
    return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp(min=1e-12)


def _masked_softmax(sim: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Softmax over the keys in fp32, cast back; `mask` [B, Sk] (True
    keeps) gains a True column for the null slot first."""
    if mask is not None:
        keep = F.pad(mask, (1, 0), value=True)
        sim = torch.where(keep[:, None, None, :], sim, torch.finfo(sim.dtype).min)
    return torch.softmax(sim.float(), dim=-1).to(sim.dtype)


def _attention_variables(attn: nn.Module, norms: dict) -> list[I.Variable]:
    """A CompoDiff attention's flax variables: its input `norms` (name ->
    `DalleLayerNorm`), `to_q` and `to_kv` (no bias), `null_kv` (normal(1.0),
    the attention scope's own first `make_rng`), `to_out`, `out_norm`."""
    return [*(v for name, norm in norms.items() for v in I.scope(name, norm.flax_variables())),
            *I.dense_like("to_q", attn.to_q), *I.dense_like("to_kv", attn.to_kv),
            I.param("null_kv", attn.null_kv.shape, I.normal(1.0), 1),
            *I.dense_like("to_out", attn.to_out),
            *I.scope("out_norm", attn.out_norm.flax_variables())]


class CompoDiffSelfAttention(nn.Module):
    """Multi-query cosine-sim self-attention with a null K/V slot
    (`CompoDiff_Model.py:295-389`)."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8, causal: bool = False,
                 cosine_sim: bool = True, cosine_sim_scale: float = 16.0,
                 use_rotary: bool = True):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.causal, self.cosine_sim, self.use_rotary = causal, cosine_sim, use_rotary
        self.scale = cosine_sim_scale if cosine_sim else dim_head ** -0.5
        self.norm = DalleLayerNorm(dim)
        self.to_q = nn.Linear(dim, dim_head * heads, bias=False)
        self.to_kv = nn.Linear(dim, 2 * dim_head, bias=False)
        self.null_kv = nn.Parameter(torch.randn(2, dim_head))
        self.to_out = nn.Linear(dim_head * heads, dim, bias=False)
        self.out_norm = DalleLayerNorm(dim)

    def flax_variables(self) -> list[I.Variable]:
        return _attention_variables(self, {"norm": self.norm})

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor | None = None,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        b, n, _ = x.shape
        x = self.norm(x)
        q = self.to_q(x).reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
        k, v = self.to_kv(x).chunk(2, dim=-1)                        # [b, n, dh]: one head
        if self.use_rotary:
            rot = min(32, self.dim_head)
            q, k = rotate_queries_or_keys(q, rot), rotate_queries_or_keys(k, rot)
        k = torch.cat([self.null_kv[0].expand(b, 1, -1), k], dim=1)
        v = torch.cat([self.null_kv[1].expand(b, 1, -1), v], dim=1)
        if self.cosine_sim:
            q, k = _l2(q), _l2(k)
        s = math.sqrt(self.scale)
        sim = torch.einsum("bhid,bjd->bhij", q * s, k * s)
        if attn_bias is not None:
            sim = sim + attn_bias
        if self.causal:
            i, j = sim.shape[-2:]
            drop = torch.ones((i, j), dtype=torch.bool, device=x.device).triu(j - i + 1)
            sim = torch.where(drop, torch.finfo(sim.dtype).min, sim)
        out = torch.einsum("bhij,bjd->bhid", _masked_softmax(sim, mask), v)
        out = self.to_out(out.transpose(1, 2).reshape(b, n, -1))
        return self.out_norm(out)


class CompoDiffCrossAttention(nn.Module):
    """Multi-head cross-attention with a null K/V slot
    (`CompoDiff_Model.py:140-209`)."""

    def __init__(self, dim: int, context_dim: int | None = None, dim_head: int = 64,
                 heads: int = 8, norm_context: bool = False, cosine_sim: bool = False,
                 cosine_sim_scale: float = 16.0):
        super().__init__()
        ctx_dim = context_dim or dim
        inner = dim_head * heads
        self.heads, self.dim_head, self.cosine_sim = heads, dim_head, cosine_sim
        self.scale = cosine_sim_scale if cosine_sim else dim_head ** -0.5
        self.norm = DalleLayerNorm(dim)
        self.norm_context = DalleLayerNorm(ctx_dim) if norm_context else None
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(ctx_dim, 2 * inner, bias=False)
        self.null_kv = nn.Parameter(torch.randn(2, dim_head))
        self.to_out = nn.Linear(inner, dim, bias=False)
        self.out_norm = DalleLayerNorm(dim)

    def flax_variables(self) -> list[I.Variable]:
        norms = {"norm": self.norm}
        if self.norm_context is not None:
            norms["norm_context"] = self.norm_context
        return _attention_variables(self, norms)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        b, n, _ = x.shape
        x = self.norm(x)
        if self.norm_context is not None:
            context = self.norm_context(context)

        def heads(t):
            return t.reshape(b, -1, self.heads, self.dim_head).transpose(1, 2)

        k, v = self.to_kv(context).chunk(2, dim=-1)
        q, k, v = heads(self.to_q(x)), heads(k), heads(v)
        k = torch.cat([self.null_kv[0].expand(b, self.heads, 1, -1), k], dim=2)
        v = torch.cat([self.null_kv[1].expand(b, self.heads, 1, -1), v], dim=2)
        if self.cosine_sim:
            q, k = _l2(q), _l2(k)
        s = math.sqrt(self.scale)
        sim = torch.einsum("bhid,bhjd->bhij", q * s, k * s)
        out = torch.einsum("bhij,bhjd->bhid", _masked_softmax(sim, mask), v)
        out = self.to_out(out.transpose(1, 2).reshape(b, n, -1))
        return self.out_norm(out)


class SwiGLUFeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, post_activation_norm: bool = False):
        super().__init__()
        inner = int(mult * dim)
        self.norm = DalleLayerNorm(dim)
        self.proj_in = nn.Linear(dim, 2 * inner, bias=False)
        self.post_norm = DalleLayerNorm(inner) if post_activation_norm else None
        self.proj_out = nn.Linear(inner, dim, bias=False)

    def flax_variables(self) -> list[I.Variable]:
        post = [] if self.post_norm is None else I.scope("post_norm",
                                                          self.post_norm.flax_variables())
        return [*I.scope("norm", self.norm.flax_variables()),
                *I.dense_like("proj_in", self.proj_in), *post,
                *I.dense_like("proj_out", self.proj_out)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.proj_in(self.norm(x)).chunk(2, dim=-1)
        x = a * F.silu(gate)
        if self.post_norm is not None:
            x = self.post_norm(x)
        return self.proj_out(x)


class CrossTransformer(nn.Module):
    def __init__(self, dim: int, depth: int, dim_head: int = 64, heads: int = 8,
                 ff_mult: int = 4, norm_out: bool = True, final_proj: bool = True,
                 rotary_emb: bool = True, causal: bool = False,
                 context_dim: int | None = None):
        super().__init__()
        self.rel_pos_bias = RelPosBias(heads=heads)
        self.attn = nn.ModuleList(
            CompoDiffSelfAttention(dim, dim_head=dim_head, heads=heads, causal=causal,
                                   use_rotary=rotary_emb) for _ in range(depth))
        self.cross = nn.ModuleList(
            CompoDiffCrossAttention(dim, context_dim=context_dim, dim_head=dim_head,
                                    heads=heads) for _ in range(depth))
        self.ff = nn.ModuleList(SwiGLUFeedForward(dim, mult=ff_mult) for _ in range(depth))
        self.norm = DalleLayerNorm(dim, stable=True) if norm_out else None
        self.project_out = nn.Linear(dim, dim, bias=False) if final_proj else None

    def flax_variables(self) -> list[I.Variable]:
        out = I.scope("rel_pos_bias", self.rel_pos_bias.flax_variables())
        for i, layers in enumerate(zip(self.attn, self.cross, self.ff)):
            for kind, layer in zip(("attn", "cross", "ff"), layers):
                out += I.scope(f"{kind}_{i}", layer.flax_variables())
        if self.norm is not None:
            out += I.scope("norm", self.norm.flax_variables())
        if self.project_out is not None:
            out += I.dense_like("project_out", self.project_out)
        return out

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        n = x.shape[1]
        bias = self.rel_pos_bias(n, n + 1)[None]
        for attn, cross, ff in zip(self.attn, self.cross, self.ff):
            x = attn(x, attn_bias=bias) + x
            x = cross(x, context, mask) + x
            x = ff(x) + x
        if self.norm is not None:
            x = self.norm(x)
        if self.project_out is not None:
            x = self.project_out(x)
        return x


class CompoDiffNetwork(nn.Module):
    """Denoiser: predicts the target CLIP image embedding from a noised
    embedding and (text, reference image, mask) conditioning
    (`CompoDiff_Model.py:13-103`)."""

    def __init__(self, dim: int, depth: int = 4, dim_head: int = 64, heads: int = 8,
                 text_cond_dim: int = 1280, mask_hw: int = 64):
        super().__init__()
        self.dim = dim
        self.to_text_embeds = nn.Linear(text_cond_dim, dim)
        self.time_mlp = MLP(dim, dim)
        self.mask_mlp = MLP(mask_hw * mask_hw, dim)
        self.transformer = CrossTransformer(dim=dim, depth=depth, dim_head=dim_head,
                                            heads=heads)

    def flax_variables(self) -> list[I.Variable]:
        """The JAX network's variables (`compodiff.py:30-330`); every Dense
        of the transformer is without bias."""
        return [*I.dense_like("to_text_embeds", self.to_text_embeds),
                *I.scope("time_mlp", self.time_mlp.flax_variables()),
                *I.scope("mask_mlp", self.mask_mlp.flax_variables()),
                *I.scope("transformer", self.transformer.flax_variables())]

    def forward(self, image_embed: torch.Tensor, image_cond: torch.Tensor,
                text_cond: torch.Tensor, input_mask: torch.Tensor,
                diffusion_timesteps: torch.Tensor) -> torch.Tensor:
        """image_embed [B, N, d]; image_cond [B, M, d]; text_cond [B, 77,
        Ct]; input_mask [B, H, W]; timesteps [B] -> predicted embed
        [B, 1, d]."""
        b = image_embed.shape[0]
        text_cond = self.to_text_embeds(text_cond)
        t = self.time_mlp(sinusoidal_pos_emb(diffusion_timesteps.float(), self.dim))
        mask_embed = self.mask_mlp(input_mask.reshape(b, -1)).reshape(b, 1, self.dim)
        tokens = torch.cat([image_embed, t.reshape(b, 1, self.dim)], dim=-2)
        context = torch.cat([text_cond, image_cond, mask_embed], dim=1)
        return self.transformer(tokens, context)[..., :1, :]

    def forward_with_cond_scale(self, image_embed, image_cond, text_cond, input_mask,
                                diffusion_timesteps, text_cond_uc, cond_scale=1.0):
        """Classifier-free guidance over one triple batch
        (`CompoDiff_Model.py:44-69`): `cond_scale` is (image_scale,
        text_scale), or 1.0 for no guidance."""
        if cond_scale == 1.0:
            return self(image_embed, image_cond, text_cond, input_mask, diffusion_timesteps)
        out = self(torch.cat([image_embed] * 3),
                   torch.cat([image_cond, image_cond, torch.zeros_like(image_cond)]),
                   torch.cat([text_cond, text_cond_uc, text_cond_uc]),
                   torch.cat([input_mask] * 3), torch.cat([diffusion_timesteps] * 3))
        logits, null_text, null_all = out.chunk(3)
        return (null_all + (logits - null_text) * cond_scale[1]
                + (null_text - null_all) * cond_scale[0])
