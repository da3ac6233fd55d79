"""The ERN fusion stack, in eval and train mode.

JAX counterpart: `fashionern_aaai2024_tpu/models/ern/fusion.py`.
Module and parameter names follow the reference `models/fusion_model.py`
state_dict, the names `models/ern/convert.py` reads:

  CombinerSimple  — gated residual mix: text_projection_layer.0,
                    image_projection_layer.0, dynamic_scalar.{0,3}
  VisualSR        — patch attention pooling: embedding_local.{0,1},
                    embedding_global.{0,1}, embedding_common
  BertLayer       — HF BertLayer: attention.self.{query,key,value},
                    attention.output.{dense,LayerNorm}, intermediate.dense,
                    output.{dense,LayerNorm}
  BertEncoder     — HF BertModel(inputs_embeds=...) without the word
                    embeddings: embeddings.{position_embeddings,
                    token_type_embeddings,LayerNorm}, encoder.layer.{i},
                    pooler.dense
  PlusModel       — [CLS] + 13 patches + 77 text tokens -> mini-BERT:
                    cls_token, bert_encoder.bert_model.*
  DVRModule       — query tower: transformer_layer, MR_component,
                    SR_module, combiner_global, combiner_local, combiner

BERT keeps the reference's quirks: LayerNorm eps 1e-12, intermediate
size 3072 at any hidden size, exact GELU, token type 0 for CLS and the
patches, and only the first `patch_num` MR outputs kept
(`fusion.py:273-275`). In eval the BERT's attention is kernel B7
(`ops.attention.fused_qkv_self_attention`), the MR cross-attention
kernel B8 (`packed_kv_cross_attention`, `models/ern/layers.py`) and every
combiner kernel B12 (`ops.combiner.combiner_apply`); the BERT's
LayerNorms are kernel B11 (`ops.layernorm.layer_norm`) in both modes. On
a CPU tensor each takes its plain version.

Every forward takes `generator` (see `models/ern/layers.py`): None is
eval, a `torch.Generator` is train mode. Train mode drops out where the
JAX modules do (Combiner 0.5 after each projection and the scalar MLP's
hidden layer; VisualSR 0.5 after each tanh; BERT 0.1 after the embedding
LN, on the attention probabilities, after the attention output and after
the output dense; MR 0.1 on the attention probabilities), takes BatchNorm
batch statistics, and runs BERT's attention through the split-head
`multi_head_attention` with probability dropout (`fusion.py:128-166`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fashionern_aaai2024_tpu_torch.models.ern.layers import (
    TorchBatchNorm,
    TorchMultiheadAttention,
    sr_l2norm,
    torch_normalize,
)
from fashionern_aaai2024_tpu_torch.ops.attention import (
    fused_qkv_self_attention,
    multi_head_attention,
)
from fashionern_aaai2024_tpu_torch.ops.combiner import combiner_apply
from fashionern_aaai2024_tpu_torch.ops.dropout import dropout
from fashionern_aaai2024_tpu_torch.ops.layernorm import layer_norm

BERT_INTERMEDIATE = 3072
BERT_LN_EPS = 1e-12
BERT_DROPOUT = 0.1
FUSION_DROPOUT = 0.5
BERT_HEADS = 8
BERT_MAX_POSITIONS = 512


class CombinerSimple(nn.Module):
    """out = normalize(σ·text + (1−σ)·image), σ = MLP(proj_text ⊕ proj_image).

    The `nn.Sequential` holders keep the reference's parameter names
    (`text_projection_layer.0`, `dynamic_scalar.{0,3}`). In eval the
    forward is kernel B12 (`combiner_apply`); in train mode it calls the
    Linear layers itself, so dropout can take a generator."""

    def __init__(self, feature_dim: int):
        super().__init__()
        proj, hidden = 4 * feature_dim, 8 * feature_dim
        self.text_projection_layer = nn.Sequential(
            nn.Linear(feature_dim, proj), nn.ReLU(), nn.Dropout(FUSION_DROPOUT))
        self.image_projection_layer = nn.Sequential(
            nn.Linear(feature_dim, proj), nn.ReLU(), nn.Dropout(FUSION_DROPOUT))
        self.dynamic_scalar = nn.Sequential(
            nn.Linear(2 * proj, hidden), nn.ReLU(), nn.Dropout(FUSION_DROPOUT),
            nn.Linear(hidden, 1), nn.Sigmoid())

    def forward(self, image_features: torch.Tensor, text_features: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if generator is None:
            return combiner_apply(image_features, text_features, self)

        def project(layer: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
            return dropout(F.relu(layer[0](x)), FUSION_DROPOUT, generator)

        cat = torch.cat([project(self.text_projection_layer, text_features),
                         project(self.image_projection_layer, image_features)], dim=-1)
        h = project(self.dynamic_scalar, cat)
        sigma = torch.sigmoid(self.dynamic_scalar[3](h))
        return torch_normalize(sigma * text_features + (1.0 - sigma) * image_features)


class VisualSR(nn.Module):
    """Self-attention pooling of patch embeddings into one embedding.
    The local branch's BatchNorm runs over the patch axis
    (num_features = num_region = 13), a reference quirk kept as is."""

    def __init__(self, embed_dim: int, num_region: int = 13):
        super().__init__()
        self.embedding_local = nn.Sequential(
            nn.Linear(embed_dim, embed_dim), TorchBatchNorm(num_region, feature_axis=1),
            nn.Tanh(), nn.Dropout(FUSION_DROPOUT))
        self.embedding_global = nn.Sequential(
            nn.Linear(embed_dim, embed_dim), TorchBatchNorm(embed_dim, feature_axis=-1),
            nn.Tanh(), nn.Dropout(FUSION_DROPOUT))
        self.embedding_common = nn.Linear(embed_dim, 1)

    def forward(self, local_feature: torch.Tensor,  # [B, R, d]
                generator: torch.Generator | None = None) -> torch.Tensor:
        train = generator is not None

        def embed(layer: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
            x = torch.tanh(layer[1](layer[0](x), train=train))
            return dropout(x, FUSION_DROPOUT, generator)

        l_emb = embed(self.embedding_local, local_feature)
        g_emb = embed(self.embedding_global, local_feature.mean(dim=1))
        logits = self.embedding_common(l_emb * g_emb[:, None, :])[..., 0]
        weights = torch.softmax(logits, dim=1)                 # over patches
        return sr_l2norm(torch.sum(weights[..., None] * local_feature, dim=1))


class _DenseLayerNorm(nn.Module):
    """HF BertSelfOutput / BertOutput parameters: dense + LayerNorm."""

    def __init__(self, d_in: int, d: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d)
        self.LayerNorm = nn.LayerNorm(d, eps=BERT_LN_EPS)

    def forward(self, hidden: torch.Tensor, residual: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        out = dropout(self.dense(hidden), BERT_DROPOUT, generator)
        return layer_norm(residual + out, self.LayerNorm.weight, self.LayerNorm.bias,
                          BERT_LN_EPS)


class _SelfAttentionParams(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)


class _AttentionParams(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.self = _SelfAttentionParams(d)
        self.output = _DenseLayerNorm(d, d)


class _Linear(nn.Module):
    """A holder whose only child is `dense` (HF BertIntermediate, BertPooler)."""

    def __init__(self, d_in: int, d: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d)


class BertLayer(nn.Module):
    """Post-LN BERT layer. In eval the q/k/v weights concatenate into one
    packed projection (`fusion.py:143-145`) for kernel B7; in train mode
    q, k and v are projected apart and the attention drops probabilities
    (`fusion.py:146-158`). The concatenation runs on every eval call: at
    d = 640 it reads and writes 4.9 MB a layer, under 3 µs at the card's
    3.35 TB/s, where a query takes milliseconds."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.attention = _AttentionParams(hidden)
        self.intermediate = _Linear(hidden, BERT_INTERMEDIATE)
        self.output = _DenseLayerNorm(BERT_INTERMEDIATE, hidden)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        qkv = self.attention.self
        if generator is None:
            ctx = fused_qkv_self_attention(
                x, torch.cat([qkv.query.weight, qkv.key.weight, qkv.value.weight]),
                torch.cat([qkv.query.bias, qkv.key.bias, qkv.value.bias]), self.heads)
        else:
            b, s, d = x.shape
            dh = d // self.heads

            def heads(lin: nn.Linear) -> torch.Tensor:
                return lin(x).reshape(b, s, self.heads, dh).transpose(1, 2)

            ctx = multi_head_attention(heads(qkv.query), heads(qkv.key), heads(qkv.value),
                                       dropout_rate=BERT_DROPOUT, generator=generator)
            ctx = ctx.transpose(1, 2).reshape(b, s, d)
        x = self.attention.output(ctx, x, generator)
        return self.output(F.gelu(self.intermediate.dense(x)), x, generator)


class _Embeddings(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.position_embeddings = nn.Embedding(BERT_MAX_POSITIONS, d)
        self.token_type_embeddings = nn.Embedding(2, d)
        self.LayerNorm = nn.LayerNorm(d, eps=BERT_LN_EPS)


class _LayerStack(nn.Module):
    def __init__(self, hidden: int, heads: int, layers: int):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(hidden, heads) for _ in range(layers))


class BertEncoder(nn.Module):
    """HF `BertModel(inputs_embeds=...)`: position + token-type
    embeddings, LN, post-LN layers, tanh pooler."""

    def __init__(self, hidden: int, heads: int = BERT_HEADS, layers: int = 3):
        super().__init__()
        self.embeddings = _Embeddings(hidden)
        self.encoder = _LayerStack(hidden, heads, layers)
        self.pooler = _Linear(hidden, hidden)

    def forward(self, inputs_embeds: torch.Tensor, token_type_ids: torch.Tensor,
                generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        s = inputs_embeds.shape[1]
        emb = self.embeddings
        x = (inputs_embeds + emb.position_embeddings.weight[:s]
             + emb.token_type_embeddings(token_type_ids))
        x = layer_norm(x, emb.LayerNorm.weight, emb.LayerNorm.bias, BERT_LN_EPS)
        x = dropout(x, BERT_DROPOUT, generator)
        for layer in self.encoder.layer:
            x = layer(x, generator)
        return x, torch.tanh(self.pooler.dense(x[:, 0]))


class _EncoderModel(nn.Module):
    def __init__(self, hidden: int, layers: int):
        super().__init__()
        self.bert_model = BertEncoder(hidden, BERT_HEADS, layers)


class PlusModel(nn.Module):
    """[CLS] ⊕ patches ⊕ text tokens -> mini-BERT. Returns
    (normalized pooler, last hidden state, pooler)."""

    def __init__(self, feature_dim: int, layers: int = 2):
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, feature_dim))
        self.bert_encoder = _EncoderModel(feature_dim, layers)

    def forward(self, reference_features: torch.Tensor, text_features: torch.Tensor,
                generator: torch.Generator | None = None):
        b, patch_num, d = reference_features.shape
        seq_num = text_features.shape[1]
        inputs = torch.cat([self.cls_token.expand(b, 1, d), reference_features,
                            text_features], dim=1)
        token_type_ids = torch.cat(
            [torch.zeros((b, patch_num + 1), dtype=torch.long),
             torch.ones((b, seq_num), dtype=torch.long)], dim=1).to(inputs.device)
        last_hidden, pooled = self.bert_encoder.bert_model(inputs, token_type_ids, generator)
        return torch_normalize(pooled), last_hidden, pooled


class DVRModule(nn.Module):
    """Dual-view refinement: query-side fusion of reference image + text."""

    def __init__(self, feature_dim: int, num_region: int = 13):
        super().__init__()
        self.transformer_layer = PlusModel(feature_dim, layers=2)
        self.MR_component = TorchMultiheadAttention(feature_dim, num_heads=8,
                                                    dropout=BERT_DROPOUT)
        self.SR_module = VisualSR(feature_dim, num_region)
        self.combiner_global = CombinerSimple(feature_dim)
        self.combiner_local = CombinerSimple(feature_dim)
        self.combiner = CombinerSimple(feature_dim)

    def forward(self, ref_patch_features: torch.Tensor, text_seq_features: torch.Tensor,
                ref_global_feats: torch.Tensor, text_global_feats: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        _, last_hidden, _ = self.transformer_layer(ref_patch_features, text_seq_features,
                                                   generator)
        patch_num = ref_patch_features.shape[1]
        image_norm = torch_normalize(last_hidden[:, 1:patch_num + 1], dim=2)
        text_norm = torch_normalize(last_hidden[:, patch_num + 1:], dim=2)
        cross = self.MR_component(text_norm, image_norm, image_norm, generator)
        # the reference keeps only the first `patch_num` text-query outputs
        patch_vision_mean = self.SR_module(cross[:, :patch_num], generator)
        global_feats = self.combiner_global(ref_global_feats, text_global_feats, generator)
        local_feats = self.combiner_local(patch_vision_mean, text_norm.mean(dim=1), generator)
        return self.combiner(global_feats, local_feats, generator)
