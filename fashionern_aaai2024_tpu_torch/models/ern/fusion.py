"""The ERN fusion stack (eval mode).

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
(`fusion.py:273-275`). The attention sites run the plain formulas of
`ops/attention.py`, as they ran on XLA on the TPU. Dropout is identity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fashionern_aaai2024_tpu_torch.models.ern.layers import (
    TorchMultiheadAttention,
    sr_l2norm,
    torch_normalize,
)
from fashionern_aaai2024_tpu_torch.ops.attention import fused_qkv_self_attention
from fashionern_aaai2024_tpu_torch.ops.common import layer_norm

BERT_INTERMEDIATE = 3072
BERT_LN_EPS = 1e-12
BERT_HEADS = 8
BERT_MAX_POSITIONS = 512


class CombinerSimple(nn.Module):
    """out = normalize(σ·text + (1−σ)·image), σ = MLP(proj_text ⊕ proj_image)."""

    def __init__(self, feature_dim: int):
        super().__init__()
        proj, hidden = 4 * feature_dim, 8 * feature_dim
        self.text_projection_layer = nn.Sequential(
            nn.Linear(feature_dim, proj), nn.ReLU(), nn.Dropout(0.5))
        self.image_projection_layer = nn.Sequential(
            nn.Linear(feature_dim, proj), nn.ReLU(), nn.Dropout(0.5))
        self.dynamic_scalar = nn.Sequential(
            nn.Linear(2 * proj, hidden), nn.ReLU(), nn.Dropout(0.5),
            nn.Linear(hidden, 1), nn.Sigmoid())

    def forward(self, image_features: torch.Tensor,
                text_features: torch.Tensor) -> torch.Tensor:
        cat = torch.cat([self.text_projection_layer(text_features),
                         self.image_projection_layer(image_features)], dim=-1)
        sigma = self.dynamic_scalar(cat)
        return torch_normalize(sigma * text_features + (1.0 - sigma) * image_features)


class VisualSR(nn.Module):
    """Self-attention pooling of patch embeddings into one embedding.
    The local branch's BatchNorm runs over the patch axis
    (num_features = num_region = 13), a reference quirk kept as is."""

    def __init__(self, embed_dim: int, num_region: int = 13):
        super().__init__()
        self.embedding_local = nn.Sequential(
            nn.Linear(embed_dim, embed_dim), nn.BatchNorm1d(num_region), nn.Tanh(),
            nn.Dropout(0.5))
        self.embedding_global = nn.Sequential(
            nn.Linear(embed_dim, embed_dim), nn.BatchNorm1d(embed_dim), nn.Tanh(),
            nn.Dropout(0.5))
        self.embedding_common = nn.Linear(embed_dim, 1)

    def forward(self, local_feature: torch.Tensor) -> torch.Tensor:  # [B, R, d]
        l_emb = self.embedding_local(local_feature)
        g_emb = self.embedding_global(local_feature.mean(dim=1))
        logits = self.embedding_common(l_emb * g_emb[:, None, :])[..., 0]
        weights = torch.softmax(logits, dim=1)                 # over patches
        return sr_l2norm(torch.sum(weights[..., None] * local_feature, dim=1))


class _DenseLayerNorm(nn.Module):
    """HF BertSelfOutput / BertOutput parameters: dense + LayerNorm."""

    def __init__(self, d_in: int, d: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d)
        self.LayerNorm = nn.LayerNorm(d, eps=BERT_LN_EPS)

    def forward(self, hidden: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return layer_norm(residual + self.dense(hidden), self.LayerNorm.weight,
                          self.LayerNorm.bias, BERT_LN_EPS)


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
    """Post-LN BERT layer. The q/k/v weights concatenate into one packed
    projection (`fusion.py:143-145`)."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.attention = _AttentionParams(hidden)
        self.intermediate = _Linear(hidden, BERT_INTERMEDIATE)
        self.output = _DenseLayerNorm(BERT_INTERMEDIATE, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = self.attention.self
        ctx = fused_qkv_self_attention(
            x, torch.cat([qkv.query.weight, qkv.key.weight, qkv.value.weight]),
            torch.cat([qkv.query.bias, qkv.key.bias, qkv.value.bias]), self.heads)
        x = self.attention.output(ctx, x)
        return self.output(F.gelu(self.intermediate.dense(x)), x)


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

    def forward(self, inputs_embeds: torch.Tensor,
                token_type_ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        s = inputs_embeds.shape[1]
        emb = self.embeddings
        x = (inputs_embeds + emb.position_embeddings.weight[:s]
             + emb.token_type_embeddings(token_type_ids))
        x = layer_norm(x, emb.LayerNorm.weight, emb.LayerNorm.bias, BERT_LN_EPS)
        for layer in self.encoder.layer:
            x = layer(x)
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

    def forward(self, reference_features: torch.Tensor, text_features: torch.Tensor):
        b, patch_num, d = reference_features.shape
        seq_num = text_features.shape[1]
        inputs = torch.cat([self.cls_token.expand(b, 1, d), reference_features,
                            text_features], dim=1)
        token_type_ids = torch.cat(
            [torch.zeros((b, patch_num + 1), dtype=torch.long),
             torch.ones((b, seq_num), dtype=torch.long)], dim=1).to(inputs.device)
        last_hidden, pooled = self.bert_encoder.bert_model(inputs, token_type_ids)
        return torch_normalize(pooled), last_hidden, pooled


class DVRModule(nn.Module):
    """Dual-view refinement: query-side fusion of reference image + text."""

    def __init__(self, feature_dim: int, num_region: int = 13):
        super().__init__()
        self.transformer_layer = PlusModel(feature_dim, layers=2)
        self.MR_component = TorchMultiheadAttention(feature_dim, num_heads=8)
        self.SR_module = VisualSR(feature_dim, num_region)
        self.combiner_global = CombinerSimple(feature_dim)
        self.combiner_local = CombinerSimple(feature_dim)
        self.combiner = CombinerSimple(feature_dim)

    def forward(self, ref_patch_features: torch.Tensor, text_seq_features: torch.Tensor,
                ref_global_feats: torch.Tensor,
                text_global_feats: torch.Tensor) -> torch.Tensor:
        _, last_hidden, _ = self.transformer_layer(ref_patch_features, text_seq_features)
        patch_num = ref_patch_features.shape[1]
        image_norm = torch_normalize(last_hidden[:, 1:patch_num + 1], dim=2)
        text_norm = torch_normalize(last_hidden[:, patch_num + 1:], dim=2)
        cross = self.MR_component(text_norm, image_norm, image_norm)
        # the reference keeps only the first `patch_num` text-query outputs
        patch_vision_mean = self.SR_module(cross[:, :patch_num])
        global_feats = self.combiner_global(ref_global_feats, text_global_feats)
        local_feats = self.combiner_local(patch_vision_mean, text_norm.mean(dim=1))
        return self.combiner(global_feats, local_feats)
