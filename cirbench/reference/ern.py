"""The ERN towers and TME in plain fp32 PyTorch, in eval mode: the
benchmark's reference.

Written from FashionERN (AAAI 2024, github.com/ChenAnno/FashionERN_AAAI2024,
`models/fusion_model.py`) under its state-dict names (`ern.*`), with
TME as the port names it (`ern.TME.*`):
  * TME: text_seq + CrossAttn(LN(text_seq), visual_proj(patches)),
    LayerNorm eps 1e-6, 8 heads; the global feature is the enhanced row at
    the EOT position;
  * index tower (gallery side): Combiner(normalize(global), SR(patches));
  * DVR query tower: [CLS] + patches + text tokens through a 2-layer
    post-LN BERT (eps 1e-12, exact GELU, token type 0 for CLS and the
    patches), the MR cross-attention of the normalized text tokens over
    the normalized patch tokens, SR over the first `patch_num` outputs,
    and three gated Combiners;
  * search: exact top-k of the query rows' dot products with the gallery.
Eval mode (`train=None`): no dropout, BatchNorm over its running
statistics. Train mode (`train`, a `reference/train.py TrainMode`): the
reference's dropout sites and BatchNorm batch statistics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cirbench.reference.clip import attention, f32, layer_norm
from cirbench.reference.ops import PLAIN, Ops
from cirbench.reference.train import TrainMode

BERT_LN_EPS = 1e-12
TME_LN_EPS = 1e-6


def normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) (torch.nn.functional.normalize)."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def tme(text_seq: torch.Tensor, patches: torch.Tensor, W: dict, heads: int,
        ops: Ops = PLAIN) -> torch.Tensor:
    pre = "ern.TME."
    v = ops.linear(patches, W[pre + "visual_proj.weight"], W[pre + "visual_proj.bias"])
    q = layer_norm(text_seq, W[pre + "ln.weight"], W[pre + "ln.bias"], TME_LN_EPS)
    ca = pre + "cross_attn."
    o = attention(ops.linear(q, W[ca + "query.weight"], W[ca + "query.bias"]),
                  ops.linear(v, W[ca + "key.weight"], W[ca + "key.bias"]),
                  ops.linear(v, W[ca + "value.weight"], W[ca + "value.bias"]), heads, ops=ops)
    return text_seq + ops.linear(o, W[ca + "out.weight"], W[ca + "out.bias"])


def enhanced_text(ids: torch.Tensor, text_seq: torch.Tensor, patches: torch.Tensor, W: dict,
                  heads: int, ops: Ops = PLAIN) -> tuple[torch.Tensor, torch.Tensor]:
    """(global at the EOT position, seq) of TME over the text tower's seq."""
    seq = tme(text_seq, patches, W, heads, ops)
    eot = ids.long().argmax(dim=-1)
    return seq[torch.arange(seq.shape[0], device=seq.device), eot], seq


def combiner(image: torch.Tensor, text: torch.Tensor, W: dict, pre: str,
             ops: Ops = PLAIN, train: TrainMode | None = None) -> torch.Tensor:
    """normalize(σ·text + (1 − σ)·image), σ = sigmoid(MLP(relu(proj_t text) ⊕
    relu(proj_i image))); dropout 0.5 after each ReLU in train mode."""
    drop = TrainMode.dropout_of(train)
    tp = drop(F.relu(ops.linear(text, W[pre + "text_projection_layer.0.weight"],
                                W[pre + "text_projection_layer.0.bias"])), 0.5)
    ip = drop(F.relu(ops.linear(image, W[pre + "image_projection_layer.0.weight"],
                                W[pre + "image_projection_layer.0.bias"])), 0.5)
    h = drop(F.relu(ops.linear(torch.cat([tp, ip], dim=-1), W[pre + "dynamic_scalar.0.weight"],
                               W[pre + "dynamic_scalar.0.bias"])), 0.5)
    sigma = torch.sigmoid(ops.linear(h, W[pre + "dynamic_scalar.3.weight"],
                                     W[pre + "dynamic_scalar.3.bias"]))
    return normalize(sigma * text + (1.0 - sigma) * image)


def _batch_norm(x: torch.Tensor, W: dict, pre: str, axis: int,
                train: TrainMode | None) -> torch.Tensor:
    """BatchNorm over `axis`: running statistics in eval; in train mode the
    batch's, the variance as max(0, E[x²] − E[x]²)."""
    axis %= x.ndim
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    if train is None:
        mean, var = f32(W[pre + "running_mean"]), f32(W[pre + "running_var"])
    else:
        dims = tuple(i for i in range(x.ndim) if i != axis)
        mean = x.mean(dim=dims)
        var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
    scale = torch.rsqrt(var + 1e-5) * f32(W[pre + "weight"])
    return (x - mean.reshape(shape)) * scale.reshape(shape) + f32(W[pre + "bias"]).reshape(shape)


def visual_sr(local: torch.Tensor, W: dict, pre: str, ops: Ops = PLAIN,
              train: TrainMode | None = None) -> torch.Tensor:
    """Patch attention pooling [B, R, d] -> [B, d], x / (||x|| + 1e-8). The
    local branch's BatchNorm runs over the patch axis (13 features);
    dropout 0.5 after each tanh in train mode."""
    drop = TrainMode.dropout_of(train)
    l_emb = drop(torch.tanh(_batch_norm(
        ops.linear(local, W[pre + "embedding_local.0.weight"], W[pre + "embedding_local.0.bias"]),
        W, pre + "embedding_local.1.", 1, train)), 0.5)
    g_emb = drop(torch.tanh(_batch_norm(
        ops.linear(local.mean(dim=1), W[pre + "embedding_global.0.weight"],
                   W[pre + "embedding_global.0.bias"]), W, pre + "embedding_global.1.", -1,
        train)), 0.5)
    logits = ops.linear(l_emb * g_emb[:, None, :], W[pre + "embedding_common.weight"],
                        W[pre + "embedding_common.bias"])[..., 0]
    pooled = torch.sum(torch.softmax(logits, dim=1)[..., None] * local, dim=1)
    return pooled / (torch.linalg.vector_norm(pooled, dim=-1, keepdim=True) + 1e-8)


def index(global_feats: torch.Tensor, patches: torch.Tensor, W: dict,
          ops: Ops = PLAIN, train: TrainMode | None = None) -> torch.Tensor:
    """The gallery's refined rows from the image tower's raw globals (eval:
    L2-normalized here, eps 1e-12 added; train mode takes them normalized)."""
    g = global_feats
    if train is None:
        g = g / (torch.linalg.vector_norm(g, dim=-1, keepdim=True) + 1e-12)
    return combiner(g, visual_sr(patches, W, "ern.SR_module.", ops, train), W,
                    "ern.Combiner_module.", ops, train)


def _bert_layer(x: torch.Tensor, W: dict, pre: str, heads: int, ops: Ops,
                train: TrainMode | None) -> torch.Tensor:
    drop = TrainMode.dropout_of(train)
    a = pre + "attention."
    q = ops.linear(x, W[a + "self.query.weight"], W[a + "self.query.bias"])
    k = ops.linear(x, W[a + "self.key.weight"], W[a + "self.key.bias"])
    v = ops.linear(x, W[a + "self.value.weight"], W[a + "self.value.bias"])
    ctx = attention(q, k, v, heads, ops=ops, drop=drop, rate=0.1)
    out = drop(ops.linear(ctx, W[a + "output.dense.weight"], W[a + "output.dense.bias"]), 0.1)
    x = layer_norm(x + out, W[a + "output.LayerNorm.weight"], W[a + "output.LayerNorm.bias"],
                   BERT_LN_EPS)
    h = F.gelu(ops.linear(x, W[pre + "intermediate.dense.weight"],
                          W[pre + "intermediate.dense.bias"]))
    out = drop(ops.linear(h, W[pre + "output.dense.weight"], W[pre + "output.dense.bias"]), 0.1)
    return layer_norm(x + out, W[pre + "output.LayerNorm.weight"],
                      W[pre + "output.LayerNorm.bias"], BERT_LN_EPS)


def _bert(inputs: torch.Tensor, token_types: torch.Tensor, W: dict, pre: str, layers: int,
          heads: int, ops: Ops, train: TrainMode | None) -> torch.Tensor:
    s = inputs.shape[1]
    e = pre + "embeddings."
    x = (inputs + f32(W[e + "position_embeddings.weight"])[:s]
         + f32(W[e + "token_type_embeddings.weight"])[token_types])
    x = layer_norm(x, W[e + "LayerNorm.weight"], W[e + "LayerNorm.bias"], BERT_LN_EPS)
    x = TrainMode.dropout_of(train)(x, 0.1)
    for i in range(layers):
        x = _bert_layer(x, W, f"{pre}encoder.layer.{i}.", heads, ops, train)
    return x


def dvr(ref_patches: torch.Tensor, text_seq: torch.Tensor, ref_global: torch.Tensor,
        text_global: torch.Tensor, W: dict, ern: dict, ops: Ops = PLAIN,
        train: TrainMode | None = None) -> torch.Tensor:
    """The DVR query tower -> the query rows [B, d]. Train mode: BERT's
    dropout 0.1 (after the embedding LN, on the attention probabilities,
    after each output dense), the MR's 0.1 on its probabilities, SR's and
    the combiners' 0.5."""
    b, patch_num, d = ref_patches.shape
    seq_num = text_seq.shape[1]
    pre = "ern.DVR."
    cls = f32(W[pre + "transformer_layer.cls_token"]).expand(b, 1, d)
    inputs = torch.cat([cls, ref_patches, text_seq], dim=1)
    types = torch.cat([torch.zeros(patch_num + 1, dtype=torch.long),
                       torch.ones(seq_num, dtype=torch.long)]).to(inputs.device)
    last = _bert(inputs, types, W, pre + "transformer_layer.bert_encoder.bert_model.",
                 ern["bert_layers"], ern["bert_heads"], ops, train)
    image_norm = normalize(last[:, 1:patch_num + 1])
    text_norm = normalize(last[:, patch_num + 1:])
    mr = pre + "MR_component."
    wq, wk, wv = W[mr + "in_proj_weight"].chunk(3)
    bq, bk, bv = W[mr + "in_proj_bias"].chunk(3)
    o = attention(ops.linear(text_norm, wq, bq), ops.linear(image_norm, wk, bk),
                  ops.linear(image_norm, wv, bv), ern["mr_heads"], ops=ops,
                  drop=TrainMode.dropout_of(train), rate=0.1)
    cross = ops.linear(o, W[mr + "out_proj.weight"], W[mr + "out_proj.bias"])
    patch_mean = visual_sr(cross[:, :patch_num], W, pre + "SR_module.", ops, train)
    global_feats = combiner(ref_global, text_global, W, pre + "combiner_global.", ops, train)
    local_feats = combiner(patch_mean, text_norm.mean(dim=1), W, pre + "combiner_local.", ops,
                           train)
    return combiner(global_feats, local_feats, W, pre + "combiner.", ops, train)


def top_k(queries: torch.Tensor, gallery: torch.Tensor, k: int
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(every score [B, N], the top-k scores [B, k], their rows [B, k])."""
    scores = queries @ gallery.t()
    top, rows = scores.topk(k, dim=-1)
    return scores, top, rows
