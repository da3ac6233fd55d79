"""The reference's ablation-loss toolbox (`losses/others/`), as functions
on tensors behind a registry.

JAX counterpart: `fashionern_aaai2024_tpu/ops/extra_losses.py`. None of
these is on the main path; BBC (`ops/losses.py`, kernel B4 on the card)
is the only load-bearing loss, and the registry's "bbc" calls it. Every
loss is differentiable by autograd.

  * ce             plain cross-entropy (`losses/others/ce_loss.py:5-14`)
  * rank           NLL with a confidence-band ignore mask, the mask
                   detached as JAX stops its gradient
                   (`losses/others/rank_loss.py:6-29`)
  * cyclip         CLIP contrastive + in-modal and cross-modal cyclic
                   consistency (`losses/others/cyclip_loss.py:5-39`)
  * text_relevance contrastive + a FIFO memory bank of detached query
                   and doc features, newest rows first
                   (`losses/others/text_relevance_loss.py:6-59`); the
                   bank is a value: each call returns the new one
  * text_generation caption reconstruction through a caller's
                   encoder-conditioned LM (`generation_loss.py:5-27`)
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from fashionern_aaai2024_tpu_torch.ops.losses import batch_based_classification_loss

# log(1 / 0.07) taken in fp32, as the JAX constant is
LOGIT_SCALE_INIT = float(torch.tensor(1.0 / 0.07).log())
# the logits of bank rows not yet filled
_EMPTY_ROW = -1e30


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """`nn.CrossEntropyLoss()` over int labels, in fp32."""
    return F.cross_entropy(logits.float(), labels)


def accuracy(logits: torch.Tensor, labels: torch.Tensor, topk=(1,)) -> list[torch.Tensor]:
    """Top-k accuracy (%) (`losses/others/ce_loss.py:17-30`). Ties rank
    the lower index first, as `lax.top_k` does: a stable descending sort,
    where `torch.topk`'s order among ties is not fixed."""
    maxk = max(topk)
    pred = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :maxk]
    correct = pred == labels[:, None]
    return [100.0 * correct[:, :k].any(dim=1).float().mean() for k in topk]


def rank_loss(inputs: torch.Tensor, targets: torch.Tensor, margin_pos: float = 1.0,
              margin_neg: float = 0.0, weight: torch.Tensor | None = None) -> torch.Tensor:
    """NLL over log-softmax with the rows ignored whose class-1
    probability leaves the (margin_neg, margin_pos) band (`rank_loss.py:
    16-29`, the active mask)."""
    logp = F.log_softmax(inputs.float(), dim=-1)
    prob1 = torch.exp(logp).detach()[:, 1]
    ignore = ((prob1 > margin_pos) | (prob1 < margin_neg)).float()
    picked = ((1.0 - ignore)[:, None] * logp).gather(1, targets[:, None])[:, 0]
    if weight is not None:
        w = weight[targets]
        return -torch.sum(w * picked) / torch.sum(w)
    return -picked.mean()


def cyclip_loss(image_emb: torch.Tensor, text_emb: torch.Tensor, logit_scale: torch.Tensor,
                cylambda1: float = 0.25, cylambda2: float = 0.25) -> torch.Tensor:
    """CLIP contrastive + cyclic consistency (`cyclip_loss.py:16-39`);
    `logit_scale` is the learnable log-temperature's value (init
    log(1 / 0.07))."""
    b = image_emb.shape[0]
    labels = torch.arange(b, device=image_emb.device)
    s = logit_scale
    l_it = s * image_emb @ text_emb.t()
    l_ti = s * text_emb @ image_emb.t()
    l_ii = s * image_emb @ image_emb.t()
    l_tt = s * text_emb @ text_emb.t()
    contrastive = (cross_entropy_loss(l_it, labels) + cross_entropy_loss(l_ti, labels)) / 2
    crossmodal = torch.mean((l_ti - l_it) ** 2) / (s * s) * b
    inmodal = torch.mean((l_ii - l_tt) ** 2) / (s * s) * b
    return contrastive + cylambda1 * inmodal + cylambda2 * crossmodal


@dataclasses.dataclass(frozen=True)
class TextRelevanceBank:
    """FIFO feature bank, newest rows first; `size` counts valid rows.
    `create` allocates it on the card unless the caller names another
    device (JAX's on the default device)."""

    query: torch.Tensor   # [K, d]
    doc: torch.Tensor     # [K, d]
    size: int

    @classmethod
    def create(cls, capacity: int, dim: int,
               device: torch.device | str = "cuda") -> "TextRelevanceBank":
        zeros = torch.zeros((capacity, dim), dtype=torch.float32, device=device)
        return cls(query=zeros, doc=zeros.clone(), size=0)


def text_relevance_loss(bank: TextRelevanceBank, image_emb: torch.Tensor,
                        text_emb: torch.Tensor, logit_scale: torch.Tensor,
                        ) -> tuple[torch.Tensor, TextRelevanceBank]:
    """Contrastive + memory-bank loss (`text_relevance_loss.py:44-59`):
    returns (loss, the new bank). The bank's rows are detached; rows not
    yet filled are masked out of the logits."""
    b = image_emb.shape[0]
    k = bank.query.shape[0]
    labels = torch.arange(b, device=image_emb.device)
    s = logit_scale
    loss_img = cross_entropy_loss(s * image_emb @ text_emb.t(), labels)
    loss_txt = cross_entropy_loss(s * text_emb @ image_emb.t(), labels)
    new_bank = TextRelevanceBank(query=torch.cat([image_emb.detach(), bank.query])[:k],
                                 doc=torch.cat([text_emb.detach(), bank.doc])[:k],
                                 size=min(bank.size + b, k))
    valid = torch.arange(k, device=image_emb.device) < new_bank.size
    neg_mask = torch.where(valid, 0.0, _EMPTY_ROW)[None, :]
    loss_1 = cross_entropy_loss(s * image_emb @ new_bank.doc.t() + neg_mask, labels)
    loss_2 = cross_entropy_loss(s * text_emb @ new_bank.query.t() + neg_mask, labels)
    return (loss_img + loss_txt + loss_1 + loss_2) / 4.0, new_bank


def text_generation_loss(generation_model: Callable, text_input: dict,
                         fusion_emb: torch.Tensor) -> torch.Tensor:
    """Caption reconstruction through a caller's encoder-conditioned LM
    (`generation_loss.py:12-27`): the tokenized caption is both input and
    labels, the fusion embedding one encoder hidden state."""
    return generation_model(
        input_ids=text_input["input_ids"],
        token_type_ids=text_input.get("token_type_ids"),
        attention_mask=text_input.get("attention_mask"),
        encoder_hidden_states=fusion_emb[:, None, :],
        labels=text_input["input_ids"],
    )


@dataclasses.dataclass(frozen=True)
class LossSpec:
    name: str
    fn: Callable
    stateful: bool = False
    notes: str = ""


LOSS_REGISTRY: dict[str, LossSpec] = {
    "bbc": LossSpec("bbc", batch_based_classification_loss,
                    notes="main-path loss (losses/loss.py:6-14)"),
    "ce": LossSpec("ce", cross_entropy_loss),
    "rank": LossSpec("rank", rank_loss),
    "cyclip": LossSpec("cyclip", cyclip_loss),
    "text_relevance": LossSpec("text_relevance", text_relevance_loss, stateful=True),
    "text_generation": LossSpec("text_generation", text_generation_loss,
                                notes="requires an external generation model"),
}


def get_loss(name: str) -> LossSpec:
    if name not in LOSS_REGISTRY:
        raise ValueError(f"unknown loss {name!r}; available: {sorted(LOSS_REGISTRY)}")
    return LOSS_REGISTRY[name]
