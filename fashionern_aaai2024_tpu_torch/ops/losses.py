"""Batch-based classification loss: kernel B4 and its autograd.

JAX counterpart: `fashionern_aaai2024_tpu/ops/losses.py`. Reference
semantics (`losses/loss.py:6-14`): logits = 100 · pred @ tarᵀ, labels =
arange(B), mean cross-entropy, negatives local to the device's batch.

  * `bbc_rowloss` (B4, TPU kernel `_bbc_rowloss_pallas`, `:55`, kernel
    body `:33`): one fp32 row loss per query,
    logsumexp_j(temp · p_i·t_j) − temp · p_i·t_i. On a CUDA tensor it
    launches `csrc/bbc_loss.cu` (the scores by 3xTF32 on the tensor
    cores, fp32-accurate), which keeps the [B, B] logits out of device
    memory as the Pallas kernel did; on a CPU tensor it takes
    `bbc_rowloss_plain`, the `_bbc_rowloss_ref` formula (`:76`) in fp32.
  * `BBCMeanLoss`, the `torch.autograd.Function` of `_bbc_mean_loss`
    (`:83-110`): the forward is `bbc_rowloss` (the kernel on the card),
    the backward is `_bbc_bwd` (`:96-107`) in plain PyTorch: recompute
    the softmax, subtract the identity, two products. In the JAX package
    the backward is two XLA matmuls, not a Pallas kernel, so there is no
    TPU backward kernel to port; the products go to `torch.matmul`.
  * `batch_based_classification_loss` (`:113`): "local" negatives; the
    "global" negatives of a multi-device run (an all-gather of the
    targets) are not ported (ROADMAP A8): with no process group they are
    the local ones, as in a one-device JAX run, and with one they raise.
"""

from __future__ import annotations

import torch

from fashionern_aaai2024_tpu_torch.ops import common

TEMPERATURE = 100.0
# rows and columns of one score tile in csrc/bbc_loss.cu
_ROW_TILE, _COL_TILE = 128, 64


def bbc_rowloss_plain(pred: torch.Tensor, tar: torch.Tensor,
                      temp: float = TEMPERATURE) -> torch.Tensor:
    """`_bbc_rowloss_ref`: fp32 scores, logsumexp minus the diagonal."""
    s = temp * torch.matmul(pred.float(), tar.float().t())
    return torch.logsumexp(s, dim=-1) - torch.diagonal(s)


def split_plan(b: int, sms: int) -> tuple[int, int]:
    """(column splits, column tiles per split) of the kernel's grid of
    128-row tiles x splits: one block an SM, no more blocks than SMs
    unless the row tiles alone exceed them, every split owning at least
    one 64-wide column tile."""
    rows, tiles = -(-b // _ROW_TILE), -(-b // _COL_TILE)
    want = min(tiles, max(1, sms // rows))
    per_split = -(-tiles // want)
    return -(-tiles // per_split), per_split


def _padded(t: torch.Tensor, width: int) -> torch.Tensor:
    """A fresh (aligned) [B, width] copy of t [B, d], zero past column d."""
    out = torch.zeros((t.shape[0], width), dtype=t.dtype, device=t.device)
    out[:, :t.shape[1]] = t
    return out


def bbc_rowloss(pred: torch.Tensor, tar: torch.Tensor,
                temp: float = TEMPERATURE) -> torch.Tensor:
    """Row losses [B] fp32 for pred, tar [B, d] (B4). CUDA: the kernel,
    fp32 operands only. CPU: the plain version."""
    if pred.ndim != 2 or pred.shape != tar.shape:
        raise ValueError(f"bbc_rowloss: pred {tuple(pred.shape)} and tar "
                         f"{tuple(tar.shape)} must both be [B, d]")
    if not common.is_cuda(pred):
        return bbc_rowloss_plain(pred, tar, temp)
    if pred.dtype != torch.float32 or tar.dtype != torch.float32:
        raise TypeError(f"bbc_rowloss: the kernel takes float32, got {pred.dtype} "
                        f"and {tar.dtype}")
    common.check_cuda_operands("bbc_rowloss", pred, tar)
    b, d = pred.shape
    if d % 4 or pred.data_ptr() % 16 or tar.data_ptr() % 16:
        # TMA's rules (16-byte row strides and bases): zero columns leave
        # every score as it is, as the Pallas kernel pads d to 128
        pred, tar = (_padded(t, d + -d % 4) for t in (pred, tar))
        d += -d % 4
    splits, per_split = split_plan(b, common.sm_count(pred.get_device()))
    row = torch.empty((b,), dtype=torch.float32, device=pred.device)
    scratch = torch.empty((2 * splits + 1, b), dtype=torch.float32, device=pred.device)
    common.launch("fern_bbc_rowloss", pred.data_ptr(), tar.data_ptr(), row.data_ptr(),
                  scratch[:splits].data_ptr(), scratch[splits:2 * splits].data_ptr(),
                  scratch[2 * splits].data_ptr(), b, d, temp, splits, per_split,
                  pred.get_device(), common.stream_of(pred))
    bbc_rowloss.launches += 1
    return row


bbc_rowloss.launches = 0


def bbc_flops_bytes(b: int, d: int) -> tuple[int, int]:
    """Work of one B4 call: 2·B²·d flops; pred and tar read once and the
    row losses written once, in fp32."""
    return 2 * b * b * d, (2 * b * d + b) * 4


class BBCMeanLoss(torch.autograd.Function):
    """mean(bbc_rowloss(pred, tar)) with the `_bbc_bwd` backward."""

    @staticmethod
    def forward(ctx, pred: torch.Tensor, tar: torch.Tensor, temp: float) -> torch.Tensor:
        ctx.save_for_backward(pred, tar)
        ctx.temp = temp
        return bbc_rowloss(pred.contiguous(), tar.contiguous(), temp).mean()

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        pred, tar = ctx.saved_tensors
        temp = ctx.temp
        b = pred.shape[0]
        predf, tarf = pred.float(), tar.float()
        p = torch.softmax(temp * torch.matmul(predf, tarf.t()), dim=-1)
        delta = p - torch.eye(b, dtype=torch.float32, device=p.device)
        coeff = g * temp / b
        dpred = coeff * torch.matmul(delta, tarf)
        dtar = coeff * torch.matmul(delta.t(), predf)
        return dpred.to(pred.dtype), dtar.to(tar.dtype), None


def batch_based_classification_loss(predicted: torch.Tensor, target: torch.Tensor, *,
                                    temperature: float = TEMPERATURE,
                                    negatives: str = "local",
                                    process_group=None) -> torch.Tensor:
    """Mean CE over in-batch negatives (B4 forward, `_bbc_bwd` backward)."""
    if negatives not in ("local", "global"):
        raise ValueError(f"negatives must be 'local' or 'global', got {negatives!r}")
    if negatives == "global" and process_group is not None:
        raise NotImplementedError(
            "negatives='global' across devices is not ported yet (ROADMAP.md A8)")
    return BBCMeanLoss.apply(predicted, target, temperature)

