"""Batch-based classification loss: kernel B4 and its autograd.

JAX counterpart: `fashionern_aaai2024_tpu/ops/losses.py`. Reference
semantics (`losses/loss.py:6-14`): logits = 100 · pred @ tarᵀ, labels =
arange(B), mean cross-entropy, negatives local to the device's batch.

  * `bbc_rowloss` (B4, TPU kernel `_bbc_rowloss_pallas`, `:55`, kernel
    body `:33`): one fp32 row loss per query,
    logsumexp_j(temp · p_i·t_j) − temp · p_i·t_(offset+i), for pred
    [B, d] and tar [N, d] (N = B and offset 0: the positive on the
    diagonal, the Pallas kernel's function). On a CUDA tensor it
    launches `csrc/bbc_loss.cu` (the scores by 3xTF32 on the tensor
    cores, fp32-accurate), which keeps the [B, N] logits out of device
    memory as the Pallas kernel did; on a CPU tensor it takes
    `bbc_rowloss_plain`, the `_bbc_rowloss_ref` formula (`:76`) in fp32.
  * `BBCMeanLoss`, the `torch.autograd.Function` of `_bbc_mean_loss`
    (`:83-110`): the forward is `bbc_rowloss` (the kernel on the card),
    the backward is `_bbc_bwd` (`:96-107`) in plain PyTorch: recompute
    the softmax, subtract the one-hot of each row's positive, two
    products. In the JAX package
    the backward is two XLA matmuls, not a Pallas kernel, so there is no
    TPU backward kernel to port; the products go to `torch.matmul`.
  * `batch_based_classification_loss` (`:113`): "local" negatives, or
    "global" negatives over a data-parallel mesh (`:120-139`): the
    targets all-gathered over the mesh (`parallel/mesh.py GatherRows`,
    whose gradient is JAX's reduce-scatter of the sum), local row i's
    positive at column rank · b + i, and the same B4 forward and
    backward with that offset. JAX computes the global branch with XLA's
    matmul and logsumexp; the function is B4's, so the port runs it on
    the kernel. Without a mesh, or on a one-process mesh, "global" is
    "local", as in a one-device JAX run.
"""

from __future__ import annotations

import torch

from fashionern_aaai2024_tpu_torch.ops import common
from fashionern_aaai2024_tpu_torch.parallel.mesh import GatherRows, ProcessMesh

TEMPERATURE = 100.0
# rows and columns of one score tile in csrc/bbc_loss.cu
_ROW_TILE, _COL_TILE = 128, 64


def bbc_rowloss_plain(pred: torch.Tensor, tar: torch.Tensor,
                      temp: float = TEMPERATURE, offset: int = 0) -> torch.Tensor:
    """`_bbc_rowloss_ref`: fp32 scores, logsumexp minus each row's
    positive (column offset + i; the diagonal at offset 0)."""
    s = temp * torch.matmul(pred.float(), tar.float().t())
    return torch.logsumexp(s, dim=-1) - torch.diagonal(s, offset)


def split_plan(b: int, sms: int, n: int | None = None) -> tuple[int, int]:
    """(column splits, column tiles per split) of the kernel's grid of
    128-row tiles x splits over `n` target columns (default b): one block
    an SM, no more blocks than SMs unless the row tiles alone exceed
    them, every split owning at least one 64-wide column tile."""
    n = b if n is None else n
    rows, tiles = -(-b // _ROW_TILE), -(-n // _COL_TILE)
    want = min(tiles, max(1, sms // rows))
    per_split = -(-tiles // want)
    return -(-tiles // per_split), per_split


def _padded(t: torch.Tensor, width: int) -> torch.Tensor:
    """A fresh (aligned) [B, width] copy of t [B, d], zero past column d."""
    out = torch.zeros((t.shape[0], width), dtype=t.dtype, device=t.device)
    out[:, :t.shape[1]] = t
    return out


def bbc_rowloss(pred: torch.Tensor, tar: torch.Tensor, temp: float = TEMPERATURE,
                offset: int = 0) -> torch.Tensor:
    """Row losses [B] fp32 for pred [B, d] and tar [N, d], row i's
    positive at column offset + i (B4). CUDA: the kernel, fp32 operands
    only. CPU: the plain version."""
    if (pred.ndim != 2 or tar.ndim != 2 or pred.shape[1] != tar.shape[1]
            or not 0 <= offset <= tar.shape[0] - pred.shape[0]):
        raise ValueError(f"bbc_rowloss: pred {tuple(pred.shape)} and tar "
                         f"{tuple(tar.shape)} must be [B, d] and [N, d] with "
                         f"0 <= offset ({offset}) <= N - B")
    if not common.is_cuda(pred):
        return bbc_rowloss_plain(pred, tar, temp, offset)
    if pred.dtype != torch.float32 or tar.dtype != torch.float32:
        raise TypeError(f"bbc_rowloss: the kernel takes float32, got {pred.dtype} "
                        f"and {tar.dtype}")
    common.check_cuda_operands("bbc_rowloss", pred, tar)
    (b, d), n = pred.shape, tar.shape[0]
    if d % 4 or pred.data_ptr() % 16 or tar.data_ptr() % 16:
        # TMA's rules (16-byte row strides and bases): zero columns leave
        # every score as it is, as the Pallas kernel pads d to 128
        pred, tar = (_padded(t, d + -d % 4) for t in (pred, tar))
        d += -d % 4
    splits, per_split = split_plan(b, common.sm_count(pred.get_device()), n)
    row = torch.empty((b,), dtype=torch.float32, device=pred.device)
    scratch = torch.empty((2 * splits + 1, b), dtype=torch.float32, device=pred.device)
    common.launch("fern_bbc_rowloss", pred.data_ptr(), tar.data_ptr(), row.data_ptr(),
                  scratch[:splits].data_ptr(), scratch[splits:2 * splits].data_ptr(),
                  scratch[2 * splits].data_ptr(), b, d, temp, splits, per_split, n,
                  offset, pred.get_device(), common.stream_of(pred))
    common.count(bbc_rowloss)
    return row


bbc_rowloss.launches = 0


def bbc_flops_bytes(b: int, d: int, n: int | None = None) -> tuple[int, int]:
    """Work of one B4 call over n target rows (default b): 2·B·N·d
    flops; pred and tar read once and the row losses written once, in
    fp32."""
    n = b if n is None else n
    return 2 * b * n * d, (b * d + n * d + b) * 4


class BBCMeanLoss(torch.autograd.Function):
    """mean(bbc_rowloss(pred, tar, offset)) with the `_bbc_bwd` backward:
    delta = softmax − onehot(offset + i)."""

    @staticmethod
    def forward(ctx, pred: torch.Tensor, tar: torch.Tensor, temp: float,
                offset: int = 0) -> torch.Tensor:
        ctx.save_for_backward(pred, tar)
        ctx.temp, ctx.offset = temp, offset
        return bbc_rowloss(pred.contiguous(), tar.contiguous(), temp, offset).mean()

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        pred, tar = ctx.saved_tensors
        temp = ctx.temp
        b = pred.shape[0]
        predf, tarf = pred.float(), tar.float()
        delta = torch.softmax(temp * torch.matmul(predf, tarf.t()), dim=-1)
        delta.diagonal(ctx.offset).sub_(1.0)
        coeff = g * temp / b
        dpred = coeff * torch.matmul(delta, tarf)
        dtar = coeff * torch.matmul(delta.t(), predf)
        return dpred.to(pred.dtype), dtar.to(tar.dtype), None, None


def batch_based_classification_loss(predicted: torch.Tensor, target: torch.Tensor, *,
                                    temperature: float = TEMPERATURE,
                                    negatives: str = "local",
                                    mesh: ProcessMesh | None = None) -> torch.Tensor:
    """Mean CE over in-batch negatives (B4 forward, `_bbc_bwd` backward).
    "global" with a mesh: this rank's queries against every rank's
    targets (JAX `:120-139`), the mean over this rank's rows."""
    if negatives not in ("local", "global"):
        raise ValueError(f"negatives must be 'local' or 'global', got {negatives!r}")
    if negatives == "global" and mesh is not None and mesh.group is not None:
        gathered = GatherRows.apply(target, mesh)
        return BBCMeanLoss.apply(predicted, gathered, temperature,
                                 mesh.rank * predicted.shape[0])
    return BBCMeanLoss.apply(predicted, target, temperature)

