"""ComposedCIRModel: frozen CLIP + trainable ERN.

JAX counterpart: `fashionern_aaai2024_tpu/models/composed.py`
(`encode_image`, `encode_text`, `index`, `query`, `train_features`,
`train_forward`). State_dict keys are `clip.*` (open_clip names) and
`ern.*` (reference ERN names).

CLIP is frozen, as the JAX model's `stop_gradient` makes it: the train
forward runs the towers under `torch.no_grad()` (not
`torch.inference_mode()`, whose tensors the fusion stack's backward
could not save), and `train/state.py` turns off `requires_grad` on
every CLIP parameter.

With `clip_config.text.tme` the ERN holds TME (`models/ern/tme.py`):
`encode_text` then needs the reference patches (`visual_emb`) and
returns the enhanced token features, with the enhanced EOT row as the
global feature (`composed.py:45-72`). In the train forward TME runs
after the towers' `torch.no_grad()` block, so it trains.

Also here:
  * `apply_precision`, the port of `cli/main.py:554 _cast_precision`
    as the serve path sees it;
  * `random_init_`, seeded weights for runs without a checkpoint.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.profiler import record_function

from fashionern_aaai2024_tpu_torch.models.clip.config import CLIPConfig
from fashionern_aaai2024_tpu_torch.models.clip.model import CLIP
from fashionern_aaai2024_tpu_torch.models.clip.resnet import (
    Bottleneck,
    FrozenBatchNorm2d,
    ModifiedResNet,
    calibrate_batchnorm_,
)
from fashionern_aaai2024_tpu_torch.models.ern.ern import ERN
from fashionern_aaai2024_tpu_torch.models.ern.layers import TorchBatchNorm


class ComposedCIRModel(nn.Module):
    def __init__(self, clip_config: CLIPConfig, patch_num: int = 13):
        super().__init__()
        self.clip_config = clip_config
        self.clip = CLIP(clip_config)
        self.ern = ERN(clip_config.feature_dim, patch_num=patch_num,
                       tme=clip_config.text.tme)

    def encode_image(self, images: torch.Tensor):
        return self.clip.encode_image(images)

    def enhance_text(self, text_ids: torch.Tensor, seq: torch.Tensor,
                     visual_emb: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
        """(global, seq) of a TME model from the text tower's token
        features: TME over `seq`, and the enhanced row at the EOT position
        (argmax of the ids) as the global feature. Raises without
        `visual_emb`."""
        if visual_emb is None:
            raise ValueError("TextConfig.tme=True requires visual_emb (the reference-patch "
                             "embeddings) at every encode_text call; the vanilla path is "
                             "tme=False (default)")
        seq = self.ern.enhance_text(seq, visual_emb)
        eot = text_ids.argmax(dim=-1)
        return seq[torch.arange(seq.shape[0], device=seq.device), eot], seq

    def encode_text(self, text_ids: torch.Tensor, mode: str = "global",
                    visual_emb: torch.Tensor | None = None):
        """mode="global" -> (global, seq); "seq" -> seq. Vanilla models
        ignore `visual_emb`; TME models need it (`enhance_text`)."""
        global_feat, seq = self.clip.encode_text(text_ids)
        if self.clip_config.text.tme:
            global_feat, seq = self.enhance_text(text_ids, seq, visual_emb)
        return seq if mode == "seq" else (global_feat, seq)

    def index(self, tar_feats: torch.Tensor, tar_local_feats: torch.Tensor,
              generator: torch.Generator | None = None) -> torch.Tensor:
        return self.ern.index(tar_feats, tar_local_feats, generator)

    def query(self, ref_feats: torch.Tensor, ref_local_feats: torch.Tensor,
              text_feats: torch.Tensor, text_seq_feats: torch.Tensor,
              generator: torch.Generator | None = None) -> torch.Tensor:
        return self.ern.query(ref_feats, ref_local_feats, text_feats, text_seq_feats,
                              generator)

    def train_features(self, ref_feats: torch.Tensor, ref_local_feats: torch.Tensor,
                       text_feats: torch.Tensor, text_seq_feats: torch.Tensor,
                       tar_feats: torch.Tensor, tar_local_feats: torch.Tensor,
                       generator: torch.Generator | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        return self.ern.train_step_features(ref_feats, ref_local_feats, text_feats,
                                            text_seq_feats, tar_feats, tar_local_feats,
                                            generator)

    def train_forward(self, ref_image: torch.Tensor, tar_image: torch.Tensor,
                      text_ids: torch.Tensor, ref_patch: torch.Tensor,
                      tar_patch: torch.Tensor, generator: torch.Generator | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """One training-step forward (`composed.py:85-123`): the frozen
        towers, TME on a TME model (conditioned on `ref_patch`, outside
        the towers' no-grad block), then the fusion stack in fp32 on raw
        query-side globals and L2-normalized target globals."""
        with torch.no_grad(), record_function("train_step/towers"):
            ref_glob, _ = self.encode_image(ref_image)
            tar_glob, _ = self.encode_image(tar_image)
            text_glob, text_seq = self.clip.encode_text(text_ids)
        if self.clip_config.text.tme:
            with record_function("train_step/tme"):
                text_glob, text_seq = self.enhance_text(text_ids, text_seq, ref_patch)
        ref_glob, tar_glob = ref_glob.float(), tar_glob.float()
        text_glob, text_seq = text_glob.float(), text_seq.float()
        tar_glob = tar_glob / torch.linalg.vector_norm(tar_glob, dim=-1, keepdim=True)
        with record_function("train_step/fusion_forward"):
            return self.train_features(ref_glob, ref_patch, text_glob, text_seq, tar_glob,
                                       tar_patch, generator)


@torch.no_grad()
def apply_precision(model: ComposedCIRModel, precision: str) -> ComposedCIRModel:
    """The serve precision policy, in place.

    "fp32": unchanged. "bf16" (the serve default): the CLIP towers are
    stored and computed in bf16, the ResNet's BatchNorm running
    statistics included (as `_cast_precision` casts `batch_stats`); the
    ERN stack keeps fp32 storage with every weight rounded to bf16.
    That is what JAX computes when `_cast_precision`'s bf16 leaves meet
    the fp32 inputs that `InferenceAPI.query` passes
    (`evaluate.py:213-216`): flax promotes to fp32. TME is the exception:
    its inputs are the bf16 text tower's token features, so JAX runs it
    wholly in bf16, and here it is stored and computed in bf16. Training
    does not use this policy: it rounds nothing of the ERN stack
    (`train/state.py cast_frozen_clip_bf16`)."""
    if precision == "fp32":
        return model
    if precision != "bf16":
        raise ValueError(f"unknown precision {precision!r}")
    model.clip.to(torch.bfloat16)
    if model.clip_config.text.tme:
        model.ern.TME.to(torch.bfloat16)
    for t in list(model.ern.parameters()) + list(model.ern.buffers()):
        if t.dtype == torch.float32:
            t.copy_(t.to(torch.bfloat16).to(torch.float32))
    return model


# std of the seeded normal init, by parameter name; the rest follows the
# module type (see random_init_)
_NAMED_STD = {
    "token_embedding.weight": lambda p: 0.02,
    "positional_embedding": lambda p: p.shape[-1] ** -0.5,
    "class_embedding": lambda p: p.shape[-1] ** -0.5,
    "proj": lambda p: p.shape[0] ** -0.5,
    "text_projection": lambda p: p.shape[0] ** -0.5,
    "position_embeddings.weight": lambda p: 0.02,
    "token_type_embeddings.weight": lambda p: 0.02,
    "cls_token": lambda p: 0.02,
}


# the seeded scale of each bottleneck branch's last BN (random_init_)
RESIDUAL_BN_SCALE = 0.25


@torch.no_grad()
def random_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights, in place (there is no checkpoint in the
    repository). Matrices and convolution kernels are normal with std
    fan_in^-0.5, embeddings as in the JAX initializers, biases
    normal(0.02), norm scales 1 + normal(0.02), the ERN's BN running
    statistics near (0, 1). In the ResNet tower the last BN of each
    bottleneck's branch is scaled by RESIDUAL_BN_SCALE, and the running
    statistics are those that two seeded N(0, 1) images meet at each BN
    (`calibrate_batchnorm_`), so that its activations stay O(1) through
    the 26 bottlenecks of RN50x4 on inputs other than those two (with
    full-scale branches, random weights let some inputs blow up by the
    last stage). TME's out-projection is drawn like every Linear, where
    JAX zero-initializes it, so that a seeded TME model differs from the
    vanilla one. Draws on the CPU from `generator`, so a seed gives the
    same weights on any device."""
    def normal(p: torch.Tensor, std: float, mean: float = 0.0) -> None:
        p.copy_(torch.randn(p.shape, generator=generator) * std + mean)

    norm_types = (nn.LayerNorm, TorchBatchNorm, FrozenBatchNorm2d)
    for mod_name, mod in model.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{name}" if mod_name else name
            rule = next((f for k, f in _NAMED_STD.items() if full.endswith(k)), None)
            if name == "logit_scale":
                p.fill_(math.log(1 / 0.07))
            elif rule is not None:
                normal(p, rule(p))
            elif isinstance(mod, norm_types) and name == "weight":
                normal(p, 0.02, 1.0)
            elif name.endswith("bias"):
                normal(p, 0.02)
            else:  # Linear / in_proj [out, in], conv [out, in, kh, kw]
                normal(p, p[0].numel() ** -0.5)
        if isinstance(mod, TorchBatchNorm):
            normal(mod.running_mean, 0.02)
            mod.running_var.copy_(1.0 + 0.1 * torch.rand(
                mod.running_var.shape, generator=generator))
    for mod in model.modules():
        if isinstance(mod, ModifiedResNet):
            for block in mod.modules():
                if isinstance(block, Bottleneck):
                    block.bn3.weight.mul_(RESIDUAL_BN_SCALE)
            side = mod.config.image_size
            images = torch.randn((2, side, side, 3), generator=generator)
            calibrate_batchnorm_(mod, images.to(mod.conv1.weight.device))
    return model
