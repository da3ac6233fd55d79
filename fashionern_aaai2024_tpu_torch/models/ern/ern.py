"""ERN: the trainable model's two serving towers.

JAX counterpart: `fashionern_aaai2024_tpu/models/ern/ern.py`, its
`index` (gallery side), `query` (query side, reference mode="test") and
`train_step_features` (reference mode="train", `ern.py:63-75`), and with
`tme=True` the text-enhancement module `TME` (models/ern/tme.py) with its
`enhance_text`. `generator` selects train mode (models/ern/layers.py).
"""

from __future__ import annotations

import torch
from torch import nn

from fashionern_aaai2024_tpu_torch.models.ern.fusion import (
    CombinerSimple,
    DVRModule,
    VisualSR,
)
from fashionern_aaai2024_tpu_torch.models.ern.tme import TMEModule


class ERN(nn.Module):
    """Query tower: DVR fusion. Gallery tower: SR + Combiner. With
    `tme=True`, the trainable TME module conditions the frozen text
    tower's token features on the reference patches."""

    def __init__(self, feature_dim: int, patch_num: int = 13, tme: bool = False):
        super().__init__()
        self.DVR = DVRModule(feature_dim)
        self.SR_module = VisualSR(feature_dim, num_region=patch_num)
        self.Combiner_module = CombinerSimple(feature_dim)
        if tme:
            self.TME = TMEModule(feature_dim)

    def enhance_text(self, text_seq: torch.Tensor, visual_emb: torch.Tensor) -> torch.Tensor:
        """TME over the text tower's token features [B, L, d], conditioned
        on the reference patches [B, P, d] (`ern.py:44-47`)."""
        return self.TME(text_seq, visual_emb)

    def index(self, tar_feats: torch.Tensor, tar_local_feats: torch.Tensor,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """Combiner(tar_global, SR(tar_patches))."""
        center = self.SR_module(tar_local_feats, generator)
        return self.Combiner_module(tar_feats, center, generator)

    def query(self, ref_feats: torch.Tensor, ref_local_feats: torch.Tensor,
              text_feats: torch.Tensor, text_seq_feats: torch.Tensor,
              generator: torch.Generator | None = None) -> torch.Tensor:
        return self.DVR(ref_local_feats, text_seq_feats, ref_feats, text_feats, generator)

    def train_step_features(self, ref_feats: torch.Tensor, ref_local_feats: torch.Tensor,
                            text_feats: torch.Tensor, text_seq_feats: torch.Tensor,
                            tar_feats: torch.Tensor, tar_local_feats: torch.Tensor,
                            generator: torch.Generator | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
        """(query embedding, target embedding): reference mode="train"."""
        fusion = self.query(ref_feats, ref_local_feats, text_feats, text_seq_feats, generator)
        return fusion, self.index(tar_feats, tar_local_feats, generator)
