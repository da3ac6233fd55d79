"""ERN: the trainable model's two serving towers.

JAX counterpart: `fashionern_aaai2024_tpu/models/ern/ern.py`, its
`index` (gallery side) and `query` (query side, reference mode="test").
TME and the train-step features are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from fashionern_aaai2024_tpu_torch.models.ern.fusion import (
    CombinerSimple,
    DVRModule,
    VisualSR,
)


class ERN(nn.Module):
    """Query tower: DVR fusion. Gallery tower: SR + Combiner."""

    def __init__(self, feature_dim: int, patch_num: int = 13):
        super().__init__()
        self.DVR = DVRModule(feature_dim)
        self.SR_module = VisualSR(feature_dim, num_region=patch_num)
        self.Combiner_module = CombinerSimple(feature_dim)

    def index(self, tar_feats: torch.Tensor, tar_local_feats: torch.Tensor) -> torch.Tensor:
        """Combiner(tar_global, SR(tar_patches))."""
        return self.Combiner_module(tar_feats, self.SR_module(tar_local_feats))

    def query(self, ref_feats: torch.Tensor, ref_local_feats: torch.Tensor,
              text_feats: torch.Tensor, text_seq_feats: torch.Tensor) -> torch.Tensor:
        return self.DVR(ref_local_feats, text_seq_feats, ref_feats, text_feats)
