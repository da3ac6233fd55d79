"""The reference's remaining utilities (`utils/utils.py`).

JAX counterpart: `fashionern_aaai2024_tpu/utils/extras.py`. Helpers no
run script uses but the toolbox ships:
  * `concat_global_local_feats` (`utils.py:32-41`);
  * `element_wise_sum`: the parameter-free fusion baseline
    (`utils.py:133-140`);
  * `cutout`: CutoutPIL augmentation (`utils.py:201-220`) on a caller's
    numpy generator, not the global `np.random`;
  * `EmaState`: an exponential moving average of parameters
    (`ModelEma`, `utils.py:223-248`, whose attribute names do not exist on
    the ERN) over a mapping of tensors or a module's parameters;
  * `setup_host_seed`: the reference's `setup_seed` (`utils.py:15-19`).
"""

from __future__ import annotations

import dataclasses
import random as _random
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def concat_global_local_feats(global_feats: torch.Tensor,
                              local_feats: torch.Tensor) -> torch.Tensor:
    """[B, d] + [B, P, d] -> [B, P + 1, d], the global feature first."""
    return torch.cat([global_feats[:, None, :], local_feats], dim=1)


def element_wise_sum(image_features: torch.Tensor, text_features: torch.Tensor) -> torch.Tensor:
    """The normalized element-wise sum."""
    return F.normalize(image_features + text_features, dim=-1, eps=1e-12)


def cutout(image, cutout_factor: float = 0.5, rng: np.random.Generator | None = None):
    """CutoutPIL: paint a random rectangle in a random colour. `image` is a
    PIL image, drawn on in place and returned (the reference's semantics,
    its `size[0]` taken as "h" included)."""
    from PIL import ImageDraw

    g = rng if rng is not None else np.random.default_rng()
    draw = ImageDraw.Draw(image)
    h, w = image.size[0], image.size[1]
    h_cut = int(cutout_factor * h + 0.5)
    w_cut = int(cutout_factor * w + 0.5)
    y_c = int(g.integers(h))
    x_c = int(g.integers(w))
    y1, y2 = np.clip(y_c - h_cut // 2, 0, h), np.clip(y_c + h_cut // 2, 0, h)
    x1, x2 = np.clip(x_c - w_cut // 2, 0, w), np.clip(x_c + w_cut // 2, 0, w)
    fill = tuple(int(v) for v in g.integers(0, 256, 3))
    draw.rectangle([int(x1), int(y1), int(x2), int(y2)], fill=fill)
    return image


def _items(params: Mapping[str, torch.Tensor] | nn.Module) -> dict[str, torch.Tensor]:
    return dict(params.named_parameters() if isinstance(params, nn.Module) else params)


def _copies(params: Mapping[str, torch.Tensor] | nn.Module) -> dict[str, torch.Tensor]:
    return {name: torch.as_tensor(t).detach().clone() for name, t in _items(params).items()}


@dataclasses.dataclass(frozen=True)
class EmaState:
    """Parameter EMA, `ema <- decay * ema + (1 - decay) * params`, over a
    name -> tensor mapping (a module's `named_parameters()`, or a
    `state_dict`). A value: `update` and `set` return a new state."""

    params: dict[str, torch.Tensor]
    decay: float = 0.9997

    @classmethod
    def create(cls, params: Mapping[str, torch.Tensor] | nn.Module,
               decay: float = 0.9997) -> "EmaState":
        return cls(params=_copies(params), decay=decay)

    def update(self, params: Mapping[str, torch.Tensor] | nn.Module) -> "EmaState":
        new = _items(params)
        return dataclasses.replace(self, params={
            name: self.decay * e + (1.0 - self.decay) * torch.as_tensor(new[name]).detach()
            for name, e in self.params.items()})

    def set(self, params: Mapping[str, torch.Tensor] | nn.Module) -> "EmaState":
        return dataclasses.replace(self, params=_copies(params))


def setup_host_seed(seed: int = 42) -> np.random.Generator:
    """Seed the host-side generators the data pipeline may touch (Python's,
    numpy's and torch's global ones) and return a numpy generator of the
    seed. Dropout and the train step draw from explicit generators."""
    _random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return np.random.default_rng(seed)
