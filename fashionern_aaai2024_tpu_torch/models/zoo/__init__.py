"""Comparison-model zoo (reference `models/others/`).

JAX counterpart: `fashionern_aaai2024_tpu/models/zoo/__init__.py`.
Fusion modules from competing CIR papers, kept for ablation: none is on
the main path. Each has its JAX module's weights carried over by a
function of `models/convert.py`.

Registry: `get_zoo_model(name, **kw)`. Torch layers need their input
widths, so a few constructors take one more argument than flax's
(`DQUCIRHead(clip_feature_dim, ...)`).
"""

from fashionern_aaai2024_tpu_torch.models.zoo.amc import AMCEnsemble, AMCInteractionModule
from fashionern_aaai2024_tpu_torch.models.zoo.artemis import Artemis
from fashionern_aaai2024_tpu_torch.models.zoo.cala import TwinAttentionCompositor
from fashionern_aaai2024_tpu_torch.models.zoo.combiner import (
    AttentionPooling,
    Clip4CirCombiner,
    VTFModule,
)
from fashionern_aaai2024_tpu_torch.models.zoo.compodiff import CompoDiffNetwork, CrossTransformer
from fashionern_aaai2024_tpu_torch.models.zoo.dqu_cir import DQUCIRHead

_ZOO = {
    "clip4cir_combiner": Clip4CirCombiner,
    "vtf": VTFModule,
    "attention_pooling": AttentionPooling,
    "cala": TwinAttentionCompositor,
    "artemis": Artemis,
    "dqu_cir": DQUCIRHead,
    "amc": AMCInteractionModule,
    "amc_ensemble": AMCEnsemble,
    "compodiff": CompoDiffNetwork,
}

__all__ = ["AMCEnsemble", "AMCInteractionModule", "Artemis", "AttentionPooling",
           "Clip4CirCombiner", "CompoDiffNetwork", "CrossTransformer", "DQUCIRHead",
           "TwinAttentionCompositor", "VTFModule", "get_zoo_model"]


def get_zoo_model(name: str, **kwargs):
    if name not in _ZOO:
        raise ValueError(f"unknown zoo model {name!r}; available: {sorted(_ZOO)}")
    return _ZOO[name](**kwargs)
