"""Comparison-model zoo (reference `models/others/`).

JAX counterpart: `fashionern_aaai2024_tpu/models/zoo/__init__.py`.
Fusion modules from competing CIR papers, kept for ablation: none is on
the main path. Each has its JAX module's weights carried over by a
function of `models/convert.py`.

Registry: `get_zoo_model(name, **kw)`. Torch layers need their input
widths, so a few constructors take one more argument than flax's
(`DQUCIRHead(clip_feature_dim, ...)`).

Seeded init: `seeded_zoo_model(name, seed, device, **kw)` builds a model
on `device` and draws there what the JAX package's
`get_zoo_model(name, **kw).init(jax.random.PRNGKey(seed), *inputs)`
draws (`jax_init_`, on `models/init.py`), as `models/composed.py
seeded_model` does for the composed model. The constructors keep the
reference's torch initializers.
"""

import torch

from fashionern_aaai2024_tpu_torch.models import convert
from fashionern_aaai2024_tpu_torch.models import init as I
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

# a zoo model's exact type -> its flax tree -> state_dict function
_STATE_DICTS = {cls: convert.ZOO_STATE_DICTS[name] for name, cls in _ZOO.items()}

__all__ = ["AMCEnsemble", "AMCInteractionModule", "Artemis", "AttentionPooling",
           "Clip4CirCombiner", "CompoDiffNetwork", "CrossTransformer", "DQUCIRHead",
           "TwinAttentionCompositor", "VTFModule", "get_zoo_model", "jax_init_",
           "seeded_zoo_model", "state_dict_from_variables"]


def get_zoo_model(name: str, **kwargs):
    if name not in _ZOO:
        raise ValueError(f"unknown zoo model {name!r}; available: {sorted(_ZOO)}")
    return _ZOO[name](**kwargs)


def state_dict_from_variables(module: torch.nn.Module, tree: dict) -> dict:
    """A zoo model's `state_dict` from its flax counterpart's variables
    (`models/convert.py ZOO_STATE_DICTS`).

    VTF: flax draws `text_mlp_shared` apart from `text_mlp`; the port, as
    the reference, holds one `text_mlp`, so that draw is dropped for a copy
    of `text_mlp`. Every gate of that MLP is a softmax over one logit,
    identically 1 with a zero gradient, so no output or gradient of the
    JAX module reads it (ROADMAP C28)."""
    if type(module) is VTFModule:
        params = dict(tree["params"])
        for i in (0, 3):
            params[f"text_mlp_shared_{i}"] = params[f"text_mlp_{i}"]
        tree = {**tree, "params": params}
    return _STATE_DICTS[type(module)](tree)


@torch.no_grad()
def jax_init_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """The JAX package's seeded init of a zoo model, in place: what its flax
    counterpart's `init` draws under `jax.random.PRNGKey(seed)`, the same
    bits on every device, drawn on the device of the module's parameters
    and carried onto the port's names (`state_dict_from_variables`)."""
    device = next(module.parameters()).device
    tree = I.variables(module.flax_variables(), seed, device)
    module.load_state_dict(state_dict_from_variables(module, tree), strict=True)
    return module


def seeded_zoo_model(name: str, seed: int, device: torch.device | str, **kwargs):
    """`get_zoo_model(name, **kwargs)` built on `device` with the JAX
    package's seeded init (`jax_init_`), drawn there."""
    with torch.device(device):
        module = get_zoo_model(name, **kwargs)
    return jax_init_(module, seed)
