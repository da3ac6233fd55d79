"""The weight bridge (`fashionern_aaai2024_tpu_torch/models/convert.py`):
JAX `model.init` variables -> the port's `load_state_dict(strict=True)`
-> the port's `state_dict` -> the JAX package's own converters
(`clip_variables_from_torch`, `ern_variables_from_torch`) gives back
every leaf exactly."""

import jax
import numpy as np
import pytest
import torch

from fashionern_aaai2024_tpu.models.clip.convert import (
    _TrackingDict,
    clip_variables_from_torch,
)
from fashionern_aaai2024_tpu.models.clip import config as jax_config
from fashionern_aaai2024_tpu.models.ern.convert import ern_variables_from_torch
from fashionern_aaai2024_tpu_torch.models import convert
from fashionern_aaai2024_tpu_torch.models.clip import config as torch_config
from torch_port_helpers import (
    jax_model_and_variables,
    port_model,
    small_config,
    tiny_config,
)

torch.set_num_threads(2)
CONFIGS = {"small": small_config, "tiny": tiny_config}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def bridged(request):
    cfg_fn = CONFIGS[request.param]
    _, variables = jax_model_and_variables(cfg_fn(jax_config), seed=3)
    model = port_model(cfg_fn(torch_config), variables)
    return cfg_fn, variables, model.state_dict()


def _split(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _assert_trees_equal(want, got):
    leaves_w, tree_w = jax.tree_util.tree_flatten(want)
    leaves_g, tree_g = jax.tree_util.tree_flatten(got)
    assert tree_w == tree_g
    for a, b in zip(leaves_w, leaves_g):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_clip_round_trip_is_exact(bridged):
    cfg_fn, variables, sd = bridged
    back = clip_variables_from_torch(_split(sd, "clip."), cfg_fn(jax_config), strict=True)
    _assert_trees_equal({"params": variables["params"]["clip"]}, back)


def test_ern_round_trip_is_exact(bridged):
    _, variables, sd = bridged
    back = ern_variables_from_torch(_split(sd, "ern."))
    _assert_trees_equal({"params": variables["params"]["ern"],
                         "batch_stats": variables["batch_stats"]["ern"]}, back)


def test_ern_keys_are_the_reference_keys(bridged):
    """Every `ern.` key is one the JAX ERN converter reads, apart from the
    BatchNorm step counters, and the converter reads nothing else."""
    _, _, sd = bridged
    ern = _split(sd, "ern.")
    tracked = _TrackingDict(ern)
    ern_variables_from_torch(tracked)
    counters = {k for k in ern if k.endswith(".num_batches_tracked")}
    assert len(counters) == 4
    assert tracked.used == set(ern) - counters
    assert "DVR.transformer_layer.bert_encoder.bert_model.encoder.layer.1.attention." \
           "self.query.weight" in ern
    assert "SR_module.embedding_local.1.running_mean" in ern


def test_clip_keys_are_the_open_clip_keys(bridged):
    """strict=True raises on any key the converter does not consume, and
    a missing key raises KeyError: both sets are equal."""
    cfg_fn, _, sd = bridged
    clip = _split(sd, "clip.")
    clip_variables_from_torch(clip, cfg_fn(jax_config), strict=True)
    assert "visual.transformer.resblocks.1.attn.in_proj_weight" in clip
    clip["visual.extra.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="not consumed"):
        clip_variables_from_torch(clip, cfg_fn(jax_config), strict=True)


def test_layouts(bridged):
    """Dense kernels transpose to Linear weights, the conv kernel goes
    HWIO -> OIHW, in_proj_weight / proj / text_projection stay."""
    _, variables, sd = bridged
    vis = variables["params"]["clip"]["visual"]
    rb = vis["transformer"]["resblock_0"]
    np.testing.assert_array_equal(
        sd["clip.visual.transformer.resblocks.0.mlp.c_fc.weight"].numpy(), rb["c_fc"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["clip.visual.transformer.resblocks.0.attn.in_proj_weight"].numpy(),
        rb["in_proj_weight"])
    np.testing.assert_array_equal(sd["clip.visual.proj"].numpy(), vis["proj"])
    np.testing.assert_array_equal(sd["clip.visual.conv1.weight"].numpy(),
                                  vis["conv1"]["kernel"].transpose(3, 2, 0, 1))


def test_bridge_rejects_missing_leaves():
    _, variables = jax_model_and_variables(small_config(jax_config), seed=4)
    del variables["params"]["ern"]["DVR"]["combiner"]
    with pytest.raises(KeyError):
        convert.state_dict_from_variables(variables, small_config(torch_config))
