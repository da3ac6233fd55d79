"""The weight bridge: JAX package variables -> the port's state_dict.

The exact inverse of the JAX package's two checkpoint converters,
`fashionern_aaai2024_tpu/models/clip/convert.py:153
clip_variables_from_torch` and `models/ern/convert.py:136
ern_variables_from_torch`: feeding this function's output back through
them gives the original variables leaf for leaf.

    Dense kernel [in, out]          -> Linear weight [out, in]
    Conv kernel [kh, kw, in, out]   -> Conv2d weight [out, in, kh, kw]
    in_proj_weight, proj, text_projection, embeddings -> unchanged
    LayerNorm / BN scale, bias      -> weight, bias
    BN batch_stats mean, var        -> running_mean, running_var

Input is the composed model's `{"params": {"clip", "ern"}, "batch_stats":
{"ern"}}` tree (with `batch_stats["clip"]["visual"]` too for the RN50x4
tower, whose BatchNorms carry running statistics) with array leaves
(numpy, or anything `np.asarray` takes, or torch tensors, which keep
their device: `models/composed.py jax_init_`);
output is a `clip.*` / `ern.*` state_dict of fp32 tensors, with the
BatchNorm step counters (`num_batches_tracked`, which reference
checkpoints carry too) set to 0.

`attn_experiment_params_from_jax` carries the attention experiment's
weights (`benchmarks/attn_experiment.py`: X3 and X4's [in, out] arrays)
into the torch layout that `ops/attn_experiment.py` takes.

A TME model's `ern/TME` subtree has no reference names (the reference's
TME is closed source); it maps onto the port's own `ern.TME.*` names
(`models/ern/tme.py`): Dense kernels transposed, the attention's
DenseGeneral kernels [d, H, Dh] / [H, Dh, d] and biases [H, Dh] flattened
over (H, Dh), the LayerNorm's scale as weight.

The comparison zoo (`models/zoo/`): one function per module turns the
JAX module's variables (`{"params": ...}`, as `Module.init` returns them)
into the port module's `state_dict`. For the modules the JAX package
converts from torch (`combiner_from_torch`, `vtf_from_torch`,
`attention_pooling_from_torch`, `cala_from_torch`, `artemis_from_torch`,
`dqu_cir_from_torch`, `amc_interaction_from_torch`) each is the exact
inverse: its output fed back through the JAX converter gives the
variables leaf for leaf. `AMCEnsemble` and `CompoDiffNetwork` have no JAX
converter; their port names follow flax's tree (`models/zoo/amc.py`,
`compodiff.py`). The walk: a Dense `{kernel[, bias]}` becomes a Linear's
`weight` (transposed) and `bias`, a LayerNorm `{scale, bias}` its
`weight` and `bias`, a module name ending `_<i>` the `.<i>` of an
`nn.Sequential` or `nn.ModuleList`, and every other leaf keeps its name.

`load_jax_train_state` carries a whole JAX `CIRTrainState`
(`fashionern_aaai2024_tpu/train/state.py:26`) into the port's train
state, so a run can continue here: the weights and ERN batch statistics
as above, optax's `ScaleByAdamState` `mu` / `nu` / `count` as
`torch.optim.Adam`'s `exp_avg` / `exp_avg_sq` / `step` (the moments are
parameter-shaped trees, converted with the parameters' own layout
changes), and the step. The JAX dropout key is not carried: the port
seeds its masks from (seed, step), and `jax.random` and
`torch.Generator` draw different masks anyway.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Mapping

import numpy as np
import torch

from fashionern_aaai2024_tpu_torch.models.clip.config import CLIPConfig


def _t(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _linear(p: Mapping, prefix: str) -> dict:
    return {f"{prefix}.weight": _t(p["kernel"]).t().contiguous(),
            f"{prefix}.bias": _t(p["bias"])}


def _norm(scale: Any, bias: Any, prefix: str) -> dict:
    return {f"{prefix}.weight": _t(scale), f"{prefix}.bias": _t(bias)}


def _resblocks(p: Mapping, prefix: str, layers: int) -> dict:
    sd: dict = {}
    for i in range(layers):
        rb, bp = p[f"resblock_{i}"], f"{prefix}.resblocks.{i}"
        sd.update(_norm(rb["ln_1"]["scale"], rb["ln_1"]["bias"], f"{bp}.ln_1"))
        sd.update(_norm(rb["ln_2"]["scale"], rb["ln_2"]["bias"], f"{bp}.ln_2"))
        sd[f"{bp}.attn.in_proj_weight"] = _t(rb["in_proj_weight"])
        sd[f"{bp}.attn.in_proj_bias"] = _t(rb["in_proj_bias"])
        sd.update(_linear(rb["out_proj"], f"{bp}.attn.out_proj"))
        sd.update(_linear(rb["c_fc"], f"{bp}.mlp.c_fc"))
        sd.update(_linear(rb["c_proj"], f"{bp}.mlp.c_proj"))
    return sd


def _conv(p: Mapping, prefix: str) -> dict:
    return {f"{prefix}.weight": _t(p["kernel"]).permute(3, 2, 0, 1).contiguous()}


def _resnet_tower(v: Mapping, stats: Mapping, cfg: CLIPConfig) -> dict:
    """Inverse of `models/clip/convert.py:74 _resnet_tower`."""
    sd: dict = {}
    for i in (1, 2, 3):
        sd.update(_conv(v[f"conv{i}"], f"visual.conv{i}"))
        sd.update(_batch_norm(v[f"bn{i}"], stats[f"bn{i}"], f"visual.bn{i}"))
    for stage, blocks in enumerate(cfg.vision.layers):
        for j in range(blocks):
            name, pre = f"layer{stage + 1}_{j}", f"visual.layer{stage + 1}.{j}"
            p, s = v[name], stats[name]
            for i in (1, 2, 3):
                sd.update(_conv(p[f"conv{i}"], f"{pre}.conv{i}"))
                sd.update(_batch_norm(p[f"bn{i}"], s[f"bn{i}"], f"{pre}.bn{i}"))
            if "downsample_conv" in p:
                sd.update(_conv(p["downsample_conv"], f"{pre}.downsample.0"))
                sd.update(_batch_norm(p["downsample_bn"], s["downsample_bn"],
                                      f"{pre}.downsample.1"))
    ap = v["attnpool"]
    sd["visual.attnpool.positional_embedding"] = _t(ap["positional_embedding"])
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        sd.update(_linear(ap[name], f"visual.attnpool.{name}"))
    return sd


def _vit_tower(v: Mapping, cfg: CLIPConfig) -> dict:
    sd = _conv(v["conv1"], "visual.conv1")
    sd.update({
        "visual.class_embedding": _t(v["class_embedding"]),
        "visual.positional_embedding": _t(v["positional_embedding"]),
        "visual.proj": _t(v["proj"]),
    })
    sd.update(_norm(v["ln_pre"]["scale"], v["ln_pre"]["bias"], "visual.ln_pre"))
    sd.update(_norm(v["ln_post"]["scale"], v["ln_post"]["bias"], "visual.ln_post"))
    sd.update(_resblocks(v["transformer"], "visual.transformer", cfg.vision.layers))
    return sd


def clip_state_dict(params: Mapping, cfg: CLIPConfig, stats: Mapping | None = None) -> dict:
    """CLIP params subtree (visual / text / logit_scale), with the CLIP
    batch_stats subtree for the ResNet tower, -> open_clip names; inverse
    of `clip_variables_from_torch`."""
    t = params["text"]
    if cfg.vision.kind == "vit":
        sd = _vit_tower(params["visual"], cfg)
    else:
        if stats is None:
            raise ValueError("the ResNet tower needs the CLIP batch_stats")
        sd = _resnet_tower(params["visual"], stats["visual"], cfg)
    sd.update({
        "token_embedding.weight": _t(t["token_embedding"]),
        "positional_embedding": _t(t["positional_embedding"]),
        "text_projection": _t(t["text_projection"]),
        "logit_scale": _t(params["logit_scale"]).reshape(()),
    })
    sd.update(_norm(t["ln_final"]["scale"], t["ln_final"]["bias"], "ln_final"))
    sd.update(_resblocks(t["transformer"], "transformer", cfg.text.layers))
    return sd


def _combiner(p: Mapping, prefix: str) -> dict:
    sd = _linear(p["text_projection"], f"{prefix}.text_projection_layer.0")
    sd.update(_linear(p["image_projection"], f"{prefix}.image_projection_layer.0"))
    sd.update(_linear(p["scalar_hidden"], f"{prefix}.dynamic_scalar.0"))
    sd.update(_linear(p["scalar_out"], f"{prefix}.dynamic_scalar.3"))
    return sd


def _batch_norm(p: Mapping, s: Mapping, prefix: str) -> dict:
    sd = _norm(p["bn"]["scale"], p["bn"]["bias"], prefix)
    sd[f"{prefix}.running_mean"] = _t(s["bn"]["mean"])
    sd[f"{prefix}.running_var"] = _t(s["bn"]["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def _visual_sr(p: Mapping, s: Mapping, prefix: str) -> dict:
    sd = _linear(p["local_dense"], f"{prefix}.embedding_local.0")
    sd.update(_linear(p["global_dense"], f"{prefix}.embedding_global.0"))
    sd.update(_linear(p["common_dense"], f"{prefix}.embedding_common"))
    sd.update(_batch_norm(p["local_bn"], s["local_bn"], f"{prefix}.embedding_local.1"))
    sd.update(_batch_norm(p["global_bn"], s["global_bn"], f"{prefix}.embedding_global.1"))
    return sd


def _bert(p: Mapping, prefix: str) -> dict:
    sd = {
        f"{prefix}.embeddings.position_embeddings.weight": _t(p["position_embeddings"]),
        f"{prefix}.embeddings.token_type_embeddings.weight": _t(p["token_type_embeddings"]),
    }
    sd.update(_norm(p["emb_ln_scale"], p["emb_ln_bias"], f"{prefix}.embeddings.LayerNorm"))
    sd.update(_linear(p["pooler"], f"{prefix}.pooler.dense"))
    layers = sorted(k for k in p if k.startswith("layer_"))
    for i in range(len(layers)):
        lp, pre = p[f"layer_{i}"], f"{prefix}.encoder.layer.{i}"
        for name in ("query", "key", "value"):
            sd.update(_linear(lp[name], f"{pre}.attention.self.{name}"))
        sd.update(_linear(lp["attn_output"], f"{pre}.attention.output.dense"))
        sd.update(_linear(lp["intermediate"], f"{pre}.intermediate.dense"))
        sd.update(_linear(lp["output"], f"{pre}.output.dense"))
        sd.update(_norm(lp["attn_ln_scale"], lp["attn_ln_bias"],
                        f"{pre}.attention.output.LayerNorm"))
        sd.update(_norm(lp["output_ln_scale"], lp["output_ln_bias"],
                        f"{pre}.output.LayerNorm"))
    return sd


def _tme(p: Mapping, prefix: str) -> dict:
    """The JAX `TMEModule` params -> `models/ern/tme.py` names."""
    sd = _linear(p["visual_proj"], f"{prefix}.visual_proj")
    sd.update(_norm(p["ln"]["scale"], p["ln"]["bias"], f"{prefix}.ln"))
    for name in ("query", "key", "value", "out"):
        lp = p["cross_attn"][name]
        kernel = _t(lp["kernel"])
        kernel = kernel.reshape(-1, kernel.shape[-1]) if name == "out" else kernel.flatten(1)
        sd[f"{prefix}.cross_attn.{name}.weight"] = kernel.t().contiguous()
        sd[f"{prefix}.cross_attn.{name}.bias"] = _t(lp["bias"]).flatten()
    return sd


def ern_state_dict(params: Mapping, stats: Mapping) -> dict:
    """ERN params + batch_stats -> reference ERN names; inverse of
    `ern_variables_from_torch`."""
    dvr, dvr_stats = params["DVR"], stats["DVR"]
    plus = dvr["transformer_layer"]
    mr = dvr["mr"]
    sd = {
        "DVR.transformer_layer.cls_token": _t(plus["cls_token"]),
        "DVR.MR_component.in_proj_weight": _t(mr["in_proj_weight"]),
        "DVR.MR_component.in_proj_bias": _t(mr["in_proj_bias"]),
    }
    sd.update(_linear(mr["out_proj"], "DVR.MR_component.out_proj"))
    sd.update(_bert(plus["bert"], "DVR.transformer_layer.bert_encoder.bert_model"))
    sd.update(_visual_sr(dvr["sr"], dvr_stats["sr"], "DVR.SR_module"))
    for name in ("combiner_global", "combiner_local", "combiner"):
        sd.update(_combiner(dvr[name], f"DVR.{name}"))
    sd.update(_visual_sr(params["SR_module"], stats["SR_module"], "SR_module"))
    sd.update(_combiner(params["Combiner_module"], "Combiner_module"))
    if "TME" in params:
        sd.update(_tme(params["TME"], "TME"))
    return sd


def state_dict_from_variables(variables: Mapping, cfg: CLIPConfig) -> dict:
    """Composed-model variables -> `ComposedCIRModel.load_state_dict` input."""
    params, stats = variables["params"], variables["batch_stats"]
    clip = clip_state_dict(params["clip"], cfg, stats.get("clip"))
    sd = {f"clip.{k}": v for k, v in clip.items()}
    sd.update({f"ern.{k}": v for k, v in ern_state_dict(params["ern"], stats["ern"]).items()})
    return sd


def load_jax_train_state(state, jax_state, cfg: CLIPConfig):
    """Load a JAX `CIRTrainState` (its fields as arrays: `step`,
    `clip_params`, `ern_params`, `batch_stats`, and `opt_state` as
    `optax.adam` builds it, `(ScaleByAdamState, ScaleByScheduleState)`)
    into the port's `CIRTrainState` `state`, in place, and return it."""
    stats = jax_state.batch_stats
    variables = {"params": {"clip": jax_state.clip_params, "ern": jax_state.ern_params},
                 "batch_stats": stats}
    state.model.load_state_dict(state_dict_from_variables(variables, cfg), strict=True)
    adam = jax_state.opt_state[0]
    mu = ern_state_dict(adam.mu, stats["ern"])
    nu = ern_state_dict(adam.nu, stats["ern"])
    count = float(np.asarray(adam.count))
    moments = {}
    for i, (name, p) in enumerate(state.model.ern.named_parameters()):
        moments[i] = {"step": torch.tensor(count),
                      "exp_avg": mu[name].to(p.device, p.dtype),
                      "exp_avg_sq": nu[name].to(p.device, p.dtype)}
    groups = state.optimizer.state_dict()["param_groups"]
    state.optimizer.load_state_dict({"state": moments, "param_groups": groups})
    state.step = int(np.asarray(jax_state.step))
    return state


# the attention experiment's arguments (`attnblock(x, g_, be, w_qkv, b_qkv,
# w_out, b_out, ...)`) -> the port's; the two kernels are [in, out]
_EXPERIMENT_NAMES = {"g_": "g", "be": "be", "w_qkv": "w_qkv", "b_qkv": "b_qkv",
                     "w_out": "w_out", "b_out": "b_out"}
_EXPERIMENT_KERNELS = ("w_qkv", "w_out")


def attn_experiment_params_from_jax(params: Mapping[str, Any], *,
                                    dtype: torch.dtype = torch.float32,
                                    device: torch.device | str = "cuda") -> dict:
    """The attention experiment's JAX weights (any of `g_`, `be`, `w_qkv`
    [W, 3W], `b_qkv`, `w_out` [W, W], `b_out`, as numpy or anything
    `np.asarray` takes, fp32 or bf16) -> the arguments of
    `ops/attn_experiment.py qkvattn` / `attnblock` (`g`, `be`, `w_qkv`
    [3W, W], `b_qkv`, `w_out` [W, W], `b_out`) in `dtype` on `device` (the
    card unless the caller names another: they are the arguments of
    kernels X3 and X4).
    Run once, as a checkpoint load, before any timed call."""
    unknown = set(params) - set(_EXPERIMENT_NAMES)
    if unknown:
        raise KeyError(f"attn_experiment_params_from_jax: unknown weights {sorted(unknown)}")
    out = {}
    for name, value in params.items():
        t = _t(value)
        if name in _EXPERIMENT_KERNELS:
            t = t.t()
        out[_EXPERIMENT_NAMES[name]] = t.to(device, dtype).contiguous()
    return out


# --- the comparison zoo --------------------------------------------------


def _zoo_tree(p: Mapping, rename: Mapping[str, str] | None = None, prefix: str = "") -> dict:
    """A flax params subtree -> state_dict entries under `prefix` (see the
    module docstring); `rename` maps a flax module name to the port's."""
    rename = rename or {}
    sd: dict = {}
    for key, v in p.items():
        name = rename.get(key) or re.sub(r"_(\d+)$", r".\1", key)
        path = f"{prefix}{name}"
        if not isinstance(v, Mapping):
            sd[path] = _t(v)
        elif "kernel" in v:
            sd[f"{path}.weight"] = _t(v["kernel"]).t().contiguous()
            if "bias" in v:
                sd[f"{path}.bias"] = _t(v["bias"])
        elif "scale" in v:
            sd.update(_norm(v["scale"], v["bias"], path))
        else:
            sd.update(_zoo_tree(v, rename, f"{path}."))
    return sd


def combiner_state_dict(variables: Mapping) -> dict:
    """`Clip4CirCombiner`: inverse of `combiner_from_torch`."""
    return _zoo_tree(variables["params"])


def vtf_state_dict(variables: Mapping) -> dict:
    """`VTFModule`: inverse of `vtf_from_torch`. The JAX tree holds a copy
    of `text_mlp` as `text_mlp_shared` (the reference's image stream calls
    `text_mlp`); the port holds one `text_mlp`, so the copy must equal it
    (numpy or torch leaves)."""
    p = dict(variables["params"])
    for i in (0, 3):
        shared, own = p.pop(f"text_mlp_shared_{i}"), p[f"text_mlp_{i}"]
        if any(not torch.equal(_t(shared[k]), _t(own[k])) for k in own):
            raise ValueError(f"vtf_state_dict: text_mlp_shared_{i} differs from text_mlp_{i}; "
                             "the port, like the reference, holds one text_mlp")
    return _zoo_tree(p)


def attention_pooling_state_dict(variables: Mapping) -> dict:
    """`AttentionPooling`: inverse of `attention_pooling_from_torch`."""
    return _zoo_tree(variables["params"])


def cala_state_dict(variables: Mapping) -> dict:
    """`TwinAttentionCompositor`: inverse of `cala_from_torch`."""
    return _zoo_tree(variables["params"])


def artemis_state_dict(variables: Mapping) -> dict:
    """`Artemis`: inverse of `artemis_from_torch`."""
    return _zoo_tree(variables["params"], {"Transform_m": "Transform_m.0"})


def dqu_cir_state_dict(variables: Mapping) -> dict:
    """`DQUCIRHead`: inverse of `dqu_cir_from_torch`."""
    return _zoo_tree(variables["params"])


_AMC_NAMES = {"att_q": "att_layer.linears.0", "att_k": "att_layer.linears.1",
              "att_v": "att_layer.linears.2", "ff_1": "feed_forward_layer.fc1",
              "ff_2": "feed_forward_layer.fc2"}


def amc_interaction_state_dict(variables: Mapping) -> dict:
    """`AMCInteractionModule`: inverse of `amc_interaction_from_torch`."""
    return _zoo_tree(variables["params"], _AMC_NAMES)


def amc_ensemble_state_dict(variables: Mapping) -> dict:
    """`AMCEnsemble` (no JAX converter): its cells under the interaction
    layers' names (`glo.*`, `sty.*`)."""
    return _zoo_tree(variables["params"], _AMC_NAMES)


def compodiff_state_dict(variables: Mapping) -> dict:
    """`CompoDiffNetwork` (no JAX converter): flax's tree under the port's
    names (`models/zoo/compodiff.py`)."""
    sd = _zoo_tree(variables["params"], {"in": "proj_in", "out": "proj_out"})
    return {(f"{k}.weight" if k.endswith("relative_attention_bias") else k): v
            for k, v in sd.items()}


# zoo registry name -> its variables -> state_dict function
ZOO_STATE_DICTS: dict[str, Callable[[Mapping], dict]] = {
    "clip4cir_combiner": combiner_state_dict, "vtf": vtf_state_dict,
    "attention_pooling": attention_pooling_state_dict, "cala": cala_state_dict,
    "artemis": artemis_state_dict, "dqu_cir": dqu_cir_state_dict,
    "amc": amc_interaction_state_dict, "amc_ensemble": amc_ensemble_state_dict,
    "compodiff": compodiff_state_dict,
}
