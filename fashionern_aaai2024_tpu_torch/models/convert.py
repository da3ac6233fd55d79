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
{"ern"}}` tree with array leaves (numpy, or anything `np.asarray` takes);
output is a `clip.*` / `ern.*` state_dict of fp32 CPU tensors, with the
BatchNorm step counters (`num_batches_tracked`, which reference
checkpoints carry too) set to 0.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from fashionern_aaai2024_tpu_torch.models.clip.config import CLIPConfig


def _t(x: Any) -> torch.Tensor:
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


def clip_state_dict(params: Mapping, cfg: CLIPConfig) -> dict:
    """CLIP params subtree (visual / text / logit_scale) -> open_clip
    names; inverse of `clip_variables_from_torch` for the ViT tower."""
    if cfg.vision.kind != "vit":
        raise NotImplementedError("only the ViT tower is ported")
    v, t = params["visual"], params["text"]
    sd = {
        "visual.conv1.weight": _t(v["conv1"]["kernel"]).permute(3, 2, 0, 1).contiguous(),
        "visual.class_embedding": _t(v["class_embedding"]),
        "visual.positional_embedding": _t(v["positional_embedding"]),
        "visual.proj": _t(v["proj"]),
        "token_embedding.weight": _t(t["token_embedding"]),
        "positional_embedding": _t(t["positional_embedding"]),
        "text_projection": _t(t["text_projection"]),
        "logit_scale": _t(params["logit_scale"]).reshape(()),
    }
    sd.update(_norm(v["ln_pre"]["scale"], v["ln_pre"]["bias"], "visual.ln_pre"))
    sd.update(_norm(v["ln_post"]["scale"], v["ln_post"]["bias"], "visual.ln_post"))
    sd.update(_norm(t["ln_final"]["scale"], t["ln_final"]["bias"], "ln_final"))
    sd.update(_resblocks(v["transformer"], "visual.transformer", cfg.vision.layers))
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
    return sd


def state_dict_from_variables(variables: Mapping, cfg: CLIPConfig) -> dict:
    """Composed-model variables -> `ComposedCIRModel.load_state_dict` input."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {f"clip.{k}": v for k, v in clip_state_dict(params["clip"], cfg).items()}
    sd.update({f"ern.{k}": v for k, v in ern_state_dict(params["ern"], stats["ern"]).items()})
    return sd
