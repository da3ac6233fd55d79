"""The JAX package's seeded init of the whole composed model (both CLIP
towers and the ERN, as its `Trainer._init_variables` and `cli/main.py
load_model_variables` make it: `ComposedCIRModel.init` under
`PRNGKey(seed)`, `train_forward`, `deterministic=False`), as a recipe
that the port draws again without JAX
(`fashionern_aaai2024_tpu_torch/benchmarks/flax_init.py`) for the
accuracy soak's `--jax-init`.

A recipe lists every variable with its flax path, its full shape, its
key and its initializer. Flax derives a parameter's key from the root
key and the module path only, never from a shape, so the keys and the
initializers are read from an init of a model of the same structure
(every layer, head and module) with CLIP towers at small widths
(`structural_config`; the ERN at its own width, as the JAX package's
ERN tests build it), which runs in seconds on a CPU. The towers' full
shapes come from the port's model built on the meta device, through
the JAX package's own checkpoint converters; the ERN's (TME included,
which those converters do not carry) from that init. No tower runs at
full width here.

    JAX_PLATFORMS=cpu python tests/jax_init_recipe.py --model ViT-B-16 --tme \\
        --out build/soak_init/vit_b16_tme.json
"""

import argparse
import dataclasses
import json
import os
import sys

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from flax.core import scope as flax_scope  # noqa: E402

from fashionern_aaai2024_tpu.models.clip import config as jax_config  # noqa: E402
from fashionern_aaai2024_tpu.models.clip.convert import clip_variables_from_torch  # noqa: E402
from fashionern_aaai2024_tpu.models.composed import ComposedCIRModel  # noqa: E402
from fashionern_aaai2024_tpu.models.ern.convert import ern_variables_from_torch  # noqa: E402


def structural_config(cfg, per_head: int):
    """`cfg` with towers at small widths (`per_head` a head), two patches a
    side and a vocabulary of 100: the same modules, layers and heads, so
    the same keys; the joint width (the ERN's) as it is. ViT towers
    only."""
    if cfg.vision.kind != "vit":
        raise ValueError("structural_config: ViT towers only")
    return dataclasses.replace(
        cfg,
        vision=dataclasses.replace(cfg.vision, image_size=2 * cfg.vision.patch_size,
                                   width=per_head * cfg.vision.heads),
        text=dataclasses.replace(cfg.text, vocab_size=100, width=per_head * cfg.text.heads))


def _closure(fn) -> dict:
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__ or ())))


def init_spec(fn) -> dict:
    """A flax / `jax.nn.initializers` initializer as a recipe entry."""
    name = getattr(fn, "__qualname__", "")
    if name in ("zeros", "ones"):
        return {"kind": name}
    free = _closure(fn)
    if name == "constant.<locals>.init":
        return {"kind": "constant", "value": float(np.float32(free["value"]))}
    if name == "normal.<locals>.init":
        return {"kind": "normal", "stddev": float(free["stddev"])}
    if name == "variance_scaling.<locals>.init":
        return {"kind": "variance_scaling", "scale": float(free["scale"]), "mode": free["mode"],
                "distribution": free["distribution"], "in_axis": free["in_axis"],
                "out_axis": free["out_axis"], "batch_axis": free["batch_axis"]}
    if name.endswith("kernel_init_wrap"):
        return {"kind": "dense_general_kernel", "n_batch_dims": free["n_batch_dims"],
                "n_axis": free["n_axis"], "n_features": free["n_features"],
                "inner": init_spec(free["self"].kernel_init)}
    if name.endswith("bias_init_wrap"):
        return {"kind": "dense_general_bias", "n_batch_dims": free["n_batch_dims"],
                "n_features": free["n_features"], "inner": init_spec(free["self"].bias_init)}
    raise ValueError(f"no recipe entry for the initializer {name or fn!r}")


def jax_init(cfg, seed: int, patch_num: int = 13, record: list | None = None) -> dict:
    """`ComposedCIRModel(cfg).init` as the JAX Trainer makes it; with
    `record`, each parameter's (path, initializer, key, shape) is
    appended."""
    orig = flax_scope.Scope.param

    def param(self, name, init_fn, *args, **kwargs):
        def traced(key, *a, **k):
            value = init_fn(key, *a, **k)
            if not isinstance(key, jax.core.Tracer):   # not flax's shape re-check
                record.append(("/".join(self.path + (name,)), init_fn,
                               [int(w) for w in np.asarray(jax.random.key_data(key))],
                               list(np.shape(value))))
            return value
        return orig(self, name, traced if record is not None else init_fn, *args, **kwargs)

    v = cfg.vision
    model = ComposedCIRModel(cfg, patch_num=patch_num)
    rng = jax.random.PRNGKey(seed)
    flax_scope.Scope.param = param
    try:
        return model.init(
            {"params": rng, "dropout": rng},
            np.zeros((2, v.image_size, v.image_size, 3), np.float32),
            np.zeros((2, v.image_size, v.image_size, 3), np.float32),
            np.zeros((2, cfg.text.context_length), np.int32),
            np.zeros((2, patch_num, cfg.feature_dim), np.float32),
            np.zeros((2, patch_num, cfg.feature_dim), np.float32),
            deterministic=False, method=model.train_forward)
    finally:
        flax_scope.Scope.param = orig


def full_shapes(port_cfg, patch_num: int = 13) -> dict:
    """'params/...' and 'batch_stats/...' flax paths -> shapes at
    `port_cfg`: the port's model on the meta device, through the JAX
    package's converters (on zero-stride arrays)."""
    import torch

    from fashionern_aaai2024_tpu_torch.models.composed import ComposedCIRModel as PortModel

    with torch.device("meta"):
        sd = PortModel(port_cfg, patch_num=patch_num).state_dict()
    zero = {k: np.broadcast_to(np.float32(0), tuple(t.shape)) for k, t in sd.items()}
    jax_cfg = jax_config.CLIPConfig(
        name=port_cfg.name,
        vision=jax_config.VisionConfig(**dataclasses.asdict(port_cfg.vision)),
        text=jax_config.TextConfig(**dataclasses.asdict(port_cfg.text)),
        activation=port_cfg.activation)
    clip = clip_variables_from_torch(
        {k.removeprefix("clip."): v for k, v in zero.items() if k.startswith("clip.")}, jax_cfg)
    ern = ern_variables_from_torch(
        {k.removeprefix("ern."): v for k, v in zero.items() if k.startswith("ern.")})
    tree = {"params": {"clip": clip["params"], "ern": ern["params"]},
            "batch_stats": {"ern": ern.get("batch_stats", {})}}
    if "batch_stats" in clip:
        tree["batch_stats"]["clip"] = clip["batch_stats"]
    return {_path(p): list(np.shape(x)) for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _path(keys) -> str:
    return "/".join(str(k.key) for k in keys)


def recipe(jax_cfg, port_cfg, seed: int = 7, patch_num: int = 13) -> dict:
    """The recipe of `jax_cfg`'s init at `port_cfg`'s shapes (the same
    model in each package's config class).

    Two structural inits, at 4 and 8 a head, must give every parameter
    the same key and initializer, but for a normal(stddev) whose stddev
    follows its tower's width as width^-0.5 (the towers' embeddings and
    projections), which is carried to the full width."""
    record: list = []
    small = jax_init(structural_config(jax_cfg, 4), seed, patch_num, record)
    other: list = []
    jax_init(structural_config(jax_cfg, 8), seed, patch_num, other)
    shapes = full_shapes(port_cfg, patch_num)
    if [r[0] for r in record] != [r[0] for r in other]:
        raise ValueError("the structural inits made different parameters")

    def spec(path: str, fn, fn8, key: list, key8: list) -> dict:
        if key != key8:
            raise ValueError(f"{path}: the key depends on the width")
        s4, s8 = init_spec(fn), init_spec(fn8)
        if s4 == s8:
            return s4
        tower = jax_cfg.vision if path.startswith("clip/visual/") else jax_cfg.text
        if (s4["kind"] != "normal" or s8["kind"] != "normal"
                or not np.isclose(s4["stddev"] / s8["stddev"], 2 ** 0.5, rtol=1e-6)):
            raise ValueError(f"{path}: the initializer depends on the width: {s4}, {s8}")
        return {"kind": "normal", "stddev": tower.width ** -0.5}
    entries = {"params": [], "batch_stats": []}

    def shape(path: str, small_shape: list) -> list:
        full = shapes.pop(path, None)
        if path.split("/")[1] == "ern":
            if full is not None and full != small_shape:
                raise ValueError(f"{path}: {small_shape} in the init, {full} in the port")
            return small_shape
        if full is None:
            raise KeyError(f"{path}: not a variable of the port's model")
        return full

    for (path, fn, key, small_shape), (_, fn8, key8, _) in zip(record, other):
        entries["params"].append({"path": path, "shape": shape(f"params/{path}", small_shape),
                                  "key": key, "init": spec(path, fn, fn8, key, key8)})
    for keys, x in jax.tree_util.tree_leaves_with_path(small.get("batch_stats", {})):
        path = _path(keys)
        x = np.asarray(x)
        kind = "zeros" if not x.any() else "ones" if (x == 1).all() else None
        if kind is None:
            raise ValueError(f"batch_stats/{path} starts neither at zeros nor at ones")
        entries["batch_stats"].append({"path": path,
                                       "shape": shape(f"batch_stats/{path}", list(x.shape)),
                                       "init": {"kind": kind}})
    if shapes:
        raise ValueError(f"variables of the port's model that the init did not make: "
                         f"{sorted(shapes)[:10]}")
    n_params = len(jax.tree_util.tree_leaves(small["params"]))
    if n_params != len(entries["params"]):
        raise ValueError(f"{n_params} parameters, {len(entries['params'])} recorded")
    return {"model": port_cfg.name, "tme": bool(port_cfg.text.tme), "seed": seed,
            "patch_num": patch_num, **entries}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="ViT-B-16")
    ap.add_argument("--tme", action="store_true")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    from fashionern_aaai2024_tpu_torch.models.clip.config import get_clip_config

    tme = True if args.tme else None
    r = recipe(jax_config.get_clip_config(args.model, tme=tme),
               get_clip_config(args.model, tme=tme), args.seed)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(r, f)
    print(f"wrote {len(r['params'])} parameters and {len(r['batch_stats'])} statistics of "
          f"{args.model}{' + TME' if args.tme else ''} (seed {args.seed}) to {args.out}")


if __name__ == "__main__":
    main()
