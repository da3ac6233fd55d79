"""The JAX package's seeded init of the whole composed model, with the
record of how flax drew each parameter: the oracle of the port's
`models/init.py` (`tests/test_torch_init.py`, `tests/test_torch_soak_parity.py`).

`jax_init` runs `ComposedCIRModel.init` as the JAX package's
`Trainer._init_variables` and `cli/main.py load_model_variables` run it
(`PRNGKey(seed)`, `train_forward`, `deterministic=False`); with `record`,
each parameter's flax path, initializer, key words and shape are
appended as flax creates it. `init_spec` names an initializer in the
port's terms (`models/init.py`).
"""

import jax
import numpy as np
from flax.core import scope as flax_scope

from fashionern_aaai2024_tpu.models.composed import ComposedCIRModel


def _closure(fn) -> dict:
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__ or ())))


def init_spec(fn) -> dict:
    """A flax / `jax.nn.initializers` initializer as `models/init.py`
    names it."""
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
    raise ValueError(f"no name for the initializer {name or fn!r}")


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
