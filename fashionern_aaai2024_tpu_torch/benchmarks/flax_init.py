"""The JAX package's seeded init of the composed model, drawn again without
JAX: the whole init (both CLIP towers and the ERN) that a JAX run starts
from, in the port's names, for the accuracy soak's `--jax-init`
(`benchmarks/accuracy_soak.py`).

Flax draws each parameter from its own key: `PRNGKey(seed)` folded along
the module path. A recipe (JSON, written by `tests/jax_init_recipe.py`,
which runs flax) lists every variable of the composed model's
`{"params", "batch_stats"}` tree with its full shape, its key (two
uint32 words) and its initializer. This module draws the values from
that: the Threefry-2x32 counter hash and JAX's partitionable random
bits, `jax.random.uniform` / `normal` / `truncated_normal` from them,
and the initializers that the JAX package's modules use (zeros, ones,
constant, normal(stddev), variance_scaling, and flax `DenseGeneral`'s
flattening wrapper), all in float32 as JAX computes them. Only XLA's
`erf_inv` polynomial and `log1p` may round differently in the last bit,
so a value agrees with JAX's to a few float32 ulps
(`tests/test_torch_soak_parity.py`). The tree then goes through
`models/convert.py state_dict_from_variables`.
"""

from __future__ import annotations

import concurrent.futures
import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_CHUNK = 1 << 22
_THREADS = 8
# erf_inv's coefficients (XLA `ErfInv32`, M. Giles' single-precision fit)
_ERF_INV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
F32 = np.float32


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 (20 rounds) of the counters (x0, x1) under `key`,
    uint32 arrays (JAX `prng.py threefry2x32`)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def random_bits(key, n: int) -> np.ndarray:
    """n uint32 words (JAX's partitionable `random_bits` at 32 bits): the
    hash of the flat index i as the counter pair (0, i), its words
    xor-ed."""
    out = np.empty(n, np.uint32)
    with np.errstate(over="ignore"):
        for start in range(0, n, _CHUNK):
            idx = np.arange(start, min(n, start + _CHUNK), dtype=np.uint32)
            y0, y1 = threefry2x32(key, np.zeros_like(idx), idx)
            out[start:start + idx.size] = y0 ^ y1
    return out


def uniform(key, shape, minval, maxval) -> np.ndarray:
    """`jax.random.uniform` in float32: the mantissa from the bits' top 23,
    scaled to [minval, maxval) by one fused multiply-add (as XLA compiles
    it: the product is exact in float64)."""
    n = math.prod(shape)
    bits = (random_bits(key, n) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - F32(1)
    minval, maxval = F32(minval), F32(maxval)
    scaled = floats.astype(np.float64) * np.float64(maxval - minval) + np.float64(minval)
    return np.maximum(minval, scaled.astype(np.float32)).reshape(shape)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 `erf_inv`."""
    x = x.astype(np.float32)
    w = -np.log1p(-x * x)
    lt = w < F32(5)
    w = np.where(lt, w - F32(2.5), np.sqrt(w) - F32(3))
    p = np.where(lt, F32(_ERF_INV_LT5[0]), F32(_ERF_INV_GE5[0]))
    for a, b in zip(_ERF_INV_LT5[1:], _ERF_INV_GE5[1:]):
        p = np.where(lt, F32(a), F32(b)) + p * w
    return np.where(np.abs(x) == F32(1), x * np.finfo(np.float32).max, p * x)


def normal(key, shape) -> np.ndarray:
    """`jax.random.normal` in float32: sqrt(2) erf_inv(u), u uniform on
    (-1, 1)."""
    lo = np.nextafter(F32(-1), F32(0))
    return F32(math.sqrt(2)) * erf_inv(uniform(key, shape, lo, F32(1)))


def truncated_normal(key, lower: float, upper: float, shape) -> np.ndarray:
    """`jax.random.truncated_normal` in float32."""
    sqrt2 = F32(math.sqrt(2))
    lower, upper = F32(lower), F32(upper)
    a, b = F32(math.erf(lower / sqrt2)), F32(math.erf(upper / sqrt2))
    out = sqrt2 * erf_inv(uniform(key, shape, a, b))
    return np.clip(out, np.nextafter(lower, F32(np.inf)), np.nextafter(upper, F32(-np.inf)))


def _fans(shape, in_axis, out_axis, batch_axis) -> tuple[float, float]:
    def size(axes):
        return shape[axes] if isinstance(axes, int) else math.prod(shape[i] for i in axes)
    field = math.prod(shape) / size(in_axis) / size(out_axis) / size(batch_axis)
    return size(in_axis) * field, size(out_axis) * field


def initialize(spec: dict, key, shape) -> np.ndarray:
    """One variable's value from its recipe entry's initializer."""
    shape = tuple(shape)
    kind = spec["kind"]
    if kind == "zeros":
        return np.zeros(shape, np.float32)
    if kind == "ones":
        return np.ones(shape, np.float32)
    if kind == "constant":
        return np.full(shape, spec["value"], np.float32)
    if kind == "normal":
        return normal(key, shape) * F32(spec["stddev"])
    if kind == "variance_scaling":
        fan_in, fan_out = _fans(shape, spec["in_axis"], spec["out_axis"], spec["batch_axis"])
        denominator = {"fan_in": fan_in, "fan_out": fan_out,
                       "fan_avg": (fan_in + fan_out) / 2}[spec["mode"]]
        variance = F32(spec["scale"] / denominator)
        if spec["distribution"] == "truncated_normal":
            stddev = np.sqrt(variance) / F32(.87962566103423978)
            return truncated_normal(key, -2, 2, shape) * stddev
        if spec["distribution"] == "normal":
            return normal(key, shape) * np.sqrt(variance)
        if spec["distribution"] == "uniform":
            return uniform(key, shape, -1, 1) * np.sqrt(F32(3) * variance)
        raise ValueError(f"variance_scaling distribution {spec['distribution']!r}")
    if kind == "dense_general_kernel":
        nb, na, nf = spec["n_batch_dims"], spec["n_axis"], spec["n_features"]
        flat = (math.prod(shape[:nb]) * math.prod(shape[nb:nb + na]),
                math.prod(shape[-nf:]))
        return initialize(spec["inner"], key, flat).reshape(shape)
    if kind == "dense_general_bias":
        flat = (math.prod(shape[:spec["n_batch_dims"]]) * math.prod(shape[-spec["n_features"]:]),)
        return initialize(spec["inner"], key, flat).reshape(shape)
    raise ValueError(f"unknown initializer {kind!r}")


def variables(recipe: dict) -> dict:
    """The composed model's `{"params", "batch_stats"}` tree (the
    variables drawn on `_THREADS` threads: numpy leaves the GIL in its
    array loops)."""
    entries = [(c, e) for c in ("params", "batch_stats") for e in recipe[c]]
    with concurrent.futures.ThreadPoolExecutor(_THREADS) as pool:
        values = pool.map(lambda ce: initialize(ce[1]["init"], ce[1].get("key"),
                                                ce[1]["shape"]), entries)
        tree: dict = {}
        for (collection, entry), value in zip(entries, values):
            node = tree.setdefault(collection, {})
            *parents, leaf = entry["path"].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = value
    return tree


def state_dict(recipe: dict, cfg=None) -> dict:
    """The port's `ComposedCIRModel` state_dict of the recipe's init (at
    `cfg`, by default the recipe's named model)."""
    from fashionern_aaai2024_tpu_torch.models import convert
    from fashionern_aaai2024_tpu_torch.models.clip.config import get_clip_config

    if cfg is None:
        cfg = get_clip_config(recipe["model"], tme=True if recipe["tme"] else None)
    return convert.state_dict_from_variables(variables(recipe), cfg)
