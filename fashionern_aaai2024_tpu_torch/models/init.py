"""The JAX package's seeded init, drawn in torch: flax's keys and
initializers, without JAX.

Where the JAX package builds weights from a seed it calls
`ComposedCIRModel.init` under `jax.random.PRNGKey(seed)`. This module
computes what that call draws, so that one seed gives both packages the
same weights (`models/composed.py jax_init_`).

The table. Each port module lists the variables of its flax
counterpart (`flax_variables`, beside its own parameters): a `Variable`
holds the flax path relative to the module's scope, the shape, the
initializer (`ZEROS`, `ONES`, `constant`, `normal`, `variance_scaling`,
`dense_general_kernel`, `dense_general_bias`: the kinds that the JAX
package's modules use) and the counter. The counter is the scope's count
of `make_rng("params")` calls when flax creates the parameter: its
parameters in order, 1, 2, ... (a child module has a scope and counts of
its own; a module called twice creates its parameters once). The helpers
below (`dense`, `conv`, `layer_norm`, `batch_norm`, `scope`) give flax's
own modules' variables in flax's order.

The keys (flax 0.12.3 `core/scope.py`, with `flax_fix_rng_separator`
False, its default). A parameter's key is `fold_in(PRNGKey(seed), h)`:
h is the first 4 bytes, big-endian, of the SHA-1 of every module name on
its path then its counter (an int as its big-endian bytes, no separator).
`PRNGKey(seed)` is the key words (0, seed mod 2^32), as JAX computes it
without x64; `fold_in(k, d)` is `threefry2x32(k, (0, d))`.

The values (JAX's `random_bits`, partitionable Threefry, and
`uniform` / `normal` / `truncated_normal`), on the device the caller
names, in chunks of `CHUNK` values (any range of a variable's flat
indices can be drawn alone, `flat_values`): the counter pair (0, i) of
the flat index i hashed by Threefry-2x32 in int64 tensors masked to 32
bits, its two words xor-ed; the mantissa from the top 23 bits; then the
float32 arithmetic that XLA's CPU backend compiles for these functions,
step by step: the uniform's multiply-add and every step of the `erf_inv`
polynomial as fused multiply-adds (a float32 product is exact in
float64: one float64 add, one rounding), XLA's own `log1p` and `log`
(Cephes' polynomials, not `torch.log1p`), square roots rounded from
float64; the truncated normal clipped to the float32 neighbours inside
its bounds; `DenseGeneral`'s flattening before its initializer. Every
step is an IEEE operation, so a device draws the same bits as the CPU,
and the CPU those of JAX on the CPU (`tests/test_torch_init.py` holds
them to 4 float32 ulps; they have been equal). Every scalar is a float32
made on the host and the tensors are only multiplied by such scalars
(PyTorch divides a CUDA tensor by a Python scalar through its
reciprocal).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Iterable

import numpy as np
import torch

MASK = 0xFFFFFFFF
CHUNK = 1 << 22
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# erf_inv's coefficients (XLA `ErfInv32`, M. Giles' single-precision fit)
_ERF_INV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
F32 = np.float32
_SQRT2 = F32(math.sqrt(2))
# XLA's float32 log (Cephes logf) and log1p (Cephes log1p: numerator and
# denominator from the highest power down)
_LOG_P = tuple(float(F32(c)) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
    -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = float(F32(-2.12194440e-4)), float(F32(0.693359375))
_LOG1P_NUM = tuple(float(F32(c)) for c in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
    2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_LOG1P_DEN = tuple(float(F32(c)) for c in (
    1.0, 1.5062909083469192198094e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
    3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1))


# --- initializers, as the JAX package's modules name them ------------------

ZEROS = {"kind": "zeros"}
ONES = {"kind": "ones"}


def constant(value: float) -> dict:
    return {"kind": "constant", "value": float(F32(value))}


def normal(stddev: float) -> dict:
    return {"kind": "normal", "stddev": float(stddev)}


def variance_scaling(scale: float, mode: str, distribution: str, in_axis: int = -2,
                     out_axis: int = -1, batch_axis: tuple = ()) -> dict:
    return {"kind": "variance_scaling", "scale": float(scale), "mode": mode,
            "distribution": distribution, "in_axis": in_axis, "out_axis": out_axis,
            "batch_axis": batch_axis}


LECUN_NORMAL = variance_scaling(1.0, "fan_in", "truncated_normal")   # flax's default kernel
XAVIER_UNIFORM = variance_scaling(1.0, "fan_avg", "uniform")         # = glorot_uniform


def dense_general_kernel(inner: dict, n_axis: int, n_features: int) -> dict:
    """`nn.DenseGeneral`'s kernel: `inner` on the kernel flattened to
    [prod(in axes), prod(features)]."""
    return {"kind": "dense_general_kernel", "n_batch_dims": 0, "n_axis": n_axis,
            "n_features": n_features, "inner": inner}


def dense_general_bias(inner: dict, n_features: int) -> dict:
    return {"kind": "dense_general_bias", "n_batch_dims": 0, "n_features": n_features,
            "inner": inner}


# --- the table --------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Variable:
    """One variable of the flax tree. `counter` is its scope's
    `make_rng("params")` count at its creation (0 for a `batch_stats`
    entry, which draws nothing)."""

    path: tuple[str, ...]
    shape: tuple[int, ...]
    init: dict
    counter: int = 0
    collection: str = "params"


def param(name: str, shape: Iterable[int], init: dict, counter: int) -> Variable:
    return Variable((name,), tuple(int(s) for s in shape), init, counter)


def scope(name: str, variables: Iterable[Variable]) -> list[Variable]:
    """`variables` of a child module named `name`."""
    return [dataclasses.replace(v, path=(name, *v.path)) for v in variables]


def dense(name: str, d_in: int, d_out: int, kernel_init: dict = LECUN_NORMAL,
          use_bias: bool = True) -> list[Variable]:
    """`nn.Dense(d_out, use_bias=use_bias, name=name)` on d_in features
    (or the JAX package's `_DenseParams` holders, which keep its names and
    rules)."""
    bias = [param("bias", (d_out,), ZEROS, 2)] if use_bias else []
    return scope(name, [param("kernel", (d_in, d_out), kernel_init, 1), *bias])


def dense_like(name: str, linear: torch.nn.Linear) -> list[Variable]:
    """`dense` at a port `nn.Linear`'s widths, with a bias where it has
    one."""
    return dense(name, linear.in_features, linear.out_features,
                 use_bias=linear.bias is not None)


def conv(name: str, k: int, c_in: int, c_out: int) -> list[Variable]:
    """`nn.Conv(c_out, (k, k), use_bias=False, name=name)`: kernel
    [k, k, c_in, c_out]."""
    return scope(name, [param("kernel", (k, k, c_in, c_out), LECUN_NORMAL, 1)])


def layer_norm(name: str, dim: int) -> list[Variable]:
    """`nn.LayerNorm` (or the JAX package's `LayerNorm` / `_LNParams`)."""
    return scope(name, [param("scale", (dim,), ONES, 1), param("bias", (dim,), ZEROS, 2)])


def batch_norm(name: str, dim: int) -> list[Variable]:
    """`nn.BatchNorm(name=name)`: scale and bias, and its running
    statistics in `batch_stats`."""
    return scope(name, [param("scale", (dim,), ONES, 1), param("bias", (dim,), ZEROS, 2),
                        Variable(("mean",), (dim,), ZEROS, collection="batch_stats"),
                        Variable(("var",), (dim,), ONES, collection="batch_stats")])


# --- keys ---------------------------------------------------------------------


def threefry2x32(key: tuple[int, int], x0, x1):
    """Threefry-2x32 (20 rounds) of the counters (x0, x1) under `key`: Python
    ints or int64 tensors holding uint32 words (JAX `prng.py
    threefry2x32`)."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) & MASK) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """`jax.random.PRNGKey(seed)` as the JAX package computes it (no x64)."""
    return 0, int(seed) & MASK


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    return threefry2x32(key, 0, data & MASK)


def path_hash(names: Iterable[str | int]) -> int:
    """flax's `_fold_in_static` hash of a scope suffix."""
    m = hashlib.sha1()
    for x in names:
        m.update(x.encode() if isinstance(x, str)
                 else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return int.from_bytes(m.digest()[:4], "big")


def variable_key(seed: int, variable: Variable) -> tuple[int, int]:
    """The key flax hands a parameter's initializer."""
    return fold_in(prng_key(seed), path_hash((*variable.path[:-1], variable.counter)))


# --- values -------------------------------------------------------------------


def _bits(key: tuple[int, int], start: int, stop: int, device) -> torch.Tensor:
    """JAX's partitionable 32-bit `random_bits` at flat indices
    [start, stop), as int64."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key, torch.zeros_like(idx), idx)
    return y0 ^ y1


def _uniform(bits: torch.Tensor, minval, maxval) -> torch.Tensor:
    """`jax.random.uniform` in float32 from its bits."""
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    minval, maxval = F32(minval), F32(maxval)
    scaled = floats.double() * float(maxval - minval) + float(minval)
    return torch.clamp_min(scaled.float(), float(minval))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32, as a fused multiply-add (float32
    operands: the product is exact in float64)."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


def _log(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 `log` for x > 0 (the Cephes `logf` polynomial, its
    multiply-adds fused, as XLA's CPU backend emits it)."""
    x = torch.clamp_min(x, float(np.finfo(np.float32).tiny))
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & 0x807FFFFF) | 0x3F000000).view(torch.float32)     # in [0.5, 1)
    below = m < float(F32(0.707106781186547524))
    t = (m - 1.0) + torch.where(below, m, 0.0)
    e = e - below.float()
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = _fma(_fma(t, p[0], p[1]), t, p[2])
    y1 = _fma(_fma(t, p[3], p[4]), t, p[5])
    y2 = _fma(_fma(t, p[6], p[7]), t, p[8])
    y = _fma(_fma(_fma(y, x3, y1), x3, y2), x3, e * _LOG_Q1)
    return (t - x2 * 0.5 + y) + e * _LOG_Q2


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 `log1p`: Cephes' rational approximation below
    |x| = sqrt(2) - 1, `_log(1 + x)` above."""
    x2 = x * x

    def poly(coefficients):
        p = torch.full_like(x, coefficients[0])
        for c in coefficients[1:]:
            p = _fma(p, x, c)
        return p
    small = (x * x2) * (poly(_LOG1P_NUM) / poly(_LOG1P_DEN))
    small = x + (small - x2 * 0.5)
    return torch.where(x.abs() < float(F32(0.41421356237309504880)), small, _log(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 `erf_inv`, its polynomial's multiply-adds fused."""
    w = -_log1p(-(x * x))
    lt = w < 5.0
    # the square root rounded from float64 is the correctly rounded float32
    # one on every device (PyTorch's vectorized float32 one on the CPU is not)
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, float(F32(_ERF_INV_LT5[0])), float(F32(_ERF_INV_GE5[0])))
    for a, b in zip(_ERF_INV_LT5[1:], _ERF_INV_GE5[1:]):
        p = _fma(p, w, torch.where(lt, float(F32(a)), float(F32(b))))
    return torch.where(x.abs() == 1.0, x * float(np.finfo(np.float32).max), p * x)


def _normal(bits: torch.Tensor) -> torch.Tensor:
    """`jax.random.normal` in float32: sqrt(2) erf_inv(u), u uniform on
    (-1, 1)."""
    lo = np.nextafter(F32(-1), F32(0))
    return erf_inv(_uniform(bits, lo, F32(1))) * float(_SQRT2)


def _truncated_normal(bits: torch.Tensor, lower: float, upper: float) -> torch.Tensor:
    """`jax.random.truncated_normal` in float32."""
    lower, upper = F32(lower), F32(upper)
    a, b = F32(math.erf(lower / _SQRT2)), F32(math.erf(upper / _SQRT2))
    out = erf_inv(_uniform(bits, a, b)) * float(_SQRT2)
    return torch.clamp(out, float(np.nextafter(lower, F32(np.inf))),
                       float(np.nextafter(upper, F32(-np.inf))))


def _fans(shape, in_axis, out_axis, batch_axis) -> tuple[float, float]:
    def size(axes):
        return shape[axes] if isinstance(axes, int) else math.prod(shape[i] for i in axes)
    field = math.prod(shape) / size(in_axis) / size(out_axis) / size(batch_axis)
    return size(in_axis) * field, size(out_axis) * field


def _sampler(spec: dict, shape: tuple[int, ...]):
    """The function from bits to values of a random initializer at its
    (flattened) shape."""
    kind = spec["kind"]
    if kind == "normal":
        std = float(F32(spec["stddev"]))
        return lambda bits: _normal(bits) * std
    if kind == "variance_scaling":
        fan_in, fan_out = _fans(shape, spec["in_axis"], spec["out_axis"], spec["batch_axis"])
        denominator = {"fan_in": fan_in, "fan_out": fan_out,
                       "fan_avg": (fan_in + fan_out) / 2}[spec["mode"]]
        variance = F32(spec["scale"] / denominator)
        if spec["distribution"] == "truncated_normal":
            std = float(np.sqrt(variance) / F32(.87962566103423978))
            return lambda bits: _truncated_normal(bits, -2, 2) * std
        if spec["distribution"] == "normal":
            std = float(np.sqrt(variance))
            return lambda bits: _normal(bits) * std
        if spec["distribution"] == "uniform":
            limit = float(np.sqrt(F32(3) * variance))
            return lambda bits: _uniform(bits, -1, 1) * limit
        raise ValueError(f"variance_scaling distribution {spec['distribution']!r}")
    raise ValueError(f"unknown initializer {kind!r}")


def flat_values(spec: dict, key: tuple[int, int], shape: Iterable[int], start: int,
                stop: int, device: torch.device | str) -> torch.Tensor:
    """A variable's values at the flat (row-major) indices [start, stop)
    of its value, drawing only those: `initialize(...).reshape(-1)[start:
    stop]`."""
    shape = tuple(int(s) for s in shape)
    kind = spec["kind"]
    if kind in ("zeros", "ones", "constant"):
        value = spec["value"] if kind == "constant" else float(kind == "ones")
        return torch.full((stop - start,), value, dtype=torch.float32, device=device)
    if kind == "dense_general_kernel":
        nb, na, nf = spec["n_batch_dims"], spec["n_axis"], spec["n_features"]
        flat = (math.prod(shape[:nb]) * math.prod(shape[nb:nb + na]), math.prod(shape[-nf:]))
        return flat_values(spec["inner"], key, flat, start, stop, device)
    if kind == "dense_general_bias":
        flat = (math.prod(shape[:spec["n_batch_dims"]])
                * math.prod(shape[-spec["n_features"]:]),)
        return flat_values(spec["inner"], key, flat, start, stop, device)
    n = math.prod(shape)
    if n >= 1 << 32:
        raise ValueError(f"{n} values: past the 32-bit counters this draw covers")
    return _sampler(spec, shape)(_bits(key, start, stop, device))


def initialize(spec: dict, key: tuple[int, int], shape: Iterable[int],
               device: torch.device | str) -> torch.Tensor:
    """One variable's value (float32, on `device`) from its initializer and
    key, drawn `CHUNK` values at a time."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=device)
    for start in range(0, n, CHUNK):
        stop = min(n, start + CHUNK)
        out[start:stop] = flat_values(spec, key, shape, start, stop, device)
    return out.reshape(shape)


def variables(table: Iterable[Variable], seed: int, device: torch.device | str) -> dict:
    """The `{"params", "batch_stats"}` tree of `table` drawn from `seed`
    on `device` (nested dicts of float32 tensors, flax's layout)."""
    tree: dict = {}
    for v in table:
        node = tree.setdefault(v.collection, {})
        for name in v.path[:-1]:
            node = node.setdefault(name, {})
        if v.path[-1] in node:
            raise ValueError(f"{'/'.join(v.path)} listed twice")
        node[v.path[-1]] = initialize(v.init, variable_key(seed, v), v.shape, device)
    return tree
