"""The port's kernel entries as registered torch ops, for `torch.export`.

JAX counterpart: none as a file. A JAX export on the TPU bakes the
Pallas kernels into the serialized program (`retrieval/artifact.py:26-
31`). Here the kernels launch through `ctypes` with raw pointers
(`ops/common.py launch`), which `torch.export`'s fake tensors cannot
run. So each kernel entry that the serve program reaches is registered
as a `torch.library.custom_op` in the `fern` namespace, with a fake
(shape-only) version for the trace:

    transformer_block (B10), attention_subblock (B1), mlp_subblock (B2),
    fused_qkv_self_attention (B7), packed_kv_cross_attention (B8),
    multi_head_attention (B9), layer_norm (B11), combiner (B12),
    int8_mlp_subblock (B5), int8_attention_subblock (B6), int8_product

An exported program calls `torch.ops.fern.<name>`, whose real body is
the entry's own function: it picks the plain version or the kernel by
the tensor's device, as an eager call does, so one exported graph runs
the kernels on CUDA tensors and the plain versions on CPU tensors, and
it counts its launches (`common.count`) as an eager call does.

`exportable` wraps an entry: while `torch.export` traces
(`torch.compiler.is_exporting()`), a call goes to the registered op;
any other call goes straight to the function, so the eager paths run as
before. It is the only place that routes a kernel entry to its op.
Where the eager entry takes what a schema cannot (B9's dropout
generator, B12's module), the registered entry is the schema-shaped
body (`attention.py mha`, `combiner.py combiner`) and the eager entry
calls it. A process that loads an exported program must have registered
the ops first (`torch.export.load` cannot deserialize an unknown op):
`register_all()` imports every module that registers one. It imports
nothing of `models/`.
"""

from __future__ import annotations

import functools
import importlib
import inspect
from typing import Callable

import torch

NAMESPACE = "fern"
# the modules whose import registers the ops
MODULES = ("attention", "block", "combiner", "layernorm", "mlp", "qmatmul", "qmlp")


def exportable(fake: Callable, name: str | None = None) -> Callable:
    """Decorator: register `fn` as the op `fern::<name>` (its schema from
    `fn`'s annotations, `fake` its fake version) and return a function
    that calls the op while `torch.export` traces and `fn` otherwise.
    The op is the returned function's `op`."""
    def wrap(fn: Callable) -> Callable:
        sig = inspect.signature(fn)
        names = list(sig.parameters)
        kwonly = {n for n, p in sig.parameters.items() if p.kind is p.KEYWORD_ONLY}
        # an op takes no keyword-only tensors: the op's schema takes every
        # argument by position, in `fn`'s order, and its body hands the
        # keyword-only ones back to `fn` by name
        schema = torch.library.infer_schema(fn, mutates_args=()).replace("*, ", "")

        def body(*args):
            return fn(*(a for n, a in zip(names, args) if n not in kwonly),
                      **{n: a for n, a in zip(names, args) if n in kwonly})
        op = torch.library.custom_op(f"{NAMESPACE}::{name or fn.__name__}", body,
                                     mutates_args=(), schema=schema)
        op.register_fake(fake)

        @functools.wraps(fn)
        def call(*args, **kwargs):
            if torch.compiler.is_exporting():
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                return op(*bound.arguments.values())
            return fn(*args, **kwargs)
        call.op = op
        return call
    return wrap


def like(x: torch.Tensor, *_args, **_kwargs) -> torch.Tensor:
    """The fake version of an entry whose output has its first operand's
    shape and dtype (contiguous, as every entry returns it)."""
    return x.new_empty(x.shape)


def register_all() -> None:
    """Import every module that registers an op (idempotent)."""
    for module in MODULES:
        importlib.import_module(f"fashionern_aaai2024_tpu_torch.ops.{module}")
