"""The attention experiment on the card: X1-X4 at CLIP ViT-B-16's
attention layer at the bench batch (B=128, 12 heads of 64, 197 tokens).

    python -m fashionern_aaai2024_tpu_torch.benchmarks.attn_experiment \
        [--packed | --qkv-fused | --attnblock | --all]

JAX counterpart: `benchmarks/attn_experiment.py`, whose four entry points
this module keeps: no flag runs X1 (`mha_grouped`, G (batch, head) pairs a
program over padded q / k / v), `--packed` X2 (`mha_packed`, packed qkv,
gb images a program), `--qkv-fused` X3 (`qkvattn`, QKV projection +
attention), `--attnblock` X4 (`attnblock`, the whole attention
sub-block), `--all` the four in turn. Each one

  * checks the kernel in fp32 against its plain version on every output
    element (X1: all 208 rows x 128 lanes of the padded output, not only
    the [:197, :64] the JAX script reads) at atol 2e-5, and reports the
    JAX script's own comparison beside it (X1 and X2 against
    `attention_ref`, the port of `xla_ref`; X3 against the two-stage
    projection + X2; X4 against the unfused formula);
  * times the kernel in bf16 with CUDA events, best of 3 windows of 30
    calls after two warm-up calls (the experiment's definition), X1 at
    every G of (1, 4, 8, 16, 32, 64) and X2 at every gb of (1, 2, 4, 8)
    that divides its count;
  * times beside it one PyTorch library call the port never makes: SDPA
    with the bias as `attn_mask` (X1, X2), `F.linear` + SDPA (X3),
    `F.layer_norm` + `F.linear` + SDPA + `F.linear` + add (X4).

The command line runs on the card and raises without a GPU. The entry
points take `device`, `batch`, `iters` and `windows` as keywords: the
CPU tests call them with `device="cpu"` at a small batch, where the
kernels are their plain versions and the times are the host's. Nothing is caught: a
kernel that fails to build, launch or agree ends the run (the JAX
script's `try / except ... FAILED` around the gb sweep is not carried
over; a gb that does not divide the batch is skipped before the call, as
the JAX script skips a G that does not divide BH).

The inputs are drawn from `numpy.random.default_rng(0)` in the JAX
script's order; the weights of X3 and X4 go through
`models/convert.py attn_experiment_params_from_jax` once, before any
timed call, as a checkpoint load would.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from fashionern_aaai2024_tpu_torch.models.convert import attn_experiment_params_from_jax
from fashionern_aaai2024_tpu_torch.ops import attn_experiment as X
from fashionern_aaai2024_tpu_torch.ops.attention import NEG_INF
from fashionern_aaai2024_tpu_torch.ops.attn_experiment import DH, DP, H, S, SKP, SP, W
from fashionern_aaai2024_tpu_torch.ops.layernorm import layer_norm_plain

GROUPS = (1, 4, 8, 16, 32, 64)
IMAGE_GROUPS = (1, 2, 4, 8)
ITERS, WINDOWS = 30, 3
# the fp32 check: the port's module tolerance (the JAX script's 2e-5)
ATOL = 2e-5
# G and gb of the fp32 checks (the JAX script's)
CHECK_G, CHECK_GB = 8, 2


def device_of(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("attn_experiment: CUDA is not available; the experiment runs on a "
                           "GPU (pass device='cpu' for the plain versions on the host)")
    return dev


def timeit(fn, dev: torch.device, iters: int = ITERS, windows: int = WINDOWS) -> float:
    """ms a call: best of `windows` windows of `iters` calls after two
    warm-up calls; CUDA events on the card, the host clock on the CPU."""
    fn()
    fn()
    best = float("inf")
    for _ in range(windows):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms = 1e3 * (time.perf_counter() - t0) / iters
        best = min(best, ms)
    return best


def _max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.float() - want.float()).abs().max().item()


def _check(label: str, got: torch.Tensor, want: torch.Tensor, log) -> float:
    err = _max_err(got, want)
    log(f"{label} fp32 max err vs plain: {err:.2e}")
    if not err <= ATOL:
        raise AssertionError(f"{label}: the kernel disagrees with its plain version "
                             f"(max abs err {err:.3e} > {ATOL})")
    return err


def _padded_bias(sq: int, sk: int, dev: torch.device) -> torch.Tensor:
    """fp32 [sq, sk]: 0 on the first S keys, -1e30 on the padding."""
    bias = torch.full((sq, sk), NEG_INF, dtype=torch.float32)
    bias[:, :S] = 0.0
    return bias.to(dev)


def sdpa_with_bias(q, k, v, bias, scale, heads=None):
    """SDPA with `bias` as `attn_mask` (the library yardstick, never
    called by the port): q, k, v [N, S, D] (as N x 1 heads: a 3-D call
    takes SDPA's math path, the 4-D one its fused kernels), or [B, S, W]
    split into `heads`."""
    if heads is None:
        return F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None],
                                              attn_mask=bias.to(q.dtype), scale=scale)[:, 0]
    split = [t.unflatten(-1, (heads, t.shape[-1] // heads)).transpose(1, 2) for t in (q, k, v)]
    o = F.scaled_dot_product_attention(*split, attn_mask=bias.to(q.dtype), scale=scale)
    return o.transpose(1, 2).flatten(2)


def grouped_main(device: str | torch.device = "cuda", batch: int = X.B, iters: int = ITERS,
                 windows: int = WINDOWS, log=print) -> dict:
    """X1: the fp32 check at G = 8, then the bf16 G sweep."""
    dev = device_of(device)
    g = np.random.default_rng(0)
    scale = DH ** -0.5
    bh = batch * H
    q, k, v = (torch.from_numpy(g.standard_normal((bh, S, DH)).astype(np.float32))
               for _ in range(3))

    def pad(t, rows):
        out = torch.zeros((bh, rows, DP), dtype=torch.float32)
        out[:, :S, :DH] = t
        return out.to(dev)

    qp, kp, vp = pad(q, SP), pad(k, SKP), pad(v, SKP)
    bias = _padded_bias(SP, SKP, dev)
    got = X.mha_grouped(qp, kp, vp, bias, scale, CHECK_G)
    err = _check(f"X1 mha_grouped (G={CHECK_G}, all {SP}x{DP})", got,
                 X.mha_grouped_plain(qp, kp, vp, bias, scale, CHECK_G), log)
    ref_err = _max_err(got[:, :S, :DH], X.attention_ref(*(t.to(dev) for t in (q, k, v)), scale))
    log(f"X1 fp32 max err vs attention_ref on [:{S}, :{DH}]: {ref_err:.2e}")
    del got

    qb, kb, vb = (t.to(dev, torch.bfloat16) for t in (q, k, v))
    ref_ms = timeit(lambda: X.attention_ref(qb, kb, vb, scale), dev, iters, windows)
    log(f"attention_ref (bf16): {ref_ms:.4f} ms/layer")
    qpb, kpb, vpb = (t.to(torch.bfloat16) for t in (qp, kp, vp))
    del qp, kp, vp
    library_ms = timeit(lambda: sdpa_with_bias(qpb, kpb, vpb, bias, scale), dev, iters,
                        windows)
    log(f"SDPA with the bias as attn_mask (bf16, padded): {library_ms:.4f} ms/layer")
    times = {}
    for grp in GROUPS:
        if bh % grp:
            continue
        times[grp] = timeit(lambda: X.mha_grouped(qpb, kpb, vpb, bias, scale, grp), dev,
                            iters, windows)
        log(f"X1 grouped kernel G={grp:3d}: {times[grp]:.4f} ms/layer")
    return dict(kernel="X1", max_abs_err=err, ref_max_abs_err=ref_err, times_ms=times,
                library_ms=library_ms, reference_ms=ref_ms)


def packed_main(device: str | torch.device = "cuda", batch: int = X.B, iters: int = ITERS,
                windows: int = WINDOWS, log=print) -> dict:
    """X2: the fp32 check at gb = 2, then the bf16 gb sweep."""
    dev = device_of(device)
    g = np.random.default_rng(0)
    scale = DH ** -0.5
    qkv_np = g.standard_normal((batch, SP, 3 * W)).astype(np.float32)
    qkv_np[:, S:] = 0.0
    qkv = torch.from_numpy(qkv_np).to(dev)
    bias = _padded_bias(SP, SP, dev)
    got = X.mha_packed(qkv, bias, scale, CHECK_GB)
    err = _check(f"X2 mha_packed (gb={CHECK_GB})", got,
                 X.mha_packed_plain(qkv, bias, scale, CHECK_GB), log)
    heads = [t[:, :S].unflatten(-1, (H, DH)).transpose(1, 2).flatten(0, 1)
             for t in qkv.split(W, dim=-1)]
    want = X.attention_ref(*heads, scale)
    ref_err = _max_err(got[:, :S].unflatten(-1, (H, DH)).transpose(1, 2).flatten(0, 1), want)
    log(f"X2 fp32 max err vs attention_ref: {ref_err:.2e}")
    del got, want, heads

    qkvb = qkv.to(torch.bfloat16)
    del qkv
    library_ms = timeit(lambda: sdpa_with_bias(*qkvb.split(W, dim=-1), bias, scale, heads=H),
                        dev, iters, windows)
    log(f"SDPA with the bias as attn_mask (bf16): {library_ms:.4f} ms/layer")
    times = {}
    for gb in IMAGE_GROUPS:
        if batch % gb:
            continue
        times[gb] = timeit(lambda: X.mha_packed(qkvb, bias, scale, gb), dev, iters, windows)
        log(f"X2 packed kernel gb={gb}: {times[gb]:.4f} ms/layer")
    return dict(kernel="X2", max_abs_err=err, ref_max_abs_err=ref_err, times_ms=times,
                library_ms=library_ms)


def _weights(g: np.random.Generator, attnblock: bool) -> dict:
    """The JAX script's weights in its draw order, as numpy [in, out]."""
    out = {}
    if attnblock:
        out["g_"] = g.standard_normal((W,)).astype(np.float32) * 0.1 + 1.0
        out["be"] = g.standard_normal((W,)).astype(np.float32) * 0.1
    out["w_qkv"] = (g.standard_normal((W, 3 * W)) * 0.02).astype(np.float32)
    out["b_qkv"] = (g.standard_normal((3 * W,)) * 0.02).astype(np.float32)
    if attnblock:
        out["w_out"] = (g.standard_normal((W, W)) * 0.02).astype(np.float32)
        out["b_out"] = (g.standard_normal((W,)) * 0.02).astype(np.float32)
    return out


def qkv_fused_main(device: str | torch.device = "cuda", batch: int = X.B,
                   iters: int = ITERS, windows: int = WINDOWS, log=print) -> dict:
    """X3: the fp32 check (and the JAX script's two-stage comparison),
    then the bf16 time."""
    dev = device_of(device)
    g = np.random.default_rng(0)
    scale = DH ** -0.5
    x = torch.from_numpy(g.standard_normal((batch, S, W)).astype(np.float32)).to(dev)
    jax_weights = _weights(g, attnblock=False)
    p = attn_experiment_params_from_jax(jax_weights, device=dev)
    bias = torch.zeros((S, S), dtype=torch.float32, device=dev)
    got = X.qkvattn(x, p["w_qkv"], p["b_qkv"], bias, scale)
    err = _check("X3 qkvattn", got, X.qkvattn_plain(x, p["w_qkv"], p["b_qkv"], bias, scale),
                 log)
    # the JAX script's check: the projection, padded to 208 rows, through X2
    qkv = F.pad(F.linear(x, p["w_qkv"], p["b_qkv"]), (0, 0, 0, SP - S))
    two_stage = X.mha_packed(qkv, _padded_bias(SP, SP, dev), scale, 1)[:, :S]
    ref_err = _max_err(got, two_stage)
    log(f"X3 fp32 max err vs projection + X2: {ref_err:.2e}")
    del got, qkv, two_stage

    xb = x.to(torch.bfloat16)
    pb = attn_experiment_params_from_jax(jax_weights, dtype=torch.bfloat16, device=dev)
    del x, p

    def library():
        qkv = F.linear(xb, pb["w_qkv"], pb["b_qkv"])
        return sdpa_with_bias(*qkv.split(W, dim=-1), bias, scale, heads=H)

    library_ms = timeit(library, dev, iters, windows)
    log(f"F.linear + SDPA (bf16): {library_ms:.4f} ms/layer")
    ms = timeit(lambda: X.qkvattn(xb, pb["w_qkv"], pb["b_qkv"], bias, scale), dev, iters,
                windows)
    log(f"X3 qkv-fused kernel: {ms:.4f} ms/layer")
    return dict(kernel="X3", max_abs_err=err, ref_max_abs_err=ref_err, times_ms={1: ms},
                library_ms=library_ms)


def _attnblock_unfused(x, p, scale):
    """The JAX script's `ref`: LN, projection, attention with bf16 scores
    (`attention_ref`), out-projection + residual, unfused."""
    b = x.shape[0]
    y = layer_norm_plain(x, p["g"], p["be"], X.LN_EPS)
    qkv = F.linear(y, p["w_qkv"], p["b_qkv"])
    q, k, v = (t.unflatten(-1, (H, DH)).transpose(1, 2).flatten(0, 1)
               for t in qkv.split(W, dim=-1))
    o = X.attention_ref(q, k, v, scale).unflatten(0, (b, H)).transpose(1, 2).flatten(2)
    return x + F.linear(o, p["w_out"], p["b_out"]).to(x.dtype)


def attnblock_main(device: str | torch.device = "cuda", batch: int = X.B,
                   iters: int = ITERS, windows: int = WINDOWS, log=print) -> dict:
    """X4: the fp32 check (and the JAX script's unfused comparison), then
    the bf16 time."""
    dev = device_of(device)
    g = np.random.default_rng(0)
    scale = DH ** -0.5
    x = torch.from_numpy(g.standard_normal((batch, S, W)).astype(np.float32)).to(dev)
    jax_weights = _weights(g, attnblock=True)
    p = attn_experiment_params_from_jax(jax_weights, device=dev)
    bias = torch.zeros((S, S), dtype=torch.float32, device=dev)
    args = (p["g"], p["be"], p["w_qkv"], p["b_qkv"], p["w_out"], p["b_out"], bias, scale)
    got = X.attnblock(x, *args)
    err = _check("X4 attnblock", got, X.attnblock_plain(x, *args), log)
    ref_err = _max_err(got, _attnblock_unfused(x, p, scale))
    log(f"X4 fp32 max err vs the unfused formula: {ref_err:.2e}")
    del got

    xb = x.to(torch.bfloat16)
    pb = attn_experiment_params_from_jax(jax_weights, dtype=torch.bfloat16, device=dev)
    del x, p
    argsb = (pb["g"], pb["be"], pb["w_qkv"], pb["b_qkv"], pb["w_out"], pb["b_out"], bias,
             scale)

    def library():
        y = F.layer_norm(xb, (W,), pb["g"], pb["be"], X.LN_EPS)
        qkv = F.linear(y, pb["w_qkv"], pb["b_qkv"])
        o = sdpa_with_bias(*qkv.split(W, dim=-1), bias, scale, heads=H)
        return xb + F.linear(o, pb["w_out"], pb["b_out"])

    library_ms = timeit(library, dev, iters, windows)
    log(f"F.layer_norm + F.linear + SDPA + F.linear + add (bf16): {library_ms:.4f} ms/layer")
    ms = timeit(lambda: X.attnblock(xb, *argsb), dev, iters, windows)
    log(f"X4 attnblock kernel: {ms:.4f} ms/layer")
    return dict(kernel="X4", max_abs_err=err, ref_max_abs_err=ref_err, times_ms={1: ms},
                library_ms=library_ms)


ENTRY_POINTS = {"grouped": grouped_main, "packed": packed_main, "qkv_fused": qkv_fused_main,
                "attnblock": attnblock_main}


def main(argv: list[str] | None = None) -> dict:
    """Run the chosen entry points; returns {name: result}."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    which = parser.add_mutually_exclusive_group()
    which.add_argument("--packed", action="store_true", help="X2 (mha_packed)")
    which.add_argument("--qkv-fused", action="store_true", help="X3 (qkvattn)")
    which.add_argument("--attnblock", action="store_true", help="X4 (attnblock)")
    which.add_argument("--all", action="store_true", help="X1-X4 in turn")
    args = parser.parse_args(argv)
    dev = device_of("cuda")
    if args.all:
        names = list(ENTRY_POINTS)
    else:
        names = [("packed" if args.packed else "qkv_fused" if args.qkv_fused
                  else "attnblock" if args.attnblock else "grouped")]
    print(f"attention experiment on {torch.cuda.get_device_name(dev)}, B={X.B}", flush=True)

    def log(msg):
        print(msg, flush=True)

    return {name: ENTRY_POINTS[name](dev, log=log) for name in names}


if __name__ == "__main__":
    main()
