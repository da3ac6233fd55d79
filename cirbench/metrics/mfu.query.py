"""Model FLOPs utilization of query serving, %: the FLOPs of one serve
call (text tower, TME, DVR, search: `flops.serve_call`) times the calls
a second of the window's unprofiled part, over the bf16 peak."""

from cirbench import flops, peaks


def read(traced):
    if traced.summary is None:        # no device trace: not a run on the card
        return None
    rate = traced.rates.get("calls_per_s")
    if not rate:
        return None
    u = traced.units
    work = flops.serve_call(traced.config, u["gallery"], u["k"], u["batch"])
    return 100.0 * work.total_flops * rate / peaks.MFU_PEAK
