"""The serve program's share of its roofline, %: the least time of one
call's work (`flops.serve_call`: FLOPs at their type's peak, or the
weights, gallery and rows read once at the HBM rate, the larger) over
the call's device time (`serve_device_ms`)."""

from cirbench import flops, peaks


def read(traced):
    s = traced.summary
    if s is None or s.device_s <= 0:
        return None
    per_call = s.device_s / traced.units["calls"]
    u = traced.units
    return 100.0 * peaks.least_time_s(
        flops.serve_call(traced.config, u["gallery"], u["k"], u["batch"])) / per_call
