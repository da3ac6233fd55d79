"""The image tower's share of its roofline, %: the least time of a
loader batch's tower work (`flops.image_tower`: its bf16 FLOPs at their
peak, or its bytes at the HBM rate, the larger) over the batch's device
time in the tower (`image_tower_ms`)."""

from cirbench import flops, peaks


def read(traced):
    s = traced.summary
    if s is None or not s.layer_count or not s.layer_s.get("image_tower"):
        return None
    calls = s.layer_count["image_tower"]
    per_call = s.layer_s["image_tower"] / calls
    least = peaks.least_time_s(flops.image_tower(traced.config, traced.units["rows"] / calls))
    return 100.0 * least / per_call
