"""The frozen towers' share of their roofline in a train step, %: the
least time of a step's tower work (`flops.train_towers`: two images and
a caption a row, bf16 FLOPs at their peak, or the bytes at the HBM rate,
the larger) over the step's device time in the towers
(`train_step.towers_ms`)."""

from cirbench import flops, peaks


def read(traced):
    s = traced.summary
    if s is None or not s.layer_s or not s.layer_s.get("towers"):
        return None
    per_step = s.layer_s["towers"] / traced.units["steps"]
    return 100.0 * peaks.least_time_s(flops.train_towers(traced.config,
                                                         traced.units["batch"])) / per_step
