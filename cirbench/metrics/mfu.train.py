"""Model FLOPs utilization of training, %: a step's FLOPs
(`flops.train_step`: the frozen towers' forward, the trained parts
three times) times the steps a second of the window's unprofiled part,
over the bf16 peak."""

from cirbench import flops, peaks


def read(traced):
    if traced.summary is None:        # no device trace: not a run on the card
        return None
    rate = traced.rates.get("samples_per_s")
    if not rate:
        return None
    b = traced.units["batch"]
    return 100.0 * flops.train_step(traced.config, b).total_flops * rate / b / peaks.MFU_PEAK
