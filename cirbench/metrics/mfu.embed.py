"""Model FLOPs utilization of catalogue embedding, %: the FLOPs of one
image (image tower and refined row, `flops.embed_image`) times the
images a second of the window's unprofiled part, over the bf16 peak."""

from cirbench import flops, peaks


def read(traced):
    if traced.summary is None:        # no device trace: not a run on the card
        return None
    rate = traced.rates.get("img_per_s")
    if not rate:
        return None
    return 100.0 * flops.embed_image(traced.config).total_flops * rate / peaks.MFU_PEAK
