"""The device's idle share over the profiled slice, %: 1 − the union of
its activity (kernels, copies, memsets) over the slice's length. The
reader of every `idle_share.<cells>` metric (`spec.py`)."""


def read(traced):
    s = traced.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
