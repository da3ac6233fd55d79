"""Device ms a train step outside the frozen towers: the rest of the
compute stream's work in the profiled steps (the feed's casts, TME, the
fusion forward, the BBC loss, the backward, Adam), over the steps."""

from cirbench.trace import OUTSIDE


def read(traced):
    s = traced.summary
    if s is None or not s.layer_s or not s.layer_s.get(OUTSIDE):
        return None
    return 1e3 * s.layer_s[OUTSIDE] / traced.units["steps"]
