"""Device ms a query call: every device operation of the profiled calls
(the serve program's replay: its kernels and copies), over the calls.
Taken from the whole slice, which holds nothing but the calls."""


def read(traced):
    s = traced.summary
    if s is None or s.device_s <= 0:
        return None
    return 1e3 * s.device_s / traced.units["calls"]
