"""Device ms a train step in the frozen towers: the work on the compute
stream between the marks around the step's image and text tower calls
(`trace.Marks`), over the profiled steps."""


def read(traced):
    s = traced.summary
    if s is None or not s.layer_s or not s.layer_s.get("towers"):
        return None
    return 1e3 * s.layer_s["towers"] / traced.units["steps"]
