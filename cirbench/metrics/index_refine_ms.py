"""Device ms for 128 rows of `refine_gallery`: the work on the compute
stream between the marks around each call of it (`trace.Marks`), over
the rows the profiled passes refined, times 128."""


def read(traced):
    s = traced.summary
    if s is None or not s.layer_s or not s.layer_s.get("index_refine"):
        return None
    return 1e3 * s.layer_s["index_refine"] * 128 / traced.units["rows"]
