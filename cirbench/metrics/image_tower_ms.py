"""Device ms a loader batch in the image tower: the work on the compute
stream between the marks around each call of the encode callable that
the harness hands to `embed_gallery` (`trace.Marks`), over the calls of
the profiled passes."""


def read(traced):
    s = traced.summary
    if s is None or not s.layer_count or not s.layer_s.get("image_tower"):
        return None
    return 1e3 * s.layer_s["image_tower"] / s.layer_count["image_tower"]
