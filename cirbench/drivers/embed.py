"""Catalogue embedding: whole passes of `embed_gallery` and
`refine_gallery` over a pool of images in host memory.

Traffic parameters: `pool` images, `batch` rows a loader batch,
`prefetch` (the gallery engine's staging depth), `sampled_rows` of every
pass kept for the check, `profile_passes` of a `--trace 1` run profiled.

Set-up draws the weights (`program.build`), makes the pool from the seed
on the device (uint8 images, the decoded shard a catalogue job feeds,
and their patch features) and copies it to host memory, then runs one
whole pass, which warms every shape of the window. A pass is
`embed_gallery(api.gallery_encode_fn(), batches, prefetch=...)` (host
batches pinned and copied on the copy stream, the image tower on the
compute stream), then `InferenceAPI.refine_gallery`, and ends with a
synchronize. `embed_img_per_s` is the images of the whole passes over
the time from the window's start to the end of its last pass.

The check: the last pass's image-tower globals and refined rows, every
row, and `sampled_rows` rows of every pass (drawn from the seed),
against the reference's, by the worst row's relative error.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from cirbench import program, reference, weights
from cirbench.inputs import make_pool, relative_errors
from cirbench.harness import Context, Traced, Window, synchronize
from cirbench.reference.ops import LOWER
from cirbench.trace import SLICE, Marks, profiler, summarize


class Driver:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.t = ctx.traffic
        self.kept: list[tuple[torch.Tensor, torch.Tensor]] = []   # (rows, refined) a pass

    def setup(self) -> None:
        ctx, t = self.ctx, self.t
        self.model, drawn = program.build(ctx.config, ctx.seed, ctx.device)
        self.layout, self.stats = weights.layout_of(drawn), weights.statistics(drawn)
        del drawn
        from fashionern_aaai2024_tpu_torch.retrieval.evaluate import InferenceAPI

        self.api = InferenceAPI(self.model, device=ctx.device, batch_size=t["batch"])
        self.images, self.patches = make_pool(ctx.config, t["pool"], ctx.seed, ctx.device)
        names = [f"item{i}" for i in range(t["pool"])]
        b = t["batch"]
        self.batches = [{"name": names[i:i + b], "image": self.images[i:i + b],
                         "patch": self.patches[i:i + b]} for i in range(0, t["pool"], b)]
        inner = self.api.gallery_encode_fn()
        self.marks = Marks(ctx.device)

        def encode(images):
            with record_function("cirbench/image_tower"), self.marks.layer("image_tower"):
                return inner(images)
        encode.place = inner.place
        self.encode = encode
        rng = np.random.default_rng([ctx.seed, 0xE3BED])
        self.sample = torch.as_tensor(
            np.sort(rng.choice(t["pool"], size=min(t["sampled_rows"], t["pool"]), replace=False)),
            device=ctx.device)
        if ctx.control != "reference_lower":
            self.last = self.one_pass()

    def one_pass(self):
        from fashionern_aaai2024_tpu_torch.retrieval.engine import embed_gallery

        with record_function("cirbench/pass"):
            gallery = embed_gallery(self.encode, self.batches, prefetch=self.t["prefetch"])
            with record_function("cirbench/index_refine"), self.marks.layer("index_refine"):
                refined = self.api.refine_gallery(gallery.features, gallery.local_features)
            synchronize(self.ctx.device)
        return gallery.features, refined

    def _passes(self, seconds: float) -> tuple[int, float]:
        t0 = time.perf_counter()
        passes = 0
        while True:
            self.last = self.one_pass()
            self.kept.append((self.sample, self.last[1][self.sample]))
            passes += 1
            if time.perf_counter() - t0 >= seconds:
                return passes, time.perf_counter() - t0

    def window(self, seconds: float) -> Window:
        if self.ctx.control == "reference_lower":
            return Window({}, 0, 0)
        passes, elapsed = self._passes(seconds)
        return Window({"embed_img_per_s": passes * self.t["pool"] / elapsed}, passes, 0)

    def traced_window(self, seconds: float) -> tuple[Window, Traced]:
        t0 = time.perf_counter()
        profiled = self.t["profile_passes"]
        self.marks.on = True
        with profiler(self.ctx.device) as prof:
            with record_function(SLICE):
                for _ in range(profiled):
                    self.last = self.one_pass()
                    self.kept.append((self.sample, self.last[1][self.sample]))
        self.marks.on = False
        rest, elapsed = self._passes(max(0.0, seconds - (time.perf_counter() - t0)))
        summary = summarize(prof, self.marks)
        pool = self.t["pool"]
        units = {"batch": self.t["batch"], "rows": profiled * pool}
        return (Window({}, profiled + rest, 0),
                Traced(summary, self.ctx.config, units,
                       {"img_per_s": rest * pool / elapsed}))

    def release(self) -> None:
        last = getattr(self, "last", None)
        self.outputs = None if last is None else tuple(x.detach().clone() for x in last)
        self.kept = [(r, v.detach().clone()) for r, v in self.kept]
        self.model = self.api = self.encode = self.last = None

    def redraw(self) -> dict[str, torch.Tensor]:
        """The weights the program was given, drawn again."""
        return {**weights.draw(self.layout, self.ctx.seed, self.ctx.device), **self.stats}

    def check(self) -> dict[str, float]:
        ctx = self.ctx
        W = reference.served_weights(self.redraw(),
                                     ctx.config)
        want_g, want_r = reference.embed(self.images, self.patches, W, ctx.config)
        if ctx.control == "reference_lower":
            got_g, got_r = reference.embed(self.images, self.patches, W, ctx.config, LOWER)
            self.kept = [(self.sample, got_r[self.sample])]
        else:
            got_g, got_r = self.outputs
        refined_err = relative_errors(got_r, want_r).max()
        for rows, values in self.kept:
            refined_err = torch.maximum(refined_err, relative_errors(values, want_r[rows]).max())
        return {"global_rel_err": float(relative_errors(got_g, want_g).max()),
                "refined_rel_err": float(refined_err)}
