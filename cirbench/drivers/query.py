"""Shoppers' composed queries against a resident gallery: a closed loop
of `RetrievalService.query` calls.

Traffic parameters: a `gallery` of that many items (uint8 images and
patch features drawn from the seed on the device), embedded by the
service at set-up in loader batches of `gallery_batch`; one client in
a closed loop (each request sent when the last answer is on the host)
of `batch` queries a call, each `RetrievalService.query(refs, captions,
k)`;
references drawn uniformly from the gallery, captions FashionIQ-shaped
(`captions.py`) with `caption_tokens` [lo, hi] BPE tokens; `requests`
drawn ahead, cycled; `warmup_calls` before the window; `check_requests`
sampled for the check, the longest caption among them;
`profile_calls` of a `--trace 1` run profiled.

Latency is the host clock around each call: tokenize, the serve
program's call (one CUDA graph replay on the card), the top-k on the
host. `query_ms_p50` / `query_ms_p99` are the median and 99th percentile
of every call of the window.

The check: for each sampled request, the reference (its own tokenizer,
text tower, TME, DVR over the reference's own gallery, exact top-k)
scores every gallery row; `score_err` is the largest gap between a
returned score and the reference's score of the returned row, and
`rank_gap` the largest by which a returned row's reference score lies
below the reference's score at the same rank (the top-k read as a
ranking: a missed better row shows here).
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch
from torch.profiler import record_function

from cirbench import captions, program, reference, weights
from cirbench.harness import Context, Traced, Window
from cirbench.inputs import make_pool
from cirbench.reference.bpe import BPE
from cirbench.reference.ops import EXACT, LOWER
from cirbench.trace import SLICE, profiler, summarize


class Driver:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.t = ctx.traffic
        self.answers: list[tuple[int, list | None]] = []   # (request, top-k dicts)

    def setup(self) -> None:
        from fashionern_aaai2024_tpu_torch.retrieval.evaluate import InferenceAPI
        from fashionern_aaai2024_tpu_torch.retrieval.server import RetrievalService
        from fashionern_aaai2024_tpu_torch.tokenizer import SimpleTokenizer

        ctx, t = self.ctx, self.t
        merges = captions.merges()
        self.bpe = BPE(merges)
        self.model, drawn = program.build(ctx.config, ctx.seed, ctx.device)
        self.layout, self.stats = weights.layout_of(drawn), weights.statistics(drawn)
        del drawn
        n, b = t["gallery"], t["gallery_batch"]
        self.images, self.patches = make_pool(ctx.config, n, ctx.seed, ctx.device)
        self.names = [f"item{i}" for i in range(n)]
        rng = np.random.default_rng([ctx.seed, 0x9E7])
        self.refs = rng.integers(0, n, size=t["requests"])
        self.captions = captions.captions(t["requests"], ctx.seed, tuple(t["caption_tokens"]),
                                          self.bpe)
        if ctx.control == "reference_lower":        # the reference answers in the check
            return
        api = InferenceAPI(self.model, tokenizer=SimpleTokenizer(merges=merges), device=ctx.device,
                           batch_size=b, context_length=ctx.config["text"]["context_length"])
        loader = [{"name": self.names[i:i + b], "image": self.images[i:i + b],
                   "patch": self.patches[i:i + b]} for i in range(0, n, b)]
        self.service = RetrievalService(api, loader)
        for i in range(t["warmup_calls"]):
            self._call(i, keep=False)

    def _call(self, i: int, keep: bool = True) -> float:
        """Request i (cycled) as one call; -> its latency in seconds."""
        j = i % len(self.refs)
        b = self.t["batch"]
        rows = [int(self.refs[(j + q) % len(self.refs)]) for q in range(b)]
        caps = [self.captions[(j + q) % len(self.refs)] for q in range(b)]
        t0 = time.perf_counter()
        try:
            with record_function("cirbench/query"):
                results, _ = self.service.query([self.names[r] for r in rows], caps,
                                                k=self.t["k"])
        except Exception:                 # a failed call: counted, never answered
            results = None
        latency = time.perf_counter() - t0
        if keep:
            self.answers.append((j, results))
        return latency

    def _loop(self, seconds: float, first: int) -> list[float]:
        latencies = []
        end = time.perf_counter() + seconds
        i = first
        while time.perf_counter() < end:
            latencies.append(self._call(i))
            i += 1
        return latencies

    def _failed(self) -> int:
        k = self.t["k"]
        return sum(1 for _, res in self.answers
                   if res is None or any(len(r) != k for r in res))

    def window(self, seconds: float) -> Window:
        if self.ctx.control == "reference_lower":
            return Window({}, 0, 0)
        lat = self._loop(seconds, 0)
        ms = [x * 1e3 for x in lat]
        return Window({"query_ms_p50": statistics.median(ms),
                       "query_ms_p99": statistics.quantiles(ms, n=100)[98]},
                      len(ms), self._failed())

    def traced_window(self, seconds: float) -> tuple[Window, Traced]:
        t0 = time.perf_counter()
        calls = self.t["profile_calls"]
        with profiler(self.ctx.device) as prof:
            with record_function(SLICE):
                for i in range(calls):
                    self._call(i)
        rest_t0 = time.perf_counter()
        rest = self._loop(max(0.0, seconds - (rest_t0 - t0)), calls)
        elapsed = time.perf_counter() - rest_t0
        summary = summarize(prof)
        units = {"calls": calls, "batch": self.t["batch"], "gallery": self.t["gallery"],
                 "k": self.t["k"]}
        return (Window({}, calls + len(rest), self._failed()),
                Traced(summary, self.ctx.config, units,
                       {"calls_per_s": len(rest) / elapsed if elapsed > 0 else 0.0}))

    def release(self) -> None:
        self.service = self.model = None

    def redraw(self) -> dict[str, torch.Tensor]:
        """The weights the program was given, drawn again."""
        return {**weights.draw(self.layout, self.ctx.seed, self.ctx.device), **self.stats}

    def check(self) -> dict[str, float]:
        ctx, t = self.ctx, self.t
        lower = ctx.control == "reference_lower"
        if lower:                       # the control answers every request drawn
            answered = [(j, None) for j in range(len(self.refs))]
        else:
            answered = [a for a in self.answers if a[1] is not None]
        if not answered:
            return {"score_err": float("inf"), "rank_gap": float("inf")}
        rng = np.random.default_rng([ctx.seed, 0xC4EC])
        pick = rng.choice(len(answered), size=min(t["check_requests"], len(answered)),
                          replace=False)
        longest = max(range(len(answered)),
                      key=lambda a: len(self.bpe.encode(self.captions[answered[a][0]])))
        chosen = [answered[a] for a in sorted(set(pick.tolist()) | {longest})]
        b = t["batch"]
        req = [((j + q) % len(self.refs), None if res is None else res[q])
               for j, res in chosen for q in range(b)]
        W = reference.served_weights(self.redraw(), ctx.config)
        rows = torch.as_tensor([int(self.refs[j]) for j, _ in req])
        ids = torch.as_tensor(self.bpe.rows([self.captions[j] for j, _ in req],
                                            ctx.config["text"]["context_length"]))

        def answer(precision):
            gal_g, gal_r = reference.embed(self.images, self.patches, W, ctx.config, precision)
            q = reference.query(ids, gal_g[rows.to(gal_g.device)], self.patches[rows], W,
                                ctx.config, precision)
            return reference.ern.top_k(q, gal_r, t["k"])
        scores, top, _ = answer(EXACT)
        if lower:
            _, got_scores, got_rows = answer(LOWER)
        else:
            got_rows = torch.as_tensor([[int(h["name"][4:]) for h in res] for _, res in req],
                                       device=scores.device)
            got_scores = torch.as_tensor([[h["score"] for h in res] for _, res in req],
                                         device=scores.device)
        ref_of_got = scores.gather(1, got_rows)
        return {"score_err": float((got_scores - ref_of_got).abs().max()),
                "rank_gap": float((top - ref_of_got).max())}
