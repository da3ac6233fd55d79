"""Training the ERN fusion stack: whole steps of the program's `Trainer`
(`train/trainer.py`: its loader, prefetch thread, tokenizer and step).

Traffic parameters: `triplets` (reference image, target image, caption)
over an image `pool` (uint8 images and their patch features drawn from
the seed on the device, held in host memory; every triplet a distinct
pair of images, captions from `captions.py` with `caption_tokens`
tokens), `batch` rows a step, the Trainer's `num_workers` loader threads
and `prefetch` depth, `schedule_epochs` (the cosine schedule's length in
epochs), `checked_steps` run at set-up and checked, `profile_steps` of a
`--trace 1` run profiled after its first `profile_after` steps (the
window's first step waits for the epoch loop's loader to start again).

Set-up builds one Trainer over the configuration's model (the towers
cast to bf16 and frozen, TME and the fusion stack trained in fp32 by
Adam) and drives it from the seed through its first `checked_steps`
steps, through the Trainer's own epoch loop and feed; that same Trainer
then runs the window, continuing the epoch. Each step of the check's
steps records its loss and rows; the first, the gradients Adam got
(its first moment after one step, / (1 − β1)); the last, the trained
parameters. `train_samples_per_s` is the rows of the window's whole
steps over the time from the window's start to the end of its last step
(synchronized).

The check: the reference (`reference.train_steps`) follows the same
steps on the same rows from the same weights and dropout seeds; compared
are each step's loss (`loss_rel_err`), the first gradients' norms
(`grad_gap`) and the parameters' change over the steps (`change_gap`),
each by the worst leaf: the gap between the program's norm and the
reference's, over the reference's norm of that leaf or of the median
leaf, whichever is larger. Leaves whose reference gradient is under a
thousandth of the median leaf's are left out (Adam moves them by
round-off alone).
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch
from torch.profiler import record_function

from cirbench import captions, program, reference, weights
from cirbench.harness import Context, Traced, Window, synchronize
from cirbench.inputs import make_pool
from cirbench.reference.bpe import BPE
from cirbench.reference.ops import LOWER
from cirbench.reference.train import BETAS, cosine_lr
from cirbench.trace import SLICE, Marks, profiler, summarize

EXCLUDE_BELOW = 1e-3


class Triplets:
    """FashionIQ-shaped items: the Trainer's dataset."""

    def __init__(self, images: np.ndarray, patches: np.ndarray, ref: np.ndarray,
                 tar: np.ndarray, caps: list[str]):
        self.images, self.patches, self.ref, self.tar, self.caps = images, patches, ref, tar, caps

    def __len__(self) -> int:
        return len(self.caps)

    def __getitem__(self, i: int) -> dict:
        r, t = int(self.ref[i]), int(self.tar[i])
        return {"ref_image": self.images[r], "tar_image": self.images[t],
                "ref_patch": self.patches[r], "tar_patch": self.patches[t],
                "caption": self.caps[i], "ref_name": f"img{r}", "tar_name": f"img{t}"}


class Driver:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.t = ctx.traffic
        self.steps = 0                       # steps the Trainer took
        self.position = (0, 0)               # (epoch, step within it) of the next step
        self.deadline = float("inf")
        self.t_end = 0.0
        self.record: list[dict] = []
        self.prof = self.slice = None

    def setup(self) -> None:
        from fashionern_aaai2024_tpu_torch.tokenizer import SimpleTokenizer
        from fashionern_aaai2024_tpu_torch.train.trainer import (
            DatasetPlugin,
            TrainConfig,
            Trainer,
        )

        ctx, t = self.ctx, self.t
        cfg_train = ctx.config["train"]
        merges = captions.merges()
        self.bpe = BPE(merges)
        model, drawn = program.build(ctx.config, ctx.seed, ctx.device, serve=False)
        self.layout, self.stats = weights.layout_of(drawn), weights.statistics(drawn)
        del drawn
        images, patches = make_pool(ctx.config, t["pool"], ctx.seed, ctx.device)
        self.images, self.patches = images, patches
        rng = np.random.default_rng([ctx.seed, 0x7A1])
        pairs = rng.choice(t["pool"] * t["pool"], size=t["triplets"], replace=False)
        self.ref, self.tar = pairs // t["pool"], pairs % t["pool"]
        self.caps = captions.captions(t["triplets"], ctx.seed, tuple(t["caption_tokens"]),
                                      self.bpe)
        dataset = Triplets(images.numpy(), patches.numpy(), self.ref, self.tar, self.caps)
        self.row_of = {(float(patches[r, 0, 0]), float(patches[s, 0, 0])): i
                       for i, (r, s) in enumerate(zip(self.ref, self.tar))}
        cfg = TrainConfig(dataset="cirbench", clip_model_name=ctx.config["name"],
                          batch_size=t["batch"], lr=cfg_train["lr"], num_epochs=1 << 30,
                          validation_frequency=1 << 30, print_frequency=1 << 30,
                          seed=ctx.seed, num_workers=t["num_workers"],
                          schedule_epochs=t["schedule_epochs"],
                          activation=ctx.config["activation"], precision=cfg_train["towers"],
                          image_dtype="uint8", tme=ctx.config["tme"],
                          prefetch_batches=t["prefetch"], ckpt_dir="build/cirbench_ckpt")
        plugin = DatasetPlugin(name="cirbench", make_train_dataset=lambda c: dataset,
                               caption_fn=lambda batch, rng: list(batch["caption"]))
        self.trainer = Trainer(cfg, device=ctx.device, model=model, train_dataset=dataset,
                               plugin=plugin, tokenizer=SimpleTokenizer(merges=merges))
        self.per_epoch = self.trainer.steps_per_epoch
        self.inner = self.trainer.step_fn
        self.trainer.step_fn = self._step
        self.trained = [(n, p) for n, p in model.named_parameters() if n.startswith("ern.")]
        self.marks = Marks(ctx.device)
        for name in ("encode_image", "encode_text"):        # the frozen towers' calls
            setattr(model.clip, name, self._marked(getattr(model.clip, name)))
        self._run(steps=t["checked_steps"])

    def _marked(self, call):
        def marked(*args, **kwargs):
            with self.marks.layer("towers"):
                return call(*args, **kwargs)
        return marked

    # -- the Trainer's step, instrumented

    def _step(self, state, batch):
        n = self.steps
        if n < self.t["checked_steps"]:
            self._before(n, batch)
        state, loss = self.inner(state, batch)
        self.steps += 1
        epoch, i = self.position
        self.position = (epoch, i + 1) if i + 1 < self.per_epoch else (epoch + 1, 0)
        if n < self.t["checked_steps"]:
            self._after(n, state, loss)
        if self.prof is not None and self.steps == self.profile_from:
            self._open_slice()          # before the Trainer fetches the next step's batch
        elif self.prof is not None and self.steps == self.profile_until:
            synchronize(self.ctx.device)
            self.marks.on = False
            self.slice.__exit__(None, None, None)
            self.prof.stop()
            self.rest_t0, self.rest_steps = time.perf_counter(), self.steps
            self.slice = None
        if self.steps >= self.stop_at or time.perf_counter() >= self.deadline:
            synchronize(self.ctx.device)
            self.t_end = time.perf_counter()
            self.trainer.steps_per_epoch = 0          # the epoch loop ends here
        return state, loss

    def _before(self, n: int, batch: dict) -> None:
        if n == 0:
            self.start = {k: p.detach().clone() for k, p in self.trained}
        keys = zip(batch["ref_patch"][:, 0, 0].tolist(), batch["tar_patch"][:, 0, 0].tolist())
        self.record.append({"rows": [self.row_of[k] for k in keys]})

    def _after(self, n: int, state, loss) -> None:
        self.record[n]["loss"] = loss.detach().clone()
        if n == 0:
            opt = state.optimizer
            self.grads = {k: opt.state[p]["exp_avg"].detach() / (1 - BETAS[0])
                          for k, p in self.trained if p in opt.state}
            self.grads = {k: g.clone() for k, g in self.grads.items()}
        if n == self.t["checked_steps"] - 1:
            self.params = {k: p.detach().clone() for k, p in self.trained}

    def _run(self, steps: int = 1 << 62, seconds: float = float("inf")) -> None:
        """Whole steps of the Trainer's epoch loop, from where it stopped,
        until `steps` more or `seconds` have passed."""
        self.stop_at = self.steps + steps
        self.deadline = time.perf_counter() + seconds
        while self.steps < self.stop_at and time.perf_counter() < self.deadline:
            epoch, skip = self.position
            self.trainer.steps_per_epoch = self.per_epoch
            self.trainer.train_one_epoch(epoch, skip_steps=skip)
        self.trainer.steps_per_epoch = self.per_epoch

    def window(self, seconds: float) -> Window:
        first, t0 = self.steps, time.perf_counter()
        self._run(seconds=seconds)
        steps = self.steps - first
        return Window({"train_samples_per_s": steps * self.t["batch"] / (self.t_end - t0)},
                      steps, 0)

    def traced_window(self, seconds: float) -> tuple[Window, Traced]:
        first = self.steps
        self.profile_from = self.steps + self.t["profile_after"]
        self.profile_until = self.profile_from + self.t["profile_steps"]
        self.prof = profiler(self.ctx.device)
        if self.t["profile_after"] == 0:
            self._open_slice()
        self._run(seconds=seconds)
        summary = summarize(self.prof, self.marks)
        self.prof = None
        rest = self.steps - self.rest_steps
        units = {"steps": self.t["profile_steps"], "batch": self.t["batch"]}
        rate = rest * self.t["batch"] / (self.t_end - self.rest_t0) if rest else 0.0
        return (Window({}, self.steps - first, 0),
                Traced(summary, self.ctx.config, units, {"samples_per_s": rate}))

    def _open_slice(self) -> None:
        synchronize(self.ctx.device)    # the slice holds no earlier step's work
        self.marks.on = True
        self.prof.start()
        self.slice = record_function(SLICE)
        self.slice.__enter__()

    def release(self) -> None:
        self.trainer = self.inner = self.trained = None

    # -- the check

    def batches(self) -> list[dict]:
        ctx_len = self.ctx.config["text"]["context_length"]
        out = []
        for rec in self.record:
            rows = np.asarray(rec["rows"])
            r, t = self.ref[rows], self.tar[rows]
            out.append({"ref_images": self.images[r], "tar_images": self.images[t],
                        "ref_patch": self.patches[r], "tar_patch": self.patches[t],
                        "ids": torch.as_tensor(self.bpe.rows([self.caps[i] for i in rows],
                                                             ctx_len))})
        return out

    def check(self) -> dict[str, float]:
        ctx = self.ctx
        W = {**weights.draw(self.layout, ctx.seed, ctx.device), **self.stats}
        t_max = self.t["schedule_epochs"] * self.per_epoch
        lr = ctx.config["train"]["lr"]

        def run(precision):
            return reference.train_steps(self.batches(), W, ctx.config, ctx.seed,
                                         lambda s: cosine_lr(lr, t_max, s), precision)
        want = run(reference.ops.EXACT)
        if ctx.control == "reference_lower":
            got = run(LOWER)
            losses, grads, start, params = (got["losses"], got["grads"], got["start"],
                                            got["params"])
        else:
            losses = [float(r["loss"]) for r in self.record]
            grads, start, params = self.grads, self.start, self.params
        return compare(losses, grads, start, params, want)


def _worst_leaf(got: dict, want: dict, keys: list[str]) -> float:
    norms = {k: float(torch.linalg.vector_norm(want[k].float())) for k in keys}
    median = float(np.median(list(norms.values())))
    return max(abs(float(torch.linalg.vector_norm(got[k].float())) - norms[k])
               / max(norms[k], median) for k in keys)


def compare(losses: list[float], grads: dict, start: dict, params: dict, want: dict
            ) -> dict[str, float]:
    ref_grad = {k: float(torch.linalg.vector_norm(g)) for k, g in want["grads"].items()}
    median = float(np.median(list(ref_grad.values())))
    keys = sorted(k for k, v in ref_grad.items() if v >= EXCLUDE_BELOW * median)
    missing = [k for k in keys if k not in grads]
    zero = {k: torch.zeros_like(want["grads"][k]) for k in missing}
    change = {k: params[k].float() - start[k].float() for k in keys}
    want_change = {k: want["params"][k] - want["start"][k] for k in keys}
    return {"loss_rel_err": max(abs(a - b) / abs(b) for a, b in
                                itertools.zip_longest(losses, want["losses"], fillvalue=0.0)),
            "grad_gap": _worst_leaf({**grads, **zero}, want["grads"], keys),
            "change_gap": _worst_leaf(change, want_change, keys)}
