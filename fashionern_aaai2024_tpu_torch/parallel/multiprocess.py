"""The multi-process portability drive: the process boundary, executed.

JAX counterpart: `fashionern_aaai2024_tpu/parallel/multiprocess.py`. The
reference scales by launching processes that rendezvous over TCP and
all-reduce through NCCL (`run/train/train_fiq.py:210-227`); the port does
the same with `torch.distributed` (`parallel/mesh.py`). This drive runs
the real data-parallel train step (`train/step.py build_train_step`:
frozen towers, fusion, per-shard "local" negatives, one
all-reduce, Adam) on the tiny demo config, and holds two layouts of the
same 2-shard mesh to one another:

  A  (1 rank standing for 2 shards, `one_process_step`): steps 0 and 1
      from a fresh state, the state saved at step 1 -> ck_1x2, losses
      [a0, a1];
  CB (a 2-rank gang, 1 shard a rank): C a fresh step 0 and a save ->
      ck_2x1, loss c0; B a restore of ck_1x2 and step 1 -> b1;
  D  (1 rank, 2 shards): a restore of ck_2x1 and step 1 -> d1.

Each leg is a gloo gang of spawned processes (`parallel/mesh.py
spawn_cpu_gang`, one thread a process, so that both layouts take the
same CPU code paths).

It asserts c0 == a0, b1 == a1 and d1 == a1 to 1e-5: the gang computes
what one process computes, and the saved train state crosses both ways
between the layouts. (Adam's first update is about lr x sign(g), so a
gradient element near Adam's eps whose rounding differs between the
layouts moves a weight by a sizeable part of lr: each shard runs the
same operations at the same shapes in both layouts, its loss one B4
call (`train/step.py grouped_bbc_loss` in the one-process layout), and
the one-process layout scales each shard's loss by 1/2, which is exact,
so the gradients agree bit for bit.) Both layouts are the same two
shards: each shard has its own BatchNorm statistics and dropout stream
(seeded by the shard's index, not the process's) and its own negatives. Every step's
batch is seeded by the absolute step number (`demo_batch`), and each
rank takes its contiguous rows, so every layout sees the same rows in
the same shards.

The one-process layout is JAX's (one process over several devices); the
port runs one device a process and does not deploy it. `one_process_step`
emulates it here, outside the train step, for this drive and for the
smoke's gang check on the card.

`launch_cpu_simulation` is the minimal form: an n-rank gang against one
process with n shards, one step each. Run it all from the command line:
`python -m fashionern_aaai2024_tpu_torch.parallel.multiprocess`
(`--simulation` for the minimal form). Everything runs on the CPU, over
gloo; `chip_smoke.py` runs a 2-rank gang on the card.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Callable

import numpy as np
import torch

from fashionern_aaai2024_tpu_torch.parallel.mesh import (
    ProcessMesh,
    shard_batch,
    spawn_cpu_gang,
)

DEMO_LR = 1e-4
DEMO_SHARDS = 2
TOLERANCE = 1e-5


def demo_config():
    """The tiny demo CLIP config (JAX `demo_config`)."""
    from fashionern_aaai2024_tpu_torch.models.clip.config import (
        CLIPConfig,
        TextConfig,
        VisionConfig,
    )

    return CLIPConfig(
        name="vit-dryrun",
        vision=VisionConfig(kind="vit", image_size=32, embed_dim=24, width=64, layers=2,
                            heads=4, patch_size=16),
        text=TextConfig(vocab_size=100, context_length=16, width=32, heads=4, layers=2,
                        embed_dim=24),
    )


def demo_batch(step_no: int, n_global_devices: int, cfg=None) -> dict:
    """The global demo batch of absolute step `step_no` (JAX `demo_batch`,
    the same draws): two rows a shard, a function of the step number
    only, so every layout consumes the same batch stream."""
    cfg = cfg or demo_config()
    v = cfg.vision
    b = 2 * n_global_devices
    g = np.random.default_rng(step_no)
    return {
        "ref_image": g.random((b, v.image_size, v.image_size, 3), dtype=np.float32),
        "tar_image": g.random((b, v.image_size, v.image_size, 3), dtype=np.float32),
        "text_ids": g.integers(0, 100, (b, cfg.text.context_length)).astype(np.int32),
        "ref_patch": g.standard_normal((b, 13, cfg.feature_dim), dtype=np.float32),
        "tar_patch": g.standard_normal((b, 13, cfg.feature_dim), dtype=np.float32),
    }


def one_process_step(model, schedule: Callable[[int], float], shards: int, *,
                     negatives: str = "local", forward=None) -> Callable:
    """The train step of one process standing for `shards` ranks of one
    shard each (`train/step.py build_train_step` without a mesh, the
    rows of its batch split into `shards` contiguous shards): each shard
    runs `forward` (default the model's train forward) from the same
    BatchNorm running statistics, with its dropout generator folded on
    the shard's index as on a rank of its own; the statistics end as the
    shards' mean, as a gang's all-reduce leaves them. The loss takes
    per-shard negatives (`local_groups=shards`) or every shard's
    targets ("global"), the gradients those of the mean loss, as the
    gang's all-reduce (mean) gives them."""
    from fashionern_aaai2024_tpu_torch.models.ern.layers import TorchBatchNorm
    from fashionern_aaai2024_tpu_torch.train.step import (
        _image_forward,
        build_train_step,
        step_generator,
    )

    inner = forward or _image_forward
    norms = [m for m in model.ern.modules() if isinstance(m, TorchBatchNorm)]
    clock: dict = {}

    def sharded_forward(model, batch: dict, generator) -> tuple[torch.Tensor, torch.Tensor]:
        before = [(m.running_mean.clone(), m.running_var.clone(),
                   m.num_batches_tracked.clone()) for m in norms]
        outs, stats = [], []
        for s in range(shards):
            for m, (mean, var, count) in zip(norms, before):
                m.running_mean.copy_(mean)
                m.running_var.copy_(var)
                m.num_batches_tracked.copy_(count)
            rows = {k: v[s * (len(v) // shards):(s + 1) * (len(v) // shards)]
                    for k, v in batch.items()}
            outs.append(inner(model, rows, step_generator(clock["seed"], clock["step"],
                                                          clock["device"], s)))
            stats.append([(m.running_mean.clone(), m.running_var.clone()) for m in norms])
        with torch.no_grad():
            for i, m in enumerate(norms):
                m.running_mean.copy_(torch.stack([st[i][0] for st in stats]).mean(0))
                m.running_var.copy_(torch.stack([st[i][1] for st in stats]).mean(0))
        return torch.cat([f for f, _ in outs]), torch.cat([t for _, t in outs])

    step = build_train_step(model, schedule, negatives=negatives, local_groups=shards,
                            forward=sharded_forward)

    def run(state, batch: dict):
        clock.update(seed=state.seed, step=state.step, device=state.device)
        return step(state, batch)

    return run


class DemoProgram:
    """The demo train program of one rank: model (the JAX demo's seeded
    init), train state and step, on a mesh of one shard a rank, or (on a
    one-rank mesh) one process standing for `shards` shards
    (`one_process_step`)."""

    def __init__(self, mesh: ProcessMesh, shards: int = 1):
        from fashionern_aaai2024_tpu_torch.models.composed import seeded_model
        from fashionern_aaai2024_tpu_torch.train.step import build_train_step

        self.mesh = mesh
        self.n = mesh.size * shards
        self.cfg = demo_config()
        # the JAX demo's init, `PRNGKey(0)` (JAX `multiprocess.py:146`)
        self.model = seeded_model(self.cfg, 0, mesh.device, patch_num=13)
        self._init = {k: v.clone() for k, v in self.model.state_dict().items()}
        if shards > 1:
            self.step = one_process_step(self.model, lambda step: DEMO_LR, shards)
        else:
            self.step = build_train_step(self.model, lambda step: DEMO_LR, negatives="local",
                                         local_groups=self.n, mesh=mesh)

    def fresh_state(self):
        """A fresh train state on the seeded initial weights."""
        from fashionern_aaai2024_tpu_torch.train.state import create_train_state

        self.model.load_state_dict(self._init)
        return create_train_state(self.model, seed=1)

    def batch_for(self, state) -> dict:
        return shard_batch(self.mesh, demo_batch(state.step, self.n, self.cfg))

    def run(self, state, steps: int, save_path: str | None = None,
            save_at_step: int | None = None) -> tuple[object, list[float]]:
        from fashionern_aaai2024_tpu_torch.train.checkpoint import save_state

        losses = []
        for _ in range(steps):
            state, loss = self.step(state, self.batch_for(state))
            losses.append(loss.item())
            if save_path and state.step == save_at_step:
                save_state(save_path, state, mesh=self.mesh)
        return state, losses


def worker_main(mesh: ProcessMesh, *, shards: int = 1, steps: int = 1,
                save_path: str | None = None, restore_path: str | None = None,
                save_at_step: int | None = None) -> dict:
    """One rank's (or one process's) demo run: a fresh state or a restored
    one, `steps` steps, a save when the state reaches `save_at_step`
    (after the last step by default). -> {"losses", "final_step"}."""
    from fashionern_aaai2024_tpu_torch.train.checkpoint import restore_state

    prog = DemoProgram(mesh, shards)
    state = prog.fresh_state()
    if restore_path:
        state = restore_state(restore_path, state)
    at = save_at_step if save_at_step is not None else state.step + steps
    state, losses = prog.run(state, steps, save_path, at)
    return {"losses": losses, "final_step": state.step}


def portability_pair(mesh: ProcessMesh, save_path: str, restore_path: str) -> dict:
    """Legs C and B on one gang rank: a fresh step 0 and a save
    (`save_path`), then a restore of `restore_path` and one step.
    -> {"c0", "b1"}."""
    from fashionern_aaai2024_tpu_torch.train.checkpoint import restore_state

    prog = DemoProgram(mesh)
    state, (c0,) = prog.run(prog.fresh_state(), 1, save_path, 1)
    restored = restore_state(restore_path, prog.fresh_state())
    _, (b1,) = prog.run(restored, 1)
    return {"c0": c0, "b1": b1}


def _worker_leg(mesh: ProcessMesh, kwargs: dict) -> dict:
    return worker_main(mesh, **kwargs)


def _one_rank_leg(timeout: float, store_dir: str | None, **kwargs) -> dict:
    """`worker_main(**kwargs)` on a spawned 1-rank gang."""
    return spawn_cpu_gang(1, _worker_leg, kwargs, timeout=timeout, store_dir=store_dir)[0]


def spawn_portability_gang(save_path: str, restore_path: str, *, timeout: float = 600.0,
                           store_dir: str | None = None) -> list[dict]:
    """Legs C and B on a 2-rank gloo gang on the CPU; -> each rank's
    {"c0", "b1"}."""
    return spawn_cpu_gang(2, portability_pair, save_path, restore_path, timeout=timeout,
                          store_dir=store_dir)


def launch_portability_drive(workdir: str | None = None, *, timeout: float = 600.0,
                             leg_d: bool = True) -> dict:
    """Legs A, CB and (with `leg_d`) D (module docstring); raises when a
    check misses. -> {"control_losses", "gang", "deltas"}."""
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="portability-") if own else workdir
    os.makedirs(workdir, exist_ok=True)
    try:
        ck_1x2 = os.path.join(workdir, "ck_1x2")
        ck_2x1 = os.path.join(workdir, "ck_2x1")
        a = _one_rank_leg(timeout, workdir, shards=DEMO_SHARDS, steps=2,
                          save_path=ck_1x2, save_at_step=1)
        gang = spawn_portability_gang(ck_2x1, ck_1x2, timeout=timeout, store_dir=workdir)
        if gang[0] != gang[1]:
            raise AssertionError(f"the gang's ranks disagree: {gang}")
        deltas = {"gang_step0_matches_control": abs(gang[0]["c0"] - a["losses"][0]),
                  "restore_1x2_to_2x1": abs(gang[0]["b1"] - a["losses"][1])}
        if leg_d:
            d = _one_rank_leg(timeout, workdir, shards=DEMO_SHARDS, steps=1,
                              restore_path=ck_2x1)
            deltas["restore_2x1_to_1x2"] = abs(d["losses"][0] - a["losses"][1])
        for name, delta in deltas.items():
            if delta > TOLERANCE:
                raise AssertionError(f"{name}: |delta loss| = {delta}")
        return {"control_losses": a["losses"], "gang": gang[0], "deltas": deltas}
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)


def launch_cpu_simulation(num_processes: int = 2, *, timeout: float = 600.0) -> dict:
    """One step of an n-rank gloo gang against one process with n shards;
    raises on a loss mismatch. -> both losses."""
    gang = spawn_cpu_gang(num_processes, worker_main, timeout=timeout)
    single = _one_rank_leg(timeout, None, shards=num_processes)
    mp_loss, sp_loss = gang[0]["losses"][0], single["losses"][0]
    if abs(mp_loss - sp_loss) > TOLERANCE:
        raise AssertionError(f"loss mismatch: multiprocess {mp_loss} vs single-process "
                             f"{sp_loss}")
    return {"multiprocess_loss": mp_loss, "single_process_loss": sp_loss,
            "num_processes": num_processes}


def _cli() -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--simulation", action="store_true",
                   help="the minimal n-rank gang against one process")
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--no-leg-d", action="store_true")
    args = p.parse_args()
    if args.simulation:
        print(json.dumps(launch_cpu_simulation(args.num_processes)))
    else:
        print(json.dumps(launch_portability_drive(leg_d=not args.no_leg_d)))


if __name__ == "__main__":
    _cli()
