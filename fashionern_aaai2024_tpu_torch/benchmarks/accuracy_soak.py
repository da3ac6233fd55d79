"""Accuracy soak: make-fixture -> untrained eval -> train -> trained eval,
through the port's CLI, one consistent chain on the card.

JAX counterpart: `benchmarks/accuracy_soak.py` (`:141-300`), whose legs
`BASELINE.md` records (r5 soak ledger). Per leg, every step a subprocess
of `python -m fashionern_aaai2024_tpu_torch.cli.main`:

  1. `make-fixture` (`--n-images 64 --n-triplets 128`, large enough that
     Recall@10 over the gallery is a sharp metric);
  2. `eval --seed 7 --json` with the untrained fusion stack: the baseline
     (seed 7 gives the towers the train leg gets, so the trained-minus-
     untrained delta is the fusion stack's alone);
  3. `train` on ViT-B-16 at B = 16 for 15 epochs, validation every epoch,
     the best checkpoint selected on the dataset's metric (with its
     `.meta.json` sidecar, whose init seed step 4 reads);
  4. `eval --fusion-model-path <best> --json`.

Checks: the trained eval's metric equals the sidecar's best validation
metric exactly (a recall moves in steps of 100 / N, so this is the chain's
consistency, not a tolerance), and it beats the untrained one by more than
`--min-gain` points.

Legs (the JAX ledger's): A the control FashionIQ fixture (no caption-image
signal: its curve is a noise floor), B learnable FashionIQ, C learnable
CIRR, D learnable Fashion200k (`--validate-200k`, multi-positive
protocol), E learnable FashionIQ with `--tme`.

Not here: the JAX soak's steps 5-6 (export the serve artifact, replay
every query through the live service and the artifact) wait for ROADMAP
A7 (artifacts); this script does not stand in for them.

Run (on the card, from the repo root):
    python -m fashionern_aaai2024_tpu_torch.benchmarks.accuracy_soak --legs B,C \\
        --out soak.json
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Callable

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CLI_MODULE = "fashionern_aaai2024_tpu_torch.cli.main"

# leg -> (dataset, learnable fixture, TME)
LEGS = {"A": ("fashioniq", False, False), "B": ("fashioniq", True, False),
        "C": ("cirr", True, False), "D": ("fashion200k", True, False),
        "E": ("fashioniq", True, True)}
# the metric each dataset's Trainer selects its best checkpoint on
METRIC_KEY = {"fashioniq": "avg", "cirr": "headline", "shoes": "avg", "fashion200k": "avg"}


def cli_command(args: list[str]) -> list[str]:
    return [sys.executable, "-m", CLI_MODULE, *args]


def run_cli(args: list[str], tag: str, *, command: Callable = cli_command,
            timeout: float = 3600) -> tuple[str, float]:
    """Run one CLI step; (stdout, seconds). A failed step raises with its
    output's tail."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    done = subprocess.run(command(args), env=env, capture_output=True, text=True,
                          timeout=timeout)
    seconds = time.perf_counter() - t0
    if done.returncode != 0:
        raise RuntimeError(f"{tag} failed (rc {done.returncode}): "
                           f"{' '.join(args)}\n{done.stdout[-3000:]}\n{done.stderr[-3000:]}")
    return done.stdout, seconds


def last_json(stdout: str, tag: str) -> dict:
    for line in reversed(stdout.splitlines()):
        if line.strip().startswith("{"):
            return json.loads(line)
    raise RuntimeError(f"{tag}: no JSON line in the output")


def run_leg(leg: str, work: str, *, model: str = "ViT-B-16", n_images: int = 64,
            n_triplets: int = 128, batch: int = 16, epochs: int = 15, device: str = "cuda",
            min_gain: float = 0.0, command: Callable = cli_command) -> dict:
    """One leg in `work` (a fresh directory); returns its summary and
    raises if a check fails."""
    dataset, learnable, tme = LEGS[leg]
    root = os.path.join(work, "fixture")
    ckpt = os.path.join(work, "ckpt")
    log_path = os.path.join(work, "train.jsonl")
    mkey = METRIC_KEY[dataset]
    common = ["--dataset", dataset, "--data-root", root, "--clip-model-name", model,
              "--bpe-path", os.path.join(root, "bpe.txt.gz"), "--num-workers", "0",
              "--device", device] + (["--tme"] if tme else [])
    seconds = {}
    if dataset == "fashion200k":
        sizing = ["--n-per-color", str(max(2, n_images // 8)), "--n-queries", str(n_triplets)]
    else:
        sizing = ["--n-images", str(n_images), "--n-triplets", str(n_triplets)]
    _, seconds["fixture"] = run_cli(
        ["make-fixture", "--dataset", dataset, "--out", root, *sizing]
        + (["--learnable"] if learnable else []), f"leg {leg} fixture", command=command)
    out, seconds["untrained_eval"] = run_cli(
        ["eval", *common, "--batch-size", "32", "--split", "val", "--seed", "7", "--json"],
        f"leg {leg} untrained eval", command=command)
    untrained = last_json(out, "untrained eval")
    _, seconds["train"] = run_cli(
        ["train", *common, "--batch-size", str(batch), "--num-epochs", str(epochs),
         "--validation-frequency", "1", "--validation-bs", "32", "--image-dtype", "uint8",
         "--ckpt-dir", ckpt, "--print-frequency", "5", "--log-path", log_path, "--seed", "7"]
        + (["--validate-200k"] if dataset == "fashion200k" else []),
        f"leg {leg} train", command=command)
    with open(log_path) as f:
        records = [json.loads(line) for line in f]
    steps = max(r.get("step", 0) for r in records)
    curve = [(r["step"], r["val_metric"]) for r in records if "val_metric" in r]
    best_path = os.path.join(ckpt, f"{dataset}-best")
    with open(best_path + ".meta.json") as f:
        sidecar = json.load(f)
    out, seconds["trained_eval"] = run_cli(
        ["eval", *common, "--batch-size", "32", "--split", "val", "--fusion-model-path",
         best_path, "--json"], f"leg {leg} trained eval", command=command)
    trained = last_json(out, "trained eval")
    summary = {
        "leg": leg, "dataset": dataset, "learnable": learnable, "tme": tme, "model": model,
        "fixture": {"n_images": n_images, "n_triplets": n_triplets},
        "train": {"steps": steps, "epochs": epochs, "batch": batch, "val_curve": curve,
                  "first_metric": curve[0][1], "best_metric": sidecar["metric"]},
        "untrained_eval": untrained, "trained_eval": trained, "metric_key": mkey,
        "seconds": seconds}
    if trained[mkey] != sidecar["metric"] or sidecar["metric"] != max(m for _, m in curve):
        raise AssertionError(f"leg {leg}: the trained eval's {mkey} {trained[mkey]} is not "
                             f"the best validation metric {sidecar['metric']} "
                             f"(curve {curve})")
    if not trained[mkey] > untrained[mkey] + min_gain:
        raise AssertionError(f"leg {leg}: trained {mkey} {trained[mkey]} does not beat the "
                             f"untrained {untrained[mkey]} by more than {min_gain} points")
    return summary


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--legs", default="B,C", help="comma-separated legs among A-E")
    p.add_argument("--work", default=os.path.join(REPO, "build", "accuracy_soak"))
    p.add_argument("--model", default="ViT-B-16")
    p.add_argument("--n-images", type=int, default=64)
    p.add_argument("--n-triplets", type=int, default=128)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--device", default="cuda")
    p.add_argument("--min-gain", type=float, default=0.0,
                   help="points the trained metric must beat the untrained one by "
                        "(leg A, the control, passes only with the default 0 if at all)")
    p.add_argument("--out", default=None, help="write the legs' summaries here (JSON)")
    args = p.parse_args()
    results = []
    for leg in args.legs.split(","):
        work = os.path.join(args.work, f"leg_{leg}")
        if os.path.exists(work):
            raise SystemExit(f"{work} exists; pass a fresh --work")
        res = run_leg(leg, work, model=args.model, n_images=args.n_images,
                      n_triplets=args.n_triplets, batch=args.batch, epochs=args.epochs,
                      device=args.device, min_gain=args.min_gain)
        k = res["metric_key"]
        print(f"[soak] leg {leg} ({res['dataset']}): untrained {k} "
              f"{res['untrained_eval'][k]:.2f}, val {res['train']['first_metric']:.2f} -> "
              f"{res['train']['best_metric']:.2f}, trained {k} {res['trained_eval'][k]:.2f}, "
              f"{res['train']['steps']} steps, seconds {res['seconds']}", flush=True)
        results.append(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({"legs": [{"leg": r["leg"], "untrained": r["untrained_eval"][r["metric_key"]],
                                "best": r["train"]["best_metric"],
                                "trained": r["trained_eval"][r["metric_key"]]}
                               for r in results]}))


if __name__ == "__main__":
    main()
