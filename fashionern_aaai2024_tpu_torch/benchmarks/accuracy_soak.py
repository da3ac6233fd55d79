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
  4. `eval --fusion-model-path <best> --json`;
  5. `export --fusion-model-path <best>` (the serve artifact,
     `retrieval/artifact.py`, at the eval's fp32);
  6. in a process of its own (`artifact-vs-live`): the live service that
     `serve` builds from the same checkpoint and the loaded artifact
     answer every validation query (`iter_queries`); the top-10 names of
     each are compared and the mismatches counted, and the combined-
     gallery Recall@10 of each is recorded.

Checks: the trained eval's metric equals the sidecar's best validation
metric exactly (a recall moves in steps of 100 / N, so this is the chain's
consistency, not a tolerance), it beats the untrained one by more than
`--min-gain` points, and (steps 5-6, unless `artifact=False`) the
artifact and the live service give the same top-10 for every query and
so the same Recall@10.

Legs (the JAX ledger's): A the control FashionIQ fixture (no caption-image
signal: its curve is a noise floor), B learnable FashionIQ, C learnable
CIRR, D learnable Fashion200k (`--validate-200k`, multi-positive
protocol), E learnable FashionIQ with `--tme`.

Every leg starts from the JAX package's seeded init at seed 7 (both
CLIP towers and the ERN, `models/composed.py jax_init_`), the CLI's
default init, as the JAX soak's legs do.

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
SOAK_MODULE = "fashionern_aaai2024_tpu_torch.benchmarks.accuracy_soak"

# leg -> (dataset, learnable fixture, TME)
LEGS = {"A": ("fashioniq", False, False), "B": ("fashioniq", True, False),
        "C": ("cirr", True, False), "D": ("fashion200k", True, False),
        "E": ("fashioniq", True, True)}
# the metric each dataset's Trainer selects its best checkpoint on
METRIC_KEY = {"fashioniq": "avg", "cirr": "headline", "shoes": "avg", "fashion200k": "avg"}


def iter_queries(dataset: str, root: str, dim: int) -> list[tuple[str, str, str]]:
    """(reference, the eval protocol's caption, target) of every validation
    query (JAX `benchmarks/accuracy_soak.py:101-131`)."""
    if dataset in ("fashioniq", "fashioniq-val"):
        from fashionern_aaai2024_tpu_torch.data.captions import join_fiq_captions
        from fashionern_aaai2024_tpu_torch.data.fashioniq import DRESS_TYPES, FashionIQDataset

        rel = FashionIQDataset(root, "val", DRESS_TYPES, mode="relative", dim=dim)
        return [(it["ref_name"], join_fiq_captions(*it["captions"][:2]), it["tar_name"])
                for it in (rel[i] for i in range(len(rel)))]
    if dataset == "fashion200k":
        # multi-positive: ref / tar "names" are caption ids, the gallery's
        # item names
        from fashionern_aaai2024_tpu_torch.data.fashion200k import Fashion200kTestQueryDataset

        rel = Fashion200kTestQueryDataset(root, split="test", dim=dim)
        return [(it["ref_id"], it["caption"], it["tar_id"])
                for it in (rel[i] for i in range(len(rel)))]
    if dataset == "cirr":
        from fashionern_aaai2024_tpu_torch.data.cirr import CIRRDataset

        rel = CIRRDataset(root, "val", mode="relative", dim=dim)
    else:
        from fashionern_aaai2024_tpu_torch.data.shoes import ShoesDataset

        rel = ShoesDataset(root, "val", mode="relative", dim=dim)
    return [(it["ref_name"], it["caption"], it["tar_name"])
            for it in (rel[i] for i in range(len(rel)))]


def artifact_vs_live(artifact_dir: str, serve_args: list[str], k: int = 10) -> dict:
    """Step 6: the live service of `serve_args` (the `serve` subcommand's
    flags) and the artifact at `artifact_dir`, on the same device, over
    every validation query: top-k name mismatches and each one's
    combined-gallery Recall@k."""
    from fashionern_aaai2024_tpu_torch.cli import main as cli
    from fashionern_aaai2024_tpu_torch.retrieval.artifact import load_serve_artifact

    args = cli.build_parser().parse_args(["serve", *serve_args])
    service = cli.build_service(args)
    artifact = load_serve_artifact(artifact_dir, device=args.device)
    if artifact.names != list(service.gallery.names):
        raise AssertionError("the artifact's gallery order is not the live service's")
    queries = iter_queries(args.dataset, args.data_root,
                           cli.get_clip_config(args.clip_model_name).input_dim)
    mismatched, hits_live, hits_art, max_score_diff = 0, 0, 0, 0.0
    for ref, cap, tar in queries:
        live, _ = service.query([ref], [cap], k=k)
        live_names = [d["name"] for d in live[0]]
        scores, idx = artifact.query(service.api.tokenize([cap]), [artifact.row_for(ref)], k=k)
        art_names = [artifact.names[j] for j in idx[0]]
        mismatched += live_names != art_names
        if live_names == art_names:
            max_score_diff = max(max_score_diff, max(
                abs(d["score"] - float(v)) for d, v in zip(live[0], scores[0])))
        hits_live += tar in live_names
        hits_art += tar in art_names
    n = len(queries)
    return {"queries": n, "topk_mismatches": mismatched, "k": k,
            "max_score_diff": max_score_diff,
            "recall_live": 100.0 * hits_live / n, "recall_artifact": 100.0 * hits_art / n}


def cli_command(args: list[str]) -> list[str]:
    return [sys.executable, "-m", CLI_MODULE, *args]


def step_command(args: list[str]) -> list[str]:
    """Step 6's process: this module's `artifact-vs-live`."""
    return [sys.executable, "-m", SOAK_MODULE, "artifact-vs-live", *args]


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
            min_gain: float = 0.0, artifact: bool = True,
            command: Callable = cli_command) -> dict:
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
    vs_live = None
    if artifact:
        art_dir = os.path.join(work, "artifact")
        _, seconds["export"] = run_cli(
            ["export", *common, "--batch-size", "32", "--split", "val", "--fusion-model-path",
             best_path, "--precision", "fp32", "--out", art_dir], f"leg {leg} export",
            command=command)
        out, seconds["artifact_vs_live"] = run_cli(
            [art_dir, *common, "--batch-size", "32", "--split", "val", "--fusion-model-path",
             best_path, "--precision", "fp32"], f"leg {leg} artifact vs live",
            command=step_command)
        vs_live = last_json(out, "artifact vs live")
    summary = {
        "leg": leg, "dataset": dataset, "learnable": learnable, "tme": tme, "model": model,
        "fixture": {"n_images": n_images, "n_triplets": n_triplets},
        "train": {"steps": steps, "epochs": epochs, "batch": batch, "val_curve": curve,
                  "first_metric": curve[0][1], "best_metric": sidecar["metric"]},
        "untrained_eval": untrained, "trained_eval": trained, "metric_key": mkey,
        "artifact_vs_live": vs_live, "seconds": seconds}
    if trained[mkey] != sidecar["metric"] or sidecar["metric"] != max(m for _, m in curve):
        raise AssertionError(f"leg {leg}: the trained eval's {mkey} {trained[mkey]} is not "
                             f"the best validation metric {sidecar['metric']} "
                             f"(curve {curve})")
    if vs_live is not None and (vs_live["topk_mismatches"]
                                or vs_live["recall_live"] != vs_live["recall_artifact"]):
        raise AssertionError(f"leg {leg}: the artifact's answers differ from the live "
                             f"service's: {vs_live}")
    if not trained[mkey] > untrained[mkey] + min_gain:
        raise AssertionError(f"leg {leg}: trained {mkey} {trained[mkey]} does not beat the "
                             f"untrained {untrained[mkey]} by more than {min_gain} points")
    return summary


def main() -> None:
    if sys.argv[1:2] == ["artifact-vs-live"]:
        # step 6 in a process of its own: <artifact dir> <serve flags ...>
        print(json.dumps(artifact_vs_live(sys.argv[2], sys.argv[3:])))
        return
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
              f"{res['train']['steps']} steps, artifact vs live {res['artifact_vs_live']}, "
              f"seconds {res['seconds']}", flush=True)
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
