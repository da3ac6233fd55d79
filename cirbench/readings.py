"""The readings that a cell's correctness limits are set from: the numbers
its check compares, over many seeds in one process, for the program or
for a control in its place.

    python3 cirbench/readings.py --workload <name> --seeds 11,12,13 \
        [--seconds 2] [--control reference_lower] [--fault half_batch_loss] [--out FILE]

`reference_lower` is the reference one precision step below the
configuration (`reference/ops.py LOWER`) in the program's place.
`half_batch_loss` plants a fault in the program's train step: the loss
takes half of the batch and its mean over that half. Each seed is a
whole run (`harness.execute`) with a short window; one JSON line a seed,
then the largest and smallest reading of each number. Needs a card.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def plant_half_batch_loss() -> None:
    from fashionern_aaai2024_tpu_torch.train import step

    original = step.batch_based_classification_loss

    def half_batch_loss(predicted, target, **kwargs):
        half = predicted.shape[0] // 2
        return original(predicted[:half], target[:half], **kwargs)
    step.batch_based_classification_loss = half_batch_loss


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", choices=("reference_lower",))
    ap.add_argument("--fault", choices=("half_batch_loss",))
    ap.add_argument("--out")
    args = ap.parse_args()

    import torch

    from cirbench import harness

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    if args.fault == "half_batch_loss":
        plant_half_batch_loss()
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result = harness.execute(args.workload, seed, args.seconds, False, device="cuda",
                                 control=args.control)
        row = {"seed": seed, "control": args.control or args.fault, "failed": result["failed"],
               "seconds": time.perf_counter() - t0,
               **{k: v["value"] for k, v in result["checks"].items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del result
        gc.collect()
        torch.cuda.empty_cache()
    names = [k for k in rows[0] if k not in ("seed", "control", "failed", "seconds")]
    summary = {n: {"min": min(r[n] for r in rows), "max": max(r[n] for r in rows)}
               for n in names}
    print(json.dumps({"workload": args.workload, "control": args.control or args.fault, "n": len(rows),
                      **summary}), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps({"rows": rows, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
