"""The benchmark of the FashionERN PyTorch / CUDA port: one run of one cell.

    python3 cirbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. Prints one JSON line last on standard output:
{"correct", "attempted", "failed", "metrics", "device"[, "breakdown"], "checks"}
(`harness.py`). Exits non-zero and prints no result without CUDA, with
fewer cards than the cell asks for, or when JAX or the JAX package was
loaded into this process. Every build the program makes stays under
`build/` in the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# fixed cache directories inside the checkout, for anything that compiles
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "cirbench_cache" / sub)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from cirbench import harness
    from cirbench.spec import Spec

    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"cirbench: {args.workload} needs {cell['chips']} CUDA device(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = harness.execute(args.workload, args.seed, args.seconds, bool(args.trace),
                             device="cuda", spec=spec, t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"cirbench: JAX or the JAX package was loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
