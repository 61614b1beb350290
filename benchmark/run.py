"""Run one cell of BENCHMARK.json once on one CUDA card.

  python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the run's notes and, as its last
lines on standard error, each number of the check beside its limit; the
last line of standard output is the result as one JSON object. Exits
non-zero, printing no result, without a CUDA card, without the port
(snap_tpu_torch) beside this folder, or when a module of JAX or of the
JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))
os.environ.setdefault("USE_FLAX", "0")

from snapbench import independence, runner  # noqa: E402
from snapbench.layout import load_cell  # noqa: E402


def main(argv=None) -> int:
    proc_start = runner.process_start_epoch()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: the benchmark runs only on a card", file=sys.stderr)
        return 2
    try:
        import snap_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the port is not beside the benchmark: {e}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), proc_start)
    result.pop("_record")
    bad = independence.forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
