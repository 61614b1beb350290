"""Readings for the limits of `correct` (PERF.md sets each limit from
them): the check's numbers for the program on many seeds, and for the
control (reference/control.py: the reference in the program's place,
gapless) on some, at the cell's own batch and judged reads, in one
process so set-up is paid once. --mapq0-seeds reads the control once
more with MAPQ 0 written for every mapped read (the check's MAPQ half).

  python3 benchmark/readings.py --workload <name> --program-seeds 1 2 ... \\
      --control-seeds 1 2 3 [--mapq0-seeds 1 2 3] [--seconds S]

--seconds sizes the program's windows (default: one batch). Prints one
JSON line per run. On a CUDA card the program runs there; the control
runs on the host's numpy with its index on the card when there is one.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

from reference import control  # noqa: E402
from reference.align import KmerIndex  # noqa: E402
from snapbench import check, genome, runner, traffic  # noqa: E402
from snapbench.layout import CACHE_DIR, ROOT, load_cell  # noqa: E402


def control_reading(cell, seed: int, seconds: float, device, index=None,
                    cache_dir: str = CACHE_DIR, mapq: int | None = None) -> dict:
    """The check's numbers for the control on the window the program
    would get from this seed: its judged reads aligned gapless."""
    cfg, tr = cell.config, cell.traffic
    codes, _ = genome.prepare_genome(cfg, cache_dir)
    w = runner.draw_window(tr, codes, seed, seconds)
    pi = w.judged % w.pool_units
    names = [traffic.pool_name(runner.PREFIX, int(i)) for i in pi]
    contig = cfg["contig"].encode()
    index = index or KmerIndex(codes, check.K, device)
    t0 = time.perf_counter()
    lines = control.align_single(index, codes, contig, names, w.pool.bases[pi],
                                 w.pool.quals[pi], mapq=mapq)
    n = len(lines)
    j = check.judge(codes, contig, w.pool, runner.PREFIX, dict(zip(w.judged.tolist(), lines)),
                    w.pool_units, n, n, device, index=index)
    return {"side": "control" if mapq is None else f"control_mapq{mapq}", "seed": seed,
            "missing_records": j.missing_records,
            "inconsistent_records": j.inconsistent_records, "wrong_share": j.wrong_share,
            "judged": j.judged, "worse": j.worse, "overconfident": j.overconfident,
            "underconfident": j.underconfident, "seconds": time.perf_counter() - t0,
            "notes": j.notes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--mapq0-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    import torch

    cell = load_cell(args.workload, ROOT)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for seed in args.program_seeds:
        log = io.StringIO()
        r = runner.run_cell(cell, seed, args.seconds, False, device, log=log)
        rec = r.pop("_record")
        print(json.dumps({"side": "program", "seed": seed, "correct": r["correct"],
                          **{k: c["value"] for k, c in r["checks"].items()},
                          "reads": rec["reads"], "window_s": rec["window_s"],
                          "log": [x for x in log.getvalue().splitlines()
                                  if x.startswith(("note ", "warm-up"))]}), flush=True)
    if args.control_seeds or args.mapq0_seeds:
        codes, _ = genome.prepare_genome(cell.config)
        index = KmerIndex(codes, check.K, device)
        for seed in args.control_seeds:
            print(json.dumps(control_reading(cell, seed, args.seconds, device, index)), flush=True)
        for seed in args.mapq0_seeds:
            print(json.dumps(control_reading(cell, seed, args.seconds, device, index, mapq=0)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
