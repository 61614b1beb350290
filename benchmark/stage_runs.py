"""Runs of one cell read as the stage metrics read them (PERF.md's stage
split, the idle coverage and the recorder's cost come from here).

  python3 benchmark/stage_runs.py --workload <name> --seeds 1 2 3 [--seconds S] [--cost]

Without --cost each seed makes a traced run (as `run.py --trace 1`, the
port recording its spans while the window's profiler collects) and
prints one JSON line: the six stage metrics and their sum, the share of
the card's idle time inside a program span, the idle gaps named by the
innermost of the benchmark's and the program's spans, each stage's self
seconds of the window and of its idle time, and the spans a batch.
With --cost each seed makes two untraced runs, the recorder off and on
(enabled from Python, no profiler), in the order off, on, on, off, ...,
and prints reads_per_s for each. Runs on the card only.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
from collections import Counter

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

from snapbench import runner, stages, trace  # noqa: E402
from snapbench.layout import ROOT, load_cell  # noqa: E402

STAGE_METRICS = ("read_wait_frac", "submit_frac", "winners_wait_frac", "redo_frac",
                 "finalize_frac", "emit_frac")


def traced(cell, seed: int, seconds: float, device, recorder) -> dict:
    recorder.drain()
    r = runner.run_cell(cell, seed, seconds, True, device, log=io.StringIO(), root=ROOT)
    spans = [list(s) for s in recorder.drain()]
    rec = r.pop("_record")
    t0, t1 = rec["window_ns"]
    rec["program_spans"] = [s for s in spans if s[2] > t0 and s[1] < t1]
    idle = stages.idle_intervals(rec) if rec.get("device_ops") else []
    m = r["metrics"]
    stage = {n: m[n]["value"] for n in STAGE_METRICS if n in m}
    per_batch = Counter(s[0] for s in rec["program_spans"])
    batches = max(1, sum(1 for s in rec["program_spans"] if s[0] == "single.finalize"))
    both = {**rec, "spans": rec["spans"] + rec["program_spans"]}
    return {
        "seed": seed, "correct": r["correct"], "reads": rec["reads"],
        "window_s": (t1 - t0) / 1e9, "busy_s": r["device"].get("busy_s"),
        "stages": stage, "stage_sum": sum(stage.values()),
        "other_metrics": {n: v["value"] for n, v in m.items() if n not in stage},
        "idle_in_program_spans": stages.idle_coverage(rec),
        "idle_gaps": trace.breakdown(both)["idle_gaps"],
        "breakdown_idle_gaps": r["breakdown"]["idle_gaps"],
        "self_s": stages.self_seconds(rec),
        "idle_self_s": stages.self_seconds(rec, within=idle) if idle else None,
        "spans_a_batch": {n: c / batches for n, c in sorted(per_batch.items())},
    }


def cost(cell, seed: int, seconds: float, device, recorder, order: list[bool]) -> list[dict]:
    out = []
    for on in order:
        recorder.drain()
        if on:
            recorder.enable()
        try:
            r = runner.run_cell(cell, seed, seconds, False, device, log=io.StringIO(),
                                root=ROOT)
        finally:
            recorder.disable()
        n_spans = len(recorder.drain())
        r.pop("_record")
        out.append({"seed": seed, "recorder": on, "correct": r["correct"],
                    "reads_per_s": r["metrics"]["reads_per_s"]["value"],
                    "spans": n_spans})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--cost", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from snap_tpu_torch.stats import RECORDER

    if not torch.cuda.is_available():
        print("no CUDA device: the stage runs run only on a card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(0)
    cell = load_cell(args.workload, ROOT)
    for i, seed in enumerate(args.seeds):
        if args.cost:
            first = i % 2 == 0
            for line in cost(cell, seed, args.seconds, device, RECORDER, [not first, first]):
                print(json.dumps({"workload": args.workload, **line}), flush=True)
        else:
            line = traced(cell, seed, args.seconds, device, RECORDER)
            print(json.dumps({"workload": args.workload, **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
