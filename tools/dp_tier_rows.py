"""Why a batch of the adaptive single-end step overflows its DP tier.

The step (pipeline.align_winners_device, adaptive) scores at most
dp_rows (read, candidate) rows a phase with the DP kernels; a batch
whose phase A or phase B needs more sets dp_overflow, and the host
redoes the whole batch through the per-read two-phase path. This tool
builds a port index on the CPU over one genome of chip_smoke.py's
25%-repeat model, aligns one batch of its reads through the step, and
prints one JSON line: each phase's rows needed against its dp_rows,
and per kind of repeat the reads' origin lies in (REPEAT_CLASSES) the
reads, their candidates, their rows that need the DP tier (valid,
gapless distance past max_k_same, weight >= 2) at phase B's geometry,
and their share of popular seeds.

    python tools/dp_tier_rows.py                      # window (a) of the hg38 layout, 1 Mbp
    python tools/dp_tier_rows.py --genome chr21       # the chr21 cell's genome, 46.7 Mbp

`--genome window` is hg38_windows' first window (seed + 8, 1 Mbp; the
other windows are drawn the same way), `--genome chr21` the e2e
genome (seed, CHR21_BP). Needs ~1 minute and ~3 GB for chr21. Imports
no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> None:
    import torch

    import chip_smoke as cs
    from snap_tpu_torch.align import pipeline as P
    from snap_tpu_torch.cli import _load_index_cached
    from snap_tpu_torch.cli import main as cli_main
    from snap_tpu_torch.constants import DEFAULT_CONTIG_PADDING

    ap = argparse.ArgumentParser()
    ap.add_argument("--genome", choices=("window", "chr21"), default="window")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--reads", type=int, default=1024)
    args = ap.parse_args()

    glen = cs.HG38_WINDOW_BP if args.genome == "window" else cs.CHR21_BP
    rng = np.random.default_rng(args.seed + 8 if args.genome == "window" else args.seed)
    classes = np.zeros(glen, np.uint8)
    codes = cs.gen_repeat_genome(rng, glen, 0.25, classes)
    with tempfile.TemporaryDirectory() as wd:
        fa, idx_dir = os.path.join(wd, "g.fa"), os.path.join(wd, "idx")
        cs.write_fasta(fa, "g", codes)
        if cli_main(["index", fa, idx_dir, "-s", "24"], device="cpu") != 0:
            raise SystemExit("the index command failed")
        didx = _load_index_cached(idx_dir, "cpu").device
        reads, quals, _, starts = cs.simulate_reads(
            np.random.default_rng(args.seed + 4), codes, DEFAULT_CONTIG_PADDING,
            args.reads, cs.READ_LEN)
        kind = np.array([classes[s : s + cs.READ_LEN].max() for s in starts.tolist()])
        bases, q = torch.from_numpy(reads), torch.from_numpy(quals)
        lens = torch.full((args.reads,), cs.READ_LEN, dtype=torch.int32)
        params = P.AlignParams()

        phases = {}
        merge = P._awd_merge

        def kept(out_a, win_a, out_b, win_b, rows, live, overflow,
                 needs_a, needs_b, dp_a, dp_b):
            phases.update(
                a={"rows_needed": int(needs_a), "dp_rows": dp_a},
                b={"reads": int(live.sum()), "rows_needed": int(needs_b), "dp_rows": dp_b})
            return merge(out_a, win_a, out_b, win_b, rows, live, overflow,
                         needs_a, needs_b, dp_a, dp_b)

        P._awd_merge = kept
        try:
            packed, _, _ = P.align_winners_device(didx, bases, q, lens, torch.tensor(1 << 40),
                                                  params, adaptive=True)
        finally:
            P._awd_merge = merge
        t1 = P.align_tier1(didx, bases, q, lens, P._phase_b_params(params))
        valid = t1.valid
        rows = (valid & (t1.gapless_dist.to(torch.int32) > params.max_k_same)
                & (t1.weight.to(torch.int32) >= 2)).sum(1).numpy()
        cands = valid.sum(1).numpy()
        popular = t1.popular.to(torch.float64).numpy()
        by_kind = {}
        for k, name in enumerate(cs.REPEAT_CLASSES):
            sel = kind == k
            if sel.any():
                by_kind[name] = {"reads": int(sel.sum()),
                                 "candidates_a_read": float(cands[sel].mean()),
                                 "dp_rows_a_read": float(rows[sel].mean()),
                                 "dp_rows": int(rows[sel].sum()),
                                 "popular_seeds_a_read": float(popular[sel].mean())}
    print(json.dumps({
        "genome": args.genome, "genome_bp": glen, "reads": args.reads,
        "dp_overflow": bool(P.HostWinners(packed.numpy()).dp_overflow),
        "phases": phases, "by_repeat_kind": by_kind}))


if __name__ == "__main__":
    main()
