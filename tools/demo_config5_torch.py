"""BASELINE config 5 on snap_tpu_torch: paired alignment over a (data x
index) mesh, written to a sorted, duplicate-marked BAM with its .bai, all
in one run. The counterpart of tools/demo_config5.py, with its genome and
pair generators, flags, checks and JSON fields.

The mesh is a list of torch devices handed to the port's CLI entry point
(snap_tpu_torch.cli.main(argv, device, devices)): on one card
`--positions 8` lists cuda:0 eight times, which with `--ishards 2` is
snap_tpu's data 4 x index 2 shape; `--device cpu` lists the CPU instead.
The path is the production CLI's (cmd_paired -> GenomeIndex.to_mesh ->
parallel.mesh.paired_candidates_sharded -> the sort / duplicate-marking /
BGZF / .bai chain of io.output). Imports no JAX and nothing of snap_tpu.

    python tools/demo_config5_torch.py                       # the card
    python tools/demo_config5_torch.py --device cpu --pairs 300 --genome-size 200000

Validates, from the BAM: coordinate order of the mapped records, the
SO:coordinate header, the .bai, PCR-duplicate flags on the planted
duplicate pairs, mapped and proper-pair rates. Writes its JSON to --out
(default: config5_torch.json in --workdir) and prints it; exits 0 when
every check passes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

from golden_harness import gen_genome, gen_pairs, write_fasta, write_fastq  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="JSON path (default: in --workdir)")
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "config5_torch"))
    ap.add_argument("--genome-size", type=int, default=1_000_000)
    ap.add_argument("--pairs", type=int, default=3000)
    ap.add_argument("--repeat-frac", type=float, default=0.25)
    ap.add_argument("--dup-frac", type=float, default=0.08)
    ap.add_argument("--ishards", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--positions", type=int, default=8,
                    help="mesh positions: the device listed this many times")
    args = ap.parse_args()

    import torch

    from snap_tpu_torch.cli import main as snap_main
    from snap_tpu_torch.io.bam import read_bam

    os.makedirs(args.workdir, exist_ok=True)
    out_json = args.out or os.path.join(args.workdir, "config5_torch.json")
    rng = np.random.default_rng(5)
    contigs = gen_genome(rng, args.genome_size, n_contigs=2, repeat_frac=args.repeat_frac)
    fa = os.path.join(args.workdir, "g.fa")
    write_fasta(contigs, fa)
    r1, r2 = gen_pairs(rng, contigs, args.pairs, 100, 0.01, 0.001)
    # plant PCR duplicates: identical sequences under new names
    n_dup = int(args.pairs * args.dup_frac)
    dup_src = rng.choice(args.pairs, size=n_dup, replace=False)
    for k, i in enumerate(dup_src):
        r1.append((f"dup{k}", r1[i][1], r1[i][2]))
        r2.append((f"dup{k}", r2[i][1], r2[i][2]))
    fq1 = os.path.join(args.workdir, "r1.fq")
    fq2 = os.path.join(args.workdir, "r2.fq")
    write_fastq(r1, fq1)
    write_fastq(r2, fq2)

    dev = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    devices = [dev] * args.positions
    idx_dir = os.path.join(args.workdir, "idx")
    bam = os.path.join(args.workdir, "out.bam")
    t0 = time.time()
    if snap_main(["index", fa, idx_dir], device=args.device) != 0:
        raise SystemExit("index failed")
    t_index = time.time() - t0
    t0 = time.time()
    argv = ["paired", idx_dir, fq1, fq2, "-o", bam, "-so",
            "-ishards", str(args.ishards), "-b", str(args.batch)]
    if snap_main(argv, device=args.device, devices=devices) != 0:
        raise SystemExit("paired failed")
    t_align = time.time() - t0

    bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "snap_tpu.")))
    if bad:
        raise SystemExit(f"the port loaded {bad}")

    # ---- validation from the BAM itself ----
    header_text, _, records = read_bam(bam)
    locs = [(r.ref_id, r.pos0) for r in records if not (r.flag & 0x4)]
    sorted_ok = all(locs[i] <= locs[i + 1] for i in range(len(locs) - 1))
    n = len(records)
    dup_flagged = sum(1 for r in records if r.flag & 0x400)
    proper = sum(1 for r in records if r.flag & 0x2)
    mapped = sum(1 for r in records if not (r.flag & 0x4))
    bai_ok = os.path.exists(bam + ".bai")
    planted_flagged = sum(
        1 for r in records if r.qname.startswith(b"dup") and r.flag & 0x400
    )

    # every planted duplicate pair should be flagged (2 records each),
    # modulo pairs whose source also duplicated by chance; require 90%
    want_dups = 2 * n_dup
    n_index = args.ishards if args.positions % args.ishards == 0 else 1
    rec = {
        "metric": "config5_mesh_paired_sorted_bam_dupmark",
        "devices": args.positions,
        "device": str(dev),
        "device_name": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
        "mesh": {"data": args.positions // n_index, "index": n_index},
        "index_shards": args.ishards,
        "pairs": args.pairs + n_dup,
        "index_seconds": round(t_index, 1),
        "align_seconds": round(t_align, 1),
        "reads_per_sec": round(2 * (args.pairs + n_dup) / t_align, 1),
        "records": n,
        "mapped_frac": round(mapped / n, 4),
        "proper_pair_frac": round(proper / n, 4),
        "coordinate_sorted": bool(sorted_ok),
        "bai_present": bool(bai_ok),
        "planted_dup_records": want_dups,
        "planted_dup_records_flagged": int(planted_flagged),
        "dup_flagged_records": int(dup_flagged),
        "sort_order_header": "SO:coordinate" in header_text,
    }
    ok = (
        sorted_ok
        and bai_ok
        and rec["sort_order_header"]
        and mapped / n > 0.97
        and proper / n > 0.9
        and dup_flagged >= 0.9 * want_dups
    )
    rec["pass"] = bool(ok)
    with open(out_json, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
