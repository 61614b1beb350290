"""hg38-scale index build (BASELINE config 4), the port's counterpart of
tools/build_big_index.py.

Synthesizes the same genome as that tool, step for step (numpy seed 42,
random bases, a 50 kb unit planted 500 times and a 5 kb unit 5,000
times, 24 equal contigs in SNAP's layout with 2,000 bases of padding),
runs snap_tpu_torch's chunked external builder under the memory budget
and saves the index. Host-only: it imports numpy and the port's index
builder, never a device, JAX or snap_tpu.

  python tools/build_big_index_torch.py <outdir> [--gbp 3.1] [--budget-gb 24]

Prints the JAX tool's progress lines and TOTAL line, then, as the last
line, one JSON object: the synthesis and build seconds, the host's peak
resident set, the table's shape, n_banks and max_probe, each file's
bytes and card_bytes, the bytes that make_device_index places on a card
(bench_big_torch.card_bytes). Keep outdir outside the repository: at
1.8 Gbp the index is ~44 GB and the build's spill ~23 GB beside it.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


def synthesize(gbp: float):
    """The JAX tool's genome: (the port's Genome, padded bases)."""
    from snap_tpu_torch.constants import PAD
    from snap_tpu_torch.genome import Contig, Genome

    n = int(gbp * 1e9)
    rng = np.random.default_rng(42)
    print(f"synthesizing {n:,} bases...", flush=True)
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    # plant repeats: a 50kb unit copied ~500 times, a 5kb unit ~5000
    # times (~8% of a 3.1 Gbp genome repetitive)
    rep1 = codes[1_000_000 : 1_050_000].copy()
    rep2 = codes[2_000_000 : 2_005_000].copy()
    for s in rng.integers(0, n - rep1.size, size=500):
        codes[s : s + rep1.size] = rep1
    for s in rng.integers(0, n - rep2.size, size=5000):
        codes[s : s + rep2.size] = rep2

    # 24 contigs of equal size, SNAP's layout (padding before each contig
    # and one trailing run, the first contig at exactly pad)
    n_contigs, pad = 24, 2000
    clen = n // n_contigs
    total = n_contigs * (pad + clen) + pad
    bases = np.full(total, PAD, dtype=np.uint8)
    contigs = []
    off = 0
    for c in range(n_contigs):
        off += pad
        bases[off : off + clen] = codes[c * clen : (c + 1) * clen]
        contigs.append(Contig(name=f"chr{c + 1}", start=off, length=clen))
        off += clen
    return Genome(bases=bases, contigs=contigs), total


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--gbp", type=float, default=3.1)
    ap.add_argument("--budget-gb", type=float, default=24.0)
    ap.add_argument("--seed-len", type=int, default=24)
    ap.add_argument("--load-factor", type=float, default=0.85)
    args = ap.parse_args(argv)

    from bench_big_torch import card_bytes
    from snap_tpu_torch.index.build import build_index_chunked, save_index

    t0 = time.time()
    genome, total = synthesize(args.gbp)
    synth_s = time.time() - t0
    print(f"genome ready ({total:,} padded bases, {synth_s:.0f}s)", flush=True)

    t1 = time.time()
    last = [0.0]

    def status(s):
        now = time.time()
        if now - last[0] >= 15:
            print(f"[{now - t1:7.0f}s] {s}", flush=True)
            last[0] = now

    arrays = build_index_chunked(
        genome, args.seed_len, load_factor=args.load_factor,
        memory_budget_gb=args.budget_gb, tmpdir=args.outdir + ".tmp", status=status,
    )
    index_s = time.time() - t1
    print(f"build done in {index_s:.0f}s; saving...", flush=True)
    save_index(arrays, genome, args.outdir)
    if arrays.get("_tmpdir"):
        shutil.rmtree(arrays["_tmpdir"], ignore_errors=True)
    shutil.rmtree(args.outdir + ".tmp", ignore_errors=True)
    build_s = time.time() - t1

    files = {f: os.path.getsize(os.path.join(args.outdir, f))
             for f in sorted(os.listdir(args.outdir))}
    table_shape = tuple(arrays["table"].shape)
    print(
        f"TOTAL {time.time() - t0:.0f}s wall; table banks {table_shape}, "
        f"span {arrays['max_probe']}; sizes(GB): "
        + ", ".join(f"{k}={v / 1e9:.2f}" for k, v in files.items()),
        flush=True,
    )
    result = {
        "metric": "hg38_scale_index_build",
        "gbp": args.gbp,
        "genome_bases": int(total),
        "budget_gb": args.budget_gb,
        "load_factor": args.load_factor,
        "synth_seconds": synth_s,
        "build_seconds": build_s,
        "wall_seconds": time.time() - t0,
        "host_peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
        "table_shape": list(table_shape),
        "table_slots": table_shape[0] * table_shape[1],
        "n_banks": table_shape[0],
        "max_probe": int(arrays["max_probe"]),
        "hits": int(arrays["hits"].shape[0]),
        "file_bytes": files,
        "card_bytes": card_bytes(table_shape, int(arrays["hits"].shape[0]), int(total)),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
