"""FASTQ -> SAM of the port's single-end path, phase by phase.

The counterpart of tools/profile_e2e_tpu.py: a 1 Mbp random genome and
--batch x --batches reads of 100 bp at 1% substitutions (numpy seed 1),
written as FASTA and FASTQ into --workdir; the port's `index` command
builds the index there (seed 24) and it is loaded on --device. A warm
pass aligns the file once; then a fresh SingleEndAligner (the state a
`single` run starts from) aligns it again, batch after batch, and the
seconds of each phase add up:

  read      single_batches: the next batch parsed from the FASTQ
  submit    SingleEndAligner._submit: the step dispatched, and the start
            of the winners' copy to pinned host memory
  getwin    the wait for that copy's CUDA event (the prefetch _submit
            started; no second copy is made)
  finalize  _finalize: winners unpacked, the flagged rows redone, the
            emission plan built
  emit      _emit_planned (per-read _emit when _plan_ok is false)
  wall      the whole timed pass

The loop is serial (batch i is written before batch i+1 is submitted),
as the twin's is; `single` overlaps batch i+1's step with batch i's host
work. The timed pass's SAM, header included, is the one `single idx r.fq
-o out.sam -b B -rl L` run in --workdir writes (its @PG line names that
command), and is written to --workdir/out.sam. The last line of stdout
is one JSON object holding every figure. Imports no JAX.

    python tools/profile_e2e_torch.py                       # the card, 4 batches of 16384
    python tools/profile_e2e_torch.py --batches 2
    python tools/profile_e2e_torch.py --device cpu --batch 64 --batches 2 --genome 60000
"""

from __future__ import annotations

import argparse
import io
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_common_torch import (  # noqa: E402
    SEED_LEN, align_batch_timed, finish, log, setup_device, simulate_reads,
)

PHASES = ("read", "submit", "getwin", "finalize", "emit")


def write_inputs(workdir: str, glen: int, n: int, rl: int, err: float = 0.01) -> None:
    """g.fa (one contig, chr1) and r.fq (n reads) in workdir."""
    from chip_smoke import write_fasta

    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, size=glen).astype(np.uint8)
    write_fasta(os.path.join(workdir, "g.fa"), "chr1", codes)
    reads = simulate_reads(rng, codes, n, rl, err)
    dec = np.frombuffer(b"ACGT", np.uint8)
    qline = b"I" * rl
    with open(os.path.join(workdir, "r.fq"), "wb") as f:
        for i in range(n):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, dec[reads[i]].tobytes(), qline))


def one_pass(aligner, writer, fq: str, plan_ok: bool, tot: dict | None = None) -> None:
    """Align the FASTQ batch by batch; with `tot`, add each phase's
    seconds there."""
    from snap_tpu_torch.io.readers import single_batches

    src = iter(single_batches(fq, aligner.batch_size, aligner.max_read_len))
    while True:
        t0 = time.perf_counter()
        batch = next(src, None)
        if tot is not None:
            tot["read"] += time.perf_counter() - t0
        if batch is None:
            break
        t = align_batch_timed(aligner, writer, batch, plan_ok)
        if tot is not None:
            for k in PHASES[1:]:
                tot[k] += t[k]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--genome", type=int, default=1_000_000)
    ap.add_argument("--workdir", help="keep g.fa, r.fq, idx/ and out.sam here "
                                      "(default: a temporary directory)")
    args = ap.parse_args(argv)
    device = setup_device(args.device)

    from snap_tpu_torch.align.pipeline import AlignParams
    from snap_tpu_torch.align.single import SingleEndAligner
    from snap_tpu_torch.cli import main as cli_main
    from snap_tpu_torch.index.index import GenomeIndex
    from snap_tpu_torch.io.output import OutputWriter

    wd = args.workdir or tempfile.mkdtemp(prefix="profile_e2e_")
    os.makedirs(wd, exist_ok=True)
    try:
        n = args.batch * args.batches
        rl = args.read_len
        log(f"writing {n} reads")
        write_inputs(wd, args.genome, n, rl)
        log("building index...")
        if cli_main(["index", os.path.join(wd, "g.fa"), os.path.join(wd, "idx"),
                     "-s", str(SEED_LEN)], device=device) != 0:
            raise SystemExit("the index command failed")
        index = GenomeIndex.load(os.path.join(wd, "idx"), device=device)
        fq = os.path.join(wd, "r.fq")
        command = f"single idx r.fq -o out.sam -b {args.batch} -rl {rl}"

        def aligner_and_writer():
            aligner = SingleEndAligner(
                index, AlignParams(seed_len=index.seed_len, max_probe=index.max_probe),
                batch_size=args.batch, max_read_len=rl)
            sink = io.BytesIO()
            writer = OutputWriter(out=sink, genome=index.genome_meta, command_line=command)
            writer.write_header()
            return aligner, sink, writer

        aligner, _, writer = aligner_and_writer()
        plan_ok = aligner._plan_ok(writer)
        print(f"plan_ok: {plan_ok}", flush=True)
        log("warm pass...")
        t0 = time.time()
        one_pass(aligner, writer, fq, plan_ok)
        print(f"warm: {time.time() - t0:.1f}s", flush=True)

        aligner, sink, writer = aligner_and_writer()
        tot = dict.fromkeys(PHASES, 0.0)
        t_all = time.perf_counter()
        one_pass(aligner, writer, fq, plan_ok, tot)
        wall = time.perf_counter() - t_all
        writer.close()
        with open(os.path.join(wd, "out.sam"), "wb") as f:
            f.write(sink.getvalue())
        for k, v in tot.items():
            print(f"{k:8s} {v:7.2f}s  ({n / max(v, 1e-9):12,.0f} reads/s)")
        print(f"wall     {wall:7.2f}s  ({n / wall:12,.0f} reads/s e2e, serial)", flush=True)
        result = {
            "tool": "profile_e2e_torch", "batch": args.batch, "batches": args.batches,
            "reads": n, "read_len": rl, "genome": args.genome, "plan_ok": plan_ok,
            "seconds": {**tot, "wall": wall},
            "reads_per_s": {k: n / max(v, 1e-9) for k, v in {**tot, "wall": wall}.items()},
            "share_of_wall": {k: v / wall for k, v in tot.items()},
            "branches": dict(aligner.branches), "sam_bytes": len(sink.getvalue()),
        }
    finally:
        if not args.workdir:
            shutil.rmtree(wd, ignore_errors=True)
    return finish(result, device)


if __name__ == "__main__":
    main()
