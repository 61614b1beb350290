"""The host half of the port's single-end and paired-end paths, measured
one batch at a time.

    python tools/profile_host_torch.py single [--repeat-frac 0.25] [--cprofile]
    python tools/profile_host_torch.py paired [--cprofile]
    python tools/profile_host_torch.py single --device cpu --batch 64 --genome 60000 --iters 1

`single` is the counterpart of tools/profile_host_emit.py and
profile_finalize_cprof.py: one batch of 16384 x 100 bp reads (1 Mbp
random genome, seed 24, num_seeds 25, hit_cap 8, max_cand 16) through
SingleEndAligner._submit, the wait for its winners (the prefetch copy's
CUDA event), _finalize and _emit_planned (per-read _emit when _plan_ok is
false), once untimed and then --iters times. Each pass reports the reads
of each host branch (SingleEndAligner.branches) and the seconds in the
redo paths' calls, so a time lands on the branch that ran. With
--repeat-frac the genome holds planted repeats (chip_smoke's model of
bench.py's): reads whose hit lists the step's gather cap cut take the
wide redo (_redo_wide, redo_truncated), and a batch that overflows the
step's DP tier goes whole through align_tier1 and the host-gated
two_phase_merge (dp_overflow).

`paired` is the counterpart of tools/profile_paired_host.py: 2048 FR
pairs (inserts normal(300, 50) clipped to [2L + 10, 600], 1-3 bp indels
in --indel-frac of the ends, num_seeds 8) through
PairedEndAligner.align_batch and _emit_planned_pairs. It reports the
twin's branch statistics (intersect_wide_pairs, intersect_overflow_pairs,
paired_slow_rows, paired_planned_rows) and the seconds in each part of
align_batch: the device intersection, score_candidates and
two_phase_merge (which waits for the card), the host overflow redo
(_redo_overflow_pairs), the edge-indel fix, _plan_pairs, and the
per-pair loop after the plan (its batched CIGAR pass, _precompute_slow_
cigars, given apart too).

--cprofile runs one more pass under cProfile and prints its top --top
functions by cumulative time; on the card a row that waits for it
(.cpu(), .numpy(), an event or stream synchronize) is marked as a wait.
--sam PATH writes the last timed pass's SAM records there. The last
line of stdout is one JSON object holding every figure. Imports no JAX.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import time
from collections import Counter

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_common_torch import (  # noqa: E402
    READ_PAD, SEED_LEN, Profiled, add_common_flags, align_batch_timed, finish, log,
    make_genome, print_rows, read_batch, setup_device, simulate_reads,
)

# the aligner's methods and pipeline functions whose seconds a pass
# reports; a call made inside another of them is counted under
# "<outer>/<inner>"
SINGLE_TIMED = (("_redo_wide", "_fetch_winners"),
                ("align_tier1", "two_phase_merge", "score_candidates", "gather_merged_rows"))
PAIRED_TIMED = (("_device_intersect", "_redo_overflow_pairs", "_fix_edge_indels",
                 "_plan_pairs", "_precompute_slow_cigars"),
                ("score_candidates", "two_phase_merge"))
PAIRED_STATS = ("intersect_wide_pairs", "intersect_overflow_pairs",
                "paired_slow_rows", "paired_planned_rows")


def timed_calls(aligner, names, acc: dict):
    """chip_smoke.timers over the aligner class's methods and the
    pipeline functions `names` lists, adding up in acc {name: [seconds,
    calls]}."""
    from chip_smoke import timers

    from snap_tpu_torch.align import pipeline

    methods, functions = names
    return timers(acc, [(type(aligner), n) for n in methods]
                  + [(pipeline, n) for n in functions])


def tally(acc: dict) -> dict:
    return {k: {"s": s, "calls": n} for k, (s, n) in sorted(acc.items())}


def params_for(index, num_seeds: int):
    from snap_tpu_torch.align.pipeline import AlignParams

    return AlignParams(seed_len=SEED_LEN, max_probe=index.max_probe,
                       num_seeds=num_seeds, hit_cap=8, max_cand=16)


def new_writer(genome):
    from snap_tpu_torch.io.output import OutputWriter

    sink = io.BytesIO()
    return sink, OutputWriter(out=sink, genome=genome, command_line="profile")


def stat(values: list[float]) -> dict:
    return {"min_ms": min(values) * 1e3, "median_ms": float(np.median(values)) * 1e3}


# ------------------------------------------------------------------ single


def single_inputs(args):
    """(the port's Genome, the ReadBatch) of a `single` run."""
    rng = np.random.default_rng(0)
    codes, genome = make_genome(rng, args.genome, args.repeat_frac)
    reads = simulate_reads(rng, codes, args.batch, args.read_len, args.err)
    return genome, read_batch(reads, [b"r%07d" % i for i in range(args.batch)])


def run_single(args, device) -> dict:
    from snap_tpu_torch.align.single import SingleEndAligner
    from snap_tpu_torch.index.index import GenomeIndex

    genome, batch = single_inputs(args)
    log("building index...")
    index = GenomeIndex.build(genome, seed_len=SEED_LEN, device=device)
    B = args.batch
    aligner = SingleEndAligner(index, params_for(index, 25), batch_size=B)
    sink, writer = new_writer(genome)
    plan_ok = aligner._plan_ok(writer)
    print(f"plan_ok (batched native SAM path): {plan_ok}", flush=True)
    for _ in range(args.warm):
        log("warm pass")
        align_batch_timed(aligner, writer, batch, plan_ok)
    passes = []
    for _ in range(max(1, args.iters)):
        sink.seek(0)
        sink.truncate()
        before = Counter(aligner.branches)
        acc: dict = {}
        with timed_calls(aligner, SINGLE_TIMED, acc):
            t = align_batch_timed(aligner, writer, batch, plan_ok)
        t["branches"] = dict(aligner.branches - before)
        t["calls"] = tally(acc)
        passes.append(t)
    sam = sink.getvalue()
    r = {k: stat([p[k] for p in passes]) for k in ("submit", "getwin", "finalize", "emit")}
    host = [p["finalize"] + p["emit"] for p in passes]
    r["host_half"] = stat(host)
    for k in ("finalize", "emit", "host_half"):
        ms = r[k]["min_ms"]
        r[k]["reads_per_s"] = B / (ms / 1e3)
    print(f"finalize: {r['finalize']['min_ms']:8.1f} ms  ({r['finalize']['reads_per_s']:10,.0f} reads/s)")
    print(f"emit:     {r['emit']['min_ms']:8.1f} ms  ({r['emit']['reads_per_s']:10,.0f} reads/s)")
    print(f"host half:{r['host_half']['min_ms']:8.1f} ms  ({r['host_half']['reads_per_s']:10,.0f} reads/s)  "
          f"[{len(sam) / 1e6:.1f} MB SAM]")
    print(f"submit {r['submit']['min_ms']:.1f} ms, winners wait {r['getwin']['min_ms']:.1f} ms; "
          f"branches of the last pass: {passes[-1]['branches']}", flush=True)
    result = {"tool": "profile_host_torch", "mode": "single", "batch": B,
              "read_len": args.read_len, "genome": args.genome,
              "repeat_frac": args.repeat_frac, "plan_ok": plan_ok,
              "sam_bytes": len(sam), **r, "passes": passes}
    if args.sam:
        with open(args.sam, "wb") as f:
            f.write(sam)
    if args.cprofile:
        log("cProfile pass")
        sink.seek(0)
        sink.truncate()
        with Profiled(device) as prof:
            align_batch_timed(aligner, writer, batch, plan_ok)
        result["cprofile"] = {"wall_s": prof.wall_s, "top": prof.rows(args.top)}
        print_rows(result["cprofile"]["top"])
    return result


# ------------------------------------------------------------------ paired


def paired_inputs(args):
    """(the port's Genome, the two ReadBatches) of a `paired` run: the
    draws of tools/profile_paired_host.py."""
    rng = np.random.default_rng(0)
    codes, genome = make_genome(rng, args.genome, args.repeat_frac)
    B, L, glen = args.pairs, args.read_len, args.genome
    inserts = np.clip(rng.normal(300, 50, size=B).astype(np.int64), 2 * L + 10, 600)
    starts = rng.integers(0, glen - 700, size=B)

    def mutate(read):
        read = read.copy()
        mut = rng.random(read.shape) < args.err
        read[mut] = rng.integers(0, 4, int(mut.sum()))
        if rng.random() < args.indel_frac:
            k = int(rng.integers(1, 4))
            p = int(rng.integers(10, L - 10 - k))
            if rng.random() < 0.5:  # deletion from the read
                read = np.concatenate([read[:p], read[p + k :], rng.integers(0, 4, k)])
            else:  # insertion into the read
                read = np.concatenate([read[:p], rng.integers(0, 4, k), read[p:]])[:L]
        return read.astype(np.uint8)

    RC = np.array([3, 2, 1, 0, 4], np.uint8)
    ends = np.empty((2, B, L), np.uint8)
    for i in range(B):
        fwd = codes[starts[i] : starts[i] + L]
        mate = codes[starts[i] + inserts[i] - L : starts[i] + inserts[i]]
        ends[0, i] = mutate(fwd)
        ends[1, i] = mutate(RC[mate[::-1]])
    return genome, tuple(
        read_batch(ends[e], [b"p%07d/%d" % (i, e + 1) for i in range(B)]) for e in (0, 1)
    )


def paired_pass(aligner, writer, b0, b1) -> dict:
    """One batch of pairs: align_batch, then emission. The per-pair loop
    is the time from the end of _plan_pairs (or, without a plan, of the
    edge-indel fix) to align_batch's return."""
    marks = {}
    cls = type(aligner)

    def mark(name):
        fn = getattr(cls, name)

        def wrapped(self, *a, **kw):
            try:
                return fn(self, *a, **kw)
            finally:
                marks[name] = time.perf_counter()
        return wrapped

    for name in ("_fix_edge_indels", "_plan_pairs"):
        setattr(aligner, name, mark(name).__get__(aligner))
    try:
        t0 = time.perf_counter()
        out = aligner.align_batch(b0, b1, plan_writer=writer)
        t1 = time.perf_counter()
    finally:
        for name in ("_fix_edge_indels", "_plan_pairs"):
            delattr(aligner, name)
    results, plan = out
    if plan is not None:
        aligner._emit_planned_pairs(writer, b0, b1, results, plan)
    else:
        for i, (r0, r1) in enumerate(results):
            aligner._emit_pair(writer, b0, b1, i, r0, r1)
    t2 = time.perf_counter()
    loop_from = marks.get("_plan_pairs", marks.get("_fix_edge_indels", t0))
    return {"align_batch": t1 - t0, "emit": t2 - t1, "wall": t2 - t0,
            "per_pair_loop": t1 - loop_from, "planned": plan is not None}


def run_paired(args, device) -> dict:
    from snap_tpu_torch.align.paired_driver import PairedEndAligner
    from snap_tpu_torch.index.index import GenomeIndex

    genome, (b0, b1) = paired_inputs(args)
    log("building index...")
    index = GenomeIndex.build(genome, seed_len=SEED_LEN, device=device)
    B = args.pairs
    aligner = PairedEndAligner(index, params_for(index, 8), batch_size=B)
    sink, writer = new_writer(genome)
    plan_ok = aligner._plan_ok(writer)
    print(f"plan_ok: {plan_ok}", flush=True)
    for _ in range(args.warm):
        log("warm pass")
        t0 = time.time()
        paired_pass(aligner, writer, b0, b1)
        print(f"  first align_batch: {time.time() - t0:.1f}s", flush=True)
    passes = []
    for _ in range(max(1, args.iters)):
        sink.seek(0)
        sink.truncate()
        before = Counter(aligner.branches)
        st0 = {k: getattr(aligner.stats, k) for k in PAIRED_STATS}
        acc: dict = {}
        with timed_calls(aligner, PAIRED_TIMED, acc):
            t = paired_pass(aligner, writer, b0, b1)
        t["branches"] = dict(aligner.branches - before)
        t["stats"] = {k: getattr(aligner.stats, k) - st0[k] for k in PAIRED_STATS}
        t["calls"] = tally(acc)
        passes.append(t)
    sam = sink.getvalue()
    best = min(p["wall"] for p in passes)
    print(f"align_batch+emit: {best * 1e3:8.1f} ms ({2 * B / best:10,.0f} reads/s "
          f"incl. the device step)")
    st = passes[-1]["stats"]
    done = max(1, st["paired_slow_rows"] + st["paired_planned_rows"])
    print(f"intersect wide-tier pairs: {st['intersect_wide_pairs']} "
          f"({100.0 * st['intersect_wide_pairs'] / done:.2f}%)\n"
          f"intersect overflow pairs (host redo): {st['intersect_overflow_pairs']} "
          f"({100.0 * st['intersect_overflow_pairs'] / done:.2f}% of {done} finalized)\n"
          f"slow finalize rows: {st['paired_slow_rows']} "
          f"({100.0 * st['paired_slow_rows'] / done:.2f}%), planned: "
          f"{st['paired_planned_rows']}")
    last = passes[-1]["calls"]
    parts = {name: last.get(name, {"s": 0.0})["s"] for name in sum(PAIRED_TIMED, ())}
    print("seconds of the last pass: " + ", ".join(
        f"{k} {v:.3f}" for k, v in [*parts.items(),
                                    ("per_pair_loop", passes[-1]["per_pair_loop"]),
                                    ("emit", passes[-1]["emit"]),
                                    ("wall", passes[-1]["wall"])]), flush=True)
    result = {"tool": "profile_host_torch", "mode": "paired", "pairs": B,
              "read_len": args.read_len, "genome": args.genome,
              "repeat_frac": args.repeat_frac, "indel_frac": args.indel_frac,
              "plan_ok": plan_ok, "sam_bytes": len(sam),
              **{k: stat([p[k] for p in passes])
                 for k in ("align_batch", "per_pair_loop", "emit", "wall")},
              "reads_per_s": 2 * B / best,
              "stats_total": {k: getattr(aligner.stats, k) for k in PAIRED_STATS},
              "passes": passes}
    if args.sam:
        with open(args.sam, "wb") as f:
            f.write(sam)
    if args.cprofile:
        log("cProfile pass")
        sink.seek(0)
        sink.truncate()
        with Profiled(device) as prof:
            paired_pass(aligner, writer, b0, b1)
        result["cprofile"] = {"wall_s": prof.wall_s, "top": prof.rows(args.top)}
        print_rows(result["cprofile"]["top"])
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    for mode, iters, top in (("single", 5, 35), ("paired", 3, 28)):
        p = sub.add_parser(mode)
        add_common_flags(p, iters=iters)
        p.add_argument("--err", type=float, default=0.01)
        p.add_argument("--repeat-frac", type=float, default=0.0)
        p.add_argument("--cprofile", action="store_true")
        p.add_argument("--top", type=int, default=top)
        p.add_argument("--sam", help="write the last timed pass's SAM records here")
        if mode == "single":
            p.add_argument("--batch", type=int, default=16384)
        else:
            p.add_argument("--pairs", type=int, default=2048)
            p.add_argument("--indel-frac", type=float, default=0.10)
    args = ap.parse_args(argv)
    if args.read_len > READ_PAD:
        ap.error(f"--read-len is at most {READ_PAD}")
    device = setup_device(args.device)
    run = run_single if args.mode == "single" else run_paired
    return finish(run(args, device), device)


if __name__ == "__main__":
    main()
