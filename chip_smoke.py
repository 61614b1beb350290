#!/usr/bin/env python3
"""Chip smoke test of the snap_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py                       # as the acceptance run
    python3 chip_smoke.py --genome-len 4641652  # a quicker, smaller run
    python3 chip_smoke.py --baseline .archive   # also time the kernels there
    python3 chip_smoke.py --only agcigar        # build, then the agcigar phase

Phases, each printing one JSON line:
  device   the card's name and power limit (nvidia-smi) and torch's name
  build    nvcc builds the kernels from snap_tpu_torch/csrc
  e2e      the adaptive single-end device step end to end: a 25%-repeat
           genome of chr21's length written as FASTA and indexed once by
           the port's `index` command (the index is then loaded), 16384
           simulated 100 bp reads written as FASTQ and read back, then
           align_winners_device(adaptive=True) with and without phase C;
           checks launch counts, accuracy, and card-vs-CPU winners, and
           times the step (--profile adds a torch.profiler trace). The
           inputs of every kernel launch of the phase-C step are kept.
  sam      the main path as a user runs it: 65536 simulated 100 bp reads
           (true position in each name) through `single <index> reads.fq
           -o out.sam` on the card. First an untimed run of the first
           8192 reads with the CLI's defaults (-b 1024) keeps the inputs
           of every kernel launch of its first RECORD_STEPS steps and of
           every launch made by its redo paths (score_candidates,
           score_rows, align_tier1), replays each against its plain
           version bit for bit, and must give the timed run's records
           of those reads. Then
           timed runs at -b 1024 (every read) and -b 16384 (the first
           16384 reads): wall time, FASTQ->SAM
           reads/s, AlignerStats' seconds reading/aligning/writing, the
           host's seconds in the device step (dispatch and winners wait)
           and in the redo paths' device calls, record and status
           counts, the reads of each host branch, each kernel's
           launches, and whether the native FASTQ scanner and SAM
           formatter did the work. Fails unless 98% of primary MAPQ >= 10
           records lie within 30 bp of their true position, unless the
           first 1024 reads give the same SAM on the card and on the CPU
           (at most 2 records differing, in MAPQ +-1 only), and on any
           replayed launch that differs from its plain version.
           --profile adds a cProfile of a -b 1024 run's host functions
           (a sam_profile line).
  paired   the paired-end path as a user runs it: 16384 simulated pairs
           (the first of 32768 drawn) of 2 x 100 bp (inserts normal(300, 30) clipped to [220, 600],
           the second end reverse complemented, the single-end error
           model, both true positions in the pair's name) through
           `paired <index> r1.fq r2.fq -o out.sam` at the CLI default
           -b 512. First an untimed run of the first 4096 pairs keeps
           the inputs of every kernel launch of its first 4 batches and
           of every launch of the host overflow redo and the edge-indel
           fix, and replays each against its plain version bit for bit
           (the wide tier launches no kernel: its pairs are scored with
           their batch). Then the timed run: wall time, pairs/s and
           reads/s, AlignerStats' seconds, the host's seconds in the
           device intersection (its wide tier included), the batch's
           score_candidates + two_phase_merge and the redo paths, the
           branch counts, each kernel's launches, whether the native
           paired formatter did the work. Fails unless 98% of primary
           MAPQ >= 10 records lie within 30 bp of their end's true
           position, unless the first 512 pairs give the same SAM on the
           card and on the CPU (at most 2 records differing, in MAPQ +-1
           only), and on any replayed launch that differs.
  kernels  each kernel launch of that step replayed on its own inputs,
           against the kernel's plain PyTorch version on the same CUDA
           tensors (every output bit for bit), beside the launch's bound.
           Two times per launch: `ms`, the kernel's device time (the
           wrapper captured 50 times in one CUDA graph, the graph
           replayed between CUDA events, so the host's checks and
           allocations stay out of the window), and `call_ms`, CUDA
           events around one wrapper call as the host-bound step pays
           it. With --baseline DIR, each kernel whose source (affine.cu,
           dp.cu, gapless.cu) lies in DIR is also built from there and
           timed on the same launches in turns (baseline, kernel,
           kernel, baseline): how an earlier commit's kernel is put
           beside the current one without committing it (the DP and
           affine sources of the block-scan design need block_rows.cuh
           beside them). The first batch's launches at -rl 256, -rl 400
           and 1500 bp in the long phase get the same comparison.
  long     long reads through `single` with the script's error model:
           8192 reads of 250 bp at -rl 256 and 8192 of 400 bp at -rl 400
           (the CLI's -b 1024), and 256 reads of 1500 bp with
           test_long_reads.py's options (-rl 1500 -d 160 -i 200 -dp 0.15
           -mrl 100, -b 64), where the DP and affine rows take the
           long-row kernels (a block a row). An untimed run of the first
           2 batches (for 1500 bp, the one run, whose first batch is
           replayed) keeps every launch, replayed bit for bit; the first
           batch's launches at -rl 256, -rl 400 and 1500 bp (their rows,
           plen and tlen spread printed) are timed as in the
           kernels phase. Fails unless every kernel launched, 98% of
           primary MAPQ >= 10 records lie within 30 bp, and on any launch
           that differs.
  options  `single -om 3 -omax 2` and `single -dp 0.1` on the first 16384
           reads of the sam phase: every read takes the non-fast
           (two-phase) path (branches' non_fast), reads/s, accuracy.
  bam      `single -so` to a .bam on the first 16384 of the sam phase's
           reads, in memory and
           through the -sm spill: the .bai is there, the port's BAM
           reader finds the records sorted, with the SAM run's count and
           names, the spill gives the same record bytes; the host's
           seconds in the sort and write (OutputWriter.close) and spills.
  threads  `single -t 4` on the first 16384 of the sam phase's reads:
           the range reader's batches aligned as they come, as snap_tpu
           aligns them. Fails unless the reader parsed every read, each
           has its primary record, 98% of primary MAPQ >= 10 records lie
           within 30 bp and every kernel launched; shows the records that
           differ from the -t 1 run's records of the same reads beside
           both runs' dp_overflow reads and phase-C steps (a batch's
           make-up decides both).
  apps     `daemon` on a Unix socket in a thread, on the card: `single`
           sent through `command` writes the direct run's SAM; `roc` on
           it; `tofastq` gives back the FASTQ's bytes and `single` on
           them the same records; `depth` on a 200 kbp index.
  hg38     the main paths at GRCh38 coordinates: the layout of GRCh38's
           25 primary contigs at their lengths with SNAP's 2000-base
           pads (3,088,338,401 bases, every location from 2^31 on past
           the int32 range), sequenced in four windows (chr1's first
           Mbp; 2 Mbp of chr13 centred on location 2^31; chr21 whole,
           the e2e genome; chrY's last Mbp) and N elsewhere, written as
           FASTA, indexed by `index` and loaded on the card (build and
           load seconds, host peak RSS, card peak memory). 16384 reads
           (a quarter from each window) and 64 more that straddle 2^31
           through `single` (an untimed run of the first 4096 replays
           its first 4 steps' and redo paths' launches bit for bit, then
           the timed run), `single -so` (the sorted, duplicate-marked BAM
           and .bai: sorted, and the SAM's records once sorted), 2048
           pairs and 64 straddling ones through `paired` (recorded run
           replayed, then timed). Fails unless 98% of primary MAPQ >= 10
           records lie on their contig within 30 bp of their position,
           overall and among the straddling reads.
  mesh     the multi-device path on one card (parallel/mesh.py), on
           the hg38 phase's index and inputs: `single -ishards 2` on
           its first 8192 reads (one card makes it a 1 x 1 mesh, as in
           snap_tpu: the resharded index, the monolithic mesh step, its
           dp_overflow redo), an untimed run whose first 4 steps' and
           redo paths' launches are replayed bit for bit, then a timed
           run (reads/s); align_winners_sharded on a data = 1 x index =
           2 mesh of cuda:0 twice on one 8192-read batch, every launch
           replayed, its winners on the first 1024 reads equal to the
           CPU mesh's bit for bit; the same step and batch with the
           index row across 2 processes (children of this script joined
           over gloo, each placing its own shard and the genome on
           cuda:0; nccl refuses two ranks on one card), each child's
           launches replayed, both ranks' winners equal to the
           one-process step's bit for bit; `paired -ishards 2` on 2048
           pairs, its first batches' launches replayed; BASELINE config
           5 in one run, `paired -ishards 2 -so` with cuda:0 listed 8
           times (data 4 x index 2) on those pairs plus 8% planted
           duplicates: SO:coordinate, the .bai, the mapped records
           sorted, every mapped record of a planted pair flagged 0x400,
           the sort-and-write seconds, its first batches' launches
           replayed. Fails unless every kernel launched on the mesh path
           and the runs meet the hg38 phase's accuracy.
  profile  the port's profiling tools (tools/profile_step_torch.py,
           profile_host_torch.py, profile_e2e_torch.py) on the card at
           their JAX twins' defaults (1 Mbp genome, seed 24, 100 bp
           reads), each run in this process with the launch counts set
           to 0 just before and read just after: the step's stages
           (device ms against wall ms) at 16384 reads and its pipelined
           rate at 16384, 32768 and 65536; the single-end host half of
           one 16384-read batch (submit, winners wait, finalize, emit,
           the reads of each host branch; cProfile's top rows), again on
           a 25%-repeat genome (PROFILE_RUNS says its cuts); the paired
           host half of 2048 pairs (_plan_pairs, the per-pair loop, the
           overflow redo, emit; cProfile), again on a 25%-repeat genome;
           FASTQ -> SAM of 2 x 16384 reads phase by phase (read, submit,
           winners wait, finalize, emit). One line a run, the tool's
           JSON under "result"; fails if a tool fails or if the step
           tool's run left a kernel unlaunched.
  bigidx   BASELINE config 4's tools (tools/build_big_index_torch.py,
           bench_big_torch.py) in this process: the chunked build of a
           0.02 Gbp genome under a budget of 4 banks (fails under 2),
           then 4 batches of 1024 reads through the bench on the card,
           the launch counts set to 0 just before and read just after
           (fails if a kernel was not launched). One line a tool run,
           its JSON under "result".
  agcigar  a timing aid for the emission AG CIGAR kernel
           (csrc/agcigar.cu): synthetic rows of one batch of
           ecoli.single250 (5,000 of 250 bp) and of ecoli.single (2,650
           of 100 bp), and 1,000 rows of 400 bp and 200 of 1,500 bp (the
           global plane's), on a random genome of E. coli's length: bit
           for bit against its plain version, device ms, one host
           round's call ms, the plain version's and the host's native
           row loop's ms, the bound. One line a shape. The kernel's
           launches on the main paths are counted by each run (the
           `agcigar` key of its launches), and those of the sam, hg38
           and mesh recording runs' first finalizes, the paired ones'
           first batches and the long runs' first batches are replayed
           against the plain version bit for bit like the other
           kernels'; the sam phase fails if its recording run launched
           none.
  card_vs_cpu  the first reads of the sam run (1024), the paired run
           (512 pairs), each long and options run (128; 16 at 1500 bp;
           512), the -t 4 run (1024), the hg38 phase's `single` (512:
           the straddling reads first), `single_fast` (512) and `paired`
           (256 pairs, the straddling ones first) and the mesh phase's
           `single -ishards 2` (512), `paired -ishards 2` (256 pairs) and
           Config 5 (256 pairs and 20 planted, a 4 x 2 mesh of the CPU:
           the BAMs' records),
           run on the card in their phase, again on the CPU: at most 2
           records differing, in MAPQ +-1 only; and the bigidx bench's
           first batch (1024), its packed winners equal bit for bit.
           The CPU runs go to a worker process on the upper half of the
           host's cores as each phase ends (CpuChecks), grouped by index
           so that each index is loaded to host memory once, and run
           while the card phases go on; the line comes when the last has
           ended.
Then a `seconds` line (each phase's wall seconds, and the wait for the
CPU checks after the kernels phase), one {"kernels": [...]}
line (per kernel: its launches in the timed -b 1024 FASTQ->SAM run, in
the timed paired run, in each run of the profile phase and in the
bigidx bench; the sums
over the launches of one 16384-read phase-C step of its device time,
its per-call time, its plain version's time and its bound; the launches
replayed; each long, options and mesh
run's launches and the daemon's; the hg38 and mesh runs' launches and
the launches they replayed; the sums over the first batch's launches at
-rl 256, -rl 400 and 1500 bp), the card's name and power limit, and as
the last line
{"ok": true, "device": {...}}.

Exits non-zero, printing no result, when there is no CUDA device or when
snap_tpu_torch is not beside this file. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
T_START = time.time()

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W): HBM
# bandwidth, and 67 TFLOP/s of float32 outside the tensor cores, which
# counts a fused multiply-add as two operations: one float32 add,
# multiply or conversion per FP32 lane per clock is half of it. An SM
# has half as many INT32 lanes as FP32 lanes (64 against 128, H100
# white paper), so integer operations, compares and selects run at a
# quarter of it.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2
INT32_OPS_PER_S = 67e12 / 4

# Operations that the plain recurrences (snap_tpu_torch/ops) do per
# cell, as (integer/compare/select, float32). Counted once per cell
# from each recurrence's elementwise steps; moving a column to its
# neighbour, masks that only matter outside the pattern, and work done
# once per row or per read are left out. The breakdown is in PERF.md.
DP_OPS_PER_CELL = (26, 7)      # ops/dp.py fitting_edit_distance_core_plain
AG_OPS_PER_CELL = (44, 7)      # ops/affine.py affine_extend_core_plain
# ops/agcigar_cuda.py ag_traceback_plain: score 6, m 1, F's scan term 4,
# F 2, H 2, the four traceback bits 13, E 1
AGTB_OPS_PER_CELL = 29
GL_OPS_PER_WORD = 11           # ops/gapless.py, per (read, candidate, word)
GL_OPS_PER_MISMATCH = (3, 1)   # find the set bit, add its ln P(error)

KERNEL_SOURCES = {
    "gapless_prescreen": (
        "snap_tpu_torch/csrc/gapless.cu",
        "snap_tpu/ops/gapless_pallas.py:98",
    ),
    "fitting_edit_distance": (
        "snap_tpu_torch/csrc/dp.cu",
        "snap_tpu/ops/dp_pallas.py:190",
    ),
    "affine_extend": (
        "snap_tpu_torch/csrc/affine.cu",
        "snap_tpu/ops/affine_pallas.py:261",
    ),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(phase: str, msg: str, code: int = 1) -> None:
    print(json.dumps({"phase": phase, "ok": False, "error": msg}),
          file=sys.stderr, flush=True)
    sys.exit(code)


def nvidia_smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of one fn() call between CUDA events on the
    current stream, after one warm-up call: the host's work inside fn
    counts whenever the card waits for it."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def device_ms(fn, per_graph: int = 50, reps: int = 5) -> float:
    """Median device milliseconds per fn() call: fn captured per_graph
    times in one CUDA graph, the graph replayed between CUDA events, so
    only the launches' device time (and the graph's gaps between them)
    is in the window. fn must launch on the current stream."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(per_graph):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / per_graph)
    del g
    return float(np.median(times))


def float_err(got, ref) -> float:
    """Largest absolute difference over the float outputs of two result
    tuples (their integer outputs are held equal separately)."""
    errs = [float((a.float() - b.float()).abs().max())
            for a, b in zip(outputs(got), outputs(ref))
            if a.dtype.is_floating_point and a.numel()]
    return max(errs, default=0.0)


def bound_ms(nbytes: float, int_ops: float, fp_ops: float) -> tuple[float, str]:
    """The least time for the work: bytes over HBM bandwidth, or the
    integer and float operations on their own lanes (which run side by
    side), whichever is longer."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = max(int_ops / INT32_OPS_PER_S, fp_ops / FP32_OPS_PER_S) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ------------------------------------------------------------ the kernels


def kernel_table() -> dict:
    """name -> (the pipeline's name for the wrapper it calls, or an
    (owner, name) pair for a wrapper called elsewhere, the kernel
    wrapper that counts launches, the kernel's plain version, a function
    turning the pipeline call's (args, kwargs) into the kernel
    wrapper's, and the wrapper's C launcher)."""
    from snap_tpu_torch.ops import (
        affine, affine_cuda, agcigar_cuda, dp, dp_cuda, gapless, gapless_cuda,
    )

    return {
        "gapless_prescreen": (
            "gapless_prescreen_cuda", gapless_cuda.gapless_prescreen_cuda,
            gapless.gapless_prescreen_plain, lambda a, kw: (a, {}),
            gapless_cuda.KERNEL,
        ),
        "fitting_edit_distance": (
            "fitting_edit_distance_cuda", dp_cuda.fitting_edit_distance_core_cuda,
            dp.fitting_edit_distance_core_plain,
            lambda a, kw: ((*a, kw["anchored"]), {}),
            dp_cuda.KERNEL,
        ),
        "affine_extend": (
            # the kernel computes the recurrence; the epilogue takes end_bonus
            "affine_extend_cuda", affine_cuda.affine_extend_core_cuda,
            affine.affine_extend_core_plain, lambda a, kw: (a[:6], kw),
            affine_cuda.KERNEL,
        ),
        # launched by the host's AG CIGAR batches (agcigar.compute_ag_cigar_batch)
        "agcigar": (
            (agcigar_cuda, "ag_traceback_cuda"), agcigar_cuda.ag_traceback_cuda,
            _ag_plain, _ag_args, agcigar_cuda.KERNEL,
        ),
    }


def _ag_args(a, kw):
    """ag_traceback_cuda's arguments with the genome cut to the rows'
    texts and each row's location moved into the cut (the kernel reads
    genome[loc : loc + T] only), so that a recorded launch keeps its
    rows' bytes and not the genome."""
    import torch

    genome, meta, pat, *rest = a
    T = meta[:, 3]
    start = torch.cumsum(T, 0) - T
    idx = (torch.arange(int(T.sum()), device=meta.device)
           + torch.repeat_interleave(meta[:, 2] - start, T))
    cut = meta.clone()
    cut[:, 2] = start
    return (genome[idx], cut, pat, *rest), kw


def _ag_plain(genome, meta, pat, R, groups, *scores):
    """ag_traceback_cuda's plain version on the CPU, its result back on
    the card."""
    from snap_tpu_torch.ops import agcigar_cuda

    return agcigar_cuda.ag_traceback_plain(
        genome.cpu(), meta.cpu(), pat.cpu(), R, *scores).to(meta.device)


def no_calls() -> dict:
    """Recorded launches by kernel, none yet."""
    return {name: [] for name in kernel_table()}


def ag_rows_key() -> tuple:
    """`recording`'s key for the host's calls of the AG CIGAR kernel
    (ops.agcigar_cuda.ag_traceback_rows, one a round of a batch's fixup
    loop)."""
    from snap_tpu_torch.ops import agcigar_cuda

    return (agcigar_cuda, "ag_traceback_rows")


@contextlib.contextmanager
def recording(calls: dict, inside: dict | None = None):
    """Within the block the pipeline's kernel wrappers run unchanged, and
    each call's inputs are cloned into calls[name] as the kernel
    wrapper's (args, kwargs). With `inside` (a pipeline function's name,
    or an (owner, name) pair for another function or method -> how many
    of its first calls to follow, None for all), only the launches made
    within those calls are kept. Blocks nest."""
    import torch

    from snap_tpu_torch.align import pipeline

    saved = {}
    depth = [0]
    for key, limit in (inside or {}).items():
        owner, fname = key if isinstance(key, tuple) else (pipeline, key)
        fn = saved[(owner, fname)] = getattr(owner, fname)

        def within(*a, _fn=fn, _limit=limit, _seen=[0], **kw):
            _seen[0] += 1
            follow = int(_limit is None or _seen[0] <= _limit)
            depth[0] += follow
            try:
                return _fn(*a, **kw)
            finally:
                depth[0] -= follow

        setattr(owner, fname, within)
    for name, (key, _, _, core, _) in kernel_table().items():
        owner, attr = key if isinstance(key, tuple) else (pipeline, key)
        fn = saved[(owner, attr)] = getattr(owner, attr)

        def rec(*a, _fn=fn, _name=name, _core=core, **kw):
            if depth[0] or not inside:
                args, kwargs = _core(a, kw)
                calls[_name].append((
                    tuple(x.clone() if torch.is_tensor(x) else x for x in args), kwargs,
                ))
            return _fn(*a, **kw)

        setattr(owner, attr, rec)
    try:
        yield
    finally:
        for (owner, attr), fn in saved.items():
            setattr(owner, attr, fn)


def tensor_bytes(xs) -> int:
    import torch

    return sum(x.numel() * x.element_size() for x in xs if torch.is_tensor(x))


def shape_of(name: str, args) -> dict:
    if name == "agcigar":
        meta = args[1]
        return {"rows": meta.shape[0], "L": int(meta[:, 1].max()), "T": int(meta[:, 3].max())}
    if name == "gapless_prescreen":
        return {"B": args[0].shape[0], "K": args[10]}
    return {"N": args[0].shape[0], "L": args[0].shape[1], "W": args[3].shape[1]}


def work_ops(name: str, args, got) -> tuple[float, float]:
    """(integer, float) operations that these inputs need."""
    if name == "agcigar":
        meta = args[1]
        return float((meta[:, 1].double() * meta[:, 3].double()).sum()) * AGTB_OPS_PER_CELL, 0.0
    if name == "gapless_prescreen":
        B, K, PW = args[0].shape[0], args[10], args[11]
        mism = float(got[0].sum())
        return (B * K * (GL_OPS_PER_WORD * PW + 1) + GL_OPS_PER_MISMATCH[0] * mism,
                GL_OPS_PER_MISMATCH[1] * mism)
    if name == "fitting_edit_distance":
        pat, plen, text = args[0], args[2], args[3]
        cells = float(plen.clamp(0, pat.shape[1]).sum()) * (text.shape[1] + 1)
        per = DP_OPS_PER_CELL
    else:
        pat, plen, text, tlen = args[0], args[2], args[3], args[4]
        cells = float((plen.clamp(0, pat.shape[1]).double()
                       * tlen.clamp(0, text.shape[1]).double()).sum())
        per = AG_OPS_PER_CELL
    return cells * per[0], cells * per[1]


OUTPUT_FIELDS = {
    "gapless_prescreen": ("dist", "logp_err"),
    "fitting_edit_distance": ("packed", "log_prob", "end_col"),
    "agcigar": ("runs",),
}


def outputs(x) -> tuple:
    """A kernel's outputs as a tuple (agcigar returns one tensor)."""
    import torch

    return (x,) if torch.is_tensor(x) else x


def differing(name: str, got, ref) -> list[str]:
    """The outputs in which the kernel's bits differ from the plain
    version's, with the count of differing elements."""
    import torch

    fields = getattr(got, "_fields", None) or OUTPUT_FIELDS[name]
    out = []
    for g, r, field in zip(outputs(got), outputs(ref), fields):
        gi, ri = g.contiguous().view(torch.int32), r.contiguous().view(torch.int32)
        if not torch.equal(gi, ri):
            out.append(f"{field} differs in {int((gi != ri).sum())} of {g.numel()}")
    return out


# ------------------------------------------------------------------ phases


def phase_device():
    import torch

    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "ok": True, "nvidia_smi": smi,
          "torch_name": name, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi, name


# The C launchers of the long-row kernels' block-scan design (one
# 256-thread block a row, state planes in scratch, csrc/block_rows.cuh):
# no row counter, and scratch of 6 (W + 1) (DP) or 9 L (affine) words
# for each of up to 4 blocks per SM. --baseline calls a source of that
# design this way; the port's wrappers call the row-wavefront launchers.
BLOCK_SCAN_BLOCKS_PER_SM = 4


def _block_scan_dp(lib: str):
    import ctypes

    import torch

    from snap_tpu_torch.ops import _build, dp

    fn = _build.Kernel(lib, "fitting_dp_launch",
                       [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])

    def call(pattern, pat_logq, plen, text, anchored):
        N, L = pattern.shape
        W = text.shape[1]
        dev = pattern.device
        blocks, scratch = 0, None
        if W + 1 > 512:
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            blocks = max(1, min(N, sms * BLOCK_SCAN_BLOCKS_PER_SM))
            scratch = torch.empty((blocks, 6, W + 1), dtype=torch.int32, device=dev)
        packed = torch.empty((N,), dtype=torch.int32, device=dev)
        lp = torch.empty((N,), dtype=torch.float32, device=dev)
        end = torch.empty((N,), dtype=torch.int32, device=dev)
        p = _build.ptr
        _build.check(fn(
            p(pattern), p(pat_logq), p(plen), p(text), p(packed), p(lp), p(end),
            N, L, W, int(bool(anchored)), dp.LOG_GAP_OPEN, dp.LOG_GAP_EXTEND, dp.NEG,
            None if scratch is None else p(scratch), blocks, _build.stream_ptr(dev),
        ), f"{lib}")
        return packed, lp, end

    return call


def _block_scan_affine(lib: str):
    import torch

    from snap_tpu_torch.constants import AG_GAP_EXTEND, AG_GAP_OPEN, AG_MATCH, AG_MISMATCH
    from snap_tpu_torch.ops import _build, affine, affine_cuda

    fn = _build.Kernel(lib, "affine_extend_launch", affine_cuda.KERNEL.argtypes)

    def call(pattern, pat_logq, plen, text, tlen, score_init, match=AG_MATCH,
             sub=AG_MISMATCH, gap_open=AG_GAP_OPEN, gap_extend=AG_GAP_EXTEND):
        N, L = pattern.shape
        T = text.shape[1]
        dev = pattern.device
        blocks, scratch = 0, None
        if L > 512:
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            blocks = max(1, min(N, sms * BLOCK_SCAN_BLOCKS_PER_SM))
            scratch = torch.empty((blocks, 9, L), dtype=torch.int32, device=dev)
        out_i = torch.empty((affine_cuda.plan_ints(N),), dtype=torch.int32, device=dev)
        out_f = torch.empty((N, 2), dtype=torch.float32, device=dev)
        p = _build.ptr
        _build.check(fn(
            p(pattern), p(pat_logq), p(plen), p(text), p(tlen), p(score_init),
            p(out_i), p(out_f), N, L, T, match, sub, gap_open + gap_extend, gap_extend,
            affine.LOG_GAP_OPEN, affine.LOG_GAP_EXTEND, affine.NEG_F,
            None if scratch is None else p(scratch), blocks, _build.stream_ptr(dev),
        ), f"{lib}")
        out_i = out_i[: 7 * N].view(N, 7)
        return affine.ExtendBest(
            out_i[:, 0], out_i[:, 1], out_f[:, 0], out_i[:, 2],
            out_i[:, 3], out_i[:, 4], out_i[:, 5], out_f[:, 1], out_i[:, 6],
        )

    return call


def baselines(directory: str | None) -> dict:
    """kernel name -> (the library name of its baseline source in
    `directory`, registered with the build, and a function with the
    kernel wrapper's signature that launches it), for those that have
    one. A DP or affine source of the block-scan design (it includes
    block_rows.cuh, which must lie beside it) goes through that design's
    launch convention, any other through the port's wrapper."""
    from snap_tpu_torch.ops import _build

    out = {}
    table = kernel_table()
    for name, (src, _) in (KERNEL_SOURCES.items() if directory else ()):
        path = os.path.join(directory, os.path.basename(src))
        if not os.path.exists(path):
            continue
        lib = os.path.basename(src)[: -len(".cu")] + "_baseline"
        _build.add_source(lib, path)
        with open(path) as f:
            block_scan = '#include "block_rows.cuh"' in f.read()
        if block_scan and name == "fitting_edit_distance":
            out[name] = (lib, _block_scan_dp(lib))
        elif block_scan and name == "affine_extend":
            out[name] = (lib, _block_scan_affine(lib))
        else:
            kern, launcher = table[name][1], table[name][4]

            def call(*a, _kern=kern, _launcher=launcher, _lib=lib, **kw):
                with _launcher.using(_lib):
                    return _kern(*a, **kw)

            out[name] = (lib, call)
    return out


def _demangle(names: list[str]) -> list[str]:
    """The C++ names of mangled symbols (c++filt), without the anonymous
    namespace and the parameter list; the mangled names where c++filt is
    missing."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return names
    if len(out) != len(names):
        return names
    short = []
    for d in out:
        d = d.replace("(anonymous namespace)::", "")
        depth = 0
        for i, ch in enumerate(d):  # cut at the parameter list's "("
            depth += ch == "<"
            depth -= ch == ">"
            if ch == "(" and depth == 0:
                d = d[:i]
                break
        short.append(d.removeprefix("void "))
    return short


def ptxas_functions(log: str) -> dict:
    """Per kernel function of an nvcc -Xptxas -v log: its registers, the
    bytes of its stack frame, spill stores and loads, and its static
    shared memory."""
    import re

    funcs, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = funcs.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", ln)
            cur["smem"] = int(s.group(1)) if s else 0
    return dict(zip(_demangle(list(funcs)), funcs.values()))


def phase_build(base: dict):
    from snap_tpu_torch.ops import _build

    names = (*_build.KERNELS, *(lib for lib, _ in base.values()))
    t0 = time.time()
    per = _build.build_all(names)
    secs = time.time() - t0
    ptxas = {n: ptxas_functions(_build.BUILD_LOG.get(n, "")) for n in names}
    emit({"phase": "build", "ok": True, "seconds": round(secs, 3),
          "per_kernel_s": {k: round(v, 3) for k, v in per.items()},
          "ptxas": ptxas,
          "spilling": {f"{n}: {f}": v["spill_stores"] for n, fs in ptxas.items()
                       for f, v in fs.items() if v.get("spill_stores")}})


def phase_kernels(calls: dict, base: dict) -> dict:
    """Each kernel launch of the main path's phase-C step again, on its
    own inputs: the kernel against its plain version, its device and
    per-call times, the plain version's time, and the launch's bound;
    with a baseline library, that kernel's outputs and device time on
    the same inputs, timed in turns with the kernel. Returns name ->
    per-launch rows."""
    summary = time_launches(calls, base)
    for name, rows in summary.items():
        emit({"phase": "kernels", "kernel": name, "ok": True, "launches": rows})
    return summary


def time_launches(calls: dict, base: dict | None = None, phase: str = "kernels",
                  plain_reps: int = 5) -> dict:
    """Each recorded launch again: the kernel against its plain version
    (bit for bit), its device time, per-call time, the plain version's
    time (median of plain_reps calls; for 0, the comparison call's own
    time, one call between CUDA events) and the launch's bound (and a
    baseline library's, see phase_kernels). Returns name -> per-launch
    rows."""
    import torch

    base = base or {}
    summary = {}
    for name, (_, kern, plain, _, _) in kernel_table().items():
        rows = []
        for args, kw in calls.get(name, ()):
            run = lambda: kern(*args, **kw)
            got = run()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            ref = plain(*args, **kw)
            ev[1].record()
            torch.cuda.synchronize()
            bad = differing(name, got, ref)
            if bad:
                fail(phase, f"{name}: " + "; ".join(bad))
            row = {"shape": shape_of(name, args), "max_abs_err": float_err(got, ref)}
            if name in base:
                run_b = lambda: base[name][1](*args, **kw)
                got_b = run_b()
                torch.cuda.synchronize()
                row["base_differs"] = differing(name, got_b, ref)
                t_b = [device_ms(run_b)]
                t_k = [device_ms(run), device_ms(run)]
                t_b.append(device_ms(run_b))
                row["base_ms"] = float(np.mean(t_b))
                row["ms"] = float(np.mean(t_k))
            else:
                row["ms"] = device_ms(run)
            row["call_ms"] = cuda_ms(run)
            row["plain_ms"] = (cuda_ms(lambda: plain(*args, **kw), plain_reps)
                               if plain_reps else ev[0].elapsed_time(ev[1]))
            nbytes = tensor_bytes(args) + tensor_bytes(outputs(got))
            int_ops, fp_ops = work_ops(name, args, got)
            bms, by = bound_ms(nbytes, int_ops, fp_ops)
            row.update({
                "bytes": nbytes, "int_ops": int_ops, "fp_ops": fp_ops,
                "bound_ms": bms, "bound_by": by,
            })
            rows.append(row)
        summary[name] = rows
    return summary


# The emission AG CIGAR rows of one batch of each cell whose batches
# send rows there: (read length, rows). ecoli.single250: ~31% of a
# 16,384-read batch; ecoli.single: ~2,650 rows of a 65,536-read batch
# (PERF.md section 5); and rows of -rl 400 and of 1500 bp reads, which
# no cell has (some in the global plane).
AGCIGAR_SHAPES = {"ecoli.single250": (250, 5_000), "ecoli.single": (100, 2_650),
                  "rl400": (400, 1_000), "rl1500": (1_500, 200)}


def agcigar_rows(rng, codes: np.ndarray, L: int, n: int):
    """n rows as align.single sends them to compute_ag_cigar_batch: a
    read body of L bases from the genome with 1% of positions redrawn,
    a third with a 1-3 bp indel and a few with a 1-6 base soft clip,
    and winner_record's text margin from its edit distance. Returns
    (meta [n, 4] int64, patterns uint8)."""
    from snap_tpu_torch.constants import MAX_K

    meta = np.empty((n, 4), np.int64)
    pats, off = [], 0
    for r in range(n):
        s = int(rng.integers(0, codes.size - L - 200))
        p = codes[s : s + L + 3].copy()
        red = rng.random(L) < 0.01
        p[: L][red] = rng.integers(0, 4, int(red.sum()))
        dist = int((p[:L] != codes[s : s + L]).sum())
        if r % 3 == 0:
            k, at = int(rng.integers(1, 4)), int(rng.integers(10, L - 10))
            p = (np.delete(p, slice(at, at + k)) if r % 2
                 else np.insert(p, at, rng.integers(0, 4, k).astype(np.uint8)))
            dist += k
        p = p[: L - (int(rng.integers(1, 7)) if r % 17 == 0 else 0)]
        T = len(p) + min(MAX_K, max(8, 2 * dist + 8))
        meta[r] = (off, len(p), s, T)
        pats.append(p)
        off += len(p)
    return meta, np.concatenate(pats).astype(np.uint8)


def phase_agcigar(seed: int) -> dict:
    """The emission AG CIGAR kernel (csrc/agcigar.cu) at each cell's
    shapes on a genome of E. coli's length: bit for bit against its plain
    version (on the CPU), its device time (CUDA graph replays), one host
    call of ops.agcigar_cuda.ag_traceback_rows (the upload, launch,
    download and synchronize of a round of the fixup loop), the plain
    version's time, the host's native row-at-a-time loop that it takes
    over (native.ag_traceback a row), and the bound."""
    import torch

    from snap_tpu_torch.align.agcigar import AG_MATCH, AG_MISMATCH, EXT, OPEN
    from snap_tpu_torch.io import native
    from snap_tpu_torch.ops import agcigar_cuda as K

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, 4_641_652).astype(np.uint8)
    g_card, g_cpu = torch.from_numpy(codes).cuda(), torch.from_numpy(codes)
    scores = (OPEN, EXT, AG_MATCH, AG_MISMATCH)
    out = {}
    for cell, (L, n) in AGCIGAR_SHAPES.items():
        meta, pat = agcigar_rows(rng, codes, L, n)
        order = np.argsort(K._order_keys(meta), kind="stable")
        meta = np.ascontiguousarray(meta[order])
        R, groups = K.launch_plan(meta)
        meta_d, pat_d = torch.from_numpy(meta).cuda(), torch.from_numpy(pat).cuda()
        run = lambda: K.ag_traceback_cuda(g_card, meta_d, pat_d, R, groups, *scores)
        before = K.ag_traceback_cuda.launches
        got = run().cpu().numpy()
        launches = K.ag_traceback_cuda.launches - before
        t0 = time.time()
        ref = K.ag_traceback_rows(g_cpu, meta, pat, *scores)
        plain_ms = (time.time() - t0) * 1e3
        bad = [r for r in range(n)
               if not np.array_equal(got[r, : 2 + got[r, 0]], ref[r, : 2 + ref[r, 0]])]
        if bad:
            fail("agcigar", f"{cell}: {len(bad)} of {n} rows differ from the plain "
                            f"version, first {bad[:5]}")
        t0 = time.time()
        for o, pl, loc, T in meta:
            native.ag_traceback(codes[loc : loc + T], pat[o : o + pl], *scores)
        host_ms = (time.time() - t0) * 1e3
        cells = int((meta[:, 1] * meta[:, 3]).sum())
        nbytes = int(meta[:, 1].sum() + meta[:, 3].sum() + meta.nbytes
                     + 4 * (ref[:, 0] + 2).sum())
        bms, by = bound_ms(nbytes, AGTB_OPS_PER_CELL * cells, 0)
        ms = device_ms(run)
        row = {"rows": n, "read_len": L, "launches": launches, "groups": len(groups),
               "cells": cells, "runs_mean": float(ref[:, 0].mean()),
               "ms": ms, "call_ms": cuda_ms(lambda: K.ag_traceback_rows(g_card, meta, pat, *scores)),
               "plain_ms": plain_ms, "host_native_ms": host_ms,
               "bytes": nbytes, "int_ops": AGTB_OPS_PER_CELL * cells,
               "bound_ms": bms, "bound_by": by, "x_bound": ms / bms,
               "smem": [g[3] for g in groups],
               "global_plane_rows": sum(g[1] - g[0] for g in groups if g[4])}
        emit({"phase": "agcigar", "ok": True, "cell": cell, **row})
        out[cell] = row
    return out


def launch_sums(rows: list) -> dict:
    """Sums over launches' rows (time_launches) of their times and
    bounds."""
    by_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    bound = sum(r["bound_ms"] for r in rows)
    out = {
        "launches": len(rows),
        "ms": sum(r["ms"] for r in rows),
        "call_ms": sum(r["call_ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": bound,
        "bound_by": "operations" if 2 * by_ops >= bound else "bytes",
        "max_abs_err": max((r["max_abs_err"] for r in rows), default=0.0),
    }
    if rows and all("base_ms" in r for r in rows):
        out["base_ms"] = sum(r["base_ms"] for r in rows)
        out["base_differs"] = [d for r in rows for d in r["base_differs"]]
    return out


# --------------------------------------------------------------- end to end

CHR21_BP = 46_709_983   # BASELINE config 3's reference length
READS, READ_LEN, MAX_LEN = 16384, 100, 128
CHECK_READS = 1024      # card-vs-CPU batch


REPEAT_CLASSES = ("unique", "sine", "line", "microsatellite")


def gen_repeat_genome(rng, glen: int, repeat_frac: float,
                      classes: np.ndarray | None = None) -> np.ndarray:
    """Synthetic genome with planted repeats (the model of bench.py's
    _gen_repeat_genome): ~300 bp SINE-like units with 1% divergence,
    6 kb LINE-like units, and tandem microsatellites, one family of
    each kind, copies in proportion to glen. With `classes` ([glen]
    uint8), each base's last planted kind is written there (an index of
    REPEAT_CLASSES); the draws are the same."""
    if classes is None:
        classes = np.zeros(glen, np.uint8)
    seq = rng.integers(0, 4, size=glen).astype(np.uint8)
    budget = int(glen * repeat_frac)
    alu = rng.integers(0, 4, size=300).astype(np.uint8)
    for _ in range(max(1, budget // 2 // 300)):
        p = int(rng.integers(0, glen - 300))
        u = alu.copy()
        d = rng.random(300) < 0.01
        u[d] = rng.integers(0, 4, int(d.sum()))
        seq[p : p + 300] = u
        classes[p : p + 300] = 1
    line = rng.integers(0, 4, size=6000).astype(np.uint8)
    for _ in range(max(1, budget // 2 // 6000)):
        p = int(rng.integers(0, glen - 6000))
        seq[p : p + 6000] = line
        classes[p : p + 6000] = 2
    for _ in range(max(1, glen // 20000)):
        unit = rng.integers(0, 4, size=4).astype(np.uint8)
        reps = int(rng.integers(20, 60))
        p = int(rng.integers(0, glen - 4 * reps))
        seq[p : p + 4 * reps] = np.tile(unit, reps)
        classes[p : p + 4 * reps] = 3
    return seq


def write_fasta(path: str, name: str, codes: np.ndarray, width: int = 100):
    write_fasta_contigs(path, [(name, codes)], width)


def write_fasta_contigs(path: str, contigs, width: int = 100):
    """A FASTA of (name, base codes) contigs, `width` bases a line."""
    from snap_tpu_torch.constants import BASE_DECODE

    decode = BASE_DECODE.tobytes().ljust(256, b"N")  # a bytes.translate table
    with open(path, "wb") as f:
        for name, codes in contigs:
            f.write(b">" + name.encode() + b"\n")
            text = np.frombuffer(np.ascontiguousarray(codes, np.uint8).tobytes()
                                 .translate(decode), np.uint8)
            full = text.shape[0] // width
            lines = np.empty((full, width + 1), np.uint8)
            lines[:, :width] = text[: full * width].reshape(full, width)
            lines[:, width] = ord("\n")
            f.write(lines)
            if text.shape[0] > full * width:
                f.write(text[full * width :].tobytes() + b"\n")


def simulate_reads(rng, codes: np.ndarray, contig_start: int, n: int, L: int,
                   starts: np.ndarray | None = None):
    """n reads of L bases: 1% substitutions, a 1-3 bp deletion or
    insertion in a quarter of them, half from the reverse strand, from
    `starts` (0-based positions in codes; drawn uniformly when None).
    Returns (codes [n, L] uint8, qual bytes [n, L] uint8, the genome
    location one past the sampled reference span [n] int64, the
    span's first base as a 0-based contig position [n] int64)."""
    reads = np.empty((n, L), np.uint8)
    true_end = np.empty(n, np.int64)
    span = L + 8
    if starts is None:
        starts = rng.integers(0, codes.size - span, n)
    for i in range(n):
        s = int(starts[i])
        r = codes[s : s + span].copy()
        used = L
        kind = i % 8
        if kind == 1:  # deletion from the read
            p, k = int(rng.integers(20, L - 20)), int(rng.integers(1, 4))
            r = np.delete(r, slice(p, p + k))
            used = L + k
        elif kind == 2:  # insertion into the read
            p, k = int(rng.integers(20, L - 20)), int(rng.integers(1, 4))
            r = np.insert(r, p, rng.integers(0, 4, k).astype(np.uint8))
            used = L - k
        r = r[:L]
        if rng.random() < 0.5:
            r = (3 - r)[::-1]
        reads[i] = r
        true_end[i] = contig_start + s + used
    mut = rng.random((n, L)) < 0.01
    reads = np.where(mut, rng.integers(0, 4, (n, L)), reads).astype(np.uint8)
    phred = np.clip(rng.normal(36, 5, (n, L)).round(), 2, 41).astype(np.uint8)
    return reads, phred + 33, true_end, starts.astype(np.int64)


def write_fastq(path: str, reads: np.ndarray, quals: np.ndarray, names=None):
    from snap_tpu_torch.constants import BASE_DECODE

    seqs = BASE_DECODE[reads]
    with open(path, "wb") as f:
        for i in range(reads.shape[0]):
            name = names[i] if names is not None else b"r%d" % i
            f.write(b"@%s\n%s\n+\n%s\n" % (name, seqs[i].tobytes(), quals[i].tobytes()))


def counted(run) -> tuple[object, dict]:
    """Run `run()` with every launch counter set to 0 just before, and
    return its result with the counts read just after."""
    import torch

    ws = {name: t[1] for name, t in kernel_table().items()}
    for w in ws.values():
        w.launches = 0
    out = run()
    if torch.cuda.is_initialized():  # a CPU check's worker never starts CUDA
        torch.cuda.synchronize()
    return out, {n: w.launches for n, w in ws.items()}


def profile_steps(step, n: int) -> dict:
    """torch.profiler over n adaptive steps: wall time, device busy
    time (the union of kernel intervals), and device time by op."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step().cpu()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step().cpu()
        wall = time.perf_counter() - t0
    kernels = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy, end = 0.0, -1.0
    for s, e in kernels:
        if e > end:
            busy += e - max(s, end)
            end = e
    ops = sorted(prof.key_averages(), key=lambda a: -a.self_device_time_total)
    return {
        "steps": n, "wall_ms_per_step": wall * 1e3 / n,
        "device_busy_ms_per_step": busy / 1e3 / n,
        "device_busy_share": busy / 1e6 / wall,
        "device_kernels_per_step": len(kernels) / n,
        "top_device_ops": [
            {"op": a.key, "ms_per_step": a.self_device_time_total / 1e3 / n,
             "calls_per_step": a.count / n}
            for a in ops[:12]
        ],
    }


def phase_e2e(seed: int, glen: int, workdir: str, profile: bool = False):
    """Returns the launch counts of the phase-C step and the inputs of
    each of its launches (name -> [(args, kwargs)])."""
    import torch

    from snap_tpu_torch.align.pipeline import (
        AlignParams,
        HostWinners,
        align_winners_device,
    )
    from snap_tpu_torch.genome import load_fasta
    from snap_tpu_torch.index.index import GenomeIndex
    from snap_tpu_torch.io.fastq import read_batches

    rng = np.random.default_rng(seed)
    t0 = time.time()
    codes = gen_repeat_genome(rng, glen, 0.25)
    fa = os.path.join(workdir, "ref.fa")
    write_fasta(fa, "chr21sim", codes)
    genome = load_fasta(fa)
    contig_start = genome.contigs[0].start
    if not np.array_equal(genome.bases[contig_start : contig_start + glen], codes):
        fail("e2e", "FASTA round trip changed the genome")
    t_gen = time.time() - t0

    # the index is built once, by the port's `index` command, and loaded
    from snap_tpu_torch.cli import main as cli_main

    idx_dir = os.path.join(workdir, "idx")
    t0 = time.time()
    if cli_main(["index", fa, idx_dir, "-s", "24"]) != 0:
        fail("e2e", "the index command failed")
    t_index = time.time() - t0
    t0 = time.time()
    idx = GenomeIndex.load(idx_dir, device="cuda")
    torch.cuda.synchronize()
    t_load = time.time() - t0
    index_bytes = sum(t.numel() * t.element_size() for t in idx.device)

    reads, quals, true_end, _ = simulate_reads(rng, codes, contig_start, READS, READ_LEN)
    fq = os.path.join(workdir, "reads.fq")
    write_fastq(fq, reads, quals)
    batch = next(read_batches(fq, batch_size=READS, max_len=MAX_LEN))
    if len(batch) != READS or not np.array_equal(batch.bases[:, :READ_LEN], reads):
        fail("e2e", "FASTQ round trip changed the reads")

    dev = torch.device("cuda")
    b = torch.from_numpy(batch.bases).to(dev)
    q = torch.from_numpy(batch.quals).to(dev)
    ln = torch.from_numpy(batch.lengths).to(dev)
    fas = torch.tensor(genome.first_alt_start(), dtype=torch.int64, device=dev)
    params = AlignParams(seed_len=24, max_probe=idx.max_probe)

    def step(phase_c=False, bb=b, qq=q, ll=ln, didx=idx.device):
        packed, _, _ = align_winners_device(
            didx, bb, qq, ll, fas.to(bb.device), params,
            adaptive=True, phase_c=phase_c,
        )
        return packed

    # the main path, counted: one adaptive step, then one with phase C
    # whose kernel inputs are kept for the kernels phase
    per_step = {"gapless_prescreen": 2, "fitting_edit_distance": 4, "affine_extend": 4,
                "agcigar": 0}
    per_step_c = {"gapless_prescreen": 3, "fitting_edit_distance": 6, "affine_extend": 6,
                  "agcigar": 0}
    torch.cuda.reset_peak_memory_stats()
    packed_ab, counts_ab = counted(lambda: step())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    calls = no_calls()
    with recording(calls):
        packed_c, counts_c = counted(lambda: step(phase_c=True))
    for want, got, what in ((per_step, counts_ab, "adaptive"),
                            (per_step_c, counts_c, "adaptive+phase C")):
        if got != want:
            fail("e2e", f"{what} step launched {got}, expected {want}")
    if {n: len(c) for n, c in calls.items()} != counts_c:
        fail("e2e", "recorded kernel calls do not match the launch counts")

    # accuracy: reads placed with MAPQ >= 10 end near where they were
    # sampled
    acc = {}
    for name, pk in (("adaptive", packed_ab), ("phase_c", packed_c)):
        w = HostWinners(pk)
        near = np.abs(w.end_loc - true_end) <= 30
        conf_all = w.found & (w.mapq >= 10)
        # rows flagged truncated or fallback are redone exactly on the
        # host; the device's answer is final for the others
        conf = conf_all & ~w.truncated & ~w.fallback
        share = float(near[conf].mean()) if conf.any() else 0.0
        acc[name] = {"mapq10_final_reads": int(conf.sum()), "within_30bp": share,
                     "mapq10_all_reads": int(conf_all.sum()),
                     "within_30bp_all": float(near[conf_all].mean()) if conf_all.any() else 0.0,
                     "found": int(w.found.sum()),
                     "truncated": int(w.truncated.sum()),
                     "fallback": int(w.fallback.sum())}
        if share < 0.98:
            fail("e2e", f"{name}: only {share:.4f} of MAPQ>=10 reads within 30 bp")

    # the same first reads on the card and on the CPU
    n = CHECK_READS
    sl = lambda t: t[:n].contiguous()
    card = step(bb=sl(b), qq=sl(q), ll=sl(ln)).cpu().numpy()
    t0 = time.time()
    cpu_idx = idx.on("cpu")
    cpu = step(bb=sl(b).cpu(), qq=sl(q).cpu(), ll=sl(ln).cpu(), didx=cpu_idx).numpy()
    t_cpu = time.time() - t0
    rows = np.flatnonzero((card != cpu).any(axis=1))
    diffs = [{"row": int(r), "card": card[r].tolist(), "cpu": cpu[r].tolist()}
             for r in rows]
    for r in rows:
        wc, wu = HostWinners(card[[r, -1]]), HostWinners(cpu[[r, -1]])
        same_but_mapq = np.array_equal(card[r, :5], cpu[r, :5]) and (
            (card[r, 5] & ~0xFF) == (cpu[r, 5] & ~0xFF))
        if r == n or not same_but_mapq or abs(int(wc.mapq[0]) - int(wu.mapq[0])) > 1:
            fail("e2e", f"card and CPU winners differ beyond MAPQ +-1: {diffs}")
    if len(rows) > 2:
        fail("e2e", f"{len(rows)} of {n} rows differ between card and CPU: {diffs}")

    # step rate, pipelined: step i+1 is queued before step i's winners
    # are fetched (bench.py's timing loop)
    step().cpu()
    n_steps = 8
    stamps = []
    t0 = time.perf_counter()
    nxt = step()
    for i in range(n_steps):
        cur = nxt
        if i + 1 < n_steps:
            nxt = step()
        cur.cpu()
        stamps.append(time.perf_counter())
    total = stamps[-1] - t0
    # the last interval only drains the queue: leave it out of the median
    step_s = np.diff([t0] + stamps)[:-1]
    med = float(np.median(step_s))
    res = {
        "phase": "e2e", "ok": True,
        "genome_bp": glen, "repeat_frac": 0.25,
        "genome_s": round(t_gen, 3), "index_build_s": round(t_index, 3),
        "index_load_s": round(t_load, 3),
        "index_device_bytes": index_bytes, "max_probe": idx.max_probe,
        "reads": READS, "read_len": READ_LEN, "max_len": MAX_LEN,
        "launches_adaptive": counts_ab, "launches_phase_c": counts_c,
        "accuracy": acc,
        "card_vs_cpu": {"reads": n, "rows_differ": len(rows), "diffs": diffs,
                        "cpu_s": round(t_cpu, 3)},
        "steps": n_steps,
        "step_ms_median": med * 1e3,
        "step_ms_all": [float(x * 1e3) for x in step_s],
        "reads_per_s": READS * n_steps / total,  # all steps over their total time
        "reads_per_s_median_step": READS / med,
        "peak_device_gb_adaptive_step": peak_gb,
    }
    if profile:
        res["profile"] = profile_steps(step, 3)
    emit(res)
    return counts_c, calls, {"codes": codes, "contig_start": contig_start,
                             "idx_dir": idx_dir}


# ------------------------------------------------------------ FASTQ -> SAM

SAM_READS = 65_536
SUB_READS = 16_384             # the first reads: the -b 16384, -so and -t 4 runs
SAM_RUNS = ((None, SAM_READS), (16_384, SUB_READS))  # (-b, reads) of each timed run
SAM_CHECK_READS = 1024         # card-vs-CPU SAM
SAM_RECORD_READS = 8 * 1024    # the untimed recording run's reads
# the device calls of the host redo paths: the wide redo of truncated and
# edge-indel rows (score_candidates, then score_rows in two_phase_merge)
# and the dp_overflow redo (align_tier1, then score_rows)
REDO_PATH = ("score_candidates", "score_rows", "align_tier1")
RECORD_STEPS = 4               # steps of the -b 1024 run whose launches are replayed
# where the host's seconds go in a run: methods of SingleEndAligner (the
# step's dispatch, the batch's padding and copy included, and the wait
# for its winners) and the pipeline calls of the redo paths (device work
# and its fetch)
TIMED_METHODS = ("_submit", "_fetch_winners")
TIMED_PIPELINE = ("align_tier1", "score_candidates", "two_phase_merge")


def sam_summary(path: str) -> dict:
    """Record and status counts of a SAM file whose read names end in
    _<true 1-based position>, and how many primary MAPQ >= 10 records lie
    within 30 bp of it."""
    out = {"records": 0, "primary": 0, "secondary_or_supplementary": 0,
           "unmapped": 0, "mapq_ge_10": 0, "mapq_lt_10": 0, "mapq10_within_30bp": 0}
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"@"):
                continue
            qname, flag, _, pos, mapq, _ = line.split(b"\t", 5)
            flag = int(flag)
            out["records"] += 1
            if flag & 0x900:
                out["secondary_or_supplementary"] += 1
                continue
            out["primary"] += 1
            if flag & 0x4:
                out["unmapped"] += 1
                continue
            if int(mapq) >= 10:
                out["mapq_ge_10"] += 1
                true = int(qname.rsplit(b"_", 1)[1])
                out["mapq10_within_30bp"] += abs(int(pos) - true) <= 30
            else:
                out["mapq_lt_10"] += 1
    out["within_30bp_share"] = out["mapq10_within_30bp"] / max(1, out["mapq_ge_10"])
    out["shares"] = {"all": out["within_30bp_share"]}
    return out


def sam_records(path: str) -> list[bytes]:
    """The records of a SAM file, or of a BAM file (bam_lines)."""
    if path.endswith(".bam"):
        return bam_lines(path)
    with open(path, "rb") as f:
        return [ln for ln in f.read().split(b"\n") if ln and not ln.startswith(b"@")]


def bam_lines(path: str) -> list[bytes]:
    """A BAM file's records in file order as SAM-like lines: QNAME FLAG
    RNAME POS MAPQ CIGAR RNEXT PNEXT TLEN SEQ QUAL, then the tags in hex."""
    from snap_tpu_torch.io.bam import read_bam

    _, refs, recs = read_bam(path)
    ref = lambda i: refs[i].encode() if i >= 0 else b"*"  # noqa: E731
    return [b"\t".join((
        r.qname, b"%d" % r.flag, ref(r.ref_id), b"%d" % (r.pos0 + 1), b"%d" % r.mapq,
        (r.cigar or "*").encode(), ref(r.next_ref_id), b"%d" % (r.next_pos0 + 1),
        b"%d" % r.tlen, r.seq or b"*", r.qual or b"*", r.tags.hex().encode(),
    )) for r in recs]


def card_vs_cpu(phase: str, card: list[bytes], cpu: list[bytes]) -> list[dict]:
    """The SAM records that differ between the card's run and the CPU's;
    fails unless they are at most 2 and differ in MAPQ by at most 1."""
    if len(card) != len(cpu):
        fail(phase, f"card wrote {len(card)} records, the CPU {len(cpu)}")
    diffs = []
    for a, b in zip(card, cpu):
        if a == b:
            continue
        fa, fb = a.split(b"\t"), b.split(b"\t")
        diffs.append({"card": a[:200].decode(), "cpu": b[:200].decode()})
        if fa[:4] + fa[5:] != fb[:4] + fb[5:] or abs(int(fa[4]) - int(fb[4])) > 1:
            fail(phase, f"card and CPU records differ beyond MAPQ +-1: {diffs}")
    if len(diffs) > 2:
        fail(phase, f"{len(diffs)} of {len(card)} records differ between card and CPU")
    return diffs


@contextlib.contextmanager
def timers(acc: dict, owners: list):
    """Within the block, the seconds spent in (and the calls of) each
    (owner, name) function of `owners` add up in acc[name] = [seconds,
    calls]: a perf_counter pair per call, a few hundred calls a run. A
    call made inside another timed function adds up in
    acc["<outermost>/<name>"] instead."""
    saved = []
    stack = []
    for owner, name in owners:
        fn = getattr(owner, name)
        acc.setdefault(name, [0.0, 0])

        def timed(*a, _fn=fn, _name=name, **kw):
            tally = acc.setdefault(f"{stack[0]}/{_name}" if stack else _name, [0.0, 0])
            stack.append(_name)
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                tally[0] += time.perf_counter() - t0
                tally[1] += 1
                stack.pop()

        saved.append((owner, name, fn))
        setattr(owner, name, timed)
    try:
        yield
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)


def run_cli(phase: str, argv: list[str], cls, entry: str, owners: list,
            device: str, devices=None) -> tuple[dict, object, dict]:
    """One command through the port's CLI entry point (on `devices`, a
    mesh's positions, when given), timed, with the
    kernels' launch counts and the native library's use set to 0 just
    before it and read just after, and the host's seconds in `owners`
    (timers). Returns (the common fields of the run, the `cls` aligner
    whose `entry` method ran, the timers' tallies)."""
    from snap_tpu_torch.cli import main as cli_main
    from snap_tpu_torch.io import native

    made = []
    run_entry = getattr(cls, entry)

    def keep(self, *a, **kw):
        made.append(self)
        return run_entry(self, *a, **kw)

    setattr(cls, entry, keep)
    used0 = dict(native.USED)
    acc = {}
    try:
        with timers(acc, owners):
            t0 = time.perf_counter()
            rc, launches = counted(lambda: cli_main(argv, device=device, devices=devices))
            wall = time.perf_counter() - t0
    finally:
        setattr(cls, entry, run_entry)
    if rc != 0:
        fail(phase, f"{' '.join(argv)} exited {rc}")
    aligner = made[-1]
    st = aligner.stats
    return {
        "argv": argv, "device": device, "wall_s": wall,
        "seconds_reading": st.seconds_reading,
        "seconds_aligning": st.seconds_aligning,
        "seconds_writing": st.seconds_writing,
        "align_seconds": st.align_seconds,
        "host_seconds": {name: {"s": s, "calls": n} for name, (s, n) in acc.items()},
        "status": {"total": st.total, "single": st.single, "multi": st.multi,
                   "not_found": st.not_found, "too_short": st.too_short,
                   "filtered": st.filtered},
        "branches": dict(aligner.branches),
        "launches": launches,
        "native_calls": {k: v - used0[k] for k, v in native.USED.items()},
    }, aligner, acc


def run_single(argv: list[str], device: str = "cuda", phase: str = "sam",
               owners: list | None = None) -> dict:
    """One `single` command through run_cli, with the host's seconds in
    the device step (its dispatch and the wait for its winners), in the
    redo paths' pipeline calls and in `owners`."""
    from snap_tpu_torch.align import pipeline, single

    from snap_tpu_torch.parallel import mesh

    owners = list(owners or [])
    owners += [(single.SingleEndAligner, n) for n in TIMED_METHODS]
    owners += [(pipeline, n) for n in TIMED_PIPELINE]
    steps = {"phase_c": 0, "without_phase_c": 0, "mesh": 0}
    step, mesh_step = pipeline.align_winners_device, mesh.align_winners_sharded

    def counted_step(*a, **kw):
        steps["phase_c" if kw.get("phase_c") else "without_phase_c"] += 1
        return step(*a, **kw)

    def counted_mesh_step(*a, **kw):
        steps["mesh"] += 1
        return mesh_step(*a, **kw)

    pipeline.align_winners_device = counted_step
    mesh.align_winners_sharded = counted_mesh_step
    try:
        run, aligner, acc = run_cli(phase, argv, single.SingleEndAligner, "align_file",
                                    owners, device)
    finally:
        pipeline.align_winners_device = step
        mesh.align_winners_sharded = mesh_step
    run["steps"] = steps
    run["mesh"] = None if aligner.mesh is None else dict(aligner.mesh.shape)
    step_s = acc["_submit"][0] + acc["_fetch_winners"][0]
    run.update({
        "step_s": step_s,
        "step_share_of_wall": step_s / run["wall_s"],
        "redo_calls_share_of_wall":
            sum(acc[n][0] for n in TIMED_PIPELINE) / run["wall_s"],
    })
    return run


def profile_single(argv: list[str], top: int = 30) -> dict:
    """One `single` command under cProfile: the host functions by
    cumulative and by own seconds. A wait for the card shows up in the
    function that synchronizes (a .cpu(), .numpy() or event wait)."""
    import cProfile
    import pstats

    from snap_tpu_torch.cli import main as cli_main

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    rc = cli_main(argv)
    prof.disable()
    wall = time.perf_counter() - t0
    if rc != 0:
        fail("sam", f"{' '.join(argv)} exited {rc} under cProfile")
    st = pstats.Stats(prof)

    def rows(key):
        items = sorted(st.stats.items(), key=lambda kv: -kv[1][key])[:top]
        return [{"fn": f"{os.path.relpath(f, HERE) if f.startswith(HERE) else f}:{ln}:{name}",
                 "calls": nc, "own_s": tt, "cum_s": ct}
                for (f, ln, name), (_, nc, tt, ct, _) in items]

    return {"argv": argv, "wall_s": wall, "by_cumulative": rows(3), "by_own": rows(2)}


def replay_launches(calls: dict, what: str, phase: str = "sam") -> dict:
    """Each recorded kernel launch again, on its inputs: the kernel
    against its plain version, bit for bit."""
    import torch

    out = {}
    for name, (_, kern, plain, _, _) in kernel_table().items():
        err = 0.0
        for args, kw in calls[name]:
            got = kern(*args, **kw)
            ref = plain(*args, **kw)
            torch.cuda.synchronize()
            bad = differing(name, got, ref)
            if bad:
                fail(phase, f"{name} launch from the {what}: " + "; ".join(bad))
            err = max(err, float_err(got, ref))
        out[name] = {"launches": len(calls[name]), "max_abs_err": err}
    return out


def phase_sam(seed: int, ctx: dict, workdir: str, profile: bool = False) -> dict:
    """Returns the timed -b 1024 run's launch counts and the replays of
    the recorded launches. With profile, another -b 1024 run under
    cProfile is reported in a sam_profile line."""
    from snap_tpu_torch.cli import _load_index_cached
    from snap_tpu_torch.io import native

    rng = np.random.default_rng(seed + 1)
    reads, quals, _, starts = simulate_reads(
        rng, ctx["codes"], ctx["contig_start"], SAM_READS, READ_LEN
    )
    names = [b"r%d_%d" % (i, s + 1) for i, s in enumerate(starts.tolist())]
    fq = os.path.join(workdir, "sam_reads.fq")
    write_fastq(fq, reads, quals, names)
    fq_sub = os.path.join(workdir, "sam_sub.fq")
    write_fastq(fq_sub, reads[:SUB_READS], quals[:SUB_READS], names[:SUB_READS])
    idx_dir = ctx["idx_dir"]
    t0 = time.time()
    _load_index_cached(idx_dir, "cuda")   # cached for the runs below
    load_s = time.time() - t0

    # an untimed run of the first SAM_RECORD_READS reads with the CLI's
    # defaults first: it keeps the inputs of every launch of the first
    # RECORD_STEPS steps and of every launch its redo paths make, and takes
    # the first-use costs off the timed runs
    step_calls = no_calls()
    redo_calls = no_calls()
    n_rec = SAM_RECORD_READS
    fq_rec = os.path.join(workdir, "sam_rec.fq")
    write_fastq(fq_rec, reads[:n_rec], quals[:n_rec], names[:n_rec])
    rec_out = os.path.join(workdir, "recorded.sam")
    t0 = time.time()
    with recording(step_calls, inside={"align_winners_device": RECORD_STEPS,
                                       ag_rows_key(): RECORD_STEPS}), \
            recording(redo_calls, inside=dict.fromkeys(REDO_PATH)):
        rec = run_single(["single", idx_dir, fq_rec, "-o", rec_out])
    replays = {"step": replay_launches(step_calls, "-b 1024 step"),
               "redo": replay_launches(redo_calls, "redo path")}
    del step_calls, redo_calls
    record_s = time.time() - t0
    if not (rec["launches"]["agcigar"] and replays["step"]["agcigar"]["launches"]):
        fail("sam", "the AG CIGAR kernel never ran in the recorded run's finalize: "
                    f"{rec['launches']}")

    runs = []
    for k, (b, n) in enumerate(SAM_RUNS):
        out = os.path.join(workdir, f"out{k}.sam")
        argv = (["single", idx_dir, fq if n == SAM_READS else fq_sub, "-o", out]
                + (["-b", str(b)] if b else []))
        r = run_single(argv)
        r["batch"], r["reads"] = b or 1024, n
        check_run("sam", f"-b {r['batch']}", r, out, n)
        runs.append(r)
    # the serial reader's first batches are the same reads in both runs
    rec_recs = sam_records(rec_out)
    recorded = {"reads": n_rec, "wall_s": rec["wall_s"], "launches": rec["launches"],
                "with_replays_s": record_s,
                "same_records_as_timed_run":
                    rec_recs == sam_records(os.path.join(workdir, "out0.sam"))[:len(rec_recs)]}
    if profile:
        out = os.path.join(workdir, "out_profile.sam")
        emit({"phase": "sam_profile", "ok": True,
              **profile_single(["single", idx_dir, fq, "-o", out])})

    # the first reads on the card; on the CPU in CpuChecks
    check = card_check("sam", "sam", lambda f, o: ["single", idx_dir, f, "-o", o], workdir,
                       reads, quals, names, SAM_CHECK_READS)

    emit({
        "phase": "sam", "ok": True, "reads": SAM_READS, "read_len": READ_LEN,
        "index_load_s": load_s, "runs": runs,
        "native_library": {"available": native.available(),
                           "sam_formatter": native.has_sam_formatter(),
                           "build_error": native.BUILD_ERROR},
        "recorded_run": recorded, "replays": replays,
    })
    return {"launches": runs[0]["launches"], "replays": replays, "fq": fq,
            "fq_sub": fq_sub,
            "sam": os.path.join(workdir, "out0.sam"), "run": runs[0],
            "reads": (reads, quals, names), "checks": [check]}

# ------------------------------------------------------- paired FASTQ -> SAM

PAIRS_DRAWN = 32_768           # pairs drawn (the draw of earlier calls kept)
PAIRS = 16_384                 # the first of them: the timed run
PAIRED_RECORD_PAIRS = 4_096    # the untimed recording run
PAIRED_RECORD_BATCHES = 4      # batches of it whose every launch is replayed
PAIRED_CHECK_PAIRS = 512       # card-vs-CPU SAM
# where the host's seconds go in a paired run: the device intersection
# (its wide tier and the overflow fetch included), the batch's scoring,
# and the two redo paths (their own scoring calls included)
PAIRED_METHODS = ("_device_intersect", "_redo_overflow_pairs", "_fix_edge_indels")
PAIRED_PIPELINE = ("score_candidates", "two_phase_merge")


def simulate_pairs(rng, codes: np.ndarray, n: int, L: int,
                   starts: np.ndarray | None = None):
    """n pairs of L-base ends from inserts drawn from normal(300, 30)
    clipped to [220, 600]: the first end forward from the fragment's
    start (`starts`, 0-based positions in codes; drawn uniformly when
    None), the second reverse complemented from its end, each with
    simulate_reads' errors (1% substitutions, a 1-3 bp deletion or
    insertion in a quarter of the ends, phred normal(36, 5)). Returns
    (ends [2, n, L] uint8, quals [2, n, L], the 1-based leftmost
    reference position of each end [2, n] int64)."""
    ends = np.empty((2, n, L), np.uint8)
    pos = np.empty((2, n), np.int64)
    inserts = np.clip(rng.normal(300, 30, n).round(), 220, 600).astype(np.int64)
    if starts is None:
        starts = rng.integers(0, codes.size - 700, n)
    for i in range(n):
        for e in range(2):
            kind = int(rng.integers(0, 8))
            used = L
            if kind in (1, 2):
                p, k = int(rng.integers(20, L - 20)), int(rng.integers(1, 4))
                used = L + k if kind == 1 else L - k
            s0 = int(starts[i]) if e == 0 else int(starts[i] + inserts[i]) - used
            r = codes[s0 : s0 + L + 8].copy()
            if kind == 1:  # deletion from the read
                r = np.delete(r, slice(p, p + k))
            elif kind == 2:  # insertion into the read
                r = np.insert(r, p, rng.integers(0, 4, k).astype(np.uint8))
            r = r[:L]
            ends[e, i] = r if e == 0 else (3 - r)[::-1]
            pos[e, i] = s0 + 1
    mut = rng.random(ends.shape) < 0.01
    ends = np.where(mut, rng.integers(0, 4, ends.shape), ends).astype(np.uint8)
    phred = np.clip(rng.normal(36, 5, ends.shape).round(), 2, 41).astype(np.uint8)
    return ends, phred + 33, pos


def paired_summary(path: str) -> dict:
    """Record and status counts of a paired SAM file whose pair names end
    in _<true position of end 1>_<of end 2>, how many primary MAPQ >= 10
    records lie within 30 bp of their end's, and the share of pairs
    flagged proper (0x2)."""
    out = {"records": 0, "primary": 0, "secondary_or_supplementary": 0,
           "unmapped": 0, "mapq_ge_10": 0, "mapq10_within_30bp": 0,
           "proper_pairs": 0, "pairs": 0}
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"@"):
                continue
            qname, flag, _, pos, mapq, _ = line.split(b"\t", 5)
            flag = int(flag)
            out["records"] += 1
            if flag & 0x900:
                out["secondary_or_supplementary"] += 1
                continue
            out["primary"] += 1
            if flag & 0x40:
                out["pairs"] += 1
                out["proper_pairs"] += bool(flag & 0x2)
            if flag & 0x4:
                out["unmapped"] += 1
                continue
            if int(mapq) >= 10:
                out["mapq_ge_10"] += 1
                true = int(qname.rsplit(b"_", 2)[1 if flag & 0x40 else 2])
                out["mapq10_within_30bp"] += abs(int(pos) - true) <= 30
    out["within_30bp_share"] = out["mapq10_within_30bp"] / max(1, out["mapq_ge_10"])
    out["proper_share"] = out["proper_pairs"] / max(1, out["pairs"])
    return out


def run_paired(argv: list[str], device: str = "cuda", phase: str = "paired",
               devices=None, owners: list = ()) -> dict:
    """One `paired` command through run_cli (on `devices` when given),
    with the host's seconds in the device intersection, the batch's
    scoring, the redo paths and `owners`, the pair counters of
    AlignerStats, and the card's peak memory in the run."""
    import torch

    from snap_tpu_torch.align import paired_driver, pipeline

    cls = paired_driver.PairedEndAligner
    owners = ([(cls, n) for n in PAIRED_METHODS] + [(pipeline, n) for n in PAIRED_PIPELINE]
              + list(owners))
    card = device != "cpu"
    if card:
        torch.cuda.reset_peak_memory_stats()
    run, aligner, acc = run_cli(phase, argv, cls, "align_files", owners, device, devices)
    wall = run["wall_s"]
    sec = lambda *names: sum(acc.get(n, [0.0])[0] for n in names)
    parts = {"intersect": sec("_device_intersect"), "scoring": sec(*PAIRED_PIPELINE),
             "redo": sec("_redo_overflow_pairs", "_fix_edge_indels")}
    st = aligner.stats
    run["status"].update(aligned_as_pairs=st.aligned_as_pairs,
                         intersect_wide_pairs=st.intersect_wide_pairs,
                         intersect_overflow_pairs=st.intersect_overflow_pairs)
    run["mesh"] = None if aligner.mesh is None else dict(aligner.mesh.shape)
    run.update({
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9 if card else None,
        **{f"{k}_s": v for k, v in parts.items()},
        "shares_of_wall": {k: v / wall for k, v in parts.items()},
    })
    return run


def phase_paired(seed: int, ctx: dict, workdir: str) -> dict:
    """Returns the timed run's launch counts and the replays of the
    recorded launches."""
    from snap_tpu_torch.align import paired_driver
    from snap_tpu_torch.cli import _load_index_cached
    from snap_tpu_torch.io import native

    t_phase = time.time()
    rng = np.random.default_rng(seed + 2)
    ends, quals, pos = simulate_pairs(rng, ctx["codes"], PAIRS_DRAWN, READ_LEN)
    names = [b"p%d_%d_%d" % (i, a, b) for i, (a, b) in enumerate(zip(*pos.tolist()))]

    def write_pairs(tag: str, n: int) -> tuple[str, str]:
        fqs = tuple(os.path.join(workdir, f"{tag}_{e + 1}.fq") for e in range(2))
        for e in range(2):
            write_fastq(fqs[e], ends[e, :n], quals[e, :n], names[:n])
        return fqs

    fq = write_pairs("pairs", PAIRS)
    idx_dir = ctx["idx_dir"]
    t0 = time.time()
    _load_index_cached(idx_dir, "cuda")   # cached for the runs below
    load_s = time.time() - t0

    # an untimed run on the first pairs: every launch of its first
    # batches and every launch of the two redo paths (the host overflow
    # redo, the edge-indel fix) kept and replayed against the plain
    # versions. The wide tier launches no kernel: its pairs are scored
    # by their batch's score_candidates and two_phase_merge.
    cls = paired_driver.PairedEndAligner
    batch_calls = no_calls()
    redo_calls = no_calls()
    fq_rec = write_pairs("rec", PAIRED_RECORD_PAIRS)
    with recording(batch_calls, inside={(cls, "align_batch"): PAIRED_RECORD_BATCHES}), \
            recording(redo_calls, inside={(cls, "_redo_overflow_pairs"): None,
                                          (cls, "_fix_edge_indels"): None}):
        rec = run_paired(["paired", idx_dir, *fq_rec, "-o", os.path.join(workdir, "prec.sam")])
    replays = {"batch": replay_launches(batch_calls, "paired batches", "paired"),
               "redo": replay_launches(redo_calls, "paired redo paths", "paired")}
    empty = [n for n in KERNEL_SOURCES if replays["batch"][n]["launches"] == 0]
    if empty:
        fail("paired", f"no launch of {empty} recorded in the first batches")

    out = os.path.join(workdir, "paired.sam")
    run = run_paired(["paired", idx_dir, *fq, "-o", out])
    run["pairs_per_s"] = PAIRS / run["wall_s"]
    run["reads_per_s"] = 2 * PAIRS / run["wall_s"]
    run["sam"] = summary = paired_summary(out)
    if summary["pairs"] != PAIRS or summary["primary"] != 2 * PAIRS:
        fail("paired", f"{summary['pairs']} pairs, {summary['primary']} primary records "
                       f"for {PAIRS} pairs")
    if summary["within_30bp_share"] < 0.98:
        fail("paired", f"only {summary['within_30bp_share']:.4f} of primary MAPQ >= 10 "
                       "records within 30 bp")
    missing = [n for n in KERNEL_SOURCES if run["launches"].get(n, 0) == 0]
    if missing:
        fail("paired", f"no launch of {missing} in the timed run: {run['launches']}")

    # the first pairs on the card; on the CPU in CpuChecks
    check = paired_card_check("paired", "paired",
                              lambda f1, f2, o: ["paired", idx_dir, f1, f2, "-o", o],
                              workdir, (ends, quals, names), PAIRED_CHECK_PAIRS)

    emit({
        "phase": "paired", "ok": True, "pairs": PAIRS, "read_len": READ_LEN,
        "index_load_s": load_s, "run": run,
        "native_library": {"available": native.available(),
                           "paired_formatter": native.has_paired_formatter(),
                           "build_error": native.BUILD_ERROR},
        "recorded_run": {"pairs": PAIRED_RECORD_PAIRS, "wall_s": rec["wall_s"],
                         "launches": rec["launches"], "branches": rec["branches"]},
        "replays": replays,
        "phase_s": time.time() - t_phase,
    })
    return {"launches": run["launches"], "replays": replays,
            "pairs_per_s": run["pairs_per_s"], "checks": [check]}


# --------------------------------------------- long reads, options, BAM, -t

# read length, -rl, reads drawn (one rng for every run: the -rl 256 run keeps
# the draw of 16,384 reads, so each run's reads stay those of earlier
# calls), reads run
LONG_RUNS = ((250, 256, 16_384, 8_192), (400, 400, 8_192, 8_192))
LONG_RECORD_BATCHES = 2        # batches of each recording run whose launches are replayed
LONG_CHECK_READS = 128         # card-vs-CPU SAM
XL_LEN, XL_READS, XL_BATCH, XL_CHECK_READS = 1500, 256, 64, 16
XL_REPLAY_BATCHES = 1          # batches of the 1500 bp run whose launches are replayed
XL_OPTS = ["-rl", "1500", "-d", "160", "-i", "200", "-dp", "0.15", "-mrl", "100"]
OPTION_RUNS = {"om": ["-om", "3", "-omax", "2"], "dp": ["-dp", "0.1"]}
OPTIONS_READS = 16_384
OPTIONS_CHECK_READS = 512
BAM_READS = SUB_READS          # the sam phase's first reads
BAM_SPILL_GB = "0.001"         # -sm: 1 MiB of records a sorted block, ~5 blocks
MIN_WITHIN_30BP = 0.98         # share of primary MAPQ >= 10 records near their origin


def recorded_run(phase: str, argv: list[str], batches: int):
    """One `single` command (run_single) with the inputs of every kernel
    launch of its first `batches` batches kept (their dispatch and their
    host finalization, redo paths included), and those of its first
    batch apart. Returns (run, calls, first-batch calls)."""
    from snap_tpu_torch.align.single import SingleEndAligner as cls

    calls = no_calls()
    first = no_calls()
    with recording(calls, inside={(cls, "_submit"): batches, (cls, "_finalize"): batches}), \
            recording(first, inside={(cls, "_submit"): 1, (cls, "_finalize"): 1}):
        run = run_single(argv, phase=phase)
    return run, calls, first


def check_run(phase: str, what: str, run: dict, out: str, n: int,
              summary=sam_summary) -> dict:
    """The truth summary of a run of n reads (`summary(out)`: its primary
    records, and per subset of them the share of MAPQ >= 10 records at
    their truth); fails unless every read has its primary record, each
    subset's share is MIN_WITHIN_30BP or more, and every kernel
    launched."""
    summ = summary(out)
    if summ["primary"] != n:
        fail(phase, f"{what}: {summ['primary']} primary records for {n} reads")
    for k, share in summ["shares"].items():
        if share < MIN_WITHIN_30BP:
            fail(phase, f"{what}: only {share:.4f} of {k} primary MAPQ >= 10 records "
                        f"at their truth: {summ}")
    missing = [k for k in KERNEL_SOURCES if run["launches"].get(k, 0) == 0]
    if missing:
        fail(phase, f"{what}: no launch of {missing}: {run['launches']}")
    run["reads_per_s"] = n / run["wall_s"]
    run["sam"] = summ
    return summ


def card_check(phase: str, tag: str, argv_of, workdir: str, reads, quals, names,
               n: int, submit=None) -> dict:
    """The first n reads through argv_of(fastq, out) on the card; the
    same on the CPU runs in CpuChecks (handed to `submit`, when given,
    before the card's run, so that the CPU's runs while the card's)."""
    fq1 = os.path.join(workdir, f"{tag}_check.fq")
    write_fastq(fq1, reads[:n], quals[:n], names[:n])
    o = os.path.join(workdir, f"{tag}_check_cuda.sam")
    o_cpu = os.path.join(workdir, f"{tag}_check_cpu.sam")
    check = {"phase": phase, "tag": tag, "reads": n, "cpu_argv": argv_of(fq1, o_cpu),
             "cpu_sam": o_cpu}
    if submit:
        submit([check])
    r = run_single(argv_of(fq1, o), phase=phase)
    check.update(card=sam_records(o), card_wall_s=r["wall_s"])
    return check


def paired_card_check(phase: str, tag: str, argv_of, workdir: str, pairs, n: int,
                      positions: int = 0, ext: str = ".sam", submit=None) -> dict:
    """The first n pairs (`pairs`: ends [2, P, L], quals, names) through
    argv_of(fastq 1, fastq 2, out) on the card (on the card listed
    `positions` times, when given: a mesh); the same on the CPU (the CPU
    as many times) runs in CpuChecks (handed to `submit`, when given,
    before the card's run). `ext` is the output's (.sam or .bam)."""
    import torch

    ends, quals, names = pairs
    fqs = [os.path.join(workdir, f"{tag}_check_{e + 1}.fq") for e in range(2)]
    for e in range(2):
        write_fastq(fqs[e], ends[e, :n], quals[e, :n], names[:n])
    o = os.path.join(workdir, f"{tag}_check_cuda{ext}")
    o_cpu = os.path.join(workdir, f"{tag}_check_cpu{ext}")
    check = {"phase": phase, "tag": tag, "reads": 2 * n, "paired": True,
             "positions": positions, "cpu_argv": argv_of(*fqs, o_cpu), "cpu_sam": o_cpu}
    if submit:
        submit([check])
    devices = [torch.device(CARD)] * positions if positions else None
    r = run_paired(argv_of(*fqs, o), phase=phase, devices=devices)
    check.update(card=sam_records(o), card_wall_s=r["wall_s"])
    return check


def launch_spread(calls: dict) -> dict:
    """Per kernel, each recorded launch's rows, widths, and the spread
    (min, quartiles, max) of plen (and tlen), the rows past 512 pattern
    columns (the long-row kernels' rows) and, for the affine, past
    BLOCK_COLS (the block kernel's); for the gapless prescreen its reads,
    candidates, positions and threads a pair; for the AG CIGAR kernel its
    rows, L and T, and the rows of its global plane."""
    from snap_tpu_torch.ops.affine_cuda import BLOCK_COLS
    from snap_tpu_torch.ops.agcigar_cuda import fits as agcigar_fits
    from snap_tpu_torch.ops.gapless_cuda import ONE_THREAD_L, split_threads

    q = lambda x: np.percentile(x.cpu().numpy(), [0, 25, 50, 75, 100]).tolist()
    out = {}
    for name, launches in calls.items():
        rows = []
        for args, _ in launches:
            if name == "agcigar":
                meta = args[1].cpu()
                rows.append({"rows": meta.shape[0], "L": q(meta[:, 1]), "T": q(meta[:, 3]),
                             "global_plane_rows": sum(
                                 not agcigar_fits(int(T), int(L)) for L, T in meta[:, [1, 3]])})
                continue
            if name == "gapless_prescreen":
                B, K, L = args[0].shape[0], args[10], args[6].shape[1]
                rows.append({"B": B, "K": K, "L": L, "threads_a_pair":
                             1 if L <= ONE_THREAD_L else split_threads(L, B * K)})
                continue
            pat, plen, text = args[0], args[2], args[3]
            r = {"N": pat.shape[0], "L": pat.shape[1], "W": text.shape[1], "plen": q(plen),
                 "rows_past_512": int((plen > 512).sum())}
            if name == "affine_extend":
                r["tlen"] = q(args[4])
                r["rows_past_block_cols"] = int((plen.clamp(0, pat.shape[1]) > BLOCK_COLS).sum())
            rows.append(r)
        out[name] = rows
    return out


def phase_long(seed: int, ctx: dict, workdir: str, base: dict) -> tuple[dict, list]:
    """`single` at -rl 256 (250 bp reads) and -rl 400 (400 bp) with the
    CLI's -b 1024, and 1500 bp reads with test_long_reads.py's options:
    an untimed recording run of the first batches (for the 1500 bp
    reads, whose run is short, the one run) whose launches are replayed
    bit for bit, then the timed run; the launches of the first batch at
    -rl 256, -rl 400 and 1500 bp timed like the kernels phase's. Returns
    the runs and the card-vs-CPU checks still to run on the CPU."""
    from snap_tpu_torch.cli import _load_index_cached

    rng = np.random.default_rng(seed + 3)
    idx_dir = ctx["idx_dir"]
    _load_index_cached(idx_dir, "cuda")
    runs, checks = {}, []
    for read_len, rl, drawn, n in (*LONG_RUNS, (XL_LEN, XL_LEN, XL_READS, XL_READS)):
        t_run = time.time()
        xl = read_len == XL_LEN
        tag = f"rl{rl}"
        reads, quals, _, starts = simulate_reads(rng, ctx["codes"], ctx["contig_start"],
                                                 drawn, read_len)
        reads, quals, starts = reads[:n], quals[:n], starts[:n]
        names = [b"l%d_%d" % (i, s + 1) for i, s in enumerate(starts.tolist())]
        fq = os.path.join(workdir, f"{tag}.fq")
        write_fastq(fq, reads, quals, names)
        opts = XL_OPTS if xl else ["-rl", str(rl)]
        bopt = ["-b", str(XL_BATCH)] if xl else []
        n_rec = n if xl else LONG_RECORD_BATCHES * 1024
        fq_rec = fq if xl else os.path.join(workdir, f"{tag}_rec.fq")
        if not xl:
            write_fastq(fq_rec, reads[:n_rec], quals[:n_rec], names[:n_rec])
        out_rec = os.path.join(workdir, f"{tag}_rec.sam")
        rec, calls, first = recorded_run(
            "long", ["single", idx_dir, fq_rec, "-o", out_rec, *opts, *bopt],
            XL_REPLAY_BATCHES if xl else LONG_RECORD_BATCHES)
        # at 1500 bp the replayed batches are the first batch, which
        # time_launches below holds to the plain versions bit for bit
        replays = None if xl else replay_launches(calls, f"{tag} batches", "long")
        del calls
        if xl:
            run, out = rec, out_rec
        else:
            out = os.path.join(workdir, f"{tag}.sam")
            run = run_single(["single", idx_dir, fq, "-o", out, *opts], phase="long")
        check_run("long", tag, run, out, n)
        spread = launch_spread(first)
        rows = time_launches(first, base, phase="long", plain_reps=0)
        timed = {k: launch_sums(v) for k, v in rows.items() if v}
        if xl:
            replays = {k: {"launches": len(v),
                           "max_abs_err": max((r["max_abs_err"] for r in v), default=0.0)}
                       for k, v in rows.items()}
        empty = [k for k in KERNEL_SOURCES if replays[k]["launches"] == 0]
        if empty:
            fail("long", f"{tag}: no launch of {empty} recorded in the first batches")
        n_chk = XL_CHECK_READS if xl else LONG_CHECK_READS
        argv_of = lambda f, o, opts=opts, n_chk=n_chk: (
            ["single", idx_dir, f, "-o", o, *opts, "-b", str(n_chk)])
        checks.append(card_check("long", tag, argv_of, workdir, reads, quals, names, n_chk))
        runs[tag] = {"read_len": read_len, "reads": n, "launches": run["launches"],
                     "replays": replays, "first_batch": timed}
        emit({"phase": "long", "ok": True, "run": tag, "read_len": read_len, "reads": n,
              "options": opts + bopt, "timed_run": run, "recorded_run": {
                  "reads": n_rec, "wall_s": rec["wall_s"], "launches": rec["launches"],
                  "batches_replayed": XL_REPLAY_BATCHES if xl else LONG_RECORD_BATCHES},
              "replays": replays, "first_batch_launches": timed,
              "first_batch_spread": spread,
              "run_s": time.time() - t_run})
    return runs, checks


def phase_options(ctx: dict, sam: dict, workdir: str) -> tuple[dict, list]:
    """`single -om 3 -omax 2` and `single -dp 0.1` on the first 16,384
    reads of the sam phase: every batch takes the non-fast (two-phase)
    path. Returns the runs and the card-vs-CPU checks still to run."""
    from snap_tpu_torch.cli import _load_index_cached

    idx_dir = ctx["idx_dir"]
    _load_index_cached(idx_dir, "cuda")
    reads, quals, names = sam["reads"]
    n = OPTIONS_READS
    fq = os.path.join(workdir, "options.fq")
    write_fastq(fq, reads[:n], quals[:n], names[:n])
    runs, checks = {}, []
    for name, opts in OPTION_RUNS.items():
        out = os.path.join(workdir, f"options_{name}.sam")
        run = run_single(["single", idx_dir, fq, "-o", out, *opts], phase="options")
        check_run("options", name, run, out, n)
        if run["branches"].get("non_fast") != n:
            fail("options", f"{name}: the non-fast path took {run['branches'].get('non_fast')} "
                            f"of {n} reads")
        argv_of = lambda f, o, opts=opts: (
            ["single", idx_dir, f, "-o", o, *opts, "-b", str(OPTIONS_CHECK_READS)])
        checks.append(card_check("options", name, argv_of, workdir, reads, quals, names,
                                 OPTIONS_CHECK_READS))
        runs[name] = {"launches": run["launches"], "reads_per_s": run["reads_per_s"]}
        emit({"phase": "options", "ok": True, "run": name, "options": opts, "reads": n,
              "timed_run": run})
    return runs, checks


def bam_body(path: str) -> bytes:
    """The decompressed records of a BAM file, its header skipped."""
    from snap_tpu_torch.io.bgzf import decompress_all

    with open(path, "rb") as f:
        data = decompress_all(f.read())
    p = 8 + int.from_bytes(data[4:8], "little")
    n_ref = int.from_bytes(data[p : p + 4], "little")
    p += 4
    for _ in range(n_ref):
        p += 8 + int.from_bytes(data[p : p + 4], "little")
    return data[p:]


def phase_bam(ctx: dict, sam: dict, workdir: str) -> dict:
    """`single -so` to a .bam on the first BAM_READS of the sam phase's
    reads, in memory and through the -sm spill: the .bai is written, the port's BAM reader
    finds the records sorted, with the SAM run's count and names, and
    the spill gives the in-memory run's record bytes. The host's seconds
    in OutputWriter.close (sort, duplicate marking, BAM and .bai write)
    and in the spills."""
    from snap_tpu_torch.cli import _load_index_cached
    from snap_tpu_torch.io import output
    from snap_tpu_torch.io.bam import read_bam

    idx_dir = ctx["idx_dir"]
    _load_index_cached(idx_dir, "cuda")
    names = sam["reads"][2]
    fq = sam["fq_sub"]
    sam_names = sorted(names[:BAM_READS])
    owners = [(output.OutputWriter, "close"), (output.OutputWriter, "_spill_block")]
    res = {}
    for name, extra in (("sorted", []), ("spill", ["-sm", BAM_SPILL_GB])):
        out = os.path.join(workdir, f"{name}.bam")
        run = run_single(["single", idx_dir, fq, "-o", out, "-so", *extra],
                         phase="bam", owners=owners)
        if not os.path.exists(out + ".bai"):
            fail("bam", f"{name}: no .bai beside the BAM")
        _, _, recs = read_bam(out)
        keys = [(r.ref_id if r.ref_id >= 0 else 1 << 30, r.pos0) for r in recs]
        if keys != sorted(keys):
            fail("bam", f"{name}: the BAM records are not sorted")
        if sorted(r.qname for r in recs) != sam_names:
            fail("bam", f"{name}: {len(recs)} BAM records, not the {len(sam_names)} reads' names")
        hs = run["host_seconds"]
        spills = hs.get("_spill_block", {}).get("calls", 0) + hs.get(
            "close/_spill_block", {}).get("calls", 0)
        if name == "spill" and spills < 2:
            fail("bam", f"the -sm {BAM_SPILL_GB} run spilled {spills} blocks")
        res[name] = {
            "wall_s": run["wall_s"], "reads_per_s": BAM_READS / run["wall_s"],
            "records": len(recs), "duplicates": sum(1 for r in recs if r.flag & 0x400),
            "unmapped": sum(1 for r in recs if r.ref_id < 0),
            "sort_and_write_s": hs.get("close", {}).get("s"),
            "spill_s": hs.get("_spill_block", {}).get("s", 0.0), "spilled_blocks": spills,
            "seconds_writing": run["seconds_writing"], "bam_bytes": os.path.getsize(out),
            "bai_bytes": os.path.getsize(out + ".bai"),
        }
    body = {k: bam_body(os.path.join(workdir, f"{k}.bam")) for k in res}
    if body["spill"] != body["sorted"]:
        fail("bam", "the spilled BAM's records differ from the in-memory sort's")
    bai = {k: open(os.path.join(workdir, f"{k}.bam.bai"), "rb").read() for k in res}
    res["spill_same_record_bytes"] = True
    res["spill_same_bai_bytes"] = bai["spill"] == bai["sorted"]
    emit({"phase": "bam", "ok": True, "reads": BAM_READS, **res})
    return res


THREADS = 4
THREADS_READS = SUB_READS      # the sam phase's first reads
THREADS_CHECK_READS = 1024     # card-vs-CPU SAM of -t 4


def phase_threads(ctx: dict, sam: dict, workdir: str) -> list:
    """`single -t 4` on the first THREADS_READS reads of the sam phase.
    The parse threads' range batches are aligned as they come, as
    snap_tpu aligns them, so where a batch-level path (the DP tier's
    overflow, the phase-C switch) turns on a batch's make-up the records
    may differ from the sam phase's -t 1 run's records of the same
    reads: they are counted and shown beside both runs' dp_overflow
    reads and phase-C steps (the -t 1 run's over all SAM_READS reads).
    Fails unless the range reader parsed every read, each has its
    primary record, 98% of MAPQ >= 10 records lie within 30 bp and every
    kernel launched. Returns the card-vs-CPU check of its first reads
    still to run."""
    idx_dir = ctx["idx_dir"]
    out = os.path.join(workdir, "t4.sam")
    run = run_single(["single", idx_dir, sam["fq_sub"], "-o", out, "-t", str(THREADS)],
                     phase="threads")
    if run["branches"].get("reader_range_split") != THREADS_READS:
        fail("threads", f"the -t {THREADS} reader parsed {run['branches']}")
    check_run("threads", f"t{THREADS}", run, out, THREADS_READS)

    def by_name(path):
        recs = {}
        for ln in sam_records(path):
            recs.setdefault(ln.split(b"\t", 1)[0], []).append(ln)
        return recs

    t4 = by_name(out)
    t1 = {k: v for k, v in by_name(sam["sam"]).items() if k in t4}
    differ = sorted(k for k in t1.keys() | t4.keys() if t1.get(k) != t4.get(k))
    t1_run = sam["run"]
    res = {
        "wall_s": run["wall_s"], "reads_per_s": run["reads_per_s"],
        "records_differ_from_t1": len(differ),
        "differing_records": [{"t1": b"\n".join(t1.get(k, [])).decode(),
                               f"t{THREADS}": b"\n".join(t4.get(k, [])).decode()}
                              for k in differ[:5]],
        "dp_overflow": {"t1": t1_run["branches"].get("dp_overflow", 0),
                        f"t{THREADS}": run["branches"].get("dp_overflow", 0)},
        "steps": {"t1": t1_run["steps"], f"t{THREADS}": run["steps"]},
        "batches": {"t1": t1_run["branches"].get("batches"),
                    f"t{THREADS}": run["branches"].get("batches")},
        "t1_reads": SAM_READS,
        "branches": run["branches"], "sam": run["sam"],
    }
    emit({"phase": "threads", "ok": True, "reads": THREADS_READS, **res})
    reads, quals, names = sam["reads"]
    argv_of = lambda f, o: ["single", idx_dir, f, "-o", o, "-t", str(THREADS)]
    return [card_check("threads", f"t{THREADS}", argv_of, workdir, reads, quals, names,
                       THREADS_CHECK_READS)]


# ---------------------------------------------------- GRCh38 coordinates

# GRCh38's primary assembly in its FASTA order, with each contig's length
# (GCA_000001405.15, chr1-22, X, Y, M). SNAP's layout puts 2,000 pad
# bases before each contig and after the last: 3,088,338,401 bases, of
# which every location from 2^31 (70,414,666 bp into chr13) on is past
# the int32 range.
HG38_CONTIGS = (
    ("chr1", 248_956_422), ("chr2", 242_193_529), ("chr3", 198_295_559),
    ("chr4", 190_214_555), ("chr5", 181_538_259), ("chr6", 170_805_979),
    ("chr7", 159_345_973), ("chr8", 145_138_636), ("chr9", 138_394_717),
    ("chr10", 133_797_422), ("chr11", 135_086_622), ("chr12", 133_275_309),
    ("chr13", 114_364_328), ("chr14", 107_043_718), ("chr15", 101_991_189),
    ("chr16", 90_338_345), ("chr17", 83_257_441), ("chr18", 80_373_285),
    ("chr19", 58_617_616), ("chr20", 64_444_167), ("chr21", 46_709_983),
    ("chr22", 50_818_468), ("chrX", 156_040_895), ("chrY", 57_227_415),
    ("chrM", 16_569),
)
HG38_PAD = 2000
HG38_BP = sum(n for _, n in HG38_CONTIGS) + HG38_PAD * (len(HG38_CONTIGS) + 1)
TWO31 = 1 << 31
HG38_WINDOW_BP = 1_000_000     # windows (a) and (d); (b) is twice as long
HG38_STRADDLE = 64             # reads (and pairs) placed across 2^31


def hg38_starts() -> dict:
    """Each contig's first absolute location in SNAP's layout."""
    out, pos = {}, 0
    for name, n in HG38_CONTIGS:
        pos += HG38_PAD
        out[name] = pos
        pos += n
    return out


def hg38_windows(seed: int, chr21: np.ndarray) -> list:
    """The sequenced windows of the layout, as (contig, 0-based contig
    offset, codes): (a) chr1's first 1 Mbp, (b) 2 Mbp of chr13 centred
    on absolute 2^31, (c) chr21 from its start (`chr21`: the e2e
    genome, the whole of chr21 at the default length), (d) chrY's last
    1 Mbp; (a), (b) and (d) from the same 25%-repeat model."""
    rng = np.random.default_rng(seed + 8)
    w = HG38_WINDOW_BP
    b_off = TWO31 - hg38_starts()["chr13"] - w
    return [
        ("chr1", 0, gen_repeat_genome(rng, w, 0.25)),
        ("chr13", b_off, gen_repeat_genome(rng, 2 * w, 0.25)),
        ("chr21", 0, chr21),
        ("chrY", dict(HG38_CONTIGS)["chrY"] - w, gen_repeat_genome(rng, w, 0.25)),
    ]


def write_hg38_fasta(path: str, windows: list) -> None:
    """The layout's FASTA: every contig at its GRCh38 length, N outside
    the windows."""
    by_contig = {}
    for name, off, codes in windows:
        by_contig.setdefault(name, []).append((off, codes))

    def contigs():
        for name, n in HG38_CONTIGS:
            seq = np.full(n, 4, np.uint8)
            for off, codes in by_contig.get(name, []):
                seq[off : off + codes.size] = codes
            yield name, seq

    write_fasta_contigs(path, contigs())


def hg38_reads(rng, windows: list, n: int, L: int):
    """HG38_STRADDLE reads whose span starts 1-99 bp before 2^31, then n
    reads, a quarter from each window, in a random order. Names end in
    _<contig>_<1-based position>; the straddling ones start with s.
    Returns (reads, quals, names)."""
    starts = hg38_starts()
    name_b, off_b, codes_b = windows[1]
    st = TWO31 - rng.integers(1, 100, HG38_STRADDLE) - starts[name_b] - off_b
    r0, q0, _, s0 = simulate_reads(rng, codes_b, starts[name_b] + off_b,
                                   HG38_STRADDLE, L, starts=st)
    names = [b"s%d_%s_%d" % (i, name_b.encode(), off_b + p + 1)
             for i, p in enumerate(s0.tolist())]
    rest = []
    for name, off, codes in windows:
        r, q, _, s = simulate_reads(rng, codes, starts[name] + off, n // len(windows), L)
        rest += [(r[i], q[i], b"%s_%d" % (name.encode(), off + p + 1))
                 for i, p in enumerate(s.tolist())]
    order = rng.permutation(len(rest))
    reads = np.concatenate([r0, np.stack([rest[i][0] for i in order])])
    quals = np.concatenate([q0, np.stack([rest[i][1] for i in order])])
    names += [b"h%d_%s" % (k, rest[i][2]) for k, i in enumerate(order)]
    return reads, quals, names


def hg38_pairs(rng, windows: list, n: int, L: int):
    """HG38_STRADDLE pairs whose fragment starts 180-240 bp before 2^31
    (the first end wholly below it, the second across it or above it),
    then n pairs, a quarter from each window, in a random order. Names
    end in _<contig>_<end 1's position>_<end 2's>; the straddling ones
    start with q. Returns (ends [2, m, L], quals, names).

    Window (b) of the default seed holds a 210 bp (GGCT)n microsatellite
    at 2^31 + 93; an end wholly inside it has equally good placements
    4 bp apart (both packages put such ends 36-44 bp off, MAPQ 70), so
    the fragments start early enough that second ends seldom lie wholly
    inside it at the inserts' spread."""
    name_b, off_b, codes_b = windows[1]
    st = TWO31 - rng.integers(180, 241, HG38_STRADDLE) - hg38_starts()[name_b] - off_b
    e0, q0, p0 = simulate_pairs(rng, codes_b, HG38_STRADDLE, L, starts=st)
    names = [b"q%d_%s_%d_%d" % (i, name_b.encode(), off_b + a, off_b + b)
             for i, (a, b) in enumerate(zip(*p0.tolist()))]
    rest = []
    for name, off, codes in windows:
        e, q, p = simulate_pairs(rng, codes, n // len(windows), L)
        rest += [(e[:, i], q[:, i], b"%s_%d_%d" % (name.encode(), off + a, off + b))
                 for i, (a, b) in enumerate(zip(*p.tolist()))]
    order = rng.permutation(len(rest))
    ends = np.concatenate([e0, np.stack([rest[i][0] for i in order], axis=1)], axis=1)
    quals = np.concatenate([q0, np.stack([rest[i][1] for i in order], axis=1)], axis=1)
    names += [b"p%d_%s" % (k, rest[i][2]) for k, i in enumerate(order)]
    return ends, quals, names


def hg38_summary(path: str) -> dict:
    """Primary records of a SAM file whose read names end in the true
    _<contig>_<position> (single) or _<contig>_<pos 1>_<pos 2> (paired,
    the 0x40 end takes pos 1), for all reads and for the ones placed
    across 2^31 (names starting with s or q): primary, unmapped, MAPQ >=
    10, and how many MAPQ >= 10 records lie on their contig within 30 bp
    of their position."""
    out = {k: {"primary": 0, "unmapped": 0, "mapq_ge_10": 0, "mapq10_at_truth": 0}
           for k in ("all", "straddle")}
    for ln in sam_records(path):
        qname, flag, rname, pos, mapq, _ = ln.split(b"\t", 5)
        flag = int(flag)
        if flag & 0x900:
            continue
        f = qname.split(b"_")
        if len(f) == 4:  # a pair's name: <id>_<contig>_<pos 1>_<pos 2>
            true_rname, true_pos = f[1], int(f[2] if flag & 0x40 else f[3])
        else:
            true_rname, true_pos = f[1], int(f[2])
        for k in ("all", "straddle") if qname[:1] in b"sq" else ("all",):
            o = out[k]
            o["primary"] += 1
            if flag & 0x4:
                o["unmapped"] += 1
            elif int(mapq) >= 10:
                o["mapq_ge_10"] += 1
                o["mapq10_at_truth"] += (rname == true_rname
                                         and abs(int(pos) - true_pos) <= 30)
    for o in out.values():
        o["at_truth_share"] = o["mapq10_at_truth"] / max(1, o["mapq_ge_10"])
    out["primary"] = out["all"]["primary"]
    out["shares"] = {k: out[k]["at_truth_share"] for k in ("all", "straddle")}
    return out


HG38_READS = 16_384            # single-end reads beside the HG38_STRADDLE straddling ones
HG38_PAIRS = 2_048             # pairs beside the straddling ones
HG38_RECORD_READS = 4_096      # the untimed recording run: its first RECORD_STEPS steps
HG38_CHECK_READS = 512         # card-vs-CPU SAM: the straddling reads and the next 448
HG38_FAST_READS = 512          # the fast-path run: the straddling reads and 448 of chr21
HG38_CHECK_PAIRS = 256         # card-vs-CPU SAM: the straddling pairs and the next 192


def peak_rss_gb() -> float:
    """This process's peak resident set so far."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def bam_vs_sam(bam: str, sam: str) -> dict:
    """Fails unless the .bai is there, the BAM's records are sorted, and
    they are the SAM's records once sorted (the duplicate flag aside)."""
    from snap_tpu_torch.io.bam import read_bam

    if not os.path.exists(bam + ".bai"):
        fail("hg38", "-so: no .bai beside the BAM")
    _, refs, recs = read_bam(bam)
    if refs != [n for n, _ in HG38_CONTIGS]:
        fail("hg38", f"-so: the BAM's references are {refs}")
    keys = [(r.ref_id if r.ref_id >= 0 else 1 << 30, r.pos0) for r in recs]
    if keys != sorted(keys):
        fail("hg38", "-so: the BAM records are not sorted")
    fields = lambda qn, fl, rn, pos, mq, cig: (qn, int(fl) & ~0x400, rn, int(pos), int(mq), cig)
    from_bam = sorted(fields(r.qname, r.flag, refs[r.ref_id] if r.ref_id >= 0 else "*",
                             r.pos0 + 1, r.mapq, r.cigar or "*") for r in recs)
    from_sam = sorted(fields(f[0], f[1], f[2].decode(), f[3], f[4], f[5].decode())
                      for f in (ln.split(b"\t", 6) for ln in sam_records(sam)))
    if from_bam != from_sam:
        bad = next(i for i, (a, b) in enumerate(zip(from_bam, from_sam)) if a != b)
        fail("hg38", f"-so: {len(from_bam)} BAM records, {len(from_sam)} SAM records; "
                     f"first difference {from_bam[bad]} against {from_sam[bad]}")
    return {"records": len(recs), "duplicates": sum(1 for r in recs if r.flag & 0x400),
            "contigs_with_records": len({r.ref_id for r in recs if r.ref_id >= 0}),
            "bam_bytes": os.path.getsize(bam), "bai_bytes": os.path.getsize(bam + ".bai")}


def phase_hg38(seed: int, ctx: dict, sam: dict, paired: dict, workdir: str) -> tuple:
    """The main paths at GRCh38 coordinates: the hg38 layout's FASTA
    (chr21 the e2e genome) through `index`, loaded on the card, then
    `single` (an untimed run of the first HG38_RECORD_READS reads whose
    step and redo-path launches are replayed bit for bit, then the timed
    run), `single` on the straddling reads and chr21's in one batch that
    must keep the fast path, `single -so` on the recorded run's reads
    (its sorted BAM and .bai held to that run's records), `paired` (as
    `single`). Returns (the runs' launches and replays,
    the inputs for the mesh phase, the card-vs-CPU checks still to run
    on the CPU)."""
    import torch

    from snap_tpu_torch.align import paired_driver
    from snap_tpu_torch.cli import _load_index_cached
    from snap_tpu_torch.cli import main as cli_main
    from snap_tpu_torch.io import output

    t_phase = time.time()
    res, runs, replays, checks = {}, {}, {}, []
    windows = hg38_windows(seed, ctx["codes"])
    fa = os.path.join(workdir, "hg38.fa")
    t0 = time.time()
    write_hg38_fasta(fa, windows)
    res["fasta_s"], res["fasta_bytes"] = time.time() - t0, os.path.getsize(fa)
    idx_dir = os.path.join(workdir, "hg38_idx")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    if cli_main(["index", fa, idx_dir, "-s", "24"]) != 0:
        fail("hg38", "the index command failed")
    res["index_build_s"] = time.time() - t0
    res["index_build_peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["peak_rss_gb_after_build"] = peak_rss_gb()
    os.remove(fa)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    idx = _load_index_cached(idx_dir, "cuda")
    torch.cuda.synchronize()
    res["index_load_s"] = time.time() - t0
    res["peak_rss_gb_after_load"] = peak_rss_gb()
    g = idx.genome_meta
    if g.num_bases != HG38_BP or [(c.name, c.length) for c in g.contigs] != list(HG38_CONTIGS):
        fail("hg38", f"the index holds {g.num_bases} bases in {len(g.contigs)} contigs")
    starts = hg38_starts()
    for name, off, codes in windows:
        s = starts[name] + off
        if not np.array_equal(g.bases[s : s + codes.size], codes):
            fail("hg38", f"the {name} window at {s} did not come back from the index")
    res["index_device_bytes"] = sum(t.numel() * t.element_size() for t in idx.device)
    res["hits"], res["max_probe"] = int(idx._host_arrays["hits"].shape[0]), idx.max_probe

    # single: an untimed recording run, then the timed run of every read
    rng = np.random.default_rng(seed + 10)
    reads, quals, names = hg38_reads(rng, windows, HG38_READS, READ_LEN)
    n = reads.shape[0]
    fq = os.path.join(workdir, "hg38.fq")
    write_fastq(fq, reads, quals, names)
    fq_rec = os.path.join(workdir, "hg38_rec.fq")
    k = HG38_RECORD_READS
    write_fastq(fq_rec, reads[:k], quals[:k], names[:k])
    step_calls = no_calls()
    redo_calls = no_calls()
    with recording(step_calls, inside={"align_winners_device": RECORD_STEPS,
                                       ag_rows_key(): RECORD_STEPS}), \
            recording(redo_calls, inside=dict.fromkeys(REDO_PATH)):
        rec = run_single(["single", idx_dir, fq_rec, "-o", os.path.join(workdir, "hg38_rec.sam")],
                         phase="hg38")
    replays["single_step"] = replay_launches(step_calls, "hg38 steps", "hg38")
    replays["single_redo"] = replay_launches(redo_calls, "hg38 redo paths", "hg38")
    del step_calls, redo_calls
    out = os.path.join(workdir, "hg38.sam")
    run = run_single(["single", idx_dir, fq, "-o", out], phase="hg38")
    check_run("hg38", "single", run, out, n, hg38_summary)
    runs["single"] = {"launches": run["launches"], "reads_per_s": run["reads_per_s"],
                      "chr21_sam_reads_per_s": sam["run"]["reads_per_s"]}
    emit({"phase": "hg38", "ok": True, "run": "single", "reads": n, **res,
          "recorded_run": {"reads": k, "wall_s": rec["wall_s"], "launches": rec["launches"]},
          "replays": {r: replays[r] for r in ("single_step", "single_redo")},
          "timed_run": run, "chr21_sam_reads_per_s": sam["run"]["reads_per_s"]})
    argv_of = lambda f, o: ["single", idx_dir, f, "-o", o]
    checks.append(card_check("hg38", "hg38_single", argv_of, workdir, reads, quals, names,
                             HG38_CHECK_READS))

    # the fast path past 2^31: the straddling reads in one batch with
    # chr21's, which the DP tier holds (the other windows' repeat families
    # overflow it: PERF.md §6), so every record of the run, the straddlers'
    # among them, comes from the device step's winners (_finalize_fast)
    pick = [i for i in range(n) if i < HG38_STRADDLE or b"_chr21_" in names[i]]
    pick = pick[:HG38_FAST_READS]
    fq_fast = os.path.join(workdir, "hg38_fast.fq")
    write_fastq(fq_fast, reads[pick], quals[pick], [names[i] for i in pick])
    fast_out = os.path.join(workdir, "hg38_fast.sam")
    fast = run_single(["single", idx_dir, fq_fast, "-o", fast_out], phase="hg38")
    check_run("hg38", "single_fast", fast, fast_out, len(pick), hg38_summary)
    br = fast["branches"]
    if br.get("dp_overflow", 0) or br.get("batches") != 1 or not br.get("planned", 0):
        fail("hg38", f"single_fast: the straddling reads' batch left the fast path "
                     f"(dp_overflow, or no native SAM plan): {dict(br)}")
    runs["single_fast"] = {"launches": fast["launches"], "branches": dict(br)}
    emit({"phase": "hg38", "ok": True, "run": "single_fast", "reads": len(pick),
          "timed_run": fast})
    o_cpu = os.path.join(workdir, "hg38_fast_cpu.sam")
    checks.append({"phase": "hg38", "tag": "hg38_single_fast", "reads": len(pick),
                   "cpu_argv": ["single", idx_dir, fq_fast, "-o", o_cpu], "cpu_sam": o_cpu,
                   "card": sam_records(fast_out), "card_wall_s": fast["wall_s"]})

    # -so on the recording run's reads: the sorted, duplicate-marked BAM
    # with its .bai, held to that run's SAM
    bam = os.path.join(workdir, "hg38.bam")
    so = run_single(["single", idx_dir, fq_rec, "-o", bam, "-so"], phase="hg38",
                    owners=[(output.OutputWriter, "close")])
    so_res = bam_vs_sam(bam, os.path.join(workdir, "hg38_rec.sam"))
    runs["single_so"] = {"launches": so["launches"], "reads_per_s": k / so["wall_s"]}
    emit({"phase": "hg38", "ok": True, "run": "single_so", "reads": k, **so_res,
          "wall_s": so["wall_s"], "reads_per_s": k / so["wall_s"],
          "sort_and_write_s": so["host_seconds"].get("close", {}).get("s"),
          "launches": so["launches"]})

    # paired: an untimed recording run, then the timed run
    ends, pquals, pnames = hg38_pairs(rng, windows, HG38_PAIRS, READ_LEN)
    m = ends.shape[1]
    fqs = tuple(os.path.join(workdir, f"hg38_{e + 1}.fq") for e in range(2))
    for e in range(2):
        write_fastq(fqs[e], ends[e], pquals[e], pnames)
    cls = paired_driver.PairedEndAligner
    batch_calls = no_calls()
    redo_calls = no_calls()
    with recording(batch_calls, inside={(cls, "align_batch"): PAIRED_RECORD_BATCHES}), \
            recording(redo_calls, inside={(cls, "_redo_overflow_pairs"): None,
                                          (cls, "_fix_edge_indels"): None}):
        prec = run_paired(["paired", idx_dir, *fqs, "-o", os.path.join(workdir, "hg38_prec.sam")],
                          phase="hg38")
    replays["paired_batch"] = replay_launches(batch_calls, "hg38 paired batches", "hg38")
    replays["paired_redo"] = replay_launches(redo_calls, "hg38 paired redo paths", "hg38")
    del batch_calls, redo_calls
    pout = os.path.join(workdir, "hg38_paired.sam")
    prun = run_paired(["paired", idx_dir, *fqs, "-o", pout], phase="hg38")
    check_run("hg38", "paired", prun, pout, 2 * m, hg38_summary)
    prun["pairs_per_s"] = m / prun["wall_s"]
    runs["paired"] = {"launches": prun["launches"], "pairs_per_s": prun["pairs_per_s"],
                      "chr21_paired_pairs_per_s": paired["pairs_per_s"]}
    emit({"phase": "hg38", "ok": True, "run": "paired", "pairs": m,
          "recorded_run": {"wall_s": prec["wall_s"], "launches": prec["launches"]},
          "replays": {r: replays[r] for r in ("paired_batch", "paired_redo")},
          "timed_run": prun, "chr21_paired_pairs_per_s": paired["pairs_per_s"]})
    checks.append(paired_card_check(
        "hg38", "hg38_paired", lambda f1, f2, o: ["paired", idx_dir, f1, f2, "-o", o],
        workdir, (ends, pquals, pnames), HG38_CHECK_PAIRS))
    res["phase_s"] = time.time() - t_phase
    res["peak_rss_gb"] = peak_rss_gb()
    res["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "hg38", "ok": True, "run": "summary", **res})
    return ({"runs": runs, "replays": replays, **res},
            {"idx_dir": idx_dir, "reads": (reads, quals, names),
             "pairs": (ends, pquals, pnames)}, checks)


# -------------------------------------------------------------- multi-device

CARD = "cuda"                  # the mesh and apps phases' device (the cached index's)
MESH_READS = 8_192             # `single -ishards 2` and the direct index = 2 step (hg38)
MESH_RECORD_STEPS = 4          # mesh steps of the recording run whose launches are replayed
MESH_CHECK_READS = 1024        # card-vs-CPU winners of the direct index = 2 step
MESH_SAM_CHECK_READS = 512     # card-vs-CPU SAM of `single -ishards 2`
MESH_PAIRS = 2_048             # `paired -ishards 2` (hg38)
MESH_CHECK_PAIRS = 256         # card-vs-CPU SAM of it, and of Config 5's BAM
MESH_PROCS = 2                 # processes of the index = 2 step across processes
MESH_PROCS_TIMEOUT = 300       # seconds the processes may take together
CONFIG5_POSITIONS = 8          # cuda:0 listed 8 times: -ishards 2 makes it data 4 x index 2
CONFIG5_DUP_FRAC = 0.08        # planted duplicate pairs (tools/demo_config5.py's --dup-frac)


def plant_duplicate_pairs(pairs, n: int, seed: int = 5):
    """The first n pairs (`pairs`: ends [2, P, L], quals, names) and
    int(CONFIG5_DUP_FRAC * n) of them again under new names (dup<k>_ and
    the source's truth fields: the same bases and qualities), as
    tools/demo_config5.py plants PCR duplicates. Returns the pairs tuple
    and the source pair of each duplicate."""
    ends, quals, names = pairs
    src = np.random.default_rng(seed).choice(n, size=int(n * CONFIG5_DUP_FRAC), replace=False)
    take = np.concatenate([np.arange(n), src])
    new = [b"dup%d%s" % (k, names[i][names[i].index(b"_"):]) for k, i in enumerate(src)]
    return (ends[:, take], quals[:, take], list(names[:n]) + new), src


def config5_bam_checks(path: str, src) -> dict:
    """Config 5's BAM: SO:coordinate, its .bai, the mapped records in
    coordinate order, and every mapped record of a planted duplicate
    (named dup<k>_) flagged 0x400 unless its source pair is itself a
    duplicate of another pair by chance (both ends' contig, position and
    strand alike). Fails otherwise; returns the counts."""
    from snap_tpu_torch.io.bam import read_bam

    if not os.path.exists(path + ".bai"):
        fail("mesh", "config5: no .bai beside the BAM")
    header, _, recs = read_bam(path)
    if "SO:coordinate" not in header:
        fail("mesh", "config5: the BAM's header has no SO:coordinate")
    placed = [(r.ref_id, r.pos0) for r in recs if not r.flag & 0x4]
    if placed != sorted(placed):
        fail("mesh", "config5: the mapped records are not in coordinate order")
    ends = {}
    for r in recs:
        if not r.flag & 0x900:
            ends.setdefault(r.qname, []).append(
                (r.flag & 0x40, r.ref_id, r.pos0, bool(r.flag & 0x10)))
    by_place = {}
    for name, v in ends.items():
        if not name.startswith(b"dup"):
            by_place.setdefault(tuple(sorted(v)), []).append(name)
    planted = [r for r in recs if r.qname.startswith(b"dup") and not r.flag & 0x900]
    chance = {r.qname for r in planted
              if len(by_place.get(tuple(sorted(ends[r.qname])), ())) > 1}
    unflagged = [r.qname.decode() for r in planted if not r.flag & 0x4
                 and not r.flag & 0x400 and r.qname not in chance]
    if unflagged:
        fail("mesh", f"config5: {len(unflagged)} mapped records of planted duplicates "
                     f"not flagged 0x400, first {unflagged[:5]}")
    return {"records": len(recs), "planted_pairs": len(src),
            "planted_records": len(planted),
            "planted_flagged": sum(1 for r in planted if r.flag & 0x400),
            "planted_unmapped": sum(1 for r in planted if r.flag & 0x4),
            "planted_of_chance_duplicates": len(chance),
            "duplicates": sum(1 for r in recs if r.flag & 0x400),
            "bam_bytes": os.path.getsize(path), "bai_bytes": os.path.getsize(path + ".bai")}


def mesh_child(rank: int, port: int, d: str) -> None:
    """One process of run (4): joins a gloo group of MESH_PROCS, places
    the index = 2 mesh's position it owns (shard `rank` and the genome,
    on the card), runs align_winners_sharded on the job's batch with its
    kernel launches counted and recorded, replays them against the plain
    versions, and writes its winners and a JSON report into `d`."""
    import torch
    import torch.distributed as dist

    from snap_tpu_torch.align.pipeline import AlignParams
    from snap_tpu_torch.parallel import mesh

    with open(os.path.join(d, "job.json")) as f:
        job = json.load(f)
    # a share of the lower half of the host's cores each (CpuChecks' worker
    # holds the upper half): torch's threads spinning on shared cores slow
    # a host step by orders of magnitude
    cores = sorted(os.sched_getaffinity(0))
    lower = cores[:max(1, len(cores) // 2)]
    per = max(1, len(lower) // MESH_PROCS)
    os.sched_setaffinity(0, lower[rank * per:(rank + 1) * per] or lower)
    torch.set_num_threads(per)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=MESH_PROCS)
    dev = torch.device(job["device"])
    m = mesh.Mesh([[dev] * MESH_PROCS], ranks=[list(range(MESH_PROCS))])
    t0 = time.time()
    arrays = {k: np.load(os.path.join(d, f"{k}.npy"), mmap_mode="r") for k in ("table", "hits")}
    sh = mesh.sharded_device_index(arrays, np.load(job["genome"], mmap_mode="r"), m)
    place_s = time.time() - t0
    tb, tq, tl = (torch.from_numpy(np.load(os.path.join(d, f"{k}.npy"))).to(dev)
                  for k in ("bases", "quals", "lens"))
    params = AlignParams(**job["params"])

    def step():
        return mesh.align_winners_sharded(sh, tb, tq, tl, job["fas"], params, m)[0]

    calls = no_calls()
    with recording(calls):
        packed, launches = counted(step)
    acc = {}
    with timers(acc, [(mesh, "_row_columns")]):  # the gather over the row's ranks
        t0 = time.perf_counter()
        step().cpu()
        wall = time.perf_counter() - t0
    replays = replay_launches(calls, f"rank {rank}'s index = 2 step", "mesh")
    np.save(os.path.join(d, f"winners{rank}.npy"), packed.cpu().numpy())
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump({"launches": launches, "replays": replays, "place_s": place_s,
                   "step_wall_s": wall, "gather_s": acc["_row_columns"][0],
                   "columns": list(m.local_cols[0]),
                   "shards_placed": sorted(j for _, j in sh.shards)}, f)
    dist.destroy_process_group()


def mesh_procs(workdir: str, arrays: dict, genome_path: str, b, q, lens, fas: int,
               params, want) -> dict:
    """Run (4): align_winners_sharded on a data 1 x index 2 mesh whose
    row spans MESH_PROCS processes (ranks ((0, 1))), each a child of this
    script on the card, joined over gloo (nccl refuses two ranks on one
    card), on run (2)'s resharded index and batch. Their output goes to
    files, never to this script's stdout. Fails unless each exits 0
    within MESH_PROCS_TIMEOUT and returns `want` (run (2)'s one-process
    winners) bit for bit; returns the children's reports."""
    import socket

    d = os.path.join(workdir, "mesh_procs")
    os.makedirs(d, exist_ok=True)
    t0 = time.time()
    for k, a in (("table", arrays["table"]), ("hits", arrays["hits"]),
                 ("bases", b), ("quals", q), ("lens", lens)):
        np.save(os.path.join(d, f"{k}.npy"), a)
    with open(os.path.join(d, "job.json"), "w") as f:
        json.dump({"genome": genome_path, "fas": int(fas), "device": CARD,
                   "params": {"seed_len": params.seed_len, "max_probe": params.max_probe}}, f)
    write_s = time.time() - t0
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [HERE] + [x for x in os.environ.get("PYTHONPATH", "").split(os.pathsep) if x]))
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(k, None)
    logs = [open(os.path.join(d, f"log{r}.txt"), "w") for r in range(MESH_PROCS)]
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--mesh-child",
         str(r), str(port), d], env=env, stdout=logs[r], stderr=subprocess.STDOUT,
        stdin=subprocess.DEVNULL) for r in range(MESH_PROCS)]
    try:
        rcs = [p.wait(timeout=max(1.0, MESH_PROCS_TIMEOUT - (time.time() - t0)))
               for p in procs]
    except subprocess.TimeoutExpired:
        rcs = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    procs_s = time.time() - t0

    def tail(r: int) -> str:
        with open(os.path.join(d, f"log{r}.txt")) as f:
            return f.read()[-1500:]

    if rcs is None or any(rcs):
        fail("mesh", f"index = 2 across processes: exit codes {rcs}; "
                     + " | ".join(f"rank {r}: {tail(r)}" for r in range(MESH_PROCS)))
    reports = []
    for r in range(MESH_PROCS):
        got = np.load(os.path.join(d, f"winners{r}.npy"))
        rows = np.flatnonzero((got != want).any(axis=1)) if got.shape == want.shape else None
        if rows is None or rows.size:
            fail("mesh", f"index = 2 across processes: rank {r}'s winners differ from the "
                         f"one-process step's ({got.shape} against {want.shape}), rows "
                         f"{None if rows is None else rows[:5].tolist()}")
        with open(os.path.join(d, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    return {"write_s": write_s, "procs_s": procs_s, "ranks": reports}


def phase_mesh(hg: dict, sam: dict, workdir: str, submit) -> dict:
    """The multi-device path on one card, on the hg38 phase's index and
    inputs (`hg`: its index directory, reads and pairs). (1) `single
    -ishards 2` on the first MESH_READS reads: one device makes it a 1 x 1
    mesh (snap_tpu's rule), so the resharded index, the monolithic mesh
    step (parallel.mesh.align_winners_sharded) and its dp_overflow redo
    (align_tier1_sharded) run; an untimed run keeps the launches of its
    first MESH_RECORD_STEPS steps and of its redo paths, replayed bit
    for bit, then a timed run (reads/s). (2) align_winners_sharded
    called directly on a data = 1 x index = 2 mesh of cuda:0 twice (the
    index resharded into 2 tables, the K axis merged across them), one
    MESH_READS batch, every launch replayed; its winners on the first
    MESH_CHECK_READS reads equal the CPU mesh's bit for bit. (4) The same
    step and batch with the index row across MESH_PROCS processes
    (mesh_procs), winners equal to (2)'s bit for bit, each child's
    launches replayed. (3) `paired -ishards 2` on the first MESH_PAIRS
    pairs, its first batches' launches replayed. (5) Config 5: `paired
    -ishards 2 -so` with cuda:0 listed CONFIG5_POSITIONS times (data 4 x
    index 2) on those pairs plus planted duplicates
    (plant_duplicate_pairs), the BAM checked (config5_bam_checks), the
    sort-and-write seconds, its first batches' launches replayed. Runs
    (1), (3) and (5) are held to the truth in the read names (check_run
    with hg38_summary). The card-vs-CPU checks of (1), (3) and (5) go to
    `submit` (CpuChecks.submit) before their card runs, Config 5's before
    its timed run, so that the CPU runs them beside the card. Returns
    the runs' launches and replays."""
    import torch

    from snap_tpu_torch.align import paired_driver
    from snap_tpu_torch.align.pipeline import AlignParams, HostWinners, align_winners_device
    from snap_tpu_torch.cli import _load_index_cached
    from snap_tpu_torch.index.build import reshard_index
    from snap_tpu_torch.parallel import mesh

    idx_dir = hg["idx_dir"]
    reads, quals, names = hg["reads"]
    n = MESH_READS
    fq = os.path.join(workdir, "mesh.fq")
    write_fastq(fq, reads[:n], quals[:n], names[:n])
    cached = _load_index_cached(idx_dir, "cuda")
    runs, replays = {}, {}

    # (1) single -ishards 2: a 1 x 1 mesh on one card
    argv_of = lambda f, o: ["single", idx_dir, f, "-o", o, "-ishards", "2"]
    step_calls = no_calls()
    redo_calls = no_calls()
    with recording(step_calls, inside={(mesh, "align_winners_sharded"): MESH_RECORD_STEPS,
                                       ag_rows_key(): MESH_RECORD_STEPS}), \
            recording(redo_calls, inside=dict.fromkeys(REDO_PATH)):
        rec = run_single(argv_of(fq, os.path.join(workdir, "mesh_rec.sam")), phase="mesh")
    replays["single_step"] = replay_launches(step_calls, "mesh steps", "mesh")
    replays["single_redo"] = replay_launches(redo_calls, "mesh redo paths", "mesh")
    out = os.path.join(workdir, "mesh.sam")
    run = run_single(argv_of(fq, out), phase="mesh")
    if run["mesh"] != {"data": 1, "index": 1} or run["steps"]["mesh"] != n // 1024:
        fail("mesh", f"-ishards 2 on one card ran mesh {run['mesh']}, steps {run['steps']}")
    check_run("mesh", "single_ishards2", run, out, n, hg38_summary)
    sam_run = sam["run"]
    runs["single_ishards2"] = {
        "launches": run["launches"], "reads_per_s": run["reads_per_s"],
        "wall_s": run["wall_s"], "step_s": run["step_s"],
        "dp_overflow": run["branches"].get("dp_overflow", 0),
        "sam_phase_reads_per_s": sam_run["reads_per_s"],
        "sam_phase_step_s_per_1024_reads": sam_run["step_s"] * 1024 / SAM_READS,
        "step_s_per_1024_reads": run["step_s"] * 1024 / n,
    }
    emit({"phase": "mesh", "ok": True, "run": "single_ishards2", "reads": n,
          "timed_run": run, "recorded_run": {"wall_s": rec["wall_s"],
                                             "launches": rec["launches"]},
          "replays": {k: replays[k] for k in ("single_step", "single_redo")}})
    card_check("mesh", "mesh_single", argv_of, workdir, reads, quals, names,
               MESH_SAM_CHECK_READS, submit=submit)

    # (2) align_winners_sharded on data = 1 x index = 2, cuda:0 twice
    t0 = time.time()
    arrays = reshard_index({"seed_len": cached.seed_len, "max_probe": cached.max_probe,
                            **cached._host_arrays}, 2)
    reshard_s = time.time() - t0
    mesh2 = mesh.make_mesh(1, 2, [torch.device(CARD)] * 2)
    bases_g = np.asarray(cached.genome_meta.bases)
    sh = mesh.sharded_device_index(arrays, bases_g, mesh2)
    params = AlignParams(seed_len=cached.seed_len,
                         max_probe=max(cached.max_probe, arrays["max_probe"]))
    fas = cached.genome_meta.first_alt_start()
    b = np.full((n, MAX_LEN), 4, np.uint8)
    q = np.zeros((n, MAX_LEN), np.uint8)
    b[:, :READ_LEN], q[:, :READ_LEN] = reads[:n], quals[:n]
    lens = np.full(n, READ_LEN, np.int32)
    dev = torch.device(CARD)
    tb, tq, tl = (torch.from_numpy(x).to(dev) for x in (b, q, lens))
    def step(bb=tb, qq=tq, ll=tl, d=sh, m=mesh2):
        return mesh.align_winners_sharded(d, bb, qq, ll, fas, params, m)[0]

    calls = no_calls()
    with recording(calls):
        packed, launches = counted(step)
    missing = [k for k in KERNEL_SOURCES if launches.get(k, 0) == 0]
    if missing:
        fail("mesh", f"index = 2 step: no launch of {missing}: {launches}")
    replays["index2_step"] = replay_launches(calls, "index = 2 mesh step", "mesh")
    del calls

    def wall(fn, reps=3):  # median seconds of fn() to its winners on the host
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn().cpu()
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    step_wall = wall(step)
    # the same batch through the flat index's full-depth step (the one
    # index, K = 16): what the second index shard adds
    flat_wall = wall(lambda: align_winners_device(
        cached.device, tb, tq, tl, torch.tensor(fas, device=dev),
        AlignParams(seed_len=cached.seed_len, max_probe=cached.max_probe))[0])
    w = HostWinners(packed)
    c = MESH_CHECK_READS
    sl = lambda t: t[:c].contiguous()
    card = step(sl(tb), sl(tq), sl(tl)).cpu().numpy()
    t0 = time.time()
    mesh_cpu = mesh.make_mesh(1, 2, [torch.device("cpu")] * 2)
    sh_cpu = mesh.sharded_device_index(arrays, bases_g, mesh_cpu)
    cpu = step(sl(tb).cpu(), sl(tq).cpu(), sl(tl).cpu(), sh_cpu, mesh_cpu).numpy()
    cpu_s = time.time() - t0
    rows = np.flatnonzero((card != cpu).any(axis=1))
    if rows.size:
        fail("mesh", f"index = 2 step: {rows.size} of {c + 1} winner rows differ between "
                     f"card and CPU, first {rows[:5].tolist()}")
    runs["index2_step"] = {"launches": launches, "reads_per_s": n / step_wall,
                           "flat_full_depth_reads_per_s": n / flat_wall}
    emit({"phase": "mesh", "ok": True, "run": "index2_step", "reads": n,
          "mesh": {**mesh2.shape, "devices": [str(d) for d in mesh2.devices[0]]},
          "reshard_s": reshard_s, "max_probe": params.max_probe,
          "flat_max_probe": cached.max_probe,
          "shard_table_bytes": int(arrays["table"][0].nbytes),
          "shard_hits": [int(x) for x in arrays["hits"].shape],
          "launches": launches, "step_wall_s": step_wall, "reads_per_s": n / step_wall,
          "flat_full_depth_step_wall_s": flat_wall, "flat_full_depth_reads_per_s": n / flat_wall,
          "found": int(w.found.sum()), "dp_overflow": bool(w.dp_overflow),
          "card_vs_cpu": {"reads": c, "rows_differ": 0, "cpu_s": cpu_s},
          "replays": replays["index2_step"]})
    want = packed.cpu().numpy()
    del step, sh, sh_cpu, tb, tq, tl, packed
    torch.cuda.empty_cache()

    # (4) the same step with the index row across MESH_PROCS processes
    res = mesh_procs(workdir, arrays, os.path.join(idx_dir, "genome_bases.npy"), b, q,
                     lens, fas, params, want)
    del arrays
    launches = {k: sum(r["launches"][k] for r in res["ranks"]) for k in KERNEL_SOURCES}
    missing = [k for k in KERNEL_SOURCES
               if any(r["launches"].get(k, 0) == 0 for r in res["ranks"])]
    if missing:
        fail("mesh", f"index = 2 across processes: a rank launched no {missing}: "
                     f"{[r['launches'] for r in res['ranks']]}")
    for r, rep in enumerate(res["ranks"]):
        replays[f"index2_procs_rank{r}"] = rep["replays"]
    runs["index2_procs"] = {"launches": launches,
                            "reads_per_s": n / max(r["step_wall_s"] for r in res["ranks"]),
                            "one_process_reads_per_s": runs["index2_step"]["reads_per_s"]}
    emit({"phase": "mesh", "ok": True, "run": "index2_procs", "reads": n,
          "processes": MESH_PROCS, "backend": "gloo", "ranks": [list(range(MESH_PROCS))],
          "winners_equal_one_process": True, **res})

    # (3) paired -ishards 2
    ends, pquals, pnames = hg["pairs"]

    def write_pairs(tag: str, k: int) -> tuple[str, str]:
        fqs = tuple(os.path.join(workdir, f"{tag}_{e + 1}.fq") for e in range(2))
        for e in range(2):
            write_fastq(fqs[e], ends[e, :k], pquals[e, :k], pnames[:k])
        return fqs

    cls = paired_driver.PairedEndAligner
    batch_calls = no_calls()
    fqp = write_pairs("mesh_pairs", MESH_PAIRS)
    out = os.path.join(workdir, "mesh_pairs.sam")
    n_sharded = [0]
    intersect = mesh.paired_candidates_sharded

    def counted_intersect(*a, **kw):
        n_sharded[0] += 1
        return intersect(*a, **kw)

    mesh.paired_candidates_sharded = counted_intersect
    try:
        with recording(batch_calls, inside={(cls, "align_batch"): PAIRED_RECORD_BATCHES}):
            prun = run_paired(["paired", idx_dir, *fqp, "-o", out, "-ishards", "2"],
                              phase="mesh")
    finally:
        mesh.paired_candidates_sharded = intersect
    replays["paired_batch"] = replay_launches(batch_calls, "mesh paired batches", "mesh")
    if prun["mesh"] != {"data": 1, "index": 1} or n_sharded[0] != MESH_PAIRS // 512:
        fail("mesh", f"paired -ishards 2 ran mesh {prun['mesh']}, "
                     f"{n_sharded[0]} sharded intersections")
    summ = check_run("mesh", "paired_ishards2", prun, out, 2 * MESH_PAIRS, hg38_summary)
    runs["paired_ishards2"] = {"launches": prun["launches"],
                               "pairs_per_s": MESH_PAIRS / prun["wall_s"]}
    emit({"phase": "mesh", "ok": True, "run": "paired_ishards2", "pairs": MESH_PAIRS,
          "timed_run": prun, "sam": summ, "pairs_per_s": MESH_PAIRS / prun["wall_s"],
          "replays": replays["paired_batch"]})
    paired_card_check(
        "mesh", "mesh_paired",
        lambda f1, f2, o: ["paired", idx_dir, f1, f2, "-o", o, "-ishards", "2"],
        workdir, hg["pairs"], MESH_CHECK_PAIRS, submit=submit)

    # (5) Config 5: paired -ishards 2 -so on a data 4 x index 2 mesh of cuda:0
    from snap_tpu_torch.index.index import GenomeIndex
    from snap_tpu_torch.io import output

    c5_pairs, src = plant_duplicate_pairs(hg["pairs"], MESH_PAIRS)
    n5 = len(c5_pairs[2])
    f1, f2 = (os.path.join(workdir, f"config5_{e + 1}.fq") for e in range(2))
    for e, fq_e in enumerate((f1, f2)):
        write_fastq(fq_e, c5_pairs[0][e], c5_pairs[1][e], c5_pairs[2])
    out = os.path.join(workdir, "config5.bam")
    c5_argv = lambda a, b, o: ["paired", idx_dir, a, b, "-o", o, "-so", "-ishards", "2"]  # noqa: E731
    # the card-vs-CPU check first: its CPU run goes beside the timed run,
    # and its card run reshards the index for the new mesh and places it
    # (to_mesh, kept for the timed run): the set-up a new mesh costs
    c5_check, _ = plant_duplicate_pairs(hg["pairs"], MESH_CHECK_PAIRS)
    first = {}
    with timers(first, [(GenomeIndex, "to_mesh")]):
        paired_card_check("mesh", "mesh_config5", c5_argv, workdir, c5_check,
                          len(c5_check[2]), positions=CONFIG5_POSITIONS, ext=".bam",
                          submit=submit)
    place_s = first["to_mesh"][0]
    c5_calls = no_calls()
    with recording(c5_calls, inside={(cls, "align_batch"): PAIRED_RECORD_BATCHES}):
        crun = run_paired(c5_argv(f1, f2, out), phase="mesh",
                          devices=[torch.device(CARD)] * CONFIG5_POSITIONS,
                          owners=[(output.OutputWriter, "close"), (GenomeIndex, "to_mesh")])
    replays["config5_batch"] = replay_launches(c5_calls, "Config 5 batches", "mesh")
    del c5_calls
    if crun["mesh"] != {"data": CONFIG5_POSITIONS // 2, "index": 2}:
        fail("mesh", f"config5 ran mesh {crun['mesh']}")
    bam = config5_bam_checks(out, src)
    summ = check_run("mesh", "config5", crun, out, 2 * n5, hg38_summary)
    sort_s = crun["host_seconds"].get("close", {}).get("s")
    rate = n5 / (crun["wall_s"] - crun["host_seconds"]["to_mesh"]["s"])
    runs["config5"] = {"launches": crun["launches"], "pairs_per_s": rate,
                       "sort_and_write_s": sort_s, "first_to_mesh_s": place_s}
    emit({"phase": "mesh", "ok": True, "run": "config5", "pairs": n5,
          "positions": CONFIG5_POSITIONS, "timed_run": crun, "bam": bam, "sam": summ,
          "pairs_per_s": rate, "first_to_mesh_s": place_s, "sort_and_write_s": sort_s,
          "replays": replays["config5_batch"]})
    empty = [k for k in KERNEL_SOURCES
             if not any(rp[k]["launches"] for rp in replays.values())]
    if empty:
        fail("mesh", f"no launch of {empty} recorded on the mesh path")
    return {"runs": runs, "replays": replays}


APPS_READS = 2048
DEPTH_GENOME_BP = 200_000


def phase_apps(seed: int, ctx: dict, workdir: str) -> dict:
    """The apps on the card: `daemon` on a Unix socket in a thread (the
    card as its device, so the cached index stays there) runs `single`
    sent through `command`, whose SAM must equal the direct run's; `roc`
    on that SAM (wgsim-style read names); `tofastq` on it, which must
    give back the FASTQ's bytes, and `single` on that FASTQ, which must
    give the same records; `depth` on a small index (host numpy)."""
    import contextlib as cl
    import io
    import threading

    from snap_tpu_torch import apps
    from snap_tpu_torch.cli import main as cli_main

    t_phase = time.time()
    idx_dir = ctx["idx_dir"]
    rng = np.random.default_rng(seed + 6)
    reads, quals, _, starts = simulate_reads(rng, ctx["codes"], ctx["contig_start"],
                                             APPS_READS, READ_LEN)
    names = [b"chr21sim_%d_%d_%d" % (s + 1, s + 1, i) for i, s in enumerate(starts.tolist())]
    fq = os.path.join(workdir, "apps.fq")
    write_fastq(fq, reads, quals, names)
    res = {}

    sock = os.path.join(workdir, "daemon.sock")
    srv = threading.Thread(target=apps.cmd_daemon, args=([sock], CARD), daemon=True)
    srv.start()
    for _ in range(600):
        if os.path.exists(sock):
            break
        time.sleep(0.05)
    if not os.path.exists(sock):
        fail("apps", "the daemon did not open its socket")
    out_d = os.path.join(workdir, "apps_daemon.sam")
    t0 = time.perf_counter()
    rc, launches = counted(lambda: apps.cmd_command([sock, "single", idx_dir, fq, "-o", out_d]))
    daemon_s = time.perf_counter() - t0
    if rc != 0:
        fail("apps", f"`command single` through the daemon exited {rc}")
    missing = [k for k in KERNEL_SOURCES if launches.get(k, 0) == 0]
    if missing:
        fail("apps", f"the daemon's single: no launch of {missing}: {launches}")
    if apps.cmd_command([sock, "exit"]) != 0:
        fail("apps", "the daemon did not take `exit`")
    srv.join(timeout=60)
    if srv.is_alive():
        fail("apps", "the daemon thread is still running after `exit`")
    out = os.path.join(workdir, "apps_direct.sam")
    direct = run_single(["single", idx_dir, fq, "-o", out], phase="apps")

    def body(path):  # @PG's CL: holds the output path
        with open(path, "rb") as f:
            return [ln for ln in f.read().split(b"\n") if not ln.startswith(b"@PG")]

    if body(out_d) != body(out):
        fail("apps", "the daemon's SAM differs from the direct run's")
    res["daemon"] = {"wall_s": daemon_s, "launches": launches,
                     "direct_wall_s": direct["wall_s"], "same_sam": True}

    buf = io.StringIO()
    t0 = time.perf_counter()
    with cl.redirect_stdout(buf):
        rc = apps.cmd_roc([out])
    roc_s = time.perf_counter() - t0
    table = [ln.split("\t") for ln in buf.getvalue().splitlines()[1:] if ln]
    if rc != 0 or not table:
        fail("apps", f"roc exited {rc}: {buf.getvalue()[:500]}")
    aligned = sum(int(t[1]) for t in table)
    wrong = sum(int(t[2]) for t in table)
    mapq10 = [t for t in table if int(t[0]) >= 10]
    res["roc"] = {"s": roc_s, "aligned": aligned, "misaligned": wrong,
                  "mapq10_reads": sum(int(t[1]) for t in mapq10),
                  "mapq10_misaligned": sum(int(t[2]) for t in mapq10)}
    if aligned < 0.8 * APPS_READS or res["roc"]["mapq10_misaligned"] > 0.02 * aligned:
        fail("apps", f"roc: {res['roc']}")

    back = os.path.join(workdir, "apps_back.fq")
    t0 = time.perf_counter()
    if apps.cmd_tofastq([out, back]) != 0:
        fail("apps", "tofastq failed")
    tofastq_s = time.perf_counter() - t0
    with open(fq, "rb") as f1, open(back, "rb") as f2:
        if f1.read() != f2.read():
            fail("apps", "tofastq did not give back the FASTQ's bytes")
    out_b = os.path.join(workdir, "apps_back.sam")
    run_single(["single", idx_dir, back, "-o", out_b], phase="apps")
    if sam_records(out_b) != sam_records(out):
        fail("apps", "single on the tofastq FASTQ wrote other records")
    res["tofastq"] = {"s": tofastq_s, "same_fastq": True, "same_records_again": True}

    small = os.path.join(workdir, "depth.fa")
    write_fasta(small, "small", np.random.default_rng(seed + 7).integers(
        0, 4, DEPTH_GENOME_BP).astype(np.uint8))
    small_idx = os.path.join(workdir, "depth_idx")
    tsv = os.path.join(workdir, "depth.tsv")
    t0 = time.perf_counter()
    if cli_main(["index", small, small_idx, "-s", "20", ",", "depth", small_idx, tsv]) != 0:
        fail("apps", "index + depth on the small genome failed")
    depth_s = time.perf_counter() - t0
    with open(tsv) as f:
        total = {int(v): int(c) for k, v, c in (ln.split("\t") for ln in f.read().splitlines()[1:])
                 if k == "TOTAL"}
    if sum(total.values()) != DEPTH_GENOME_BP:
        fail("apps", f"depth covered {sum(total.values())} of {DEPTH_GENOME_BP} loci")
    res["depth"] = {"s": depth_s, "loci": DEPTH_GENOME_BP, "depth_1_loci": total.get(1, 0)}
    res["phase_s"] = time.time() - t_phase
    emit({"phase": "apps", "ok": True, "reads": APPS_READS, **res})
    return res



# (run, tool module under tools/, argv): the JAX twins' defaults, except
# the repeat runs: one pass and no warm pass (the process is warm), so
# that a batch whose reads take the host's per-read redo paths stays
# inside the phase's time
PROFILE_RUNS = (
    ("step", "profile_step_torch", ["--sizes", "16384,32768,65536"]),
    ("host_single", "profile_host_torch", ["single", "--cprofile"]),
    ("host_single_repeat", "profile_host_torch",
     ["single", "--repeat-frac", "0.25", "--iters", "1", "--warm", "0", "--cprofile"]),
    ("host_paired", "profile_host_torch", ["paired", "--cprofile"]),
    ("host_paired_repeat", "profile_host_torch",
     ["paired", "--repeat-frac", "0.25", "--iters", "1", "--warm", "0", "--cprofile"]),
    ("e2e", "profile_e2e_torch", ["--batches", "2"]),
)


def tool_main(module: str):
    """The main() of a tool under tools/."""
    tools = os.path.join(HERE, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return importlib.import_module(module).main


def phase_profile(workdir: str) -> dict:
    """Each PROFILE_RUNS tool through its main() on the card, its human
    lines sent to stderr (the e2e tool's files under workdir); one line a
    run: the tool's JSON, its wall seconds and each kernel's launches.
    Returns run -> launches."""
    out = {}
    for run, module, argv in PROFILE_RUNS:
        main = tool_main(module)
        if module == "profile_e2e_torch":
            argv = [*argv, "--workdir", os.path.join(workdir, "profile_e2e")]
        t0 = time.time()
        try:
            with contextlib.redirect_stdout(sys.stderr):
                result, launches = counted(lambda: main([*argv, "--device", "cuda"]))
        except Exception as e:  # a tool's failure fails the phase
            fail("profile", f"{module} {' '.join(argv)}: {e!r}")
        emit({"phase": "profile", "ok": True, "run": run, "argv": argv,
              "wall_s": time.time() - t0, "launches": launches, "result": result})
        out[run] = launches
    if not all(out["step"].get(n, 0) > 0 for n in KERNEL_SOURCES):
        fail("profile", f"a kernel was never launched in the step tool: {out['step']}")
    return out


# the BASELINE config 4 tools at a size whose build takes seconds: a
# budget of 4 banks, so that the chunked, banked, memory-mapped build
# runs; the bench's batches of CHECK_READS reads, the first of them on
# the CPU too
BIGIDX_GBP = "0.02"
BIGIDX_BUDGET_GB = "0.5"
BIGIDX_BATCHES = 4


def phase_bigidx(workdir: str, submit) -> dict:
    """tools/build_big_index_torch.py and tools/bench_big_torch.py through
    their main(), their human lines sent to stderr: the chunked build
    (fails unless it made 2 or more banks), then BIGIDX_BATCHES batches
    on the card, every kernel launch counted (fails unless each kernel
    ran). The bench's first batch runs again on the CPU in CpuChecks
    (handed to `submit` before the card's run), whose packed winners
    finish() holds to the card's bit for bit. One line a tool run: its
    JSON, its wall seconds (and the bench's launches). Returns
    {"launches"}."""
    d = os.path.join(workdir, "bigidx")
    idx = os.path.join(d, "index")
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            built = tool_main("build_big_index_torch")(
                [idx, "--gbp", BIGIDX_GBP, "--budget-gb", BIGIDX_BUDGET_GB])
    except Exception as e:  # a tool's failure fails the phase
        fail("bigidx", f"build_big_index_torch: {e!r}")
    if built["n_banks"] < 2:
        fail("bigidx", f"the build made {built['n_banks']} bank(s), not the chunked path")
    emit({"phase": "bigidx", "ok": True, "run": "build", "wall_s": time.time() - t0,
          "result": built})

    def bench_argv(device: str, reads: int, tag: str):
        return [idx, "--reads", str(reads), "--batch", str(CHECK_READS),
                "--device", device, "--out", os.path.join(d, f"{tag}.json"),
                "--first-winners", os.path.join(d, f"{tag}_first.npy")]

    check = {"phase": "bigidx", "tag": "bench_first_batch", "reads": CHECK_READS,
             "tool": "bench_big_torch", "cpu_argv": bench_argv("cpu", CHECK_READS, "cpu"),
             "cpu_winners": os.path.join(d, "cpu_first.npy"),
             "card_winners": os.path.join(d, "card_first.npy")}
    submit([check])
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            rec, launches = counted(lambda: tool_main("bench_big_torch")(
                bench_argv("cuda", BIGIDX_BATCHES * CHECK_READS, "card")))
    except Exception as e:
        fail("bigidx", f"bench_big_torch: {e!r}")
    check["card_wall_s"] = time.time() - t0
    if not all(launches.get(n, 0) > 0 for n in KERNEL_SOURCES):
        fail("bigidx", f"a kernel was never launched in the bench: {launches}")
    if rec["backend"] != "cuda" or rec["reads"] != BIGIDX_BATCHES * CHECK_READS:
        fail("bigidx", f"the bench ran {rec['reads']} reads on {rec['backend']}")
    emit({"phase": "bigidx", "ok": True, "run": "bench", "wall_s": check["card_wall_s"],
          "launches": launches, "result": rec})
    return {"launches": launches}


def winners_vs_cpu(phase: str, card: str, cpu: str) -> list[dict]:
    """The rows of two packed-winner arrays (.npy) that differ; fails
    unless there are none."""
    a, b = np.load(card), np.load(cpu)
    if a.shape != b.shape:
        fail(phase, f"card winners {a.shape}, CPU winners {b.shape}")
    rows = np.nonzero((a != b).any(axis=1))[0]
    diffs = [{"row": int(r), "card": a[r].tolist(), "cpu": b[r].tolist()} for r in rows[:4]]
    if rows.size:
        fail(phase, f"{rows.size} of {a.shape[0]} packed winner rows differ "
                    f"between card and CPU: {diffs}")
    return diffs


def cpu_worker(todo, done) -> None:
    """CpuChecks' worker process: on the upper half of the host's cores
    (torch's threads as many), each queued (i, phase, argv, paired)
    command through the port's CLI on the CPU (or, when the job names a
    tool, that tool's main(argv)); puts (i, error, wall seconds) back; a
    check with positions runs on the CPU listed that many times (a
    mesh). Stops at None, or after a run that failed."""
    cores = sorted(os.sched_getaffinity(0))
    mine = cores[len(cores) // 2:]
    os.sched_setaffinity(0, mine)
    import torch

    torch.set_num_threads(len(mine))
    while (job := todo.get()) is not None:
        i, phase, argv, paired, positions, tool = job
        try:
            if tool:
                t0 = time.time()
                with contextlib.redirect_stdout(sys.stderr):
                    tool_main(tool)(argv)
                r = {"wall_s": time.time() - t0}
            elif paired:
                r = run_paired(argv, device="cpu", phase=phase,
                               devices=[torch.device("cpu")] * positions if positions else None)
            else:
                r = run_single(argv, device="cpu", phase=phase)
        except BaseException as e:  # fail() exits; its message is on stderr
            done.put((i, repr(e), None))
            return
        done.put((i, None, r["wall_s"]))


class CpuChecks:
    """The CPU side of the card-vs-CPU checks (card_check,
    paired_card_check, phase_bigidx): each check's command runs again on
    the CPU in a worker process (cpu_worker) while the card phases go on,
    and finish() holds the CPU's records to the card's (card_vs_cpu; a
    tool's packed winners, winners_vs_cpu). The port's index
    cache keeps one index, so checks are submitted grouped by index."""

    def __init__(self):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.todo, self.done = ctx.Queue(), ctx.Queue()
        self.proc = ctx.Process(target=cpu_worker, args=(self.todo, self.done), daemon=True)
        self.proc.start()
        self.checks = []

    def submit(self, checks: list) -> None:
        for c in checks:
            self.todo.put((len(self.checks), c["phase"], c["cpu_argv"], bool(c.get("paired")),
                           c.get("positions", 0), c.get("tool")))
            self.checks.append(c)

    def finish(self) -> list:
        """Waits for every CPU run, compares, and prints the card_vs_cpu
        line; fails on a CPU run that failed or records that differ."""
        import queue

        self.todo.put(None)
        wall = {}
        while len(wall) < len(self.checks):
            try:
                i, err, s = self.done.get(timeout=10)
            except queue.Empty:
                if not self.proc.is_alive():
                    fail("card_vs_cpu", f"the CPU worker exited {self.proc.exitcode}")
                continue
            if err:
                c = self.checks[i]
                fail(c["phase"], f"the CPU run of the {c['tag']} check: {err}")
            wall[i] = s
        self.proc.join(60)
        out = []
        for i, c in enumerate(self.checks):
            if c.get("tool"):  # a tool's packed winners, bit for bit
                diffs = winners_vs_cpu(c["phase"], c["card_winners"], c["cpu_winners"])
            else:
                diffs = card_vs_cpu(c["phase"], c["card"], sam_records(c["cpu_sam"]))
            out.append({"phase": c["phase"], "run": c["tag"], "reads": c["reads"],
                        "records_differ": len(diffs), "diffs": diffs,
                        "card_wall_s": c["card_wall_s"], "cpu_wall_s": wall[i]})
        emit({"phase": "card_vs_cpu", "ok": True, "checks": out})
        return out

    def stop(self) -> None:
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(10)


def kernels_line(ksum: dict, launches: dict, step_launches: dict, replays: dict,
                 paired: dict, long: dict, options: dict, hg38: dict, mesh: dict,
                 apps: dict, profile: dict, bigidx: dict) -> dict:
    """The summary line: per kernel, its launches in the timed FASTQ->SAM
    run (-b 1024) and in the timed paired run (launches_paired), and the
    sums over the launches_step_c launches of one 16384-read phase-C step
    (replayed in the kernels phase) of its device time, its per-call
    time, its plain version's time and its bound (and its baseline's
    device time, when there was one). The launches replayed bit for bit
    are counted apart (the -b 1024 run's first steps' and redo paths';
    the paired recording run's first batches' and redo paths', summed in
    paired_launches_replayed); max_abs_err covers them too. The long
    and options phases add each run's launches, the launches replayed,
    and the sums over the first batch's launches at -rl 256, -rl 400
    and 1500 bp (`rl256`, `rl400`, `rl1500`: device time, per-call time,
    bound; the plain versions timed once, by their comparison call). The
    hg38 and mesh phases add each of their runs' launches (launches_hg38,
    launches_mesh) and the launches they replayed (hg38_launches_replayed,
    mesh_launches_replayed), the apps phase the daemon's run's launches
    (launches_daemon), the profile phase each tool run's
    (launches_profile), the bigidx phase its bench run's
    (launches_bigidx)."""
    replays = {**replays, **{f"paired_{k}": v for k, v in paired["replays"].items()}}
    out = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        rows = ksum[name]
        by_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
        bound = sum(r["bound_ms"] for r in rows)
        k = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name],
            "launches_step_c": step_launches[name],
            "sam_step_launches_replayed": replays["step"][name]["launches"],
            "redo_launches_replayed": replays["redo"][name]["launches"],
            "launches_paired": paired["launches"][name],
            "paired_launches_replayed": sum(
                r[name]["launches"] for r in paired["replays"].values()),
            "max_abs_err": max(max(r["max_abs_err"] for r in rows),
                               *(rp[name]["max_abs_err"] for rp in replays.values())),
            "ms": sum(r["ms"] for r in rows),
            "call_ms": sum(r["call_ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": bound,
            "bound_by": "operations" if 2 * by_ops >= bound else "bytes",
            "library_ms": None,
        }
        if all("base_ms" in r for r in rows):
            k["base_ms"] = sum(r["base_ms"] for r in rows)
        k["launches_long"] = {t: r["launches"][name] for t, r in long.items()}
        k["long_launches_replayed"] = {t: r["replays"][name]["launches"]
                                       for t, r in long.items()}
        k["launches_options"] = {t: r["launches"][name] for t, r in options.items()}
        for ph, res in (("hg38", hg38), ("mesh", mesh)):
            k[f"launches_{ph}"] = {t: r["launches"][name] for t, r in res["runs"].items()}
            k[f"{ph}_launches_replayed"] = {t: r[name]["launches"]
                                           for t, r in res["replays"].items()}
        k["launches_daemon"] = apps["daemon"]["launches"][name]
        k["launches_profile"] = {run: n[name] for run, n in profile.items()}
        k["launches_bigidx"] = bigidx["launches"][name]
        k["max_abs_err"] = max([k["max_abs_err"], *(
            r["replays"][name]["max_abs_err"] for r in long.values()), *(
            r[name]["max_abs_err"] for res in (hg38, mesh)
            for r in res["replays"].values())])
        for t, r in long.items():
            if name in r["first_batch"]:
                k[t] = r["first_batch"][name]
        out.append(k)
    # the AG CIGAR kernel runs in no step: its launches on each path, the
    # main-path launches replayed bit for bit, and the long phase's first
    # batches' sums
    name = "agcigar"
    get = lambda d: d.get(name)  # runs whose counts cover the step's kernels only lack it
    k = {"name": name, "route": "cuda", "source": "snap_tpu_torch/csrc/agcigar.cu",
         "replaces": None, "launches": get(launches),
         "sam_step_launches_replayed": get(replays["step"])["launches"],
         "launches_paired": get(paired["launches"]),
         "paired_launches_replayed": sum(
             get(r)["launches"] for r in paired["replays"].values()),
         "launches_long": {t: get(r["launches"]) for t, r in long.items()},
         "launches_options": {t: get(r["launches"]) for t, r in options.items()},
         "launches_daemon": get(apps["daemon"]["launches"]),
         "launches_profile": {run: get(n) for run, n in profile.items()},
         "launches_bigidx": get(bigidx["launches"])}
    for ph, res in (("hg38", hg38), ("mesh", mesh)):
        k[f"launches_{ph}"] = {t: get(r["launches"]) for t, r in res["runs"].items()}
        k[f"{ph}_launches_replayed"] = {t: (get(r) or {}).get("launches")
                                       for t, r in res["replays"].items()}
    for t, r in long.items():
        if name in r["first_batch"]:
            k[t] = r["first_batch"][name]
    out.append(k)
    return {"kernels": out}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--genome-len", type=int, default=CHR21_BP)
    ap.add_argument("--profile", action="store_true",
                    help="also trace three end-to-end steps with torch.profiler "
                         "and profile one FASTQ -> SAM run's host with cProfile")
    ap.add_argument("--baseline", metavar="DIR",
                    help="also build and time the kernel sources found in DIR")
    ap.add_argument("--only", choices=["agcigar"],
                    help="build, then run only this phase")
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(HERE, "snap_tpu_torch")):
        fail("setup", "snap_tpu_torch/ is not beside chip_smoke.py", 2)
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        fail("device", "torch.cuda.is_available() is false", 2)

    smi, name = phase_device()
    base = baselines(args.baseline)
    phase_build(base)
    if args.only == "agcigar":
        t0 = time.time()
        phase_agcigar(args.seed)
        emit({"phase": "seconds", "ok": True, "agcigar": time.time() - t0,
              "script": time.time() - T_START})
        print(smi, flush=True)
        return
    import tempfile

    seconds = {}
    t0 = time.time()
    cpu = CpuChecks()
    try:
        with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke_") as wd:
            step_launches, calls, ctx = phase_e2e(args.seed, args.genome_len, wd,
                                                  args.profile)
            if not all(step_launches.get(n, 0) > 0 for n in KERNEL_SOURCES):
                fail("e2e", f"a kernel was never launched in the step: {step_launches}")
            seconds["e2e"], t0 = time.time() - t0, time.time()
            # each phase's card-vs-CPU checks go to the CPU worker as the
            # phase ends: the e2e genome's index first, then the hg38 one
            sam = phase_sam(args.seed, ctx, wd, args.profile)
            cpu.submit(sam["checks"])
            seconds["sam"], t0 = time.time() - t0, time.time()
            paired = phase_paired(args.seed, ctx, wd)
            cpu.submit(paired["checks"])
            seconds["paired"], t0 = time.time() - t0, time.time()
            long, checks = phase_long(args.seed, ctx, wd, base)
            cpu.submit(checks)
            seconds["long"], t0 = time.time() - t0, time.time()
            options, checks = phase_options(ctx, sam, wd)
            cpu.submit(checks)
            seconds["options"], t0 = time.time() - t0, time.time()
            phase_bam(ctx, sam, wd)
            seconds["bam"], t0 = time.time() - t0, time.time()
            cpu.submit(phase_threads(ctx, sam, wd))
            seconds["threads"], t0 = time.time() - t0, time.time()
            apps = phase_apps(args.seed, ctx, wd)
            seconds["apps"], t0 = time.time() - t0, time.time()
            hg38, hg, checks = phase_hg38(args.seed, ctx, sam, paired, wd)
            cpu.submit(checks)
            seconds["hg38"], t0 = time.time() - t0, time.time()
            mesh = phase_mesh(hg, sam, wd, cpu.submit)
            seconds["mesh"], t0 = time.time() - t0, time.time()
            profile = phase_profile(wd)
            seconds["profile"], t0 = time.time() - t0, time.time()
            bigidx = phase_bigidx(wd, cpu.submit)
            seconds["bigidx"], t0 = time.time() - t0, time.time()
            ksum = phase_kernels(calls, base)
            seconds["kernels"], t0 = time.time() - t0, time.time()
            phase_agcigar(args.seed)
            seconds["agcigar"], t0 = time.time() - t0, time.time()
            cpu.finish()
            seconds["card_vs_cpu_wait"] = time.time() - t0
    finally:
        cpu.stop()
    emit({"phase": "seconds", "ok": True, **seconds,
          "script": time.time() - T_START})
    emit(kernels_line(ksum, sam["launches"], step_launches, sam["replays"], paired,
                      long, options, hg38, mesh, apps, profile, bigidx))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-child"]:
        sys.path.insert(0, HERE)
        mesh_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main()
