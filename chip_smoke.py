#!/usr/bin/env python3
"""Chip smoke test of the snap_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py                       # as the acceptance run
    python3 chip_smoke.py --genome-len 4641652  # a quicker, smaller run
    python3 chip_smoke.py --baseline .archive   # also time the kernels there

Phases, each printing one JSON line:
  device   the card's name and power limit (nvidia-smi) and torch's name
  build    nvcc builds the three kernels from snap_tpu_torch/csrc
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
           -o out.sam` on the card. First an untimed run with the CLI's
           defaults (-b 1024) keeps the inputs of every kernel launch of
           its first RECORD_STEPS steps and of every launch made by the
           redo paths (score_candidates, score_rows, align_tier1), and
           replays each against its plain version bit for bit. Then
           timed runs at -b 1024 and -b 16384: wall time, FASTQ->SAM
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
  paired   the paired-end path as a user runs it: 32768 simulated pairs
           of 2 x 100 bp (inserts normal(300, 30) clipped to [220, 600],
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
           beside the current one without committing it.
  long     long reads through `single` with the script's error model:
           16384 reads of 250 bp at -rl 256 and 8192 of 400 bp at -rl 400
           (the CLI's -b 1024), and 256 reads of 1500 bp with
           test_long_reads.py's options (-rl 1500 -d 160 -i 200 -dp 0.15
           -mrl 100, -b 64), where the DP and affine rows take the
           long-row kernels (a block a row). An untimed run of the first
           4 batches (for 1500 bp, the one run, whose first batch is
           replayed) keeps every launch, replayed bit for bit; the first
           batch's launches at -rl 400 and at 1500 bp are timed as in the
           kernels phase. Fails unless every kernel launched, 98% of
           primary MAPQ >= 10 records lie within 30 bp, and on any launch
           that differs.
  options  `single -om 3 -omax 2` and `single -dp 0.1` on the first 16384
           reads of the sam phase: every read takes the non-fast
           (two-phase) path (branches' non_fast), reads/s, accuracy.
  bam      `single -so` to a .bam on the sam phase's reads, in memory and
           through the -sm spill: the .bai is there, the port's BAM
           reader finds the records sorted, with the SAM run's count and
           names, the spill gives the same record bytes; the host's
           seconds in the sort and write (OutputWriter.close) and spills.
  threads  `single -t 4` on the sam phase's reads: the SAM of -t 1 (the
           sam phase's -b 1024 run), the @PG line aside.
  card_vs_cpu  the first reads of each long and options run (256; 16
           at 1500 bp; 512), run on the card in their phase, again on the
           CPU: at most 2 records differing, in MAPQ +-1 only. The CPU
           runs come last, so that the index is loaded to host memory
           once.
Then a `seconds` line (each phase's wall seconds), one {"kernels": [...]}
line (per kernel: its launches in the timed -b 1024 FASTQ->SAM run and
in the timed paired run; the sums over the launches of one 16384-read
phase-C step of its device time, its per-call time, its plain version's
time and its bound; the launches replayed; each long and options run's
launches; the sums over the first batch's launches at -rl 400 and
1500 bp), the card's name and power limit, and as the last line
{"ok": true, "device": {...}}.

Exits non-zero, printing no result, when there is no CUDA device or when
snap_tpu_torch is not beside this file. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
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
    errs = [float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref)
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
    """name -> (the pipeline's name for the wrapper it calls, the kernel
    wrapper that counts launches, the kernel's plain version, a function
    turning the pipeline call's (args, kwargs) into the kernel
    wrapper's, and the wrapper's C launcher)."""
    from snap_tpu_torch.ops import affine, affine_cuda, dp, dp_cuda, gapless, gapless_cuda

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
    }


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
    for name, (attr, _, _, core, _) in kernel_table().items():
        fn = saved[(pipeline, attr)] = getattr(pipeline, attr)

        def rec(*a, _fn=fn, _name=name, _core=core, **kw):
            if depth[0] or not inside:
                args, kwargs = _core(a, kw)
                calls[_name].append((
                    tuple(x.clone() if torch.is_tensor(x) else x for x in args), kwargs,
                ))
            return _fn(*a, **kw)

        setattr(pipeline, attr, rec)
    try:
        yield
    finally:
        for (owner, attr), fn in saved.items():
            setattr(owner, attr, fn)


def tensor_bytes(xs) -> int:
    import torch

    return sum(x.numel() * x.element_size() for x in xs if torch.is_tensor(x))


def shape_of(name: str, args) -> dict:
    if name == "gapless_prescreen":
        return {"B": args[0].shape[0], "K": args[10]}
    return {"N": args[0].shape[0], "L": args[0].shape[1], "W": args[3].shape[1]}


def work_ops(name: str, args, got) -> tuple[float, float]:
    """(integer, float) operations that these inputs need."""
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
}


def differing(name: str, got, ref) -> list[str]:
    """The outputs in which the kernel's bits differ from the plain
    version's, with the count of differing elements."""
    import torch

    fields = getattr(got, "_fields", None) or OUTPUT_FIELDS[name]
    out = []
    for g, r, field in zip(got, ref, fields):
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


def baselines(directory: str | None) -> dict:
    """kernel name -> the library name of its baseline source in
    `directory` (registered with the build), for those that have one."""
    from snap_tpu_torch.ops import _build

    out = {}
    for name, (src, _) in (KERNEL_SOURCES.items() if directory else ()):
        path = os.path.join(directory, os.path.basename(src))
        if os.path.exists(path):
            lib = os.path.basename(src)[: -len(".cu")] + "_baseline"
            _build.add_source(lib, path)
            out[name] = lib
    return out


def phase_build(base: dict):
    from snap_tpu_torch.ops import _build

    names = (*_build.KERNELS, *base.values())
    t0 = time.time()
    per = _build.build_all(names)
    secs = time.time() - t0
    regs = {
        n: [ln.strip() for ln in _build.BUILD_LOG.get(n, "").splitlines()
            if "registers" in ln or "spill" in ln]
        for n in names
    }
    emit({"phase": "build", "ok": True, "seconds": round(secs, 3),
          "per_kernel_s": {k: round(v, 3) for k, v in per.items()},
          "ptxas": regs})


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
    for name, (_, kern, plain, _, launcher) in kernel_table().items():
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
                with launcher.using(base[name]):
                    got_b = run()
                    torch.cuda.synchronize()
                    row["base_differs"] = differing(name, got_b, ref)
                    t_b = [device_ms(run)]
                t_k = [device_ms(run), device_ms(run)]
                with launcher.using(base[name]):
                    t_b.append(device_ms(run))
                row["base_ms"] = float(np.mean(t_b))
                row["ms"] = float(np.mean(t_k))
            else:
                row["ms"] = device_ms(run)
            row["call_ms"] = cuda_ms(run)
            row["plain_ms"] = (cuda_ms(lambda: plain(*args, **kw), plain_reps)
                               if plain_reps else ev[0].elapsed_time(ev[1]))
            nbytes = tensor_bytes(args) + tensor_bytes(got)
            int_ops, fp_ops = work_ops(name, args, got)
            bms, by = bound_ms(nbytes, int_ops, fp_ops)
            row.update({
                "bytes": nbytes, "int_ops": int_ops, "fp_ops": fp_ops,
                "bound_ms": bms, "bound_by": by,
            })
            rows.append(row)
        summary[name] = rows
    return summary


def launch_sums(rows: list) -> dict:
    """Sums over launches' rows (time_launches) of their times and
    bounds."""
    by_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    bound = sum(r["bound_ms"] for r in rows)
    return {
        "launches": len(rows),
        "ms": sum(r["ms"] for r in rows),
        "call_ms": sum(r["call_ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": bound,
        "bound_by": "operations" if 2 * by_ops >= bound else "bytes",
        "max_abs_err": max((r["max_abs_err"] for r in rows), default=0.0),
    }


# --------------------------------------------------------------- end to end

CHR21_BP = 46_709_983   # BASELINE config 3's reference length
READS, READ_LEN, MAX_LEN = 16384, 100, 128
CHECK_READS = 1024      # card-vs-CPU batch


def gen_repeat_genome(rng, glen: int, repeat_frac: float) -> np.ndarray:
    """Synthetic genome with planted repeats (the model of bench.py's
    _gen_repeat_genome): ~300 bp SINE-like units with 1% divergence,
    6 kb LINE-like units, and tandem microsatellites."""
    seq = rng.integers(0, 4, size=glen).astype(np.uint8)
    budget = int(glen * repeat_frac)
    alu = rng.integers(0, 4, size=300).astype(np.uint8)
    for _ in range(max(1, budget // 2 // 300)):
        p = int(rng.integers(0, glen - 300))
        u = alu.copy()
        d = rng.random(300) < 0.01
        u[d] = rng.integers(0, 4, int(d.sum()))
        seq[p : p + 300] = u
    line = rng.integers(0, 4, size=6000).astype(np.uint8)
    for _ in range(max(1, budget // 2 // 6000)):
        p = int(rng.integers(0, glen - 6000))
        seq[p : p + 6000] = line
    for _ in range(max(1, glen // 20000)):
        unit = rng.integers(0, 4, size=4).astype(np.uint8)
        reps = int(rng.integers(20, 60))
        p = int(rng.integers(0, glen - 4 * reps))
        seq[p : p + 4 * reps] = np.tile(unit, reps)
    return seq


def write_fasta(path: str, name: str, codes: np.ndarray, width: int = 100):
    from snap_tpu_torch.constants import BASE_DECODE

    text = BASE_DECODE[codes].tobytes()
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        for i in range(0, len(text), width):
            f.write(text[i : i + width] + b"\n")


def simulate_reads(rng, codes: np.ndarray, contig_start: int, n: int, L: int):
    """n reads of L bases: 1% substitutions, a 1-3 bp deletion or
    insertion in a quarter of them, half from the reverse strand.
    Returns (codes [n, L] uint8, qual bytes [n, L] uint8, the genome
    location one past the sampled reference span [n] int64, the
    span's first base as a 0-based contig position [n] int64)."""
    reads = np.empty((n, L), np.uint8)
    true_end = np.empty(n, np.int64)
    span = L + 8
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
        packed, _ = align_winners_device(
            didx, bb, qq, ll, fas.to(bb.device), params,
            adaptive=True, phase_c=phase_c,
        )
        return packed

    # the main path, counted: one adaptive step, then one with phase C
    # whose kernel inputs are kept for the kernels phase
    per_step = {"gapless_prescreen": 2, "fitting_edit_distance": 4, "affine_extend": 4}
    per_step_c = {"gapless_prescreen": 3, "fitting_edit_distance": 6, "affine_extend": 6}
    torch.cuda.reset_peak_memory_stats()
    packed_ab, counts_ab = counted(lambda: step())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    calls = {name: [] for name in KERNEL_SOURCES}
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
SAM_RUNS = (None, 16_384)      # -b of each timed run: the CLI's default (1024), 16384
SAM_CHECK_READS = 1024         # card-vs-CPU SAM
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
    return out


def sam_records(path: str) -> list[bytes]:
    with open(path, "rb") as f:
        return [ln for ln in f.read().split(b"\n") if ln and not ln.startswith(b"@")]


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
            device: str) -> tuple[dict, object, dict]:
    """One command through the port's CLI entry point, timed, with the
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
            rc, launches = counted(lambda: cli_main(argv, device=device))
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

    owners = list(owners or [])
    owners += [(single.SingleEndAligner, n) for n in TIMED_METHODS]
    owners += [(pipeline, n) for n in TIMED_PIPELINE]
    run, _, acc = run_cli(phase, argv, single.SingleEndAligner, "align_file",
                          owners, device)
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
    idx_dir = ctx["idx_dir"]
    t0 = time.time()
    _load_index_cached(idx_dir, "cuda")   # cached for the runs below
    load_s = time.time() - t0

    # an untimed run with the CLI's defaults first: it keeps the inputs of
    # every launch of the first RECORD_STEPS steps and of every launch
    # the redo paths make, and takes the first-use costs off the timed runs
    step_calls = {name: [] for name in KERNEL_SOURCES}
    redo_calls = {name: [] for name in KERNEL_SOURCES}
    rec_out = os.path.join(workdir, "recorded.sam")
    with recording(step_calls, inside={"align_winners_device": RECORD_STEPS}), \
            recording(redo_calls, inside=dict.fromkeys(REDO_PATH)):
        rec = run_single(["single", idx_dir, fq, "-o", rec_out])
    replays = {"step": replay_launches(step_calls, "-b 1024 step"),
               "redo": replay_launches(redo_calls, "redo path")}

    runs = []
    for k, b in enumerate(SAM_RUNS):
        out = os.path.join(workdir, f"out{k}.sam")
        argv = ["single", idx_dir, fq, "-o", out] + (["-b", str(b)] if b else [])
        r = run_single(argv)
        r["batch"] = b or 1024
        r["reads_per_s"] = SAM_READS / r["wall_s"]
        r["sam"] = sam_summary(out)
        runs.append(r)
        if r["sam"]["primary"] != SAM_READS:
            fail("sam", f"-b {r['batch']}: {r['sam']['primary']} primary records "
                        f"for {SAM_READS} reads")
        if r["sam"]["within_30bp_share"] < 0.98:
            fail("sam", f"-b {r['batch']}: only {r['sam']['within_30bp_share']:.4f} "
                        "of primary MAPQ >= 10 records within 30 bp")
        missing = [n for n in KERNEL_SOURCES if r["launches"].get(n, 0) == 0]
        if missing:
            fail("sam", f"-b {r['batch']}: no launch of {missing}: {r['launches']}")
    recorded = {"wall_s": rec["wall_s"], "launches": rec["launches"],
                "same_records_as_timed_run":
                    sam_records(rec_out) == sam_records(os.path.join(workdir, "out0.sam")),
                "same_launches_as_timed_run": rec["launches"] == runs[0]["launches"]}
    if profile:
        out = os.path.join(workdir, "out_profile.sam")
        emit({"phase": "sam_profile", "ok": True,
              **profile_single(["single", idx_dir, fq, "-o", out])})

    # the first reads on the card and on the CPU (the CPU run loads the
    # index to host memory, so it comes last)
    fq1 = os.path.join(workdir, "check.fq")
    write_fastq(fq1, reads[:SAM_CHECK_READS], quals[:SAM_CHECK_READS],
                names[:SAM_CHECK_READS])
    recs = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(workdir, f"check_{dev}.sam")
        r = run_single(["single", idx_dir, fq1, "-o", out], device=dev)
        recs[dev] = (sam_records(out), r["wall_s"])
    diffs = card_vs_cpu("sam", recs["cuda"][0], recs["cpu"][0])

    emit({
        "phase": "sam", "ok": True, "reads": SAM_READS, "read_len": READ_LEN,
        "index_load_s": load_s, "runs": runs,
        "native_library": {"available": native.available(),
                           "sam_formatter": native.has_sam_formatter(),
                           "build_error": native.BUILD_ERROR},
        "recorded_run": recorded, "replays": replays,
        "card_vs_cpu": {"reads": SAM_CHECK_READS, "records_differ": len(diffs),
                        "diffs": diffs, "cpu_wall_s": recs["cpu"][1],
                        "card_wall_s": recs["cuda"][1]},
    })
    return {"launches": runs[0]["launches"], "replays": replays, "fq": fq,
            "sam": os.path.join(workdir, "out0.sam"), "reads": (reads, quals, names)}

# ------------------------------------------------------- paired FASTQ -> SAM

PAIRS = 32_768
PAIRED_RECORD_PAIRS = 4_096    # the untimed recording run
PAIRED_RECORD_BATCHES = 4      # batches of it whose every launch is replayed
PAIRED_CHECK_PAIRS = 512       # card-vs-CPU SAM
# where the host's seconds go in a paired run: the device intersection
# (its wide tier and the overflow fetch included), the batch's scoring,
# and the two redo paths (their own scoring calls included)
PAIRED_METHODS = ("_device_intersect", "_redo_overflow_pairs", "_fix_edge_indels")
PAIRED_PIPELINE = ("score_candidates", "two_phase_merge")


def simulate_pairs(rng, codes: np.ndarray, n: int, L: int):
    """n pairs of L-base ends from inserts drawn from normal(300, 30)
    clipped to [220, 600]: the first end forward from the fragment's
    start, the second reverse complemented from its end, each with
    simulate_reads' errors (1% substitutions, a 1-3 bp deletion or
    insertion in a quarter of the ends, phred normal(36, 5)). Returns
    (ends [2, n, L] uint8, quals [2, n, L], the 1-based leftmost
    reference position of each end [2, n] int64)."""
    ends = np.empty((2, n, L), np.uint8)
    pos = np.empty((2, n), np.int64)
    inserts = np.clip(rng.normal(300, 30, n).round(), 220, 600).astype(np.int64)
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


def run_paired(argv: list[str], device: str = "cuda") -> dict:
    """One `paired` command through run_cli, with the host's seconds in
    the device intersection, the batch's scoring and the redo paths, the
    pair counters of AlignerStats, and the card's peak memory in the
    run."""
    import torch

    from snap_tpu_torch.align import paired_driver, pipeline

    cls = paired_driver.PairedEndAligner
    owners = [(cls, n) for n in PAIRED_METHODS] + [(pipeline, n) for n in PAIRED_PIPELINE]
    torch.cuda.reset_peak_memory_stats()
    run, aligner, acc = run_cli("paired", argv, cls, "align_files", owners, device)
    wall = run["wall_s"]
    sec = lambda *names: sum(acc.get(n, [0.0])[0] for n in names)
    parts = {"intersect": sec("_device_intersect"), "scoring": sec(*PAIRED_PIPELINE),
             "redo": sec("_redo_overflow_pairs", "_fix_edge_indels")}
    st = aligner.stats
    run["status"].update(aligned_as_pairs=st.aligned_as_pairs,
                         intersect_wide_pairs=st.intersect_wide_pairs,
                         intersect_overflow_pairs=st.intersect_overflow_pairs)
    run.update({
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
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
    ends, quals, pos = simulate_pairs(rng, ctx["codes"], PAIRS, READ_LEN)
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
    batch_calls = {name: [] for name in KERNEL_SOURCES}
    redo_calls = {name: [] for name in KERNEL_SOURCES}
    fq_rec = write_pairs("rec", PAIRED_RECORD_PAIRS)
    with recording(batch_calls, inside={(cls, "align_batch"): PAIRED_RECORD_BATCHES}), \
            recording(redo_calls, inside={(cls, "_redo_overflow_pairs"): None,
                                          (cls, "_fix_edge_indels"): None}):
        rec = run_paired(["paired", idx_dir, *fq_rec, "-o", os.path.join(workdir, "prec.sam")])
    replays = {"batch": replay_launches(batch_calls, "paired batches", "paired"),
               "redo": replay_launches(redo_calls, "paired redo paths", "paired")}
    empty = [n for n, r in replays["batch"].items() if r["launches"] == 0]
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

    # the first pairs on the card and on the CPU (the CPU run loads the
    # index to host memory, so it comes last)
    fq1 = write_pairs("check", PAIRED_CHECK_PAIRS)
    recs = {}
    for dev in ("cuda", "cpu"):
        o = os.path.join(workdir, f"pcheck_{dev}.sam")
        r = run_paired(["paired", idx_dir, *fq1, "-o", o], device=dev)
        recs[dev] = (sam_records(o), r["wall_s"])
    diffs = card_vs_cpu("paired", recs["cuda"][0], recs["cpu"][0])

    emit({
        "phase": "paired", "ok": True, "pairs": PAIRS, "read_len": READ_LEN,
        "index_load_s": load_s, "run": run,
        "native_library": {"available": native.available(),
                           "paired_formatter": native.has_paired_formatter(),
                           "build_error": native.BUILD_ERROR},
        "recorded_run": {"pairs": PAIRED_RECORD_PAIRS, "wall_s": rec["wall_s"],
                         "launches": rec["launches"], "branches": rec["branches"]},
        "replays": replays,
        "card_vs_cpu": {"pairs": PAIRED_CHECK_PAIRS, "records_differ": len(diffs),
                        "diffs": diffs, "cpu_wall_s": recs["cpu"][1],
                        "card_wall_s": recs["cuda"][1]},
        "phase_s": time.time() - t_phase,
    })
    return {"launches": run["launches"], "replays": replays}


# --------------------------------------------- long reads, options, BAM, -t

LONG_RUNS = ((250, 256, 16_384), (400, 400, 8_192))  # read length, -rl, reads
LONG_RECORD_BATCHES = 4        # batches of each recording run whose launches are replayed
LONG_CHECK_READS = 256         # card-vs-CPU SAM
XL_LEN, XL_READS, XL_BATCH, XL_CHECK_READS = 1500, 256, 64, 16
XL_REPLAY_BATCHES = 1          # batches of the 1500 bp run whose launches are replayed
XL_OPTS = ["-rl", "1500", "-d", "160", "-i", "200", "-dp", "0.15", "-mrl", "100"]
OPTION_RUNS = {"om": ["-om", "3", "-omax", "2"], "dp": ["-dp", "0.1"]}
OPTIONS_READS = 16_384
OPTIONS_CHECK_READS = 512
BAM_SPILL_GB = "0.004"         # -sm: 4 MiB of records a sorted block, ~5 blocks
MIN_WITHIN_30BP = 0.98         # share of primary MAPQ >= 10 records near their origin


def recorded_run(phase: str, argv: list[str], batches: int):
    """One `single` command (run_single) with the inputs of every kernel
    launch of its first `batches` batches kept (their dispatch and their
    host finalization, redo paths included), and those of its first
    batch apart. Returns (run, calls, first-batch calls)."""
    from snap_tpu_torch.align.single import SingleEndAligner as cls

    calls = {name: [] for name in KERNEL_SOURCES}
    first = {name: [] for name in KERNEL_SOURCES}
    with recording(calls, inside={(cls, "_submit"): batches, (cls, "_finalize"): batches}), \
            recording(first, inside={(cls, "_submit"): 1, (cls, "_finalize"): 1}):
        run = run_single(argv, phase=phase)
    return run, calls, first


def check_run(phase: str, what: str, run: dict, out: str, n: int, want: list) -> dict:
    """The SAM summary of a run of n reads; fails unless every read has
    its primary record, 98% of primary MAPQ >= 10 records lie within
    30 bp of their true position, and each kernel of `want` launched."""
    summ = sam_summary(out)
    if summ["primary"] != n:
        fail(phase, f"{what}: {summ['primary']} primary records for {n} reads")
    if summ["within_30bp_share"] < MIN_WITHIN_30BP:
        fail(phase, f"{what}: only {summ['within_30bp_share']:.4f} of primary MAPQ >= 10 "
                    "records within 30 bp")
    missing = [k for k in want if run["launches"].get(k, 0) == 0]
    if missing:
        fail(phase, f"{what}: no launch of {missing}: {run['launches']}")
    run["reads_per_s"] = n / run["wall_s"]
    run["sam"] = summ
    return summ


def card_check(phase: str, tag: str, argv_of, workdir: str, reads, quals, names,
               n: int) -> dict:
    """The first n reads through argv_of(fastq, out) on the card; the
    same on the CPU runs in phase_card_vs_cpu."""
    fq1 = os.path.join(workdir, f"{tag}_check.fq")
    write_fastq(fq1, reads[:n], quals[:n], names[:n])
    o = os.path.join(workdir, f"{tag}_check_cuda.sam")
    r = run_single(argv_of(fq1, o), phase=phase)
    o_cpu = os.path.join(workdir, f"{tag}_check_cpu.sam")
    return {"phase": phase, "tag": tag, "reads": n, "cpu_argv": argv_of(fq1, o_cpu),
            "cpu_sam": o_cpu, "card": sam_records(o), "card_wall_s": r["wall_s"]}


def phase_long(seed: int, ctx: dict, workdir: str) -> tuple[dict, list]:
    """`single` at -rl 256 (250 bp reads) and -rl 400 (400 bp) with the
    CLI's -b 1024, and 1500 bp reads with test_long_reads.py's options:
    an untimed recording run of the first batches (for the 1500 bp
    reads, whose run is short, the one run) whose launches are replayed
    bit for bit, then the timed run; the launches of the first batch at
    -rl 400 and at 1500 bp timed like the kernels phase's. Returns the
    runs and the card-vs-CPU checks still to run on the CPU."""
    from snap_tpu_torch.cli import _load_index_cached

    rng = np.random.default_rng(seed + 3)
    idx_dir = ctx["idx_dir"]
    _load_index_cached(idx_dir, "cuda")
    runs, checks = {}, []
    for read_len, rl, n in (*LONG_RUNS, (XL_LEN, XL_LEN, XL_READS)):
        t_run = time.time()
        xl = read_len == XL_LEN
        tag = f"rl{rl}"
        reads, quals, _, starts = simulate_reads(rng, ctx["codes"], ctx["contig_start"], n,
                                                 read_len)
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
        replays = replay_launches(calls, f"{tag} batches", "long")
        if xl:
            run, out = rec, out_rec
        else:
            out = os.path.join(workdir, f"{tag}.sam")
            run = run_single(["single", idx_dir, fq, "-o", out, *opts], phase="long")
        check_run("long", tag, run, out, n, list(KERNEL_SOURCES))
        empty = [k for k in KERNEL_SOURCES if replays[k]["launches"] == 0]
        if empty:
            fail("long", f"{tag}: no launch of {empty} recorded in the first batches")
        timed = {}
        if rl in (400, XL_LEN):
            timed = {k: launch_sums(v) for k, v in
                     time_launches(first, phase="long", plain_reps=0).items() if v}
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
        check_run("options", name, run, out, n, list(KERNEL_SOURCES))
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
    """`single -so` to a .bam on the sam phase's reads, in memory and
    through the -sm spill: the .bai is written, the port's BAM reader
    finds the records sorted, with the SAM run's count and names, and
    the spill gives the in-memory run's record bytes. The host's seconds
    in OutputWriter.close (sort, duplicate marking, BAM and .bai write)
    and in the spills."""
    from snap_tpu_torch.cli import _load_index_cached
    from snap_tpu_torch.io import output
    from snap_tpu_torch.io.bam import read_bam

    idx_dir = ctx["idx_dir"]
    _load_index_cached(idx_dir, "cuda")
    sam_names = sorted(ln.split(b"\t", 1)[0] for ln in sam_records(sam["sam"]))
    owners = [(output.OutputWriter, "close"), (output.OutputWriter, "_spill_block")]
    res = {}
    for name, extra in (("sorted", []), ("spill", ["-sm", BAM_SPILL_GB])):
        out = os.path.join(workdir, f"{name}.bam")
        run = run_single(["single", idx_dir, sam["fq"], "-o", out, "-so", *extra],
                         phase="bam", owners=owners)
        if not os.path.exists(out + ".bai"):
            fail("bam", f"{name}: no .bai beside the BAM")
        _, _, recs = read_bam(out)
        keys = [(r.ref_id if r.ref_id >= 0 else 1 << 30, r.pos0) for r in recs]
        if keys != sorted(keys):
            fail("bam", f"{name}: the BAM records are not sorted")
        if sorted(r.qname for r in recs) != sam_names:
            fail("bam", f"{name}: {len(recs)} BAM records, not the SAM run's {len(sam_names)} names")
        hs = run["host_seconds"]
        spills = hs.get("_spill_block", {}).get("calls", 0) + hs.get(
            "close/_spill_block", {}).get("calls", 0)
        if name == "spill" and spills < 2:
            fail("bam", f"the -sm {BAM_SPILL_GB} run spilled {spills} blocks")
        res[name] = {
            "wall_s": run["wall_s"], "reads_per_s": SAM_READS / run["wall_s"],
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
    emit({"phase": "bam", "ok": True, "reads": SAM_READS, **res})
    return res


def phase_threads(ctx: dict, sam: dict, workdir: str) -> dict:
    """`single -t 4` on the sam phase's reads: the parse threads' reader
    gives the SAM of the sam phase's -t 1 run, the @PG line aside."""
    out = os.path.join(workdir, "t4.sam")
    run = run_single(["single", ctx["idx_dir"], sam["fq"], "-o", out, "-t", "4"],
                     phase="threads")
    body = lambda p: [ln for ln in open(p, "rb").read().split(b"\n")
                      if not ln.startswith(b"@PG")]
    if body(out) != body(sam["sam"]):
        fail("threads", "-t 4 wrote other SAM records than -t 1")
    if run["branches"].get("reader_range_split") != SAM_READS:
        fail("threads", f"the -t 4 reader parsed {run['branches']}")
    res = {"wall_s": run["wall_s"], "reads_per_s": SAM_READS / run["wall_s"],
           "same_sam_as_t1": True, "branches": run["branches"]}
    emit({"phase": "threads", "ok": True, "reads": SAM_READS, **res})
    return res


def phase_card_vs_cpu(checks: list) -> list:
    """The CPU's runs of the card checks (card_check), compared with the
    card's records (card_vs_cpu). They come after every card phase: the
    CPU runs load the index to host memory, once."""
    out = []
    for c in checks:
        r = run_single(c["cpu_argv"], device="cpu", phase=c["phase"])
        diffs = card_vs_cpu(c["phase"], c["card"], sam_records(c["cpu_sam"]))
        out.append({"phase": c["phase"], "run": c["tag"], "reads": c["reads"],
                    "records_differ": len(diffs), "diffs": diffs,
                    "card_wall_s": c["card_wall_s"], "cpu_wall_s": r["wall_s"]})
    emit({"phase": "card_vs_cpu", "ok": True, "checks": out})
    return out


def kernels_line(ksum: dict, launches: dict, step_launches: dict, replays: dict,
                 paired: dict, long: dict, options: dict) -> dict:
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
    and the sums over the first batch's launches at -rl 400 and at
    1500 bp (`rl400`, `rl1500`: device time, per-call time, bound; the
    plain versions timed once, by their comparison call)."""
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
        k["max_abs_err"] = max([k["max_abs_err"], *(
            r["replays"][name]["max_abs_err"] for r in long.values())])
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
    import tempfile

    seconds = {}
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke_") as wd:
        step_launches, calls, ctx = phase_e2e(args.seed, args.genome_len, wd,
                                              args.profile)
        if not all(step_launches.get(n, 0) > 0 for n in KERNEL_SOURCES):
            fail("e2e", f"a kernel was never launched in the step: {step_launches}")
        seconds["e2e"], t0 = time.time() - t0, time.time()
        sam = phase_sam(args.seed, ctx, wd, args.profile)
        seconds["sam"], t0 = time.time() - t0, time.time()
        paired = phase_paired(args.seed, ctx, wd)
        seconds["paired"], t0 = time.time() - t0, time.time()
        long, long_checks = phase_long(args.seed, ctx, wd)
        seconds["long"], t0 = time.time() - t0, time.time()
        options, option_checks = phase_options(ctx, sam, wd)
        seconds["options"], t0 = time.time() - t0, time.time()
        phase_bam(ctx, sam, wd)
        seconds["bam"], t0 = time.time() - t0, time.time()
        phase_threads(ctx, sam, wd)
        seconds["threads"], t0 = time.time() - t0, time.time()
        ksum = phase_kernels(calls, base)
        seconds["kernels"], t0 = time.time() - t0, time.time()
        phase_card_vs_cpu(long_checks + option_checks)
        seconds["card_vs_cpu"] = time.time() - t0
    emit({"phase": "seconds", "ok": True, **seconds,
          "script": time.time() - T_START})
    emit(kernels_line(ksum, sam["launches"], step_launches, sam["replays"], paired,
                      long, options))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
