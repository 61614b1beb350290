"""One run of one cell: set-up, the measured window, the traced
instruments (with trace on), and the check of the window's records.

Set-up makes (or loads) the genome and its index, draws the traffic's
pool of reads and orders it by the seed, and runs a warm-up call of the
port's CLI on one batch at the cell's -b: it loads the index into the
CLI's own cache (cli._load_index_cached), builds the kernels' libraries
on a first run, and warms every kernel the traffic uses. The window is
one more `cli.main` call, fed through a named pipe the whole batches
that `seconds` buys at the traffic's sizing rate, its SAM read back
through another; a child process (plumb.py) does both, so no thread of
the benchmark's own process runs beside the port in the window, and
nothing large is written to disk. Its rate is every read it aligned over
its whole wall time.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np

from . import check, genome, trace, traffic
from .layout import CACHE_DIR, ROOT, Cell, metric_reader

PREFIX = b"r"
PLUMB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "plumb.py")
WAIT_S = 120.0


def process_start_epoch() -> float | None:
    """When this process started (epoch seconds), from /proc."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(x.split()[1]) for x in f if x.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return None


class Capture:
    """Keeps the aligner and AlignerStats of each CLI run
    (cli._run_with_writer) and the wall time of each GenomeIndex.load."""

    def __init__(self):
        self.aligner = self.stats = None
        self.index_load_s: list[float] = []
        self._saved = []

    def __enter__(self):
        from snap_tpu_torch import cli
        from snap_tpu_torch.index.index import GenomeIndex

        rww = cli._run_with_writer
        load = GenomeIndex.__dict__["load"]

        def run_with_writer(index, command_line, opts, run, aligner):
            self.aligner = aligner

            def counted(writer):
                self.stats = run(writer)
                return self.stats

            return rww(index, command_line, opts, counted, aligner)

        def timed_load(cls, *a, **kw):
            t0 = time.perf_counter()
            try:
                return load.__func__(cls, *a, **kw)
            finally:
                self.index_load_s.append(time.perf_counter() - t0)

        self._saved = [(cli, "_run_with_writer", rww), (GenomeIndex, "load", load)]
        cli._run_with_writer = run_with_writer
        GenomeIndex.load = classmethod(timed_load)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


class Plumbing:
    """The child process (plumb.py) that feeds one `cli.main` call the
    window's batches through a FASTQ pipe and reads its SAM from another,
    keeping the judged records."""

    def __init__(self, workdir: str, tag: str, pool_fq: str, batch_bytes: int,
                 n_batches: int, judged):
        self.fq, self.sam, self.result, jpath = (
            os.path.join(workdir, f"{tag}.{x}") for x in ("fq", "sam", "kept", "npy"))
        for p in (self.fq, self.sam):
            os.mkfifo(p)
        np.save(jpath, np.asarray(judged, np.int64))
        self.proc = subprocess.Popen([sys.executable, PLUMB, pool_fq, str(batch_bytes),
                                      str(n_batches), self.fq, self.sam, jpath, self.result],
                                     stdout=subprocess.PIPE)
        # its start and loads belong to set-up, not to the window
        if self.proc.stdout.readline() != b"ready\n":
            raise RuntimeError(f"plumb.py did not start: exit {self.proc.wait()}")

    def finish(self) -> tuple[int, dict[int, bytes]]:
        """(records the SAM held, {record number: line} of the judged)."""
        rc = self.proc.wait(WAIT_S)
        if rc != 0:
            raise RuntimeError(f"plumb.py exited {rc}")
        with open(self.result, "rb") as f:
            first, *rest = f.read().split(b"\n")
        kept = {}
        for x in rest:
            if x:
                r, line = x.split(b"\t", 1)
                kept[int(r)] = line
        return int(first), kept

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.proc.stdout.close()


def cli_call(argv_of, plumbing: Plumbing, device) -> tuple[int, float]:
    """One `cli.main` call between the plumbing's pipes: (exit code, wall
    seconds). argv_of(fastq path, sam path) -> argv."""
    from snap_tpu_torch import cli

    t0 = time.perf_counter()
    rc = cli.main(argv_of(plumbing.fq, plumbing.sam), device=device)
    return rc, time.perf_counter() - t0


@dataclass
class Window:
    """A run's traffic: the pool in the seed's order, its FASTQ batches,
    how many batches the window sends, and the reads (numbered in the
    window) whose records are judged: `sample` reads drawn from the seed,
    and `indel_sample` more drawn from the window's reads that carry an
    indel, so that a fixed share of the judged reads tests gaps."""

    batch: int
    pool_units: int
    pool: traffic.Pool
    batches: list
    n_batches: int
    judged: np.ndarray


def draw_window(tr: dict, codes: np.ndarray, seed: int, seconds: float) -> Window:
    """The pool is drawn from the traffic file's fixed `pool_seed`, so every
    run aligns the same reads; `seed` orders them and draws the sample."""
    B = tr["batch"]
    P = B * tr["pool_batches"]
    pool = traffic.draw_reads(np.random.default_rng(tr["pool_seed"]), codes, P, tr)
    rng = np.random.default_rng(seed)
    order = rng.permutation(P)
    pool = traffic.Pool(*(x[order] for x in dataclasses.astuple(pool)))
    batches = [traffic.fastq_bytes(PREFIX, i * B, pool.bases[i * B:(i + 1) * B],
                                   pool.quals[i * B:(i + 1) * B])
               for i in range(tr["pool_batches"])]
    # the window's work: whole batches for `seconds` at the rate the cell
    # was sized for, the same for every seed
    n_batches = max(1, round(seconds * tr["sizing_reads_per_s"] / B))
    units = n_batches * B
    sampled = rng.choice(units, size=min(tr["sample"], units), replace=False)
    indel = np.flatnonzero(pool.span[np.arange(units) % P] != tr["read_len"])
    indel = rng.choice(indel, size=min(tr["indel_sample"], indel.size), replace=False)
    return Window(B, P, pool, batches, n_batches, np.union1d(sampled, indel))


def run_cell(cell: Cell, seed: int, seconds: float, trace_on: bool, device,
             proc_start: float | None = None, log=sys.stderr, root: str = ROOT,
             cache_dir: str = CACHE_DIR) -> dict:
    """Run the cell once; returns the result line's dict (with `checks`
    last, and the traced record under `_record`). device is a
    torch.device; root holds BENCHMARK.json and benchmark/."""
    import torch

    from snap_tpu_torch import cli

    t_begin = time.time()
    proc_start = proc_start or t_begin
    cfg, tr = cell.config, cell.traffic
    codes, fasta = genome.prepare_genome(cfg, cache_dir)
    idx_dir, build_s = genome.prepare_index(cfg, fasta, device, cache_dir)
    w = draw_window(tr, codes, seed, seconds)
    B, n_batches = w.batch, w.n_batches

    def argv_of(fastq, sam):
        return ["single", idx_dir, fastq, "-o", sam, "-b", str(B), *tr["options"]]

    workdir = tempfile.mkdtemp(prefix="snapbench-")
    pool_fq = os.path.join(workdir, "pool.fq")
    tracer = None
    plumbs: list[Plumbing] = []

    def plumbing(tag, batches, judged):
        plumbs.append(Plumbing(workdir, tag, pool_fq, len(w.batches[0]), batches, judged))
        return plumbs[-1]

    try:
        with open(pool_fq, "wb") as f:
            f.writelines(w.batches)
        with Capture() as cap:
            rc, warm_s = cli_call(argv_of, plumbing("warm", 1, ()), device)
            if rc != 0:
                raise RuntimeError(f"warm-up call: exit {rc}")
            warm_records, _ = plumbs[-1].finish()
            window = plumbing("window", n_batches, w.judged)
            cuda = device.type == "cuda"
            if cuda:
                torch.cuda.synchronize(device)
                setup_peak = torch.cuda.max_memory_allocated(device)
                torch.cuda.reset_peak_memory_stats(device)
            if trace_on:
                tracer = trace.Tracer(device)
                tracer.install()
                tracer.start_profiler()
            t0_ns = time.time_ns()
            setup_s = t0_ns / 1e9 - proc_start
            rc, window_s = cli_call(argv_of, window, device)
            if cuda:
                torch.cuda.synchronize(device)
            t1_ns = time.time_ns()
            if tracer is not None:
                tracer.stop_profiler()
                tracer.uninstall()
            if rc != 0:
                raise RuntimeError(f"window call: exit {rc}")
            card_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
            memory_peak = max(card_peak, setup_peak) if cuda else 0
            stats, aligner = cap.stats, cap.aligner
            index_load_s = sum(cap.index_load_s)
        reads = n_batches * B
        record = {
            "mode": "single", "reads": reads, "window_s": window_s,
            "stats": {k: getattr(stats, k) for k in (
                "total", "seconds_reading", "seconds_writing", "align_seconds")},
            "branches": dict(aligner.branches),
            "card_peak_bytes": card_peak, "index_load_s": index_load_s,
        }
        if tracer is not None:
            record.update(tracer.record(t0_ns, t1_ns))
        del stats, aligner, cap
        cli._INDEX_CACHE.clear()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        # the check: every record due, and the judged reads' records
        t_check = time.perf_counter()
        seen, kept = window.finish()
        judged = check.judge(codes, cfg["contig"].encode(), w.pool, PREFIX,
                             {int(u): kept.get(int(u)) for u in w.judged}, w.pool_units,
                             reads, seen, device)
        check_s = time.perf_counter() - t_check
    finally:
        if tracer is not None:
            tracer.uninstall()
        for p in plumbs:
            p.stop()
        shutil.rmtree(workdir, ignore_errors=True)

    limits = cell.limits
    checks = {
        "missing_records": {"value": judged.missing_records, "limit": 0},
        "inconsistent_records": {"value": judged.inconsistent_records, "limit": 0},
        "wrong_share": {"value": judged.wrong_share, "limit": limits["wrong_share"]},
    }
    correct = (judged.missing_records == 0 and judged.inconsistent_records == 0
               and judged.judged > 0 and judged.wrong_share <= limits["wrong_share"])
    if trace_on:
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"], root)(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"reads_per_s": reads / window_s, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in values}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": int(reads),
              "failed": int(judged.missing_records + judged.inconsistent_records + judged.wrong),
              "metrics": metrics, "device": dev}
    if trace_on:
        busy = trace.union_ns((s, e) for _, s, e in record.get("device_ops", []))
        dev["busy_s"] = busy / 1e9
        dev["window_s"] = (t1_ns - t0_ns) / 1e9
        result["breakdown"] = trace.breakdown(record)
    result["checks"] = checks
    print(f"warm-up: {warm_records} records for {B}; "
          f"window {window_s:.3f} s, {reads} reads, {reads / window_s:.1f} reads/s; "
          f"set-up {setup_s:.3f} s (index build {build_s:.1f} s, warm-up call {warm_s:.3f} s, "
          f"index load {index_load_s:.3f} s); check {check_s:.3f} s over {judged.judged} "
          f"reads: worse {judged.worse}, overconfident {judged.overconfident}, "
          f"underconfident {judged.underconfident}", file=log)
    for kind, notes in judged.notes.items():
        for n in notes:
            print(f"note {kind} {n}", file=log)
    result["_record"] = record
    return result
