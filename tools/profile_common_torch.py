"""Set-up and timing shared by the port's profiling tools
(profile_step_torch.py, profile_host_torch.py, profile_e2e_torch.py).

The inputs are the JAX tools' (tools/profile_*.py, prof4.py,
bench_batch_sweep.py): one contig of `--genome` random bases (or
chip_smoke.gen_repeat_genome's planted repeats, the model of bench.py's)
at location 1000 with PAD on both sides, reads drawn uniformly from it
with `--err` substitutions, all from a numpy seed. Imports torch, numpy,
snap_tpu_torch and chip_smoke's helpers; never JAX or snap_tpu.

Timing on the card (time_call): each sample is one call between CUDA
events on the current stream, then torch.cuda.synchronize():
  wall_ms    host clock from the call to the end of the synchronize;
  device_ms  the events' span on the stream, which also counts the gaps
             where the card waited for the host to enqueue work;
  busy_ms    (busy_call) the union of the card's kernel and copy
             intervals of one call under torch.profiler: the card's own
             work. wall_ms - busy_ms is the time the host holds it back.
A stage that copies to the host inside (.cpu(), .numpy()) waits there,
so its wall and device times cover the wait. On the CPU only wall_ms is
measured; the device fields are None.
"""

from __future__ import annotations

import io
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

SEED_LEN = 24
READ_PAD = 128       # ReadBatch width of the JAX tools
GENOME_START = 1000  # the contig's first location (the JAX tools' layout)

# functions through which the host waits for the card: on CUDA, cProfile
# charges the card's queued work to whichever of them synchronizes
WAIT_FUNCTIONS = ("cpu", "numpy", "item", "tolist", "synchronize",
                  "_cuda_synchronize", "__bool__", "__int__", "__float__")


def add_common_flags(ap, iters: int) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--iters", type=int, default=iters, help="timed samples")
    ap.add_argument("--warm", type=int, default=1,
                    help="untimed calls before the samples")
    ap.add_argument("--genome", type=int, default=1_000_000)
    ap.add_argument("--read-len", type=int, default=100)


def setup_device(name: str):
    """The torch.device of a run (raises when CUDA is asked for and
    absent). A CPU run takes one torch thread, as the tests do."""
    import torch

    from snap_tpu_torch import resolve_device

    dev = resolve_device(name)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    return dev


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def make_genome(rng, glen: int, repeat_frac: float = 0.0):
    """(codes [glen] uint8, the port's Genome): one contig `chr1` at
    GENOME_START, PAD on both sides."""
    from snap_tpu_torch.constants import PAD
    from snap_tpu_torch.genome import Contig, Genome

    if repeat_frac > 0:
        from chip_smoke import gen_repeat_genome

        codes = gen_repeat_genome(rng, glen, repeat_frac)
    else:
        codes = rng.integers(0, 4, size=glen).astype(np.uint8)
    bases = np.full(glen + 2 * GENOME_START, PAD, dtype=np.uint8)
    bases[GENOME_START : GENOME_START + glen] = codes
    return codes, Genome(
        bases=bases,
        contigs=[Contig(name="chr1", start=GENOME_START, length=glen)],
    )


def simulate_reads(rng, codes: np.ndarray, n: int, L: int, err: float) -> np.ndarray:
    """[n, L] uint8: uniform starts, then substitutions at rate err."""
    starts = rng.integers(0, codes.size - L - 1, size=n)
    reads = codes[starts[:, None] + np.arange(L)[None, :]]
    mut = rng.random(reads.shape) < err
    return np.where(mut, rng.integers(0, 4, reads.shape), reads).astype(np.uint8)


def read_batch(reads: np.ndarray, ids: list[bytes]):
    """A ReadBatch of READ_PAD columns, every base quality 'I'."""
    from snap_tpu_torch.io.fastq import ReadBatch

    B, L = reads.shape
    bases = np.full((B, READ_PAD), 4, np.uint8)
    bases[:, :L] = reads
    quals = np.zeros((B, READ_PAD), np.uint8)
    quals[:, :L] = ord("I")
    return ReadBatch(ids=ids, bases=bases, quals=quals,
                     lengths=np.full(B, L, np.int32))


def align_batch_timed(aligner, writer, batch, plan_ok: bool) -> dict:
    """One batch through a SingleEndAligner as its file loop runs it:
    _submit (the step dispatched, the winners' copy to pinned memory
    started), the wait for that copy's CUDA event (no second copy),
    _finalize, then _emit_planned (per-read _emit when plan_ok is
    false); the seconds of each."""
    t0 = time.perf_counter()
    handles, fc = aligner._submit(batch)
    t1 = time.perf_counter()
    if handles[0] == "fast":
        pf = aligner._win_futures.get(id(handles[1]))
        if pf is not None and pf[2] is not None:
            pf[2].synchronize()
    t2 = time.perf_counter()
    if plan_ok:
        results, plan = aligner._finalize(batch, handles, fc, plan_writer=writer)
    else:
        results, plan = aligner._finalize(batch, handles, fc), None
    t3 = time.perf_counter()
    if plan is not None:
        aligner._emit_planned(writer, batch, results, plan)
    else:
        for i, res in enumerate(results):
            aligner._emit(writer, batch, i, res)
    t4 = time.perf_counter()
    return {"submit": t1 - t0, "getwin": t2 - t1, "finalize": t3 - t2, "emit": t4 - t3}


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_call(fn, device, iters: int, warm: int = 1) -> dict:
    """Median wall_ms and device_ms of fn() over `iters` samples after
    `warm` untimed calls (module docstring)."""
    import torch

    for _ in range(warm):
        fn()
        sync(device)
    cuda = device.type == "cuda"
    walls, devs = [], []
    for _ in range(max(1, iters)):
        if cuda:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
        t0 = time.perf_counter()
        fn()
        if cuda:
            e.record()
        sync(device)
        walls.append(time.perf_counter() - t0)
        if cuda:
            devs.append(s.elapsed_time(e))
    return {"wall_ms": float(np.median(walls)) * 1e3,
            "device_ms": float(np.median(devs)) if devs else None,
            "samples": len(walls)}


def busy_call(fn, device) -> dict:
    """The card's busy milliseconds (union of its kernel and copy
    intervals) and device operations of one fn() call under
    torch.profiler; None on the CPU. One call: the profiler's processing
    of its events costs seconds a step."""
    if device.type != "cuda":
        return {"busy_ms": None, "device_ops_per_call": None}
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync(device)
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy, end = 0.0, -1.0
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return {"busy_ms": busy / 1e3, "device_ops_per_call": len(spans)}


def _bare(name: str) -> str:
    """A cProfile function name without its decoration: "<method 'cpu'
    of ...>" -> cpu, "<built-in method torch._C._cuda_synchronize>" ->
    _cuda_synchronize."""
    if name.startswith("<method '"):
        return name.split("'")[1]
    if name.startswith("<built-in method "):
        return name[len("<built-in method "):-1].split(".")[-1]
    return name


class Profiled:
    """cProfile around a block; rows() gives its top functions by
    cumulative seconds, each marked `wait` when, on the card, it is one
    of WAIT_FUNCTIONS: the host's wait for queued card work is charged to
    the call that synchronizes, not to the work itself."""

    def __init__(self, device):
        import cProfile

        self.device = device
        self.prof = cProfile.Profile()

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.prof.enable()
        return self

    def __exit__(self, *exc):
        self.prof.disable()
        self.wall_s = time.perf_counter() - self.t0
        return False

    def rows(self, top: int) -> list[dict]:
        import pstats

        st = pstats.Stats(self.prof, stream=io.StringIO())
        items = sorted(st.stats.items(), key=lambda kv: -kv[1][3])[:top]
        cuda = self.device.type == "cuda"
        out = []
        for (f, ln, name), (_, nc, tt, ct, _) in items:
            where = os.path.relpath(f, REPO) if f.startswith(REPO) else f
            out.append({
                "fn": f"{where}:{ln}:{name}", "calls": nc, "own_s": tt, "cum_s": ct,
                "wait": cuda and _bare(name) in WAIT_FUNCTIONS,
            })
        return out


def print_rows(rows: list[dict]) -> None:
    print(f"{'cum s':>9} {'own s':>9} {'calls':>8}  function")
    for r in rows:
        tag = "  [waits on the card]" if r["wait"] else ""
        print(f"{r['cum_s']:9.3f} {r['own_s']:9.3f} {r['calls']:8d}  {r['fn']}{tag}")


def finish(result: dict, device) -> dict:
    """Name the device the figures were taken on (on CUDA with the card's
    nvidia-smi name and power limit), print the result as the last line,
    and return it."""
    import torch

    result["device"] = str(device)
    if device.type == "cuda":
        from chip_smoke import nvidia_smi_line

        result["card"] = torch.cuda.get_device_name(device)
        result["nvidia_smi"] = nvidia_smi_line()
    print(json.dumps(result), flush=True)
    return result
