"""Stage-by-stage profile of the port's single-end device step, and its
rate at several batch sizes.

The counterpart of tools/profile_device_step.py, profile_stages.py,
prof4.py and bench_batch_sweep.py, on their inputs (1 Mbp random genome,
seed 24, 16384 x 100 bp reads at 1% substitutions, num_seeds 25,
hit_cap 8, max_cand 16; profile_stages.py's num_seeds 14 is not kept).
Each stage times one of the port's own functions on the inputs the step
gives it, so a stage is what the step runs:

  sync                 a null op on 8 elements and its copy to the host
                       (the fixed cost of one synchronized sample)
  clip_back, reverse_complement, pack_read_seeds
                       the seed stage's functions (pipeline, index)
  probe, gather_hits   index.probe on the canonical keys at num_lookups
                       evenly spaced offsets (prof4.py's proxy of the
                       rank order) and index.gather_hits both ways
  candidates           _align_impl: seeds, rank order, probe, gather,
                       sort + dedup + top-K (the last two have no function
                       of their own in the port; see `inline` in the JSON)
  align_tier1, align_single_device
  a_candidates, a_score, a_finalize
                       _awd_candidates / _awd_score / _awd_finalize at
                       phase A's shapes (K 4, first seed pass, the step's
                       dp_rows)
  full, adaptive       align_winners_device(adaptive=False / True), the
                       packed winners left on the card
  full_d2h, adaptive_d2h
                       the same, and the winners copied to the host
  d2h                  the packed winners' copy to the host alone

Each stage prints device ms against wall ms (profile_common_torch says
how each is taken); --sizes runs bench_batch_sweep.py's pipelined loop
(step i+1 dispatched before step i's winners are fetched) at each batch
size. Progress goes to stderr; the last line of stdout is one JSON
object holding every figure (on the card with nvidia-smi's name and
power limit).

    python tools/profile_step_torch.py                          # the card
    python tools/profile_step_torch.py --sizes 16384,32768,65536
    python tools/profile_step_torch.py --device cpu --batch 64 --genome 60000 --iters 1
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_common_torch import (  # noqa: E402
    SEED_LEN, add_common_flags, busy_call, finish, log, make_genome,
    setup_device, simulate_reads, time_call,
)

STAGES = (
    "sync", "clip_back", "reverse_complement", "pack_read_seeds", "probe",
    "gather_hits", "candidates", "align_tier1", "align_single_device",
    "a_candidates", "a_score", "a_finalize", "full", "adaptive",
    "full_d2h", "adaptive_d2h", "d2h",
)

# what a stage takes from an earlier one (build_stages' `need`)
NEEDS = {"reverse_complement": "len_eff", "probe": "canon", "gather_hits": "probe",
         "a_score": "bundle_a", "a_finalize": "score_a", "d2h": "win"}

# stages of the JAX tools that the port computes inside another function
INLINE = {
    "rank_select": "inline in pipeline._align_impl (timed within candidates)",
    "sort_dedup_topk": "inline in pipeline._align_impl (timed within candidates)",
}


@dataclasses.dataclass
class Context:
    """The inputs of every stage: numpy (for a reference to take) and
    their tensors on the run's device."""

    device: object
    codes: np.ndarray     # [glen] uint8, the contig's bases
    genome: object        # snap_tpu_torch Genome
    arrays: dict          # index arrays (index.build.build_index)
    reads: np.ndarray     # [B, L] uint8
    quals: np.ndarray     # [B, L] uint8
    lens: np.ndarray      # [B] int32
    params_kw: dict       # AlignParams fields
    didx: object
    bases_t: object
    quals_t: object
    lens_t: object


def make_context(device, batch: int, read_len: int, glen: int, err: float) -> Context:
    import torch

    from snap_tpu_torch.index.build import build_index
    from snap_tpu_torch.index.index import make_device_index

    rng = np.random.default_rng(0)
    codes, genome = make_genome(rng, glen)
    log("building index...")
    arrays = build_index(genome, seed_len=SEED_LEN)
    didx = make_device_index(arrays, genome.bases, device)
    reads = simulate_reads(rng, codes, batch, read_len, err)
    quals = np.full((batch, read_len), ord("I"), np.uint8)
    lens = np.full(batch, read_len, np.int32)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return Context(
        device=device, codes=codes, genome=genome, arrays=arrays, reads=reads, quals=quals,
        lens=lens,
        params_kw=dict(seed_len=SEED_LEN, max_probe=arrays["max_probe"],
                       num_seeds=25, hit_cap=8, max_cand=16),
        didx=didx, bases_t=to(reads), quals_t=to(quals), lens_t=to(lens),
    )


def phase_a(params, B: int, L: int):
    """Phase A's AlignParams and dp_rows, as align_winners_device makes
    them (pipeline._awd_phase_a)."""
    P = L - params.seed_len + 1
    s1 = (P - 1) // params.seed_len + 1 if P > 0 else 1
    K_A = min(4, params.max_cand)
    params_a = dataclasses.replace(params, num_seeds=2 * s1 - 2, max_cand=K_A)
    return params_a, max(512, (B * K_A) // 16)


def probe_offsets(params, L: int) -> np.ndarray:
    """prof4.py's proxy for the step's rank order: num_lookups offsets
    evenly spaced over the read."""
    return np.linspace(0, L - params.seed_len, params.num_lookups).astype(np.int64)


def build_stages(ctx: Context) -> tuple:
    """(name -> a function of no arguments that runs the stage once and
    returns its outputs, prepare(name)). What a stage takes from an
    earlier one (NEEDS) is computed once, by prepare or when the stage
    first asks for it."""
    import torch

    from snap_tpu_torch.align import pipeline as P
    from snap_tpu_torch.index.index import gather_hits, pack_read_seeds, probe, u64_min

    params = P.AlignParams(**ctx.params_kw)
    didx, b, q, l = ctx.didx, ctx.bases_t, ctx.quals_t, ctx.lens_t
    B, L = b.shape
    fas = torch.tensor(int(ctx.genome.bases.shape[0]), dtype=torch.int64, device=ctx.device)
    H = params.hit_cap
    params_a, dp_a = phase_a(params, B, L)
    tiny = torch.arange(8, device=ctx.device)
    made: dict = {}

    def need(key):
        if key not in made:
            if key == "len_eff":
                made[key] = P.clip_back(q, l)
            elif key == "canon":
                fwd, rc, _ = pack_read_seeds(b, params.seed_len)
                offs = torch.as_tensor(probe_offsets(params, L), device=ctx.device)
                made[key] = u64_min(fwd[:, offs], rc[:, offs]).reshape(-1)
            elif key == "probe":
                made[key] = probe(didx, need("canon"), params.max_probe)
            elif key == "bundle_a":
                made[key] = P._awd_candidates(didx, b, q, l, params_a, return_lowest=True)[0]
            elif key == "score_a":
                made[key] = P._awd_score(didx, b, q, need("bundle_a"), params_a, dp_a)
            elif key == "win":
                made[key] = step(True)
        return made[key]

    def step(adaptive):
        return P.align_winners_device(didx, b, q, l, fas, params, adaptive=adaptive)[0]

    def gather():
        _, start, n0, n1 = need("probe")
        return (gather_hits(didx.hits, start, n0, H),
                gather_hits(didx.hits, start + n0.to(torch.int64), n1, H))

    def a_finalize():
        out_a, needs_a = need("score_a")
        return P._awd_finalize(didx, b, out_a, fas, needs_a, params, dp_a, True, 64,
                               return_scores=True)

    def prepare(name):
        if name in NEEDS:
            need(NEEDS[name])

    return {
        "sync": lambda: (tiny + 1).cpu(),
        "clip_back": lambda: P.clip_back(q, l),
        "reverse_complement": lambda: P.reverse_complement_reads(b, q, need("len_eff")),
        "pack_read_seeds": lambda: pack_read_seeds(b, params.seed_len),
        "probe": lambda: probe(didx, need("canon"), params.max_probe),
        "gather_hits": gather,
        "candidates": lambda: P._awd_candidates(didx, b, q, l, params),
        "align_tier1": lambda: P.align_tier1(didx, b, q, l, params),
        "align_single_device": lambda: P.align_single_device(didx, b, q, l, params),
        "a_candidates": lambda: P._awd_candidates(didx, b, q, l, params_a,
                                                  return_lowest=True),
        "a_score": lambda: P._awd_score(didx, b, q, need("bundle_a"), params_a, dp_a),
        "a_finalize": a_finalize,
        "full": lambda: step(False),
        "adaptive": lambda: step(True),
        "full_d2h": lambda: step(False).cpu(),
        "adaptive_d2h": lambda: step(True).cpu(),
        "d2h": lambda: need("win").cpu(),
    }, prepare


def run_stages(ctx: Context, names, iters: int, warm: int) -> dict:
    stages, prepare = build_stages(ctx)
    B = ctx.reads.shape[0]
    out = {}
    for name in names:
        log(f"stage {name}")
        prepare(name)
        fn = stages[name]
        r = time_call(fn, ctx.device, iters, warm)
        r.update(busy_call(fn, ctx.device))
        r["reads_per_s"] = B / (r["wall_ms"] / 1e3)
        out[name] = r
        dev, busy = (f"{r[k]:9.3f} ms" if r[k] is not None else "not measured"
                     for k in ("device_ms", "busy_ms"))
        print(f"{name:22s} wall {r['wall_ms']:9.3f} ms  device {dev}  busy {busy}  "
              f"{r['reads_per_s']:>12,.0f} r/s", flush=True)
    return out


def sweep(ctx: Context, sizes, iters: int, err: float) -> list[dict]:
    """bench_batch_sweep.py's loop: at each batch size, one settling
    step, then `iters` steps pipelined, step i+1 dispatched before step
    i's winners are copied to the host."""
    import torch

    from snap_tpu_torch.align import pipeline as P

    params = P.AlignParams(**ctx.params_kw)
    rng = np.random.default_rng(1)
    fas = torch.tensor(int(ctx.genome.bases.shape[0]), dtype=torch.int64, device=ctx.device)
    L = ctx.reads.shape[1]
    rows = []
    for batch in sizes:
        log(f"sweep batch {batch}")
        reads = simulate_reads(rng, ctx.codes, batch, L, err)
        b = torch.from_numpy(reads).to(ctx.device)
        q = torch.full((batch, L), ord("I"), dtype=torch.uint8, device=ctx.device)
        ln = torch.full((batch,), L, dtype=torch.int32, device=ctx.device)

        def step():
            return P.align_winners_device(ctx.didx, b, q, ln, fas, params, adaptive=True)[0]

        t0 = time.perf_counter()
        step().cpu()
        tc = time.perf_counter() - t0
        n = max(1, iters)
        t0 = time.perf_counter()
        nxt = step()
        for _ in range(n - 1):
            cur, nxt = nxt, step()
            cur.cpu()
        nxt.cpu()
        dt = time.perf_counter() - t0
        rows.append({"batch": batch, "steps": n, "reads_per_s": batch * n / dt,
                     "ms_per_step": dt / n * 1e3, "first_step_s": tc})
        print(f"batch {batch:6d}: {batch * n / dt:12,.0f} reads/s "
              f"(first step {tc:.2f}s)", flush=True)
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_flags(ap, iters=8)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--err", type=float, default=0.01)
    ap.add_argument("--stages", default=",".join(STAGES),
                    help="comma-separated stages ('' for none)")
    ap.add_argument("--sizes", default="",
                    help="batch sizes of the pipelined step-rate loop, e.g. 16384,32768,65536")
    args = ap.parse_args(argv)
    names = [s for s in args.stages.split(",") if s]
    unknown = sorted(set(names) - set(STAGES))
    if unknown:
        ap.error(f"unknown stages {unknown}; known: {','.join(STAGES)}")
    device = setup_device(args.device)
    ctx = make_context(device, args.batch, args.read_len, args.genome, args.err)
    result = {
        "tool": "profile_step_torch", "batch": args.batch, "read_len": args.read_len,
        "genome": args.genome, "params": ctx.params_kw, "iters": args.iters,
        "stages": run_stages(ctx, names, args.iters, args.warm),
        "inline": INLINE,
    }
    if args.sizes:
        result["sweep"] = sweep(ctx, [int(s) for s in args.sizes.split(",")],
                                args.iters, args.err)
    return finish(result, device)


if __name__ == "__main__":
    main()
