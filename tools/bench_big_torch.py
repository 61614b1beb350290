"""BASELINE config 4 on one card: an hg38-scale index and a 10M-read
run, the port's counterpart of tools/bench_big.py.

Loads an index that tools/build_big_index_torch.py (or
tools/build_big_index.py) wrote, draws 100 bp reads from its genome with
the JAX tool's sampler (numpy seed 0, contigs by length, --mutate
substitutions), aligns them batch by batch through the port's device
step (align_winners_device, non-adaptive, default dp_rows) and counts
what the JAX tool counts, from HostWinners of each batch's packed
winners.

Before anything goes to a card, the bytes that make_device_index places
there (card_bytes) are held against torch.cuda.mem_get_info(): an index
that does not fit stops the run with both figures. No part of it stays
on the host and nothing moves to the CPU. --device cuda is the default
and raises without a card; --device cpu runs the plain PyTorch path.

  python tools/bench_big_torch.py <index-dir> [--reads 10000000]
         [--batch 16384] [--out BIGIDX_torch.json]

The last line of stdout is one JSON object: the JAX tool's keys (backend
is the torch device type), then the card's nvidia-smi name and power
limit, card_index_bytes, card_peak_bytes (torch.cuda.max_memory_allocated
from the load on), host_peak_rss_bytes (the process's), step_ms_median
(the wall of align_winners_device and the winners' copy to the host, per
batch: the step without the host's read sampling) and the raw counts. --first-winners PATH saves the first
batch's packed winners (.npy) for a card-vs-CPU comparison in another
process; --cpu-check N makes one in this process (cpu_check).
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def card_bytes(table_shape, n_hits: int, n_bases: int) -> int:
    """The bytes of the DeviceIndex that make_device_index builds from a
    table of `table_shape` uint32 words, `n_hits` hit entries and a
    genome of `n_bases` bases: the table; the hits with 8+ zero entries
    to a multiple of 8; the genome PAD-padded to a multiple of 8 bytes;
    the packed words and the bad mask, 16 bases a word, 8+ words of
    padding to a multiple of 8."""
    table = int(np.prod(table_shape, dtype=np.int64)) * 4
    hits = (n_hits + 8 + (-(n_hits + 8)) % 8) * 4
    genome = n_bases + (-n_bases) % 8
    n16 = (n_bases + 15) // 16
    words = (n16 + 8 + (-(n16 + 8)) % 8) * 4
    return table + hits + genome + 2 * words


def fit_check(table_shape, n_hits: int, n_bases: int, free: int, total: int) -> int:
    """card_bytes of the index; raises if they exceed `free`, the free
    bytes that torch.cuda.mem_get_info() gives (of `total`)."""
    need = card_bytes(table_shape, n_hits, n_bases)
    if need > free:
        raise RuntimeError(
            f"the index needs {need:,} bytes on the card (table "
            f"{tuple(table_shape)} of uint32, {n_hits:,} hits, {n_bases:,} "
            f"bases) but torch.cuda.mem_get_info() gives {free:,} bytes free "
            f"of {total:,}; nothing was copied to the card"
        )
    return need


def index_shapes(index_dir: str):
    """(table shape, hits, genome bases) of a saved index, read from the
    files' headers (a chunked build's arrays are memory maps)."""
    from snap_tpu_torch.genome import Genome
    from snap_tpu_torch.index.build import load_index_arrays

    arrays = load_index_arrays(index_dir)
    genome = Genome.load(index_dir)
    return tuple(arrays["table"].shape), int(arrays["hits"].shape[0]), genome.num_bases


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("index_dir")
    ap.add_argument("--reads", type=int, default=10_000_000)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--out", default="BIGIDX_torch.json")
    ap.add_argument("--mutate", type=float, default=0.01)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--first-winners", metavar="PATH",
                    help="save the first batch's packed winners (.npy)")
    ap.add_argument("--cpu-check", type=int, default=0, metavar="N",
                    help="after the run, align the first batch's first N reads "
                         "as one batch on the device and on the CPU, and raise "
                         "unless their packed winners are equal bit for bit")
    args = ap.parse_args(argv)

    import torch

    from snap_tpu_torch import resolve_device
    from snap_tpu_torch.align.pipeline import AlignParams, HostWinners, align_winners_device
    from snap_tpu_torch.index.index import GenomeIndex

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        free, total = torch.cuda.mem_get_info(dev)
        fit_check(*index_shapes(args.index_dir), free, total)
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.time()
    print(f"loading index from {args.index_dir}...", flush=True)
    index = GenomeIndex.load(args.index_dir, dev)
    if cuda:
        torch.cuda.synchronize(dev)
    genome = index.genome_meta
    didx = index.device
    load_s = time.time() - t0
    print(
        f"index loaded in {load_s:.0f}s: table {tuple(didx.table.shape)}, "
        f"hits {didx.hits.shape[0]:,}, genome {didx.genome.shape[0]:,}",
        flush=True,
    )
    index_bytes = sum(t.numel() * t.element_size() for t in didx)

    params = AlignParams(
        seed_len=index.seed_len, max_probe=index.max_probe,
        num_seeds=14, hit_cap=8, max_cand=16,
    )
    # the sampler reads random windows: from a copy in host memory, not
    # the index's memory map (whose page faults then set the rate)
    bases_np = np.array(genome.bases)
    L, B = args.read_len, args.batch
    fas = torch.tensor(genome.first_alt_start(), dtype=torch.int64, device=dev)

    rng = np.random.default_rng(0)
    # sample read starts inside contigs (avoid padding)
    contigs = genome.contigs
    cstarts = np.array([c.start for c in contigs], np.int64)
    clens = np.array([c.length for c in contigs], np.int64)
    cprob = clens / clens.sum()

    n_total = args.reads
    n_batches = (n_total + B - 1) // B
    done = found_total = pos_ok = 0
    mapq_hist = np.zeros(71, np.int64)
    quals = torch.full((B, L), ord("I"), dtype=torch.uint8, device=dev)
    lens = torch.full((B,), L, dtype=torch.int32, device=dev)
    step_ms = []

    t1 = time.time()
    last_log = t1
    for bi in range(n_batches):
        ci = rng.choice(len(contigs), size=B, p=cprob)
        offs = (rng.random(B) * (clens[ci] - L - 1)).astype(np.int64)
        starts = cstarts[ci] + offs
        reads = bases_np[starts[:, None] + np.arange(L)[None, :]]
        mut = rng.random(reads.shape) < args.mutate
        reads = np.where(mut, rng.integers(0, 4, reads.shape), reads).astype(np.uint8)
        if bi == 0:
            first_reads = reads
        reads_d = torch.from_numpy(reads).to(dev)
        ts = time.perf_counter()
        win, _, _ = align_winners_device(didx, reads_d, quals, lens, fas, params)
        packed = win.cpu().numpy()
        step_ms.append((time.perf_counter() - ts) * 1e3)
        if bi == 0 and args.first_winners:
            np.save(args.first_winners, packed)
        hw = HostWinners(packed)
        found_total += int(hw.found.sum())
        np.add.at(mapq_hist, np.minimum(hw.mapq, 70), 1)
        pos_ok += int((np.abs(hw.body_loc - starts) <= 32)[hw.found].sum())
        done += B
        now = time.time()
        if now - last_log >= 30:
            print(
                f"[{now - t1:7.0f}s] {done:,}/{n_total:,} reads "
                f"({done / (now - t1):,.0f} reads/s)",
                flush=True,
            )
            last_log = now
    dt = time.time() - t1
    cpu_check = None
    if args.cpu_check:
        cpu_check = check_on_cpu(index, first_reads[: args.cpu_check], fas, params)
    rec = {
        "metric": "hg38_scale_10M_read_batch",
        "genome_bases": int(genome.num_bases),
        "index_load_seconds": round(load_s, 1),
        "reads": done,
        "align_seconds": round(dt, 1),
        "reads_per_sec": round(done / dt, 1),
        "frac_aligned": round(found_total / done, 4),
        "frac_pos_correct_of_aligned": round(pos_ok / max(1, found_total), 4),
        "mapq_ge_10": int(mapq_hist[10:].sum()),
        "backend": dev.type,
    }
    if cuda:
        from chip_smoke import nvidia_smi_line

        rec["device"] = nvidia_smi_line()
        rec["card_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    else:
        rec["device"] = str(dev)
        rec["card_peak_bytes"] = None
    rec.update({
        "card_index_bytes": index_bytes,
        "host_peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
        "step_ms_median": float(np.median(step_ms)),
        "step_ms_first": step_ms[0],
        "batch": B,
        "found": found_total,
        "pos_ok": pos_ok,
        "table_shape": list(didx.table.shape),
        "max_probe": index.max_probe,
        "cpu_check": cpu_check,
    })
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)
    if cpu_check and cpu_check["rows_differ"]:
        raise RuntimeError(f"device and CPU packed winners differ: {cpu_check}")
    return rec


def check_on_cpu(index, reads: np.ndarray, fas, params) -> dict:
    """`reads` as one batch through align_winners_device on the index's
    device and on a CPU view of the same index (index.on: the table
    stays a host memory map): the packed winner rows that differ."""
    import torch

    from snap_tpu_torch.align.pipeline import align_winners_device

    n, L = reads.shape
    out = []
    for dev, didx in ((index.torch_device, index.device),
                      (torch.device("cpu"), index.on("cpu"))):
        win, _, _ = align_winners_device(
            didx, torch.from_numpy(reads).to(dev),
            torch.full((n, L), ord("I"), dtype=torch.uint8, device=dev),
            torch.full((n,), L, dtype=torch.int32, device=dev),
            fas.to(dev), params)
        out.append(win.cpu().numpy())
    rows = np.nonzero((out[0] != out[1]).any(axis=1))[0]
    return {"reads": n, "rows_differ": int(rows.size),
            "first_rows": [{"row": int(r), "device": out[0][r].tolist(),
                            "cpu": out[1][r].tolist()} for r in rows[:4]]}


if __name__ == "__main__":
    main()
