"""Genome index builder: canonical-seed hash table + CSR hit lists.

Counterpart of snap_tpu.index.build (same on-disk format v3, so an
index saved by either package loads in the other). Semantics follow
SNAP's GenomeIndex.cpp (BuildIndexToDirectory, :527-1010):

- every non-N seed position contributes its canonical seed
  min(seed, reverse_complement(seed));
- per-seed hit lists are sorted in DESCENDING genome order;
- lookups return forward hits and RC hits separately.

Layout (format v3):

- `table`: [n_banks, bank_slots, 4] uint32 — per slot
  (key_lo, key_hi, hits_start, n0 | n1 << 16), counts clamped at 0xFFFF.
- `hits`: flat uint32 CSR; per key the orientation-0 list (descending)
  then the orientation-1 list (descending).
- bank = murmur & (n_banks-1); home bucket within the bank =
  (murmur >> log2(n_banks)) & (bank_buckets-1); keys overflow greedily
  into following buckets (bounded by SPAN_SLACK spare buckets per bank).

Orientation 0 = genome seed equals the canonical seed; orientation 1 =
genome seed is the reverse complement of the canonical seed.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..constants import DEFAULT_SEED_LEN
from ..genome import Genome

EMPTY_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)
# rc(all-ones) = 0, so the all-ones pattern can never be canonical.

BUCKET_SLOTS = 8   # slots per hash bucket; a probe reads whole buckets
SPAN_SLACK = 64    # spare overflow buckets reserved at each bank's end
COUNT_CLAMP = 0xFFFF


def murmur_finalize64(keys: np.ndarray) -> np.ndarray:
    """MurmurHash3 64-bit finalizer (public domain; ref: HashTable.h:72-85)."""
    k = keys.astype(np.uint64, copy=True)
    with np.errstate(over="ignore"):
        k ^= k >> np.uint64(33)
        k *= np.uint64(0xFF51AFD7ED558CCD)
        k ^= k >> np.uint64(33)
        k *= np.uint64(0xC4CEB9FE1A85EC53)
        k ^= k >> np.uint64(33)
    return k


def pack_seeds(bases: np.ndarray, positions: np.ndarray, seed_len: int):
    """Pack 2-bit seeds at `positions`. Returns (fwd, rc, valid).

    fwd[p] has the base at p in the high bits (string order), rc is the
    packed reverse complement, valid = the window has only ACGT.
    """
    fwd = np.zeros(len(positions), dtype=np.uint64)
    rc = np.zeros(len(positions), dtype=np.uint64)
    valid = np.ones(len(positions), dtype=bool)
    for i in range(seed_len):
        b = bases[positions + i].astype(np.uint64)
        valid &= b < 4
        bs = np.where(b < 4, b, 0).astype(np.uint64)
        fwd = (fwd << np.uint64(2)) | bs
        # complement of base at p+i goes to rc bit position i (from low end)
        rc |= (np.uint64(3) - bs) << np.uint64(2 * i)
    return fwd, rc, valid


def pack_seeds_range(bases: np.ndarray, lo: int, hi: int, seed_len: int):
    """Pack the 2-bit seeds at the contiguous positions [lo, hi).

    Returns (fwd, rc, valid): fwd has the base at p in the high bits
    (string order), rc is the packed reverse complement, valid = the
    window holds only ACGT. Four bases are funneled into one byte before
    the u64 extends, so the seed loop runs seed_len/4 times.
    """
    n = hi - lo
    win = bases[lo : hi + seed_len - 1]
    m = win.shape[0]
    with np.errstate(over="ignore"):
        # q[j] packs bases j..j+3 string-order (j in the high bits).
        # Bytes touching a base >= 4 hold garbage, but every seed whose
        # window contains that base is marked invalid below and dropped.
        q = (
            (win[: m - 3] << np.uint8(6))
            | (win[1 : m - 2] << np.uint8(4))
            | (win[2 : m - 1] << np.uint8(2))
            | win[3:]
        )
        cb = np.uint8(3) - win
        # rq[j] packs complements reversed: base j in the low bits
        rq = (
            cb[: m - 3]
            | (cb[1 : m - 2] << np.uint8(2))
            | (cb[2 : m - 1] << np.uint8(4))
            | (cb[3:] << np.uint8(6))
        )
    fwd = np.zeros(n, dtype=np.uint64)
    rc = np.zeros(n, dtype=np.uint64)
    for j in range(seed_len // 4):
        i = 4 * j
        fwd |= q[i : i + n].astype(np.uint64) << np.uint64(
            2 * (seed_len - 4 - i)
        )
        rc |= rq[i : i + n].astype(np.uint64) << np.uint64(2 * i)
    for i in range(4 * (seed_len // 4), seed_len):  # tail bases
        b = np.where(win[i : i + n] < 4, win[i : i + n], 0).astype(
            np.uint64
        )
        fwd |= b << np.uint64(2 * (seed_len - 1 - i))
        rc |= (np.uint64(3) - b) << np.uint64(2 * i)
    inv = np.concatenate(
        ([0], np.cumsum((win >= 4).astype(np.int32), dtype=np.int64))
    )
    valid = (inv[seed_len:] - inv[:n]) == 0
    return fwd, rc, valid


def has_bases(bases: np.ndarray, lo: int, hi: int, seed_len: int) -> bool:
    """Whether the seeds at [lo, hi) touch any ACGT base: a chunk of a
    genome that is N or padding throughout (most of a layout whose
    sequence lies in windows) yields no seed and is skipped unpacked."""
    return bool((bases[lo : hi + seed_len - 1] < 4).any())


def extract_canonical_seeds(
    genome: Genome, seed_len: int, chunk: int = 1 << 24
):
    """All (canonical_key, orientation, location) triples over the genome."""
    bases = np.asarray(genome.bases)
    n = genome.num_bases - seed_len + 1
    keys_l = [np.zeros(0, np.uint64)]
    orient_l = [np.zeros(0, bool)]
    loc_l = [np.zeros(0, np.uint32)]
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        if not has_bases(bases, lo, hi, seed_len):
            continue
        pos = np.arange(lo, hi, dtype=np.int64)
        fwd, rc, valid = pack_seeds_range(bases, lo, hi, seed_len)
        canonical = np.minimum(fwd, rc)
        orient = rc < fwd  # genome seed is the RC of the canonical
        keys_l.append(canonical[valid])
        orient_l.append(orient[valid])
        loc_l.append(pos[valid].astype(np.uint32))
    return (
        np.concatenate(keys_l),
        np.concatenate(orient_l),
        np.concatenate(loc_l),
    )


def _dedup_sorted_triples(keys, orient, locs):
    """Sort triples by (key, orient, loc desc) and group by key.

    Returns (sorted_locs, unique_keys, start, n0, n1)."""
    loc_desc = np.uint32(0xFFFFFFFF) - locs
    order = np.lexsort((loc_desc, orient, keys))
    keys, orient, locs = keys[order], orient[order], locs[order]
    unique_keys, start, counts = np.unique(
        keys, return_index=True, return_counts=True
    )
    orient_cum = np.concatenate(([0], np.cumsum(orient.astype(np.int64))))
    n1 = (orient_cum[start + counts] - orient_cum[start]).astype(np.int64)
    n0 = (counts - n1).astype(np.int64)
    return locs, unique_keys, start.astype(np.int64), n0, n1


def _place_in_bank(in_bank_home: np.ndarray, bank_buckets: int):
    """Greedy bucketed linear-probing placement within one bank: with
    keys sorted by home bucket, slot_k = max(slot_{k-1}+1, home_k*8)
    unrolls to k + running_max(home_k*8 - k). Returns (slot [U] int64
    within the bank, span buckets used)."""
    u = in_bank_home.shape[0]
    if u == 0:
        return np.zeros(0, np.int64), 1
    order = np.argsort(in_bank_home, kind="stable")
    home_sorted = in_bank_home[order]
    k = np.arange(u, dtype=np.int64)
    slots_sorted = k + np.maximum.accumulate(
        home_sorted * BUCKET_SLOTS - k
    )
    span = int(np.max(slots_sorted // BUCKET_SLOTS - home_sorted)) + 1
    if span > SPAN_SLACK:
        raise ValueError(
            f"hash bank overflow: span {span} > {SPAN_SLACK}; "
            "lower the load factor"
        )
    slots = np.empty(u, dtype=np.int64)
    slots[order] = slots_sorted
    return slots, span


def _bank_geometry(n_unique_total: int, load_factor: float, n_banks: int):
    """(bank_buckets, bank_slots) for an even key split across banks."""
    per_bank = max(1, -(-n_unique_total // n_banks))
    n_buckets = 1
    while n_buckets * BUCKET_SLOTS < max(16, int(per_bank / load_factor)):
        n_buckets <<= 1
    return n_buckets, (n_buckets + SPAN_SLACK) * BUCKET_SLOTS


def _fill_bank_rows(
    table_bank: np.ndarray,   # [bank_slots, 4] uint32 (pre-filled empty)
    unique_keys: np.ndarray,
    start: np.ndarray,        # int64 global hits offsets
    n0: np.ndarray,
    n1: np.ndarray,
    in_bank_home: np.ndarray,
) -> int:
    """Place one bank's keys; returns the span used."""
    bank_buckets = table_bank.shape[0] // BUCKET_SLOTS - SPAN_SLACK
    slots, span = _place_in_bank(in_bank_home, bank_buckets)
    table_bank[slots, 0] = (unique_keys & np.uint64(0xFFFFFFFF)).astype(
        np.uint32
    )
    table_bank[slots, 1] = (unique_keys >> np.uint64(32)).astype(np.uint32)
    table_bank[slots, 2] = start.astype(np.uint32)
    packed = np.minimum(n0, COUNT_CLAMP) | (
        np.minimum(n1, COUNT_CLAMP) << 16
    )
    table_bank[slots, 3] = packed.astype(np.uint32)
    return span


def assemble_table(
    locs_sorted: np.ndarray,
    unique_keys: np.ndarray,
    start: np.ndarray,
    n0: np.ndarray,
    n1: np.ndarray,
    load_factor: float = 0.5,
    n_banks: int = 1,
) -> dict:
    """In-memory v3 assembly from deduped key groups."""
    assert n_banks >= 1 and (n_banks & (n_banks - 1)) == 0
    U = unique_keys.shape[0]
    h = murmur_finalize64(unique_keys)
    log2b = int(np.log2(n_banks)) if n_banks > 1 else 0
    bank = (
        (h & np.uint64(n_banks - 1)).astype(np.int64)
        if n_banks > 1
        else np.zeros(U, np.int64)
    )
    bank_buckets, bank_slots = _bank_geometry(U, load_factor, n_banks)
    home = ((h >> np.uint64(log2b)) & np.uint64(bank_buckets - 1)).astype(
        np.int64
    )
    table = np.zeros((n_banks, bank_slots, 4), dtype=np.uint32)
    table[:, :, 0] = 0xFFFFFFFF
    table[:, :, 1] = 0xFFFFFFFF
    span = 1
    for b in range(n_banks):
        m = bank == b
        span = max(
            span,
            _fill_bank_rows(
                table[b], unique_keys[m], start[m], n0[m], n1[m], home[m]
            ),
        )
    return {
        "hits": locs_sorted,
        "table": table,
        "max_probe": span,
    }


def build_index(
    genome: Genome,
    seed_len: int = DEFAULT_SEED_LEN,
    load_factor: float = 0.5,
) -> dict:
    """Build the full index in memory."""
    keys, orient, locs = extract_canonical_seeds(genome, seed_len)
    locs_s, uk, start, n0, n1 = _dedup_sorted_triples(keys, orient, locs)
    out = assemble_table(locs_s, uk, start, n0, n1, load_factor)
    out["seed_len"] = seed_len
    return out


def build_index_chunked(
    genome: Genome,
    seed_len: int = DEFAULT_SEED_LEN,
    load_factor: float = 0.5,
    memory_budget_gb: float = 8.0,
    tmpdir: str | None = None,
    status=None,
) -> dict:
    """hg38-scale build: external partitioned sort under a memory budget.

    The -sm analogue (GenomeIndex.cpp:630-753, 1440-1679): instead of
    one monolithic lexsort over every (key, orient, loc) triple (>40GB
    for hg38 before workspace), triples are streamed genome-chunk by
    genome-chunk into per-bank spill files partitioned by murmur low
    bits, then each bank is sorted/deduped/placed independently —
    peak memory = one bank's triples + sort workspace, bounded by
    memory_budget_gb. Returns arrays dict with numpy memmaps for the
    big arrays (tmpdir must outlive them unless save_index copies).
    """
    import tempfile

    bases = np.asarray(genome.bases)
    n_pos = genome.num_bases - seed_len + 1
    # ~13 bytes/triple on disk; budget one bank at ~1/5 of the budget
    # (sort + unique workspace is ~4x the input)
    budget = memory_budget_gb * (1 << 30)
    est_triples = n_pos
    n_banks = 1
    while est_triples * 13 * 5 / n_banks > budget and n_banks < 4096:
        n_banks <<= 1
    if n_banks == 1:
        out = build_index(genome, seed_len, load_factor)
        return out

    if tmpdir is not None:
        os.makedirs(tmpdir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=tmpdir, prefix="snap_tpu_idx_")
    spill = [
        open(os.path.join(tmp, f"part{b:04d}.bin"), "wb")
        for b in range(n_banks)
    ]
    log = status if status is not None else (lambda s: None)

    # pass 1: stream the genome, spill (key u64, loc u32, orient u8)
    # triples partitioned by murmur low bits
    chunk = 1 << 24
    total = 0
    for lo in range(0, n_pos, chunk):
        hi = min(lo + chunk, n_pos)
        if not has_bases(bases, lo, hi, seed_len):
            continue
        pos = np.arange(lo, hi, dtype=np.int64)
        fwd, rc, valid = pack_seeds_range(bases, lo, hi, seed_len)
        canonical = np.minimum(fwd, rc)[valid]
        orient = (rc < fwd)[valid]
        loc = pos[valid].astype(np.uint32)
        bank = (
            murmur_finalize64(canonical) & np.uint64(n_banks - 1)
        ).astype(np.int64)
        order = np.argsort(bank, kind="stable")
        bank_s = bank[order]
        bounds = np.searchsorted(bank_s, np.arange(n_banks + 1))
        ck, oc, lc = canonical[order], orient[order], loc[order]
        for b in range(n_banks):
            s, e = bounds[b], bounds[b + 1]
            if e <= s:
                continue
            rec = np.empty((e - s,), dtype=_TRIPLE_DT)
            rec["key"] = ck[s:e]
            rec["loc"] = lc[s:e]
            rec["orient"] = oc[s:e]
            spill[b].write(rec.tobytes())
        total += int(valid.sum())
        log(f"seed scan {hi}/{n_pos} positions ({total} seeds spilled)")
    for f in spill:
        f.close()

    # pass 2: per bank: sort, dedup, CSR append, table placement
    hits_path = os.path.join(tmp, "hits.npy")
    hits_mm = np.lib.format.open_memmap(
        hits_path, mode="w+", dtype=np.uint32, shape=(total,)
    )
    # size banks from the measured dedup ratio of bank 0 (murmur-uniform
    # partitioning makes it representative to ~0.1%), not the triple
    # count — for repeat-rich genomes that halves the table
    rec0 = np.fromfile(os.path.join(tmp, "part0000.bin"), dtype=_TRIPLE_DT)
    u0 = np.unique(rec0["key"]).shape[0] if rec0.shape[0] else 1
    del rec0
    est_uniques = min(total, int(u0 * n_banks * 1.02) + n_banks)
    bank_buckets, bank_slots = _bank_geometry(
        est_uniques, load_factor, n_banks
    )
    table_path = os.path.join(tmp, "table.npy")
    table = np.lib.format.open_memmap(
        table_path, mode="w+", dtype=np.uint32,
        shape=(n_banks, bank_slots, 4),
    )
    log2b = int(np.log2(n_banks))
    span = 1
    hits_off = 0
    for b in range(n_banks):
        pth = os.path.join(tmp, f"part{b:04d}.bin")
        rec = np.fromfile(pth, dtype=_TRIPLE_DT)
        os.remove(pth)
        tb = table[b]
        tb[:, 0] = 0xFFFFFFFF
        tb[:, 1] = 0xFFFFFFFF
        tb[:, 2] = 0
        tb[:, 3] = 0
        if rec.shape[0] == 0:
            continue
        locs_s, uk, start, n0, n1 = _dedup_sorted_triples(
            rec["key"], rec["orient"].astype(bool), rec["loc"]
        )
        del rec
        hits_mm[hits_off : hits_off + locs_s.shape[0]] = locs_s
        h = murmur_finalize64(uk)
        home = (
            (h >> np.uint64(log2b)) & np.uint64(bank_buckets - 1)
        ).astype(np.int64)
        span = max(
            span, _fill_bank_rows(tb, uk, start + hits_off, n0, n1, home)
        )
        hits_off += locs_s.shape[0]
        log(f"bank {b + 1}/{n_banks} placed ({hits_off}/{total} hits)")

    return {
        "seed_len": seed_len,
        "max_probe": span,
        "hits": hits_mm,
        "table": table,
        "_tmpdir": tmp,
    }


_TRIPLE_DT = np.dtype(
    [("key", np.uint64), ("loc", np.uint32), ("orient", np.uint8)]
)


def _stack_shards(shards: list[dict], seed_len: int) -> dict:
    """Stack per-shard tables and hit lists on a leading [n_shards] axis,
    padded to the largest shard (padding table slots are empty keys)."""
    bank_slots = max(sh["table"].shape[1] for sh in shards)
    hmax = max(max(sh["hits"].shape[0], 1) for sh in shards)

    def pad_hits(a):
        out = np.zeros((hmax,), dtype=a.dtype)
        out[: len(a)] = a
        return out

    def pad_table(t):
        if t.shape[1] == bank_slots:
            return t
        out = np.zeros((t.shape[0], bank_slots, 4), dtype=np.uint32)
        out[:, :, 0] = 0xFFFFFFFF
        out[:, :, 1] = 0xFFFFFFFF
        out[:, : t.shape[1]] = t
        return out

    return {
        "seed_len": seed_len,
        "n_shards": len(shards),
        "max_probe": max(sh["max_probe"] for sh in shards),
        "hits": np.stack([pad_hits(sh["hits"]) for sh in shards]),
        "table": np.stack([pad_table(sh["table"]) for sh in shards]),
    }


def _shard_of(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """Owning shard of each canonical key: the top log2(n_shards) bits of
    its murmur finalization (bank selection uses the low bits, so the
    two compose)."""
    shift = np.uint64(64 - int(np.log2(n_shards)))
    return (murmur_finalize64(keys) >> shift).astype(np.int64)


def shard_index(
    genome: Genome, seed_len: int, n_shards: int, load_factor: float = 0.5
) -> dict:
    """Build a seed-sharded index: n_shards independent hash tables.

    Every shard is a complete, self-contained index over its key subset
    (SNAP shards by seed prefix into per-prefix tables,
    GenomeIndex.cpp:1026-1110): a lookup probed against a non-owning
    shard cleanly misses. Arrays are padded to the largest shard and
    stacked on a leading axis, one entry per 'index' mesh column.
    """
    assert n_shards >= 1 and (n_shards & (n_shards - 1)) == 0
    keys, orient, locs = extract_canonical_seeds(genome, seed_len)
    if n_shards > 1:
        shard_of = _shard_of(keys, n_shards)
    else:
        shard_of = np.zeros(len(keys), dtype=np.int64)
    shards = []
    for s in range(n_shards):
        m = shard_of == s
        locs_s, uk, start, n0, n1 = _dedup_sorted_triples(
            keys[m], orient[m], locs[m]
        )
        shards.append(assemble_table(locs_s, uk, start, n0, n1, load_factor))
    return _stack_shards(shards, seed_len)


def reshard_index(
    arrays: dict, n_shards: int, load_factor: float = 0.5
) -> dict:
    """Re-shard a built (or loaded) flat index into the stacked
    [n_shards, ...] layout without rescanning the genome: v3 table slots
    carry the full canonical key, so the key groups and their hit runs
    come straight from the table, regrouped by shard_index's ownership
    rule."""
    assert n_shards >= 1 and (n_shards & (n_shards - 1)) == 0
    if n_shards == 1:
        return {
            "seed_len": arrays["seed_len"],
            "n_shards": 1,
            "max_probe": arrays["max_probe"],
            "hits": np.asarray(arrays["hits"])[None],
            "table": np.asarray(arrays["table"])[None],
        }
    table = np.asarray(arrays["table"]).reshape(-1, 4)
    hits = np.asarray(arrays["hits"])
    occ = ~((table[:, 0] == 0xFFFFFFFF) & (table[:, 1] == 0xFFFFFFFF))
    keys = table[occ, 0].astype(np.uint64) | (
        table[occ, 1].astype(np.uint64) << np.uint64(32)
    )
    start = table[occ, 2].astype(np.int64)
    n0 = (table[occ, 3] & 0xFFFF).astype(np.int64)
    n1 = (table[occ, 3] >> 16).astype(np.int64)
    shard_of = _shard_of(keys, n_shards)
    shards = []
    for s in range(n_shards):
        m = shard_of == s
        ks, st, a0, a1 = keys[m], start[m], n0[m], n1[m]
        tot = a0 + a1
        T = int(tot.sum())
        new_start = np.zeros(len(ks), dtype=np.int64)
        if len(ks):
            new_start[1:] = np.cumsum(tot)[:-1]
        if T:
            run_id = np.repeat(np.arange(len(ks)), tot)
            within = np.arange(T) - np.repeat(new_start, tot)
            new_hits = hits[st[run_id] + within]
        else:
            new_hits = np.zeros(0, dtype=hits.dtype)
        shards.append(
            assemble_table(
                new_hits, ks, new_start, a0.astype(np.int32),
                a1.astype(np.int32), load_factor,
            )
        )
    return _stack_shards(shards, arrays["seed_len"])


def save_index(index: dict, genome: Genome, directory: str) -> None:
    os.makedirs(directory, exist_ok=True)
    genome.save(directory)
    tmpd = index.get("_tmpdir")
    if tmpd and isinstance(index["hits"], np.memmap):
        # chunked build: the arrays already live in .npy files — move
        # them instead of rewriting ~80GB through a zip
        index["hits"].flush()
        index["table"].flush()
        os.replace(
            os.path.join(tmpd, "hits.npy"),
            os.path.join(directory, "hits.npy"),
        )
        os.replace(
            os.path.join(tmpd, "table.npy"),
            os.path.join(directory, "table.npy"),
        )
    else:
        np.savez(
            os.path.join(directory, "index_arrays.npz"),
            hits=np.asarray(index["hits"]),
            table=np.asarray(index["table"]),
        )
    with open(os.path.join(directory, "index_meta.json"), "w") as f:
        json.dump(
            {
                "format_version": 3,  # banked [n_banks, slots, 4] layout
                "seed_len": index["seed_len"],
                "max_probe": index["max_probe"],
            },
            f,
        )


def load_index_arrays(directory: str) -> dict:
    with open(os.path.join(directory, "index_meta.json")) as f:
        meta = json.load(f)
    if meta.get("format_version", 1) != 3:
        raise ValueError(
            f"index at {directory} uses format version "
            f"{meta.get('format_version', 1)}; this build reads version 3 "
            "(banked compact layout) — please rebuild the index"
        )
    out = {
        "seed_len": meta["seed_len"],
        "max_probe": meta["max_probe"],
    }
    npz = os.path.join(directory, "index_arrays.npz")
    if os.path.exists(npz):
        arrs = np.load(npz)
        out["hits"] = arrs["hits"]
        out["table"] = arrs["table"]
    else:
        # chunked-build layout: raw .npy files, memmapped
        out["hits"] = np.load(
            os.path.join(directory, "hits.npy"), mmap_mode="r"
        )
        out["table"] = np.load(
            os.path.join(directory, "table.npy"), mmap_mode="r"
        )
    return out
