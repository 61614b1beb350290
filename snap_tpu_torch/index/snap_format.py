"""Importer for reference SNAP's on-disk index directories.

Reads the native format written by `snap-aligner index` (SNAP 2.0.x,
GenomeIndexFormatMajorVersion 7) and converts it to this framework's
device arrays, so existing SNAP indices can be used directly:

- `Genome` file: text header `nBases nContigs flags`, then per contig
  `begin flagsHex origNum projBegin projRCHex nameLen cigLen name cigar`,
  then nBases raw base characters (Genome.cpp:203-250 saveToFile);
- `GenomeIndex` file: text `major minor nHashTables overflowTableSize
  seedLen chromosomePadding hashTableKeySize blobSize small locationSize`
  (GenomeIndex.cpp:1008-1010);
- `GenomeIndexHash`: nHashTables consecutive SNAPHashTable blobs, each
  `magic u32, tableSize u64, usedElementCount u64, keySize u32,
  valueSize u32, valueCount u32, invalidValue[valueSize]` followed by
  tableSize elements of (valueCount values + key) packed bytes
  (HashTable.cpp loadCommon / saveToFile);
- `OverflowTable`: uint32 (locationSize<=4) or int64 entries; a hash
  value v >= countOfBases points at offset v-countOfBases holding
  [count, locations... descending] (GenomeIndex.cpp:755-940).

Large (2-value) tables key the canonical seed with forward/RC value
slots, where InvalidGenomeLocation-1 marks an unused direction
(GenomeIndex.cpp:1515-1536 ApplyHashTableUpdate); small (1-value)
tables key each literal seed (usingComplement is always false when
!large). Both convert to our canonical-key layout.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..constants import BASE_ENCODE
from ..genome import Contig, Genome

SNAP_MAGIC = 0xB111B010  # HashTable.cpp:343


def _read_le_uint(rows: np.ndarray, lo: int, size: int) -> np.ndarray:
    """Little-endian unsigned ints from byte columns [lo, lo+size)."""
    out = np.zeros(rows.shape[0], dtype=np.uint64)
    for i in range(size):
        out |= rows[:, lo + i].astype(np.uint64) << np.uint64(8 * i)
    return out


def load_snap_genome(path: str) -> tuple[Genome, int]:
    """Parse SNAP's Genome file. Returns (Genome, chromosomePadding-free
    base count). Contig lengths are derived from neighbor offsets with
    the padding runs ('n') trimmed, as SNAP does at load."""
    with open(path, "rb") as f:
        data = f.read()
    # header line
    nl = data.index(b"\n")
    n_bases_s, n_contigs_s, _flags = data[:nl].split()
    n_bases, n_contigs = int(n_bases_s), int(n_contigs_s)
    pos = nl + 1
    raw_contigs = []
    for _ in range(n_contigs):
        nl = data.index(b"\n", pos)
        fields = data[pos:nl].split(b" ")
        # begin flagsHex origNum projBegin projRCHex nameLen cigLen name cigar
        begin = int(fields[0])
        flags = int(fields[1], 16)
        orig = int(fields[2])
        proj_begin = int(fields[3])
        proj_rc = bool(int(fields[4], 16) & 0x1)
        name = fields[7].decode()
        raw_contigs.append((begin, flags, orig, proj_begin, proj_rc, name))
        pos = nl + 1
    bases_raw = np.frombuffer(data, dtype=np.uint8, offset=pos)
    if bases_raw.shape[0] < n_bases:
        raise ValueError(
            f"Genome file truncated: {bases_raw.shape[0]} < {n_bases} bases"
        )
    bases_raw = bases_raw[:n_bases]
    codes = BASE_ENCODE[bases_raw]

    # contig lengths: up to the next contig's beginning minus its leading
    # padding; trailing padding runs trimmed by scanning 'n' (PAD) codes.
    from ..constants import PAD

    contigs: list[Contig] = []
    begins = [c[0] for c in raw_contigs] + [n_bases]
    for i, (begin, flags, orig, proj_begin, proj_rc, name) in enumerate(
        raw_contigs
    ):
        end = begins[i + 1]
        # trim the padding that precedes the NEXT contig (or trails the file)
        while end > begin and codes[end - 1] == PAD:
            end -= 1
        contigs.append(
            Contig(
                name=name,
                start=begin,
                length=end - begin,
                is_alt=bool(flags & 0x1),
                original_index=orig,
                proj_rc=proj_rc,
            )
        )
    # resolve liftover projections now that all starts are known
    for i, (begin, flags, orig, proj_begin, proj_rc, name) in enumerate(
        raw_contigs
    ):
        if bool(flags & 0x1) and proj_begin > 0:
            for j, c2 in enumerate(contigs):
                if (
                    not c2.is_alt
                    and c2.start <= proj_begin < c2.start + c2.length
                ):
                    contigs[i].proj_name = c2.name
                    contigs[i].proj_offset = proj_begin - c2.start + 1
                    break
    return Genome(bases=codes, contigs=contigs), n_bases


def _parse_hash_blob(data: bytes, offset: int):
    """One SNAPHashTable blob -> (keys u64, values [n, valueCount] u64,
    used mask, next_offset)."""
    (magic,) = struct.unpack_from("<I", data, offset)
    if magic != SNAP_MAGIC:
        raise ValueError(f"bad hash table magic {magic:#x} at {offset}")
    table_size, used_count = struct.unpack_from("<qq", data, offset + 4)
    key_size, value_size, value_count = struct.unpack_from(
        "<III", data, offset + 20
    )
    invalid = int.from_bytes(
        data[offset + 32 : offset + 32 + value_size], "little"
    )
    body = offset + 32 + value_size
    elem_size = key_size + value_size * value_count
    total = table_size * elem_size
    rows = np.frombuffer(
        data, dtype=np.uint8, count=total, offset=body
    ).reshape(table_size, elem_size)
    values = np.stack(
        [
            _read_le_uint(rows, i * value_size, value_size)
            for i in range(value_count)
        ],
        axis=1,
    )
    keys = _read_le_uint(rows, value_size * value_count, key_size)
    used = values[:, 0] != np.uint64(invalid)
    if value_count > 1:
        used |= values[:, 1] != np.uint64(invalid)
    return keys, values, used, invalid, key_size, value_count, body + total


def _expand_hits(
    values: np.ndarray,       # [n] u64 hash values for one direction
    keys: np.ndarray,         # [n] u64 canonical (or literal) seed keys
    overflow: np.ndarray,     # overflow table (u64 view)
    count_of_bases: int,
    invalid: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Decode hash values into flat (key, location) pairs."""
    v = values.astype(np.int64)
    live = (v != np.int64(invalid)) & (v != np.int64(invalid - 1))
    single = live & (v < count_of_bases)
    out_keys = [keys[single]]
    out_locs = [v[single].astype(np.uint32)]
    ovf = live & ~single
    if np.any(ovf):
        off = v[ovf] - count_of_bases
        cnt = overflow[off].astype(np.int64)
        total = int(cnt.sum())
        rep_keys = np.repeat(keys[ovf], cnt)
        starts = np.repeat(np.cumsum(cnt) - cnt, cnt)
        idx = np.repeat(off + 1, cnt) + (np.arange(total) - starts)
        out_keys.append(rep_keys)
        out_locs.append(overflow[idx].astype(np.uint32))
    return np.concatenate(out_keys), np.concatenate(out_locs)


def _snap_to_ours(keys: np.ndarray) -> np.ndarray:
    """Translate packed seeds between base codings.

    SNAP encodes A=0,G=1,C=2,T=3 (Tables.cpp:55-58); we encode
    A=0,C=1,G=2,T=3. Swapping codes 1<->2 is a bit swap within every
    2-bit group, so the translation is one shift-mask round trip (and is
    its own inverse).
    """
    k = keys.astype(np.uint64, copy=False)
    m = np.uint64(0x5555555555555555)
    return ((k & m) << np.uint64(1)) | ((k >> np.uint64(1)) & m)


def _rc_key(keys: np.ndarray, seed_len: int) -> np.ndarray:
    """Reverse complement of 2-bit packed seeds (vectorized)."""
    k = keys.astype(np.uint64, copy=True)
    k = ~k  # complement every base
    # reverse 2-bit groups within 64 bits
    m2 = np.uint64(0x3333333333333333)
    m4 = np.uint64(0x0F0F0F0F0F0F0F0F)
    k = ((k >> np.uint64(2)) & m2) | ((k & m2) << np.uint64(2))
    k = ((k >> np.uint64(4)) & m4) | ((k & m4) << np.uint64(4))
    k = k.byteswap()
    return k >> np.uint64(64 - 2 * seed_len)


def load_snap_index(directory: str, load_factor: float = 0.5):
    """Load a reference SNAP index directory into (Genome, arrays dict
    compatible with snap_tpu.index.build.build_index's output)."""
    with open(os.path.join(directory, "GenomeIndex")) as f:
        header = f.read().split()
    major = int(header[0])
    if major != 7:
        raise ValueError(
            f"unsupported SNAP index major version {major} (expected 7)"
        )
    n_tables = int(header[2])
    overflow_size = int(header[3])
    seed_len = int(header[4])
    key_size_hdr = int(header[6])
    location_size = int(header[9])

    genome, n_bases = load_snap_genome(os.path.join(directory, "Genome"))

    ovf_dtype = np.uint32 if location_size <= 4 else np.int64
    overflow = np.fromfile(
        os.path.join(directory, "OverflowTable"), dtype=ovf_dtype,
        count=overflow_size,
    ).astype(np.int64)

    with open(os.path.join(directory, "GenomeIndexHash"), "rb") as f:
        blob = f.read()

    all_keys, all_orient, all_locs = [], [], []
    offset = 0
    for t in range(n_tables):
        keys, values, used, invalid, key_size, value_count, offset = (
            _parse_hash_blob(blob, offset)
        )
        assert key_size == key_size_hdr
        high = np.uint64(t) << np.uint64(8 * key_size)
        snap_seeds = (high | keys[used]).astype(np.uint64)
        # re-encode in our base coding; canonical order may flip because
        # the codings sort differently
        fwd = _snap_to_ours(snap_seeds)
        rc = _rc_key(fwd, seed_len)
        canon = np.minimum(fwd, rc)
        flipped = rc < fwd  # SNAP's canonical string is OUR RC-canonical
        vals = values[used]
        if value_count == 2:
            # large tables: SNAP key is SNAP-canonical; slot 0 holds hits
            # where the genome matches that string, slot 1 its RC. Under
            # our coding the canonical may be the other string, in which
            # case the slots swap orientation labels.
            for which in (0, 1):
                k2, l2 = _expand_hits(
                    vals[:, which], canon, overflow, n_bases, invalid
                )
                o2, _ = _expand_hits(
                    vals[:, which],
                    flipped.astype(np.uint64),
                    overflow,
                    n_bases,
                    invalid,
                )
                orient = o2.astype(bool) ^ (which == 1)
                all_keys.append(k2)
                all_orient.append(orient)
                all_locs.append(l2)
        else:
            # small tables: literal genome seed per key
            k2, l2 = _expand_hits(
                vals[:, 0], canon, overflow, n_bases, invalid
            )
            o2, _ = _expand_hits(
                vals[:, 0], flipped.astype(np.uint64), overflow, n_bases,
                invalid,
            )
            all_keys.append(k2)
            all_orient.append(o2.astype(bool))
            all_locs.append(l2)

    keys = np.concatenate(all_keys)
    orient = np.concatenate(all_orient)
    locs = np.concatenate(all_locs)

    from .build import _dedup_sorted_triples, assemble_table

    locs_s, uk, start, n0, n1 = _dedup_sorted_triples(keys, orient, locs)
    arrays = assemble_table(locs_s, uk, start, n0, n1, load_factor)
    arrays["seed_len"] = seed_len
    return genome, arrays


def is_snap_index_dir(directory: str) -> bool:
    return os.path.exists(
        os.path.join(directory, "GenomeIndex")
    ) and os.path.exists(os.path.join(directory, "GenomeIndexHash"))
