"""Device-side genome index: hash-probe lookup as batched tensor gathers.

Counterpart of snap_tpu.index.index. Behavioral reference: SNAP's
GenomeIndex::lookupSeed (GenomeIndex.cpp:2095-2328) — returns
(nHits, hits, nRCHits, rcHits) with hit lists in descending genome
order. Here the lookup is one gather of the key's bucket span for every
query at once; hits are gathered into fixed-cap [num_queries, cap]
tiles with validity masks.

Word types: torch has no usable unsigned 32/64-bit shifts on the CPU,
so uint32 words are stored as int32 bit patterns and widened with
`& 0xFFFFFFFF`, and 64-bit seed keys live in int64 (multiplication
wraps exactly as uint64 does; every right shift is masked).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..genome import Genome
from .build import BUCKET_SLOTS, SPAN_SLACK, load_index_arrays

U32 = 0xFFFFFFFF


def _s64(c: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def srl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of an int64 tensor holding uint64 bits."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def u64_le(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a <= b for int64 tensors holding uint64 bits."""
    sign = _s64(1 << 63)
    return (a ^ sign) <= (b ^ sign)


def u64_min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(u64_le(a, b), a, b)


class DeviceIndex(NamedTuple):
    """Index tensors on one device (format v3, see build.py).

    uint32 arrays are held as int32 tensors with the same bits.
    """

    table: torch.Tensor          # [n_banks, bank_slots, 4] int32 (u32 bits)
    hits: torch.Tensor           # [T] int32 (u32 locations, desc per list)
    genome: torch.Tensor         # [G] uint8 base codes, G % 8 == 0 (PAD)
    # 2-bit-packed genome (16 bases / word, base i at bits 2*(i%16)) and
    # the per-base invalid mask at the same even bit positions; words
    # past the genome end are all-bad. The gapless XOR prescreen reads
    # these instead of byte windows (SNAP's 64-bit XOR scan,
    # LandauVishkin.h:377-407).
    genome_packed: torch.Tensor  # [n16] int32 (u32 bits)
    genome_bad16: torch.Tensor   # [n16] int32 (u32 bits)


PACK_CHUNK = 1 << 24  # bases per packing pass (a multiple of 16)


def _pack_chunked(bases: np.ndarray, out: np.ndarray, values, fill: int) -> np.ndarray:
    """Writes the 2-bit `values(chunk)` of every base into `out`, 16 bases
    a uint32 word (base i of a word at bits 2*i), PACK_CHUNK bases at a
    time: four bases to a byte, four bytes to a little-endian word, a
    chunk's last word filled with `fill`. No copy wider than a chunk. A
    chunk with no ACGT base (N or padding throughout: most of a genome
    laid out at GRCh38's coordinates with few sequenced windows) is
    skipped: the caller fills `out` with `fill` words, and `values` gives
    every other base `fill`."""
    for lo in range(0, bases.shape[0], PACK_CHUNK):
        c = bases[lo : lo + PACK_CHUNK]
        if not (c < 4).any():
            continue
        v = np.full(-(-c.shape[0] // 16) * 16, fill, dtype=np.uint8)
        v[: c.shape[0]] = values(c)
        q = v.reshape(-1, 4)
        b = q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) | (q[:, 3] << 6)
        out[lo // 16 : lo // 16 + b.shape[0] // 4] = b.view("<u4")
    return out


def pack_genome_words(bases: np.ndarray) -> np.ndarray:
    """Host-side 2-bit packing of a byte-code genome (16 bases/word),
    padded with 8+ zero words to a multiple of 8 words."""
    g = np.asarray(bases)
    n16 = (g.shape[0] + 15) // 16
    packed = np.zeros(n16 + 8 + (-(n16 + 8)) % 8, dtype=np.uint32)
    return _pack_chunked(g, packed, lambda c: c * (c < 4), 0)


def pack_bad16(bases: np.ndarray, n_words: int) -> np.ndarray:
    """Invalid-base mask at even bit positions, 16 bases/word, padded to
    n_words with all-bad words (same geometry as the packed codes)."""
    bad16 = np.full(n_words, 0x55555555, dtype=np.uint32)
    return _pack_chunked(np.asarray(bases), bad16, lambda c: c >= 4, 1)


def make_device_index(
    arrays: dict, genome_bases: np.ndarray, device=None
) -> DeviceIndex:
    """DeviceIndex from the dict that build_index returns (or that
    load_index_arrays reads), on `device` ("cuda" unless told "cpu").

    The hits array gets 8+ zero entries of padding and the genome is
    PAD-padded to a multiple of 8 bases, exactly as snap_tpu lays them
    out, so every clip and bound in the pipeline sees the same sizes.
    """
    dev = resolve_device(device)
    genome_bases = np.asarray(genome_bases)
    packed = pack_genome_words(genome_bases)
    hits = np.asarray(arrays["hits"])
    pad = 8 + (-(hits.shape[0] + 8)) % 8
    hits_p = np.concatenate([hits, np.zeros(pad, hits.dtype)])
    # one copy, PAD-padded (a loaded genome is a read-only memory map)
    G = genome_bases.shape[0]
    genome_p = np.empty(G + (-G) % 8, dtype=np.uint8)
    genome_p[:G] = genome_bases
    genome_p[G:] = 5
    bad16 = pack_bad16(genome_p, packed.shape[0])

    def t32(a):
        return torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)
        ).to(dev)

    return DeviceIndex(
        table=t32(np.asarray(arrays["table"])),
        hits=t32(hits_p),
        genome=torch.from_numpy(genome_p).to(dev),
        genome_packed=t32(packed),
        genome_bad16=t32(bad16),
    )


def murmur_finalize64(k: torch.Tensor) -> torch.Tensor:
    """MurmurHash3 64-bit finalizer on int64 tensors holding uint64 bits."""
    k = k.to(torch.int64)
    k = k ^ srl(k, 33)
    k = k * _s64(0xFF51AFD7ED558CCD)
    k = k ^ srl(k, 33)
    k = k * _s64(0xC4CEB9FE1A85EC53)
    k = k ^ srl(k, 33)
    return k


def probe(
    idx: DeviceIndex, queries: torch.Tensor, max_probe: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hash-probe a batch of canonical seed keys (format v3).

    queries: [N] int64 (uint64 bits). A key lives within `max_probe`
    consecutive 8-slot buckets from its home bucket inside its bank, so
    the lookup gathers that bucket span and compares every slot.

    Returns (found [N] bool, start [N] int64, n0 [N] int32,
    n1 [N] int32). Missing keys return counts of 0.
    """
    span = max(1, max_probe)
    n_banks, bank_slots, _ = idx.table.shape
    bank_buckets = bank_slots // BUCKET_SLOTS - SPAN_SLACK
    log2b = max(n_banks - 1, 0).bit_length()
    N = queries.shape[0]
    h = murmur_finalize64(queries)
    if n_banks > 1:
        bank = h & (n_banks - 1)
    else:
        bank = torch.zeros_like(h)
    home = srl(h, log2b) & (bank_buckets - 1)
    t2 = idx.table.reshape(-1, BUCKET_SLOTS * 4)
    nrows = t2.shape[0]
    brow = bank * (bank_slots // BUCKET_SLOTS) + home
    ridx = (
        brow[:, None] + torch.arange(span, device=h.device)[None, :]
    ).clamp(0, nrows - 1)
    rows = t2[ridx].reshape(N, span * BUCKET_SLOTS, 4).to(torch.int64) & U32
    q_lo = queries & U32
    q_hi = srl(queries, 32)
    hit = (rows[:, :, 0] == q_lo[:, None]) & (rows[:, :, 1] == q_hi[:, None])
    found = hit.any(dim=1)
    # keys are unique: at most one slot matches
    zero = torch.zeros((), dtype=torch.int64, device=h.device)
    start = torch.where(hit, rows[:, :, 2], zero).sum(dim=1)
    packed = torch.where(hit, rows[:, :, 3], zero).sum(dim=1)
    n0 = (packed & 0xFFFF).to(torch.int32)
    n1 = (packed >> 16).to(torch.int32)
    start = torch.where(found, start, zero)
    n0 = torch.where(found, n0, 0)
    n1 = torch.where(found, n1, 0)
    return found, start, n0, n1


def gather_hits(
    hits: torch.Tensor, start: torch.Tensor, count: torch.Tensor, cap: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather up to `cap` hit locations per query.

    start/count: [N]. Returns (locs [N, cap] int64, valid [N, cap] bool).
    Lists are stored descending, so taking the first `cap` keeps the
    highest locations (SNAP's descending iteration order).
    """
    T = hits.shape[0]
    offs = torch.arange(cap, dtype=torch.int64, device=hits.device)
    valid = offs[None, :] < count[:, None].to(torch.int64)
    rows = (start[:, None].to(torch.int64) + offs[None, :]).clamp(0, T - 1)
    return hits[rows].to(torch.int64) & U32, valid


def pack_read_seeds(
    bases: torch.Tensor, seed_len: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack every seed position of a read batch.

    bases: [B, L] uint8 codes. Returns (fwd [B, P] int64, rc [B, P]
    int64, valid [B, P] bool), P = L - seed_len + 1; fwd/rc hold uint64
    bits.
    """
    B, L = bases.shape
    P = L - seed_len + 1
    fwd = torch.zeros((B, P), dtype=torch.int64, device=bases.device)
    rc = torch.zeros((B, P), dtype=torch.int64, device=bases.device)
    valid = torch.ones((B, P), dtype=torch.bool, device=bases.device)
    for i in range(seed_len):
        b = bases[:, i : i + P]
        ok = b < 4
        valid = valid & ok
        bs = torch.where(ok, b, 0).to(torch.int64)
        fwd = (fwd << 2) | bs
        rc = rc | ((3 - bs) << (2 * i))
    return fwd, rc, valid


class GenomeIndex:
    """Host wrapper: genome metadata + device tensors + static params."""

    def __init__(self, genome: Genome, arrays: dict, device=None):
        self.genome_meta = genome
        self.seed_len: int = arrays["seed_len"]
        self.max_probe: int = arrays["max_probe"]
        self._host_arrays = {
            k: np.asarray(arrays[k]) for k in ("hits", "table")
        }
        self.torch_device = resolve_device(device)
        self.device = make_device_index(
            arrays, np.asarray(genome.bases), self.torch_device
        )
        self._host_index = None

    @property
    def host(self):
        """Lazy numpy-side lookup view (full CSR hit lists)."""
        if self._host_index is None:
            from .host_lookup import HostIndex

            self._host_index = HostIndex(
                self._host_arrays, self.seed_len, self.max_probe
            )
        return self._host_index

    def on(self, device) -> DeviceIndex:
        """The index tensors on another device (e.g. a CPU copy of a
        card-resident index, to hold the two paths against each other)."""
        arrays = {
            "seed_len": self.seed_len,
            "max_probe": self.max_probe,
            **self._host_arrays,
        }
        return make_device_index(arrays, np.asarray(self.genome_meta.bases), device)

    @classmethod
    def build(
        cls, genome: Genome, seed_len: int | None = None, device=None
    ) -> "GenomeIndex":
        from ..constants import DEFAULT_SEED_LEN
        from .build import build_index

        arrays = build_index(genome, seed_len or DEFAULT_SEED_LEN)
        return cls(genome, arrays, device)

    @classmethod
    def load(cls, directory: str, device=None) -> "GenomeIndex":
        import os

        if not os.path.exists(os.path.join(directory, "index_meta.json")):
            from .snap_format import is_snap_index_dir, load_snap_index

            if is_snap_index_dir(directory):
                # a reference snap-aligner index directory: import it
                genome, arrays = load_snap_index(directory)
                return cls(genome, arrays, device)
        genome = Genome.load(directory)
        arrays = load_index_arrays(directory)
        return cls(genome, arrays, device)

    def to_mesh(self, mesh, n_index: int = 1) -> "GenomeIndex":
        """Place the index for multi-device execution: re-shard the hash
        table over the mesh's 'index' axis (no genome rescan; see
        build.reshard_index) and put each shard on the devices of its
        index column, the genome on every device. Sets .device_sharded
        and .mesh; max_probe widens to cover the shards' spans, so build
        the aligner's AlignParams after this call. A second call for the
        same devices and shard count keeps the placement it made (a
        cached index runs command after command on one mesh)."""
        from ..parallel.mesh import sharded_device_index
        from .build import reshard_index

        key = (mesh.devices, mesh.ranks, n_index)
        if getattr(self, "_mesh_key", None) == key:
            self.mesh = mesh
            return self
        arrays = reshard_index(
            {
                "seed_len": self.seed_len,
                "max_probe": self.max_probe,
                **self._host_arrays,
            },
            n_index,
        )
        self.max_probe = max(self.max_probe, arrays["max_probe"])
        self.device_sharded = sharded_device_index(
            arrays, np.asarray(self.genome_meta.bases), mesh
        )
        self.mesh = mesh
        self._mesh_key = key
        return self

    def save(self, directory: str) -> None:
        from .build import save_index

        arrays = {
            "seed_len": self.seed_len,
            "max_probe": self.max_probe,
            **self._host_arrays,
        }
        save_index(arrays, self.genome_meta, directory)
