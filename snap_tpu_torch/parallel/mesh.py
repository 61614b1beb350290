"""Multi-device execution: data-parallel reads x sharded index.

Counterpart of snap_tpu.parallel.mesh. Behavioral reference: the
reference is single-node multithreaded (ParallelTask.h:43,
RangeSplitter.h:38); this module is its scale-out replacement: reads are
data-parallel across the 'data' mesh axis, and the genome index is
sharded across the 'index' axis. Each position probes its index shard
for the reads of its data row (a non-owning shard cleanly misses) and
scores its own candidates against the replicated genome; the per-shard
candidate lists concatenate along K, shard 0 first, and the selection
runs on the union.

A mesh here is an [n_data, n_index] grid of torch devices. A device may
stand at several positions (eight "cpu"s in the tests, cuda:0 twice on
one card). Under an initialised torch.distributed group the mesh also
records the rank that owns each position, in any layout: a data row's
positions may belong to several ranks. Every function runs the
positions this process owns, takes and returns the rows of every data
row in which it owns a position (each rank of a shared row passes that
row's reads and gets its winners back, replicated over 'index' as
snap_tpu's P("data") out-spec replicates them), and reduces the
dp_overflow flag across ranks. The collectives of snap_tpu's shard_map
over 'index' gather a data row's per-position tiles in column order:
inside one process a local gather, across processes an all_gather over
the row's process subgroup (on the card under nccl, through the host
under gloo). The tiled all_gather is then a torch.cat along K, psum a
sum, pmax a max. Outputs of several data rows are concatenated on the
mesh's primary device (this process's first position).
"""

from __future__ import annotations

import numpy as np
import torch

from ..align import pipeline
from ..align.intersect_device import _phase1_entries, _phase2_from_entries
from ..align.pipeline import AlignParams, SingleAlignOut, Tier1Out
from ..index.index import DeviceIndex, pack_bad16, pack_genome_words

i64 = torch.int64

# per-candidate [B, K] fields, concatenated along K across index shards
_CAND_FIELDS = (
    "dist", "lv_dist", "indels", "log_prob", "ag_score", "end_loc",
    "body_loc", "cand_loc", "escalated", "clip_before", "clip_after",
    "seed_off", "direction", "valid",
)
_TIER1_CAND_FIELDS = (
    "cand_loc", "seed_off", "direction", "valid", "weight",
    "gapless_dist", "gapless_logp", "big_indel",
)


def _norm_device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _group_size() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _group_rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class Mesh:
    """An [n_data, n_index] grid of torch devices, with the rank that owns
    each position when the grid spans the processes of a group.

    local_cols[i] lists the index columns j of data row i that this
    process owns (every row it owns a position in is a local row); a row
    whose positions belong to several ranks gets a process subgroup
    (row_groups[i] = (group, its sorted ranks)), made by every rank of
    the default group in row order, members or not, as new_group needs."""

    def __init__(self, devices, ranks=None):
        self.devices = tuple(
            tuple(_norm_device(d) for d in row) for row in devices
        )
        n_index = len(self.devices[0])
        if any(len(row) != n_index for row in self.devices):
            raise ValueError("mesh rows must all have n_index devices")
        self.shape = {"data": len(self.devices), "index": n_index}
        self.ranks = None
        if ranks is not None:
            self.ranks = tuple(tuple(int(r) for r in row) for row in ranks)
            if len(self.ranks) != len(self.devices) or any(
                len(row) != n_index for row in self.ranks
            ):
                raise ValueError("the rank grid must have the mesh's shape")
        if self.multiprocess and _group_size() <= 1:
            raise RuntimeError(
                "a mesh over several ranks needs an initialised "
                "torch.distributed group of them"
            )
        rank = _group_rank() if self.ranks is not None else 0
        self.local_cols = {}
        for i in range(self.shape["data"]):
            cols = tuple(
                j for j in range(n_index)
                if self.ranks is None or self.ranks[i][j] == rank
            )
            if cols:
                self.local_cols[i] = cols
        self.local_rows = tuple(self.local_cols)
        self.row_groups = {}
        if self.multiprocess:
            import torch.distributed as dist

            made = {}
            for i, row in enumerate(self.ranks):
                members = tuple(sorted(set(row)))
                if len(members) < 2:
                    continue
                if members not in made:
                    made[members] = dist.new_group(list(members))
                if i in self.local_cols:
                    self.row_groups[i] = (made[members], members)
        if not self.local_rows:
            raise ValueError(f"rank {rank} owns no position of the mesh")
        i0 = self.local_rows[0]
        self.primary = self.devices[i0][self.local_cols[i0][0]]

    @property
    def multiprocess(self) -> bool:
        return self.ranks is not None and len(
            {r for row in self.ranks for r in row}
        ) > 1

    def row_device(self, i: int) -> torch.device:
        """The device of this process's first position in data row i,
        where the row's merged tile and its selection live."""
        return self.devices[i][self.local_cols[i][0]]


def default_devices(device=None):
    """The devices a run spreads over by default, and the rank owning
    each (None outside a process group): every visible CUDA card, or one
    CPU device when `device` is the CPU; in a group, every rank's."""
    from .. import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        local = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    else:
        local = [dev]
    if _group_size() <= 1:
        return local, None
    import torch.distributed as dist

    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, (dev.type, len(local)))
    devices, ranks = [], []
    for r, (kind, n) in enumerate(counts):
        for k in range(n):
            devices.append(torch.device(kind, k) if kind == "cuda" else torch.device(kind))
            ranks.append(r)
    return devices, ranks


def make_mesh(n_data: int, n_index: int, devices=None, ranks=None) -> Mesh:
    """The first n_data * n_index devices (default: default_devices())
    as an [n_data, n_index] grid, row-major."""
    if devices is None:
        devices, ranks = default_devices()
    n = n_data * n_index
    if len(devices) < n:
        raise ValueError(f"mesh {n_data}x{n_index} needs {n} devices, got {len(devices)}")
    grid = [list(devices[i * n_index:(i + 1) * n_index]) for i in range(n_data)]
    rgrid = None
    if ranks is not None:
        rgrid = [list(ranks[i * n_index:(i + 1) * n_index]) for i in range(n_data)]
    return Mesh(grid, rgrid)


class ShardedIndex:
    """A stacked [n_shards, ...] index placed on a mesh: shard j's tables
    on the devices of index column j, the genome on every device. Only
    the positions (i, j) this process owns are placed, so under one
    process per card a rank holds only its own index shards; a device
    listed at several positions holds one copy of the genome and of
    each shard."""

    def __init__(self, arrays: dict, genome_bases: np.ndarray, mesh: Mesh):
        # snap_tpu's sharded layout: the stacked hit lists and the genome
        # as they are (no padding), packed words from the raw genome
        genome_bases = np.asarray(genome_bases)
        packed = pack_genome_words(genome_bases)
        bad16 = pack_bad16(genome_bases, packed.shape[0])
        tables = np.asarray(arrays["table"])
        hits = np.asarray(arrays["hits"])

        def t32(a, dev):
            return torch.from_numpy(
                np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)
            ).to(dev)

        self.mesh = mesh
        genome_on: dict[str, tuple] = {}
        shard_on: dict[tuple[str, int], tuple] = {}
        self.shards: dict[tuple[int, int], DeviceIndex] = {}
        for i in mesh.local_rows:
            for j in mesh.local_cols[i]:
                dev = mesh.devices[i][j]
                key = str(dev)
                if key not in genome_on:
                    genome_on[key] = (
                        torch.from_numpy(np.array(genome_bases, dtype=np.uint8)).to(dev),
                        t32(packed, dev),
                        t32(bad16, dev),
                    )
                if (key, j) not in shard_on:
                    shard_on[(key, j)] = (t32(tables[j], dev), t32(hits[j], dev))
                g, gp, gb = genome_on[key]
                table, h = shard_on[(key, j)]
                self.shards[(i, j)] = DeviceIndex(
                    table=table, hits=h, genome=g, genome_packed=gp,
                    genome_bad16=gb,
                )

    def at(self, i: int, j: int) -> DeviceIndex:
        return self.shards[(i, j)]


def sharded_device_index(arrays: dict, genome_bases: np.ndarray, mesh: Mesh) -> ShardedIndex:
    """Place a stacked [n_shards, ...] index on the mesh: tables/hits
    sharded over 'index', genome replicated."""
    return ShardedIndex(arrays, genome_bases, mesh)


def local_index_view(didx: ShardedIndex) -> DeviceIndex:
    """Flat view of a sharded index for genome-only consumers
    (score_rows / score_candidates never probe the hash table): the
    index at the mesh's primary position."""
    mesh = didx.mesh
    i = mesh.local_rows[0]
    return didx.at(i, mesh.local_cols[i][0])


def _row_slices(mesh: Mesh, n_rows: int):
    """(data row, slice of the local rows) for each data row this process
    owns a position in; the local rows split evenly over them (every
    rank of a shared row passes that row's reads)."""
    rows = mesh.local_rows
    if n_rows % len(rows):
        raise ValueError(
            f"{n_rows} rows do not split evenly over {len(rows)} data rows"
        )
    bl = n_rows // len(rows)
    return [(i, slice(r * bl, (r + 1) * bl)) for r, i in enumerate(rows)]


def _row_columns(mesh: Mesh, i: int, held: list, dev) -> list:
    """Every index column's tensors of data row i, in column order j =
    0..n_index-1, on `dev`. `held` has one list of tensors for each
    column this process owns (mesh.local_cols[i] order); the lists have
    the same shapes and dtypes in every column. A row inside one process
    needs no transfer; a row spread over ranks all_gathers over its
    subgroup: each rank's columns byte-packed into one [columns, bytes]
    buffer, padded to the largest rank's count (the counts follow from
    the mesh), on the card under nccl and through the host under gloo."""
    if i not in mesh.row_groups:
        return [[t.to(dev) for t in ts] for ts in held]
    import torch.distributed as dist

    group, members = mesh.row_groups[i]
    row = mesh.ranks[i]
    own = held[0][0].device
    where = own if dist.get_backend(group) == "nccl" else torch.device("cpu")
    packed = torch.stack([
        torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in ts])
        for ts in held
    ]).to(where)
    c_max = max(row.count(m) for m in members)
    if packed.shape[0] < c_max:
        pad = packed.new_zeros((c_max - packed.shape[0], packed.shape[1]))
        packed = torch.cat([packed, pad])
    parts = [torch.empty_like(packed) for _ in members]
    dist.all_gather(parts, packed, group=group)
    me = dist.get_rank()
    cols = []
    for j, owner in enumerate(row):
        at = row[:j].count(owner)
        if owner == me:
            cols.append([t.to(dev) for t in held[at]])
            continue
        raw = parts[members.index(owner)][at]
        ts, o = [], 0
        for t in held[0]:
            nb = t.numel() * t.element_size()
            ts.append(raw[o:o + nb].clone().view(t.dtype).reshape(t.shape).to(dev))
            o += nb
        cols.append(ts)
    return cols


def _cat_k(ts, dev) -> torch.Tensor:
    """The tiled all_gather over 'index': shard 0's K columns first."""
    return torch.cat([t.to(dev) for t in ts], dim=1)


def _psum(ts, dev) -> torch.Tensor:
    return torch.stack([t.to(dev) for t in ts]).sum(dim=0).to(ts[0].dtype)


def _por(ts, dev) -> torch.Tensor:
    return torch.stack([t.to(dev) for t in ts]).any(dim=0)


def _merge_out_across_index(outs: list[SingleAlignOut], dev) -> SingleAlignOut:
    """Concatenate per-shard candidate lists along K, shard 0 first;
    reduce per-read scalars. A seed's full hit list lives in exactly one
    shard (shard = top murmur bits of the key), so popular-skip counts
    and truncation flags sum/or across shards while len_eff/n_lookups are
    identical."""
    first = outs[0]
    return first._replace(
        **{f: _cat_k([getattr(o, f) for o in outs], dev) for f in _CAND_FIELDS},
        len_eff=first.len_eff.to(dev), n_lookups=first.n_lookups.to(dev),
        popular=_psum([o.popular for o in outs], dev),
        truncated=_por([o.truncated for o in outs], dev),
    )


def _concat_rows(parts: list, dev):
    """Concatenate per-data-row NamedTuples along the batch axis on `dev`."""
    if len(parts) == 1:
        return type(parts[0])(*(t.to(dev) for t in parts[0]))
    return type(parts[0])(*(
        torch.cat([t.to(dev) for t in ts], dim=0) for ts in zip(*parts)
    ))


def _max_across_ranks(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Elementwise max over every process of the mesh's group (pmax over
    the data rows other processes own)."""
    if not mesh.multiprocess:
        return t
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        buf = t.to(_norm_device("cuda"))
    else:
        buf = t.cpu()
    dist.all_reduce(buf, op=dist.ReduceOp.MAX)
    return buf.to(t.device)


def _at(x: torch.Tensor, sl: slice, dev) -> torch.Tensor:
    return x[sl].to(dev)


def _positions(mesh: Mesh, i: int):
    """(column j, device) of each position this process owns in row i."""
    return [(j, mesh.devices[i][j]) for j in mesh.local_cols[i]]


def align_single_sharded(
    didx: ShardedIndex,
    bases: torch.Tensor,   # [B, L] uint8, this process's rows
    quals: torch.Tensor,
    lens: torch.Tensor,
    params: AlignParams,
    mesh: Mesh,
) -> SingleAlignOut:
    """The monolithic align step (align_single_device) at every
    (data, index) position; the per-shard candidate lists concatenate
    along K."""
    parts = []
    for i, sl in _row_slices(mesh, bases.shape[0]):
        held = [
            list(pipeline.align_single_device(
                didx.at(i, j), _at(bases, sl, dev), _at(quals, sl, dev),
                _at(lens, sl, dev), params,
            ))
            for j, dev in _positions(mesh, i)
        ]
        dev0 = mesh.row_device(i)
        outs = [SingleAlignOut(*ts) for ts in _row_columns(mesh, i, held, dev0)]
        parts.append(_merge_out_across_index(outs, dev0))
    return _concat_rows(parts, mesh.primary)


def align_winners_sharded(
    didx: ShardedIndex,
    bases: torch.Tensor,   # [B, L] uint8, this process's rows
    quals: torch.Tensor,
    lens: torch.Tensor,
    first_alt_start,
    params: AlignParams,
    mesh: Mesh,
    dp_rows: int | None = None,
    alt_awareness: bool = True,
    max_score_gap: int = 64,
):
    """The production fast path (the monolithic, full-depth align +
    device-finalize step) over a (data x index) mesh. Each position
    probes its index shard for its data row; the candidate lists
    concatenate along K, and winner selection + MAPQ run once per data
    row on the merged [B_loc, K * n_index] tile (by every rank of a
    shared row, on the same tile). Returns (packed winners [B+1, 6]
    int32, merged SingleAlignOut), both on the primary device; the
    dp_overflow tail row is the max over every data row and rank."""
    slices = _row_slices(mesh, bases.shape[0])
    if dp_rows is None:
        b_loc = bases.shape[0] // len(slices)
        dp_rows = max(1024, (b_loc * params.max_cand) // 256)
    bodies, tails, merged_parts = [], [], []
    for i, sl in slices:
        held = []
        for j, dev in _positions(mesh, i):
            d = didx.at(i, j)
            b, q, l = _at(bases, sl, dev), _at(quals, sl, dev), _at(lens, sl, dev)
            bundle = pipeline._awd_candidates(d, b, q, l, params)
            out, needs_total = pipeline._awd_score(d, b, q, bundle, params, dp_rows)
            held.append([*out, needs_total])
        dev0 = mesh.row_device(i)
        cols = _row_columns(mesh, i, held, dev0)
        merged = _merge_out_across_index([SingleAlignOut(*ts[:-1]) for ts in cols], dev0)
        needs_max = torch.stack([ts[-1] for ts in cols]).max()
        win = pipeline._device_finalize(
            merged, torch.as_tensor(first_alt_start, dtype=i64).to(dev0),
            alt_awareness, max_score_gap, params.use_affine_gap,
            needs_max, dp_rows,
            max_k=params.max_k,
            extra_search_depth=params.extra_search_depth,
            didx=didx.at(i, mesh.local_cols[i][0]), bases=_at(bases, sl, dev0),
            flag_params=params,
        )
        # pack per data row WITHOUT the dp_overflow tail row; the flag
        # reduces over every row and rank and is appended once
        packed = pipeline.pack_winners(win)
        bodies.append(packed[:-1].to(mesh.primary))
        tails.append(packed[-1:].to(mesh.primary))
        merged_parts.append(merged)
    tail = _max_across_ranks(torch.cat(tails).amax(dim=0, keepdim=True), mesh)
    packed = torch.cat(bodies + [tail], dim=0)
    return packed, _concat_rows(merged_parts, mesh.primary)


def align_tier1_sharded(
    didx: ShardedIndex,
    bases: torch.Tensor,
    quals: torch.Tensor,
    lens: torch.Tensor,
    params: AlignParams,
    mesh: Mesh,
) -> Tier1Out:
    """Sharded tier 1 (candidates + gapless prescreen) for the two-phase
    host-gated path: per-shard candidate tiles concatenate along K.
    Downstream score_rows/two_phase_merge use local_index_view (the DP
    tier never probes the hash table)."""
    parts = []
    for i, sl in _row_slices(mesh, bases.shape[0]):
        held = [
            list(pipeline.align_tier1(
                didx.at(i, j), _at(bases, sl, dev), _at(quals, sl, dev),
                _at(lens, sl, dev), params,
            ))
            for j, dev in _positions(mesh, i)
        ]
        dev0 = mesh.row_device(i)
        outs = [Tier1Out(*ts) for ts in _row_columns(mesh, i, held, dev0)]
        first = outs[0]
        parts.append(first._replace(
            **{f: _cat_k([getattr(o, f) for o in outs], dev0) for f in _TIER1_CAND_FIELDS},
            len_eff=first.len_eff.to(dev0), n_lookups=first.n_lookups.to(dev0),
            popular=_psum([o.popular for o in outs], dev0),
            truncated=_por([o.truncated for o in outs], dev0),
        ))
    return _concat_rows(parts, mesh.primary)


def paired_candidates_sharded(
    didx: ShardedIndex,
    bases0: torch.Tensor,    # [B, L] side-0 reads
    bases1: torch.Tensor,    # [B, L] side-1 reads
    len_eff0: torch.Tensor,  # [B] i32
    len_eff1: torch.Tensor,
    offsets0: torch.Tensor,  # [B, S] i32 probe offsets (-1 = unused)
    offsets1: torch.Tensor,
    set_ids0: torch.Tensor,  # [B, S] i32 disjoint-set ids
    set_ids1: torch.Tensor,
    min_sp: int,
    max_sp: int,
    p,                       # DeviceIntersectParams
    mesh: Mesh,
) -> dict:
    """Sharded-index twin of intersect_device.paired_candidates_device
    (phases 1-2 of IntersectingPairedEndAligner.cpp:406-717): each
    position probes its index shard for its data row's seeds, the
    per-(row, dir) entry-key tables concatenate along 'index' (a seed's
    hit list lives wholly in one shard, so the merged table equals the
    single-index table; recorded / popular counts sum), and phase 2 runs
    on the union.

    Inputs arrive split per side so every data row holds both mates of
    its pairs (the mate-window step pairs local row i with local row
    B_loc + i); outputs are re-concatenated [side0; side1] on the
    primary device.
    """
    L = bases0.shape[1]
    halves = []
    for i, sl in _row_slices(mesh, bases0.shape[0]):
        dev0 = mesh.row_device(i)
        le = torch.cat([len_eff0[sl], len_eff1[sl]]).to(dev0)
        off = torch.cat([offsets0[sl], offsets1[sl]]).to(dev0)
        sid = torch.cat([set_ids0[sl], set_ids1[sl]]).to(dev0)
        b = torch.cat([bases0[sl], bases1[sl]]).to(dev0)
        held = [
            list(_phase1_entries(
                didx.at(i, j), b.to(dev), le.to(dev), off.to(dev), sid.to(dev), p
            ))
            for j, dev in _positions(mesh, i)
        ]
        e_key, rec, pop, nlk, over = zip(*_row_columns(mesh, i, held, dev0))
        # popularity / gather-cap overflow are owned by exactly one shard
        # per lookup; n_lookups is table-independent
        out = _phase2_from_entries(
            _cat_k(e_key, dev0), _psum(rec, dev0), _psum(pop, dev0),
            nlk[0], _por(over, dev0), le, off, sid, min_sp, max_sp, p, L,
        )
        bl = b.shape[0] // 2
        halves.append({k: (v[:bl], v[bl:]) for k, v in out.items()})
    dev = mesh.primary
    return {
        k: torch.cat(
            [h[k][0].to(dev) for h in halves] + [h[k][1].to(dev) for h in halves]
        )
        for k in halves[0]
    }
