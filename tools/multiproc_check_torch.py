"""Multi-process proof for snap_tpu_torch's sharded align step.

The twin of tools/multiproc_check.py for the PyTorch port: launches 2 OS
processes that join a torch.distributed group over gloo (through
cli._maybe_mesh, the path a launcher's MASTER_ADDR / RANK / WORLD_SIZE
environment takes), each owning 4 CPU positions of a global mesh.
Every process contributes the reads of its own data rows, runs the
production align_winners_sharded step on its positions, and checks:

  1. its winner rows equal the single-process run's rows (the same mesh
     of 8 CPU positions in one process), and the dp_overflow tail row,
     max-reduced across the processes, equals the single-process tail;
  2. AlignerStats sum across the processes (stats.reduce_across_hosts).

Two meshes run on all B reads with the launcher's rank order (ranks 0-3
then 4-7, row-major): data = 8 x index = 1 (what snap_tpu's tool
proves) and data = 4 x index = 2 (each process owns two whole data
rows). Three more run on the first SPLIT_READS reads with rank grids
whose data rows span both processes, so the index-axis merge is an
all_gather over a row's process subgroup:

  1x8          ((0, 0, 0, 0, 1, 1, 1, 1))   one row, half a row each
  2x4-alt      ((0, 1, 0, 1), (0, 1, 0, 1)) columns interleaved (the
                                            gather must keep column order)
  2x4-uneven   ((0, 0, 0, 1), (0, 1, 1, 1)) 3 + 1 and 1 + 3 columns (the
                                            gather pads to the larger count)

On each of them align_winners_sharded, align_tier1_sharded and
paired_candidates_sharded (SPLIT_PAIRS pairs of the world) run: both
ranks of a shared row return identical rows, and every row equals the
single-process run of the same mesh; the stats sum counts each read
once, at the rank owning its row's column 0.

Run:  python tools/multiproc_check_torch.py
Exit 0 and a final "MULTIPROC OK" line on success. Imports no JAX.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_PROC = 2
POS_PER_PROC = 4
B = 512  # global batch
L = 100
GLEN = 200_000
SEED_LEN = 20
MESHES = ((8, 1), (4, 2))  # (n_data, n_index)
SPLIT_READS = 128
SPLIT_PAIRS = 64
SPLIT_MESHES = {  # name: rank grid [n_data][n_index]
    "1x8": ((0, 0, 0, 0, 1, 1, 1, 1),),
    "2x4-alt": ((0, 1, 0, 1), (0, 1, 0, 1)),
    "2x4-uneven": ((0, 0, 0, 1), (0, 1, 1, 1)),
}
PAIR_KW = dict(num_seeds=8, max_cand=8, max_k_indels=40)
MIN_SP, MAX_SP = 50, 500


def build_world():
    """Deterministic genome/index/reads, identical in every process."""
    from snap_tpu_torch.constants import PAD
    from snap_tpu_torch.genome import Contig, Genome
    from snap_tpu_torch.index.index import GenomeIndex

    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, size=GLEN).astype(np.uint8)
    gb = np.full(GLEN + 2000, PAD, dtype=np.uint8)
    gb[1000 : 1000 + GLEN] = codes
    genome = Genome(
        bases=gb, contigs=[Contig(name="chr1", start=1000, length=GLEN)]
    )
    index = GenomeIndex.build(genome, seed_len=SEED_LEN, device="cpu")
    starts = rng.integers(0, GLEN - L - 1, size=B)
    reads = codes[starts[:, None] + np.arange(L)[None, :]]
    mut = rng.random(reads.shape) < 0.01
    reads = np.where(mut, rng.integers(0, 4, reads.shape), reads).astype(
        np.uint8
    )
    quals = np.full((B, L), ord("I"), dtype=np.uint8)
    lens = np.full(B, L, dtype=np.int32)
    return genome, index, reads, quals, lens


def build_pairs(genome):
    """SPLIT_PAIRS read pairs of the world's genome (inserts 250-450, the
    second end reverse-complemented), as paired_candidates_sharded takes
    them: per side bases, clipped lengths, probe offsets, set ids."""
    from snap_tpu_torch.align.intersect_device import probe_offsets_for

    codes = np.asarray(genome.bases)[1000 : 1000 + GLEN]
    rng = np.random.default_rng(9)
    n = SPLIT_PAIRS
    p1 = rng.integers(0, GLEN - 500, size=n)
    ins = rng.integers(250, 450, size=n)
    r1 = codes[p1[:, None] + np.arange(L)[None, :]]
    r2 = (3 - codes[(p1 + ins - L)[:, None] + np.arange(L)[None, :]][:, ::-1]).astype(np.uint8)
    mut = rng.random(r1.shape) < 0.01
    r1 = np.where(mut, rng.integers(0, 4, r1.shape), r1).astype(np.uint8)
    len_eff = np.full(n, L, np.int32)
    offsets, set_ids = probe_offsets_for(len_eff, L, SEED_LEN, PAIR_KW["num_seeds"])
    return [(r1, r2), (len_eff, len_eff), (offsets, offsets), (set_ids, set_ids)]


def split_layout(grid, rank):
    """The reads and pairs (global indices) rank passes on a mesh of
    rank grid `grid`: every data row it owns a position in, each row
    SPLIT_READS / n_data reads and SPLIT_PAIRS / n_data pairs."""
    rows = [i for i, row in enumerate(grid) if rank is None or rank in row]
    per_r, per_p = SPLIT_READS // len(grid), SPLIT_PAIRS // len(grid)
    reads = np.concatenate([np.arange(i * per_r, (i + 1) * per_r) for i in rows])
    pairs = np.concatenate([np.arange(i * per_p, (i + 1) * per_p) for i in rows])
    return reads, pairs


def run_split(mesh, index, genome, reads, quals, lens, pairs, read_rows, pair_rows):
    """The three sharded functions on a mesh over this process's rows:
    the winners (rows + tail), every tier-1 field and every paired field
    as numpy arrays, the paired ones reordered per pair ([side0 | side1]
    along the last axis of a [pairs, 2, ...] array)."""
    import torch

    from snap_tpu_torch.align.intersect_device import DeviceIntersectParams
    from snap_tpu_torch.align.pipeline import AlignParams
    from snap_tpu_torch.parallel.mesh import (
        align_tier1_sharded, align_winners_sharded, paired_candidates_sharded,
    )

    index.to_mesh(mesh, mesh.shape["index"])
    params = AlignParams(
        seed_len=SEED_LEN, max_probe=index.max_probe, num_seeds=25,
        hit_cap=8, max_cand=16,
    )
    t = lambda a, rows: torch.from_numpy(np.ascontiguousarray(a[rows]))  # noqa: E731
    b, q, ln = (t(a, read_rows) for a in (reads, quals, lens))
    d = index.device_sharded
    out = {"win": align_winners_sharded(
        d, b, q, ln, int(np.asarray(genome.bases).shape[0]), params, mesh)[0].numpy()}
    t1 = align_tier1_sharded(d, b, q, ln, params, mesh)
    out.update({f"t1_{f}": v.numpy() for f, v in zip(t1._fields, t1)})
    dip = DeviceIntersectParams(seed_len=SEED_LEN, max_probe=index.max_probe, **PAIR_KW)
    args = [t(side, pair_rows) for a in pairs for side in a]
    pc = paired_candidates_sharded(d, *args, MIN_SP, MAX_SP, dip, mesh)
    n = len(pair_rows)
    for k, v in pc.items():
        v = v.numpy()
        out[f"pc_{k}"] = np.stack([v[:n], v[n:]], axis=1)
    return out


def run_step(mesh, n_index, index, genome, reads, quals, lens, local_rows):
    """Place the index on the mesh and run the sharded step on this
    process's rows; returns the packed winners (local rows + tail)."""
    import torch

    from snap_tpu_torch.align.pipeline import AlignParams
    from snap_tpu_torch.parallel.mesh import align_winners_sharded

    index.to_mesh(mesh, n_index)
    params = AlignParams(
        seed_len=SEED_LEN, max_probe=index.max_probe, num_seeds=25,
        hit_cap=8, max_cand=16,
    )
    rows = lambda a: torch.from_numpy(np.ascontiguousarray(a[local_rows]))  # noqa: E731
    win, _ = align_winners_sharded(
        index.device_sharded, rows(reads), rows(quals), rows(lens),
        int(np.asarray(genome.bases).shape[0]), params, mesh,
    )
    return win.numpy()


def child_main(rank: int) -> None:
    import torch
    import torch.distributed as dist

    from snap_tpu_torch.cli import _maybe_mesh
    from snap_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    # the launcher path: one CPU device, no -ishards -> no mesh, but the
    # group comes up from MASTER_ADDR / RANK / WORLD_SIZE
    assert _maybe_mesh({"ishards": 1, "batch_size": B}, "cpu", [torch.device("cpu")]) == (None, 1)
    assert dist.is_initialized() and dist.get_world_size() == N_PROC
    assert dist.get_backend() == "gloo"
    genome, index, reads, quals, lens = build_world()
    per = B // N_PROC
    local_rows = np.arange(rank * per, (rank + 1) * per)
    cpu = [torch.device("cpu")] * (N_PROC * POS_PER_PROC)
    ranks = [r for r in range(N_PROC) for _ in range(POS_PER_PROC)]
    out = {}
    for n_data, n_index in MESHES:
        mesh = make_mesh(n_data, n_index, cpu, ranks)
        assert mesh.multiprocess and len(mesh.local_rows) == n_data // N_PROC
        out[f"{n_data}x{n_index}"] = run_step(
            mesh, n_index, index, genome, reads, quals, lens, local_rows
        )
    np.savez(os.path.join(os.environ["MPC_TMP"], f"part{rank}.npz"),
             idx=local_rows, **out)

    from snap_tpu_torch.parallel.mesh import Mesh

    pairs = build_pairs(genome)
    for name, grid in SPLIT_MESHES.items():
        mesh = Mesh([[torch.device("cpu")] * len(grid[0])] * len(grid), grid)
        assert mesh.multiprocess and mesh.row_groups, name
        read_rows, pair_rows = split_layout(grid, rank)
        got = run_split(mesh, index, genome, reads, quals, lens, pairs, read_rows, pair_rows)
        np.savez(os.path.join(os.environ["MPC_TMP"], f"split{rank}_{name}.npz"),
                 reads=read_rows, pairs=pair_rows, **got)
        # each read counted once: at the rank owning its row's column 0
        from snap_tpu_torch.stats import AlignerStats, reduce_across_hosts

        st = AlignerStats()
        st.total = sum(SPLIT_READS // len(grid) for row in grid if row[0] == rank)
        st = reduce_across_hosts(st)
        assert st.total == SPLIT_READS, (name, st.total)
        print(f"[proc {rank}] {name} stats_total={st.total} OK", flush=True)

    # the dp_overflow tail's reduction across the processes (a pmax)
    from snap_tpu_torch.parallel.mesh import _max_across_ranks

    flag = torch.zeros((1, 6), dtype=torch.int32)
    flag[0, 0] = rank
    assert int(_max_across_ranks(flag, mesh)[0, 0]) == N_PROC - 1

    from snap_tpu_torch.stats import AlignerStats, reduce_across_hosts

    st = AlignerStats()
    st.total = len(local_rows)
    st.single = rank + 1  # distinct per process: the sum must be 3
    st.mapq_histogram[60] = rank + 1
    st = reduce_across_hosts(st)
    assert st.total == B, st.total
    assert st.single == sum(range(1, N_PROC + 1)), st.single
    assert int(st.mapq_histogram[60]) == sum(range(1, N_PROC + 1))
    bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "snap_tpu.")))
    assert not bad, bad
    print(f"[proc {rank}] rows={len(local_rows)} stats_total={st.total} OK", flush=True)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parent_main() -> None:
    import torch

    torch.set_num_threads(1)
    tmp = tempfile.mkdtemp(prefix="mpc_torch_")
    port = _free_port()
    procs = []
    for rank in range(N_PROC):
        env = dict(
            os.environ, MPC_TMP=tmp, PYTHONPATH=REPO,
            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
            RANK=str(rank), WORLD_SIZE=str(N_PROC),
        )
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", str(rank)],
            env=env,
        ))
    try:
        # the single-process runs of the same meshes, while the group runs
        refs = single_process_refs()
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(rc == 0 for rc in rcs), f"child exit codes {rcs}"

    parts = [np.load(os.path.join(tmp, f"part{r}.npz")) for r in range(N_PROC)]
    for n_data, n_index in MESHES:
        key = f"{n_data}x{n_index}"
        ref = refs[key]
        got = {}
        for z in parts:
            for i, row in zip(z["idx"], z[key][:-1]):
                got[int(i)] = row
            assert np.array_equal(z[key][-1], ref[-1]), f"{key}: tail row differs"
        assert len(got) == B, f"{key}: covered {len(got)}/{B} reads"
        mism = [i for i in range(B) if not np.array_equal(got[i], ref[i])]
        assert not mism, f"{key}: {len(mism)} winner rows differ, first {mism[:5]}"
        found = int(((ref[:-1, 5] >> 8) & 1).sum())
        assert found > 0.9 * B, f"{key}: only {found} reads found"
        print(f"{key}: {B} winner rows identical to the single-process run")
    for name in SPLIT_MESHES:
        check_split(tmp, name, refs[name])
    print(f"MULTIPROC OK: {B} reads, {N_PROC} processes x {POS_PER_PROC} "
          "CPU positions over gloo, winners identical to single-process, "
          f"{len(SPLIT_MESHES)} meshes with rows across processes, stats summed")


def single_process_refs() -> dict:
    """Every mesh's run in this one process (no group, ranks=None), in
    the children's order, over all the reads (and pairs)."""
    import torch

    from snap_tpu_torch.parallel.mesh import Mesh, make_mesh

    genome, index, reads, quals, lens = build_world()
    refs = {}
    for n_data, n_index in MESHES:
        mesh = make_mesh(n_data, n_index, [torch.device("cpu")] * (N_PROC * POS_PER_PROC))
        refs[f"{n_data}x{n_index}"] = run_step(
            mesh, n_index, index, genome, reads, quals, lens, np.arange(B))
    pairs = build_pairs(genome)
    for name, grid in SPLIT_MESHES.items():
        mesh = Mesh([[torch.device("cpu")] * len(grid[0])] * len(grid))
        refs[name] = run_split(mesh, index, genome, reads, quals, lens, pairs,
                               *split_layout(grid, None))
    return refs


def check_split(tmp, name, ref) -> None:
    """Every row the processes returned on split mesh `name` against the
    single-process run of the same mesh, and the two ranks' copies of a
    shared row against each other."""
    seen = {}  # (field, global row) -> the first rank's row
    shared = 0
    for r in range(N_PROC):
        z = np.load(os.path.join(tmp, f"split{r}_{name}.npz"))
        assert np.array_equal(z["win"][-1], ref["win"][-1]), f"{name}: tail row differs"
        for key in ref:
            rows = z["pairs"] if key.startswith("pc_") else z["reads"]
            body = z[key][:-1] if key == "win" else z[key]
            want = ref[key][:-1] if key == "win" else ref[key]
            assert body.shape[0] == rows.size, (name, key, body.shape)
            for g, row in zip(rows.tolist(), body):
                if (key, g) in seen:
                    shared += 1
                    assert np.array_equal(seen[(key, g)], row), (
                        f"{name}: {key} row {g} differs between the ranks")
                seen[(key, g)] = row
                assert np.array_equal(row, want[g]), (
                    f"{name}: {key} row {g} differs from the single-process run")
    for key in ref:
        n = SPLIT_PAIRS if key.startswith("pc_") else SPLIT_READS
        assert sum(1 for k, _ in seen if k == key) == n, (name, key)
    assert shared > 0, f"{name}: no row shared between the ranks"
    found = int(((ref["win"][:-1, 5] >> 8) & 1).sum())
    assert found > 0.9 * SPLIT_READS and ref["pc_valid"].any(), name
    print(f"{name}: {SPLIT_READS} winner and tier-1 rows and {SPLIT_PAIRS} paired "
          "rows identical to the single-process run; shared rows identical "
          "across ranks")


if __name__ == "__main__":
    if "--child" in sys.argv:
        child_main(int(sys.argv[sys.argv.index("--child") + 1]))
    else:
        parent_main()
