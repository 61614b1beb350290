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

Two meshes run: data = 8 x index = 1 (what snap_tpu's tool proves) and
data = 4 x index = 2 (each process owns two whole data rows, so the
index-axis merge stays inside a process).

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
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(rc == 0 for rc in rcs), f"child exit codes {rcs}"

    from snap_tpu_torch.parallel.mesh import make_mesh

    genome, index, reads, quals, lens = build_world()
    parts = [np.load(os.path.join(tmp, f"part{r}.npz")) for r in range(N_PROC)]
    for n_data, n_index in MESHES:
        key = f"{n_data}x{n_index}"
        mesh = make_mesh(n_data, n_index, [torch.device("cpu")] * (N_PROC * POS_PER_PROC))
        ref = run_step(mesh, n_index, index, genome, reads, quals, lens, np.arange(B))
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
    print(f"MULTIPROC OK: {B} reads, {N_PROC} processes x {POS_PER_PROC} "
          "CPU positions over gloo, winners identical to single-process, "
          "stats summed")


if __name__ == "__main__":
    if "--child" in sys.argv:
        child_main(int(sys.argv[sys.argv.index("--child") + 1]))
    else:
        parent_main()
