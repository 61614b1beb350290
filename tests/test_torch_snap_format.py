"""Importing reference-SNAP index directories in the port
(index/snap_format.py, GenomeIndex.load): twin of
tests/test_snap_index_import.py.

Where the reference source is absent, a tiny directory is written here
in the layout snap_format.py parses: SNAP's Genome file (text header,
contig lines, raw bases with 'n' padding), the GenomeIndex header, 256
hash-table blobs of 4-byte keys and two 4-byte values (the forward and
reverse-complement hits of each SNAP-canonical 20-mer, in SNAP's
A=0,G=1,C=2,T=3 coding) and an OverflowTable for seeds with more than
one hit. On it:

- the port's load_snap_index gives snap_tpu's genome and index arrays;
- its per-seed hit lists equal those of the port's own builder over
  the same genome (the writer and the importer agree with SNAP's
  layout);
- `single` on the directory writes the same SAM in both packages, with
  the reads at their true positions.

The binary-built case (snap-aligner index on datatest.fa) runs when the
reference source and make are there, and skips otherwise, as
test_snap_index_import.py does.
"""

import os
import shutil
import struct
import subprocess

import numpy as np
import pytest
import torch

from snap_tpu_torch.index.snap_format import is_snap_index_dir, load_snap_index
from test_torch_cli_cuda import DEC
from test_torch_pipeline import same_logq  # noqa: F401
from test_snap_index_import import DATATEST_FA, snap_binary  # noqa: F401
from test_torch_single import run_jax, run_torch

torch.set_num_threads(1)

SEED, PADDING, KEY_BYTES = 20, 200, 4
SNAP_CODE = np.array([0, 2, 1, 3], np.uint64)  # ours (A C G T) -> SNAP's (A G C T)
INVALID = 0xFFFFFFFF
MAGIC = 0xB111B010


def genome_contigs(seed=5):
    """Two random contigs, the second holding a 300 bp copy of the first's
    sequence (seeds with several hits go to the overflow table)."""
    rng = np.random.default_rng(seed)
    c1 = rng.integers(0, 4, 3000).astype(np.uint8)
    c2 = rng.integers(0, 4, 2500).astype(np.uint8)
    c2[1000:1300] = c1[500:800]
    return {"ctgA": c1, "ctgB": c2}


def write_snap_dir(d, contigs):
    """A SNAP-format index directory of `contigs` (name -> codes)."""
    os.makedirs(d, exist_ok=True)
    parts, begins, pos = [], [], 0
    for codes in contigs.values():
        parts.append(b"n" * PADDING)
        pos += PADDING
        begins.append(pos)
        parts.append(DEC[codes].tobytes())
        pos += codes.size
    parts.append(b"n" * PADDING)
    raw = b"".join(parts)
    with open(os.path.join(d, "Genome"), "wb") as f:
        f.write(b"%d %d 0\n" % (len(raw), len(contigs)))
        for i, (name, b) in enumerate(zip(contigs, begins)):
            f.write(b"%d 0 %d 0 0 %d 0 %s \n" % (b, i, len(name), name.encode()))
        f.write(raw)

    # every valid 20-mer: SNAP-coded, first base in the high bits
    gen = np.frombuffer(raw, np.uint8)
    ours = np.full(gen.size, 4, np.int64)
    for ch, code in zip(b"ACGT", range(4)):
        ours[gen == ch] = code
    P = gen.size - SEED + 1
    win = np.lib.stride_tricks.sliding_window_view(ours, SEED)[:P]
    ok = (win < 4).all(axis=1)
    loc = np.flatnonzero(ok)
    codes = SNAP_CODE[win[ok]]
    sh = np.uint64(2) * np.arange(SEED - 1, -1, -1, dtype=np.uint64)
    fwd = (codes << sh).sum(axis=1, dtype=np.uint64)
    rc = ((np.uint64(3) - codes[:, ::-1]) << sh).sum(axis=1, dtype=np.uint64)
    canon = np.minimum(fwd, rc)
    slot = (fwd != canon).astype(np.int64)
    hits: dict[int, list[list[int]]] = {}
    for k, s, g in zip(canon.tolist(), slot.tolist(), loc.tolist()):
        hits.setdefault(k, [[], []])[s].append(g)

    overflow: list[int] = []
    tables: dict[int, list[tuple[int, int, int]]] = {}
    for k, slots in sorted(hits.items()):
        vals = []
        for locs in slots:
            if not locs:
                vals.append(INVALID - 1)  # no hit in this direction
            elif len(locs) == 1:
                vals.append(locs[0])
            else:
                vals.append(len(raw) + len(overflow))
                overflow += [len(locs), *sorted(locs, reverse=True)]
        t, key = k >> (8 * KEY_BYTES), k & ((1 << (8 * KEY_BYTES)) - 1)
        tables.setdefault(t, []).append((vals[0], vals[1], key))
    n_tables = 4 ** SEED >> (8 * KEY_BYTES)
    with open(os.path.join(d, "GenomeIndexHash"), "wb") as f:
        for t in range(n_tables):
            rows = tables.get(t, []) + [(INVALID, INVALID, 0)] * 3  # unused slots
            f.write(struct.pack("<Iqq", MAGIC, len(rows), len(rows) - 3))
            f.write(struct.pack("<III", KEY_BYTES, 4, 2) + struct.pack("<I", INVALID))
            f.write(np.array(rows, np.uint32).tobytes())
    np.array(overflow, np.uint32).tofile(os.path.join(d, "OverflowTable"))
    with open(os.path.join(d, "GenomeIndex"), "w") as f:
        f.write(f"7 0 {n_tables} {len(overflow)} {SEED} {PADDING} {KEY_BYTES} 0 0 4\n")
    return begins


def hit_map(arrays):
    """canonical key -> (forward hits, reverse hits) of an index's arrays."""
    m = {}
    t = arrays["table"].reshape(-1, 4)
    h = arrays["hits"]
    occ = ~((t[:, 0] == 0xFFFFFFFF) & (t[:, 1] == 0xFFFFFFFF))
    for i in np.flatnonzero(occ):
        k = int(t[i, 0]) | (int(t[i, 1]) << 32)
        s, n0, n1 = int(t[i, 2]), int(t[i, 3]) & 0xFFFF, int(t[i, 3]) >> 16
        m[k] = (h[s : s + n0].tolist(), h[s + n0 : s + n0 + n1].tolist())
    return m


def assert_same_import(directory):
    from snap_tpu.index.snap_format import load_snap_index as jload

    genome, arrays = load_snap_index(directory)
    jgenome, jarrays = jload(directory)
    assert [vars(c) for c in genome.contigs] == [vars(c) for c in jgenome.contigs]
    np.testing.assert_array_equal(genome.bases, jgenome.bases)
    assert sorted(arrays) == sorted(jarrays)
    for k in arrays:
        a, b = np.asarray(arrays[k]), np.asarray(jarrays[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    return genome, arrays


@pytest.fixture(scope="module")
def snap_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("snapfmt") / "snapidx"
    contigs = genome_contigs()
    begins = write_snap_dir(str(d), contigs)
    return str(d), contigs, begins


def test_import_matches_snap_tpu(snap_dir):
    d, contigs, begins = snap_dir
    assert is_snap_index_dir(d)
    genome, arrays = assert_same_import(d)
    assert arrays["seed_len"] == SEED
    assert [(c.name, c.start, c.length) for c in genome.contigs] == [
        (n, b, c.size) for (n, c), b in zip(contigs.items(), begins)]


def test_import_matches_own_build(snap_dir, tmp_path):
    """The imported hit lists are those of the port's builder over the
    same FASTA at the same padding."""
    from snap_tpu_torch.genome import load_fasta
    from snap_tpu_torch.index.build import build_index

    d, contigs, _ = snap_dir
    fa = tmp_path / "g.fa"
    with open(fa, "wb") as f:
        for name, codes in contigs.items():
            f.write(b">%s\n%s\n" % (name.encode(), DEC[codes].tobytes()))
    own = build_index(load_fasta(str(fa), chromosome_padding=PADDING), seed_len=SEED)
    m_imp, m_own = hit_map(load_snap_index(d)[1]), hit_map(own)
    assert m_imp == m_own
    assert any(len(f) + len(r) > 1 for f, r in m_imp.values())  # overflow seeds


def test_align_from_snap_dir(same_logq, snap_dir, tmp_path_factory):
    """GenomeIndex.load imports the directory; `single` on it writes the
    same SAM in both packages, reads at their true positions."""
    from snap_tpu_torch.index.index import GenomeIndex

    d, contigs, _ = snap_dir
    idx = GenomeIndex.load(d, device="cpu")
    assert idx.seed_len == SEED
    rng = np.random.default_rng(9)
    reads = []
    for i in range(32):
        name = list(contigs)[i % 2]
        c = contigs[name]
        s = int(rng.integers(0, c.size - 100))
        r = c[s : s + 100].copy()
        r[rng.integers(0, 100, 2)] = rng.integers(0, 4, 2)
        reads.append(b"@s%d_%s_%d\n%s\n+\n%s\n" % (i, name.encode(), s + 1, DEC[r].tobytes(), b"I" * 100))
    sams = {}
    for side, run in (("jax", run_jax), ("torch", run_torch)):
        w = tmp_path_factory.mktemp(f"snapaln_{side}")
        shutil.copytree(d, w / "snapidx")
        (w / "r.fq").write_bytes(b"".join(reads))
        run(w, ["single", "snapidx", "r.fq", "-o", "out.sam", "-b", "32"])
        sams[side] = (w / "out.sam").read_bytes()
    assert sams["torch"] == sams["jax"]
    body = [ln.split(b"\t") for ln in sams["torch"].split(b"\n") if ln and not ln.startswith(b"@")]
    placed = sum(1 for r in body if r[2] == r[0].split(b"_")[1] and
                 abs(int(r[3]) - int(r[0].split(b"_")[2])) <= 2)
    assert len(body) == 32 and placed >= 30


def test_import_binary_built_index(snap_binary, tmp_path):
    """snap-aligner's own index of datatest.fa: the port imports what
    snap_tpu imports."""
    d = tmp_path / "refidx"
    r = subprocess.run([snap_binary, "index", DATATEST_FA, str(d), "-s", "16"],
                       capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-500:]
    genome, arrays = assert_same_import(str(d))
    assert arrays["seed_len"] == 16 and [c.name for c in genome.contigs] == ["ref1"]
