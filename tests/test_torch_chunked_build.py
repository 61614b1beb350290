"""index/build.py's numpy builders in snap_tpu_torch against snap_tpu's
(the twins of tests/test_chunked_build.py, plus the sharded layouts):
pack_seeds and pack_seeds_range, the chunked (-sm) build, `index -sm`
through both CLIs, and shard_index / reshard_index. These arrays are
the system's weights: every array must be equal, max_probe included.
"""

import os

import numpy as np
import pytest
import torch

import snap_tpu.cli as jcli
import snap_tpu.index.build as J
import snap_tpu_torch.cli as tcli
import snap_tpu_torch.index.build as T
from test_torch_index import make_codes, padded_genome, port_genome

torch.set_num_threads(1)


def same_arrays(a: dict, b: dict, what=""):
    assert sorted(k for k in a if not k.startswith("_")) == sorted(
        k for k in b if not k.startswith("_")
    ), what
    for k in a:
        if k.startswith("_"):
            continue
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (what, k)
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=f"{what}{k}")
        else:
            assert a[k] == b[k], (what, k, a[k], b[k])


@pytest.mark.parametrize("seed_len", [8, 20, 22, 24, 25, 32])
def test_pack_seeds_range_matches_gather(seed_len):
    rng = np.random.default_rng(seed_len)
    bases = rng.integers(0, 4, size=5000).astype(np.uint8)
    bases[rng.integers(0, 5000, size=40)] = 5  # scattered Ns
    lo, hi = 7, 5000 - seed_len + 1
    pos = np.arange(lo, hi, dtype=np.int64)
    ref = J.pack_seeds(bases, pos, seed_len)
    for got in (T.pack_seeds(bases, pos, seed_len),
                T.pack_seeds_range(bases, lo, hi, seed_len)):
        np.testing.assert_array_equal(got[2], ref[2])
        v = ref[2]
        np.testing.assert_array_equal(got[0][v], ref[0][v])
        np.testing.assert_array_equal(got[1][v], ref[1][v])
    # pack_seeds itself is equal everywhere, invalid windows included
    for a, b in zip(T.pack_seeds(bases, pos, seed_len), ref):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def genome():
    return padded_genome(make_codes("repeat25", np.random.default_rng(3), 120_000))


def test_chunked_matches_reference(genome, tmp_path):
    """A budget that forces many banks: both packages spill and assemble
    the same arrays, and the banked table answers as the in-memory one."""
    ref = J.build_index_chunked(genome, seed_len=20, memory_budget_gb=0.0002,
                                tmpdir=str(tmp_path / "j"))
    got = T.build_index_chunked(port_genome(genome), seed_len=20,
                                memory_budget_gb=0.0002, tmpdir=str(tmp_path / "t"))
    assert got["table"].shape[0] > 1  # actually banked
    same_arrays(ref, got)
    from snap_tpu_torch.index.host_lookup import HostIndex

    mem = T.build_index(port_genome(genome), seed_len=20)
    bases = np.asarray(genome.bases)
    pos = np.random.default_rng(0).integers(1000, 1000 + 120_000 - 20, 300)
    fwd, rc, valid = T.pack_seeds(bases, pos, 20)
    q = np.minimum(fwd, rc)[valid]

    def lookups(arrays):
        hx = HostIndex(arrays, 20, arrays["max_probe"])
        found, start, n0, n1 = hx.probe(q)
        return [None if not f else (sorted(hx.hits[s:s + a].tolist()),
                                    sorted(hx.hits[s + a:s + a + b].tolist()))
                for f, s, a, b in zip(found, start.tolist(), n0.tolist(), n1.tolist())]

    assert lookups(mem) == lookups(got)


def test_index_sm_cli(tmp_path):
    """`index -sm` (the chunked build saved as raw .npy files) and a
    `single` run on it through both CLIs: equal index files, equal SAM."""
    from test_torch_cli_cuda import write_inputs

    sides = {}
    for side in ("jax", "torch"):
        d = tmp_path / side
        d.mkdir()
        write_inputs(str(d), "random", 40)
        sides[side] = d
    argv_i = ["index", "g.fa", "idx", "-s", "20", "-sm", "0.0001"]
    argv_s = ["single", "idx", "r.fq", "-o", "out.sam", "-b", "16"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcli, "_maybe_mesh", lambda opts: (None, 1))
        mp.chdir(sides["jax"])
        assert jcli.main(argv_i) == 0 and jcli.main(argv_s) == 0
        mp.chdir(sides["torch"])
        assert tcli.main(argv_i, device="cpu") == 0 and tcli.main(argv_s, device="cpu") == 0
    names = sorted(os.listdir(sides["jax"] / "idx"))
    assert "hits.npy" in names and names == sorted(os.listdir(sides["torch"] / "idx"))
    for n in names:
        a, b = (sides[s] / "idx" / n for s in ("jax", "torch"))
        if n.endswith(".npy"):
            np.testing.assert_array_equal(np.load(b), np.load(a), err_msg=n)
        else:
            assert b.read_bytes() == a.read_bytes(), n
    sam = (sides["torch"] / "out.sam").read_bytes()
    assert sam == (sides["jax"] / "out.sam").read_bytes()
    assert sam.count(b"\tc1\t") + sam.count(b"\tc2\t") > 20  # 40 reads, some junk or short


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_shard_and_reshard_match_reference(genome, n_shards):
    g_t = port_genome(genome)
    same_arrays(J.shard_index(genome, 20, n_shards), T.shard_index(g_t, 20, n_shards),
                f"shard_index({n_shards}).")
    flat = J.build_index(genome, 20)
    re_j, re_t = J.reshard_index(flat, n_shards), T.reshard_index(flat, n_shards)
    same_arrays(re_j, re_t, f"reshard_index({n_shards}).")
    assert re_t["hits"].shape[0] == re_t["table"].shape[0] == n_shards


def test_reshard_answers_as_flat(genome):
    """Every key probes to its flat hit lists in its own shard and misses
    in the others (shard = the top murmur bits of the key)."""
    from snap_tpu_torch.index.host_lookup import HostIndex

    flat = T.build_index(port_genome(genome), 20)
    sh = T.reshard_index(flat, 4)
    bases = np.asarray(genome.bases)
    pos = np.random.default_rng(1).integers(1000, 1000 + 120_000 - 20, 200)
    fwd, rc, valid = T.pack_seeds(bases, pos, 20)
    q = np.minimum(fwd, rc)[valid]
    owner = T._shard_of(q, 4)
    hf = HostIndex(flat, 20, flat["max_probe"])
    f_found, f_start, f_n0, f_n1 = hf.probe(q)
    for s in range(4):
        arr = {"table": sh["table"][s], "hits": sh["hits"][s]}
        hx = HostIndex(arr, 20, sh["max_probe"])
        found, start, n0, n1 = hx.probe(q)
        np.testing.assert_array_equal(found, f_found & (owner == s))
        for i in np.flatnonzero(found):
            a, b = int(start[i]), int(f_start[i])
            n = int(n0[i]) + int(n1[i])
            assert (int(n0[i]), int(n1[i])) == (int(f_n0[i]), int(f_n1[i]))
            np.testing.assert_array_equal(hx.hits[a:a + n], hf.hits[b:b + n])
