"""The device paired intersection of snap_tpu_torch against snap_tpu's,
on the CPU: twins of tests/test_intersect_device.py.

paired_candidates_device (and paired_wide_redo) get the same index
arrays and the same pairs in both packages and must give the same
tensors bit for bit in every field: loc, off, dir, valid, weight,
big_indel, popular, n_lookups and overflow. The port's copy of the host
intersection (align/intersect.paired_candidates) must equal the port's
device result on every row that the device path does not flag, as
snap_tpu's does. Genomes: random (near-unique seeds), random with 25
lookups per end (the 5-bit lookup index), 30% repeats, and a planted
exact repeat that overflows a tiny gather cap.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snap_tpu.align import intersect_device as JD
from snap_tpu.index.build import build_index
from snap_tpu.index.index import make_device_index as jmake
from snap_tpu_torch.align import intersect_device as TD
from snap_tpu_torch.align.intersect import IntersectParams, paired_candidates
from snap_tpu_torch.index.host_lookup import HostIndex
from snap_tpu_torch.index.index import make_device_index as tmake
from test_intersect_device import RC, _mk_genome, _mk_pairs

torch.set_num_threads(1)

FIELDS = ("loc", "off", "dir", "valid", "weight", "big_indel",
          "popular", "n_lookups", "overflow")


class Both:
    """One index in both packages (the port's on the CPU) and its host
    lookup view in the port."""

    def __init__(self, genome, seed_len=20):
        arrays = build_index(genome, seed_len=seed_len)
        self.max_probe = arrays["max_probe"]
        self.jax = jmake(arrays, genome.bases)
        self.torch = tmake(arrays, genome.bases, "cpu")
        self.host = HostIndex(arrays, seed_len, arrays["max_probe"])


def inputs(bases, L, seed_len, num_seeds):
    len_eff = np.full(bases.shape[0], L, np.int32)
    offsets, set_ids = TD.probe_offsets_for(len_eff, L, seed_len, num_seeds)
    j_off, j_sets = JD.probe_offsets_for(len_eff, L, seed_len, num_seeds)
    np.testing.assert_array_equal(offsets, j_off)
    np.testing.assert_array_equal(set_ids, j_sets)
    return bases, len_eff, offsets, set_ids


def run_both(idx, ins, min_sp, max_sp, **geom):
    """paired_candidates_device in both packages: (jax dict, torch dict)
    of numpy arrays, held equal field by field, dtypes included."""
    jp = JD.DeviceIntersectParams(max_probe=idx.max_probe, **geom)
    tp = TD.DeviceIntersectParams(max_probe=idx.max_probe, **geom)
    ref = JD.paired_candidates_device(
        idx.jax, *map(jnp.asarray, ins), jnp.int64(min_sp), jnp.int64(max_sp), jp,
    )
    got = TD.paired_candidates_device(
        idx.torch, *map(torch.from_numpy, ins), min_sp, max_sp, tp,
    )
    return assert_same_pcd(ref, got)


def assert_same_pcd(ref, got):
    assert sorted(got) == sorted(FIELDS)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: v.numpy() for k, v in got.items()}
    for k in FIELDS:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        mism = np.nonzero(got[k] != ref[k])
        assert not mism[0].size, (k, mism[0][:5], got[k][mism][:5], ref[k][mism][:5])
    return got


def assert_host_matches(idx, ins, B, dev, num_seeds):
    """The port's host intersection equals the port's device result on
    every pair the device path does not flag."""
    bases, len_eff, _, _ = ins
    ip = IntersectParams(seed_len=20, num_seeds=num_seeds, max_cand=16, max_k_indels=40)
    host = paired_candidates(idx.host, bases, len_eff, B, ip)
    over_pair = dev["overflow"][:B] | dev["overflow"][B:]
    ok_rows = np.flatnonzero(~np.concatenate([over_pair, over_pair]))
    assert ok_rows.size > 0
    for f in ("loc", "off", "dir", "valid", "weight", "big_indel"):
        d, h = dev[f][ok_rows], getattr(host, f)[ok_rows]
        if f != "valid":
            d = np.where(dev["valid"][ok_rows], d, 0)
            h = np.where(host.valid[ok_rows], h, 0)
        assert (d == h).all(), f
    assert (dev["popular"] == host.popular).all()
    assert (dev["n_lookups"] == host.n_lookups).all()
    return over_pair


GEOM = dict(seed_len=20, hit_cap=32, cand_width=32, max_cand=16, max_k_indels=40)


@pytest.mark.parametrize("case", ["random", "many_seeds", "repeat"])
def test_device_intersection_matches(case):
    """test_intersect_device's random, many-seeds and repeat cases."""
    seed, B, num_seeds, frac = {
        "random": (7, 64, 8, 0.0),
        "many_seeds": (23, 48, 25, 0.0),
        "repeat": (11, 64, 8, 0.30),
    }[case]
    rng = np.random.default_rng(seed)
    genome, seq = _mk_genome(rng, 120_000, repeat_frac=frac)
    idx = Both(genome)
    ins = inputs(_mk_pairs(rng, seq, B, 100), 100, 20, num_seeds)
    dev = run_both(idx, ins, 0, 1000, num_seeds=num_seeds, **GEOM)
    over = assert_host_matches(idx, ins, B, dev, num_seeds)
    if case == "repeat":
        assert (~over).sum() >= 32 and dev["big_indel"].any()
    else:
        assert not over.any()


def test_overflow_flags_capped_rows():
    rng = np.random.default_rng(13)
    genome, seq = _mk_genome(rng, 60_000)
    # plant a massive exact repeat so its seeds exceed a tiny hit cap
    unit = seq[5000:5060].copy()
    for k in range(40):
        p = 8000 + 200 * k
        seq[p : p + 60] = unit
    genome.bases[1000 : 1000 + seq.shape[0]] = seq
    idx = Both(genome)
    B, L = 8, 100
    bases = np.full((2 * B, L), 4, np.uint8)
    for i in range(B):
        bases[i, :60] = unit
        bases[i, 60:] = seq[5060:5100]
        bases[B + i] = RC[seq[5200:5300][::-1]]
    dev = run_both(idx, inputs(bases, L, 20, 8), 0, 1000, seed_len=20,
                   num_seeds=8, hit_cap=8, cand_width=16, max_cand=16)
    assert dev["overflow"][:B].any()


def test_wide_redo_matches():
    """paired_wide_redo after a tight-cap pass on the repeat genome: the
    same tensors in both packages, fewer flagged pairs than before, and
    the unflagged rows equal to the host intersection."""
    rng = np.random.default_rng(31)
    genome, seq = _mk_genome(rng, 120_000, repeat_frac=0.30)
    idx = Both(genome)
    B, L = 64, 100
    ins = inputs(_mk_pairs(rng, seq, B, L), L, 20, 8)
    geom = dict(seed_len=20, num_seeds=8, hit_cap=8, cand_width=8, max_cand=16,
                max_k_indels=40)
    dev0 = run_both(idx, ins, 0, 1000, **geom)
    ovp0 = dev0["overflow"][:B] | dev0["overflow"][B:]
    assert ovp0.any(), "tight caps must overflow on the repeat genome"
    over_rows = np.flatnonzero(ovp0)

    jp = JD.DeviceIntersectParams(max_probe=idx.max_probe, **geom)
    tp = TD.DeviceIntersectParams(max_probe=idx.max_probe, **geom)
    jin, tin = list(map(jnp.asarray, ins)), list(map(torch.from_numpy, ins))
    ref = JD.paired_wide_redo(
        idx.jax, *jin, JD.paired_candidates_device(
            idx.jax, *jin, jnp.int64(0), jnp.int64(1000), jp),
        over_rows, jnp.int64(0), jnp.int64(1000), jp, hit_cap=256, cand_width=128,
    )
    got = TD.paired_wide_redo(
        idx.torch, *tin, TD.paired_candidates_device(idx.torch, *tin, 0, 1000, tp),
        over_rows, 0, 1000, tp, hit_cap=256, cand_width=128,
    )
    dev = assert_same_pcd(ref, got)
    ovp1 = dev["overflow"][:B] | dev["overflow"][B:]
    assert ovp1.sum() < ovp0.sum(), "wide tier must recover rows"
    assert_host_matches(idx, ins, B, dev, 8)


def test_wide_redo_pad_rows_keep_pair_0():
    """The wide redo pads its rows with pair 0. snap_tpu's scatter then
    writes pair 0's old row after its redone one, and the last write
    wins: when pair 0 is among the flagged pairs of a padded chunk, it
    keeps its old fields and its flag. The port does the same."""
    x = torch.zeros((4, 2), dtype=torch.int64)
    idx = torch.tensor([0, 2, 0, 0])
    vals = torch.tensor([[1, 1], [2, 2], [3, 3], [4, 4]])
    out = TD._set_rows(x, idx, vals)
    assert out.tolist() == [[4, 4], [0, 0], [2, 2], [0, 0]]
    ref = jnp.zeros((4, 2), jnp.int64).at[jnp.asarray(idx.numpy())].set(
        jnp.asarray(vals.numpy()))
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())
