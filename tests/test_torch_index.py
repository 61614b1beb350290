"""snap_tpu_torch's index build and device lookups against snap_tpu's.

The same genome and the same numpy inputs go to both packages; every
lookup output is integer data and must be exactly equal. Both genomes
of the slice's tests are covered: uniform random, and 25% repeats
(bench.py's _gen_repeat_genome model), whose seeds have long hit lists.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snap_tpu.constants import PAD
from snap_tpu.genome import Contig, Genome
from snap_tpu.index import build as jbuild
from snap_tpu.index import index as jindex
from snap_tpu_torch.index import build as tbuild
from snap_tpu_torch.index import index as tindex

torch.set_num_threads(1)


def gen_repeat_genome(rng, glen: int, repeat_frac: float) -> np.ndarray:
    """bench.py's _gen_repeat_genome: ~300 bp SINE-like units with 1%
    divergence, 6 kb LINE-like units, and tandem microsatellites."""
    seq = rng.integers(0, 4, size=glen).astype(np.uint8)
    budget = int(glen * repeat_frac)
    alu = rng.integers(0, 4, size=300).astype(np.uint8)
    for _ in range(max(1, budget // 2 // 300)):
        p = int(rng.integers(0, glen - 300))
        u = alu.copy()
        d = rng.random(300) < 0.01
        u[d] = rng.integers(0, 4, int(d.sum()))
        seq[p : p + 300] = u
    line = rng.integers(0, 4, size=6000).astype(np.uint8)
    for _ in range(max(1, budget // 2 // 6000)):
        p = int(rng.integers(0, glen - 6000))
        seq[p : p + 6000] = line
    for _ in range(max(1, glen // 20000)):
        unit = rng.integers(0, 4, size=4).astype(np.uint8)
        reps = int(rng.integers(20, 60))
        p = int(rng.integers(0, glen - 4 * reps))
        seq[p : p + 4 * reps] = np.tile(unit, reps)
    return seq


def make_codes(kind: str, rng, glen: int) -> np.ndarray:
    if kind == "random":
        return rng.integers(0, 4, size=glen).astype(np.uint8)
    return gen_repeat_genome(rng, glen, 0.25)


def padded_genome(codes: np.ndarray) -> Genome:
    """One contig at location 1000, PAD on both sides (snap_tpu's
    Genome; the port's Genome has the same fields)."""
    bases = np.full(codes.size + 2000, PAD, np.uint8)
    bases[1000 : 1000 + codes.size] = codes
    return Genome(
        bases=bases, contigs=[Contig(name="c1", start=1000, length=codes.size)]
    )


def port_genome(g: Genome):
    from snap_tpu_torch.genome import Contig as TContig
    from snap_tpu_torch.genome import Genome as TGenome

    return TGenome(
        bases=np.asarray(g.bases),
        contigs=[TContig(name=c.name, start=c.start, length=c.length) for c in g.contigs],
    )


def i64(a: np.ndarray) -> torch.Tensor:
    """uint64 numpy bits as an int64 tensor."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))


def u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


@pytest.fixture(scope="module", params=["random", "repeat25"])
def built(request):
    rng = np.random.default_rng(5)
    codes = make_codes(request.param, rng, 40_000)
    genome = padded_genome(codes)
    arrays = jbuild.build_index(genome, seed_len=20)
    return codes, genome, arrays


def _query_keys(codes, rng, n_reads=48, L=60, seed_len=20):
    """Canonical seed keys of reads sampled from the genome (hits) plus
    random keys (misses), as uint64."""
    starts = rng.integers(0, codes.size - L, n_reads)
    reads = codes[starts[:, None] + np.arange(L)[None, :]]
    fwd, rc, _ = jindex.pack_read_seeds(jnp.asarray(reads), seed_len)
    keys = np.minimum(np.asarray(fwd), np.asarray(rc)).reshape(-1)
    miss = rng.integers(0, 1 << 40, 64, dtype=np.uint64)
    return np.concatenate([keys, miss]).astype(np.uint64)


def test_build_index_matches(built):
    codes, genome, arrays = built
    mine = tbuild.build_index(port_genome(genome), seed_len=20)
    assert mine["max_probe"] == arrays["max_probe"]
    assert mine["seed_len"] == arrays["seed_len"]
    np.testing.assert_array_equal(mine["table"], np.asarray(arrays["table"]))
    np.testing.assert_array_equal(mine["hits"], np.asarray(arrays["hits"]))


def test_murmur_finalize64_matches():
    rng = np.random.default_rng(3)
    k = rng.integers(0, np.iinfo(np.uint64).max, 4096, dtype=np.uint64, endpoint=True)
    k[:4] = [0, 1, (1 << 63), np.iinfo(np.uint64).max]
    ref = np.asarray(jindex.murmur_finalize64(jnp.asarray(k)))
    np.testing.assert_array_equal(u64(tindex.murmur_finalize64(i64(k))), ref)


@pytest.mark.parametrize("extra_span", [0, 2])
def test_probe_and_gather_hits_match(built, extra_span):
    """Probe at the index's own span, and at a wider one (span >= 3
    takes snap_tpu's double-bucket gather path); then gather the hit
    lists at two caps."""
    codes, genome, arrays = built
    span = arrays["max_probe"] + extra_span
    jd = jindex.make_device_index(arrays, genome.bases)
    td = tindex.make_device_index(arrays, genome.bases, device="cpu")
    for name in ("table", "hits", "genome_packed", "genome_bad16"):
        a = np.asarray(getattr(jd, name))
        b = getattr(td, name).numpy()
        np.testing.assert_array_equal(b.view(a.dtype), a, err_msg=name)
    np.testing.assert_array_equal(td.genome.numpy(), np.asarray(jd.genome))

    keys = _query_keys(codes, np.random.default_rng(9))
    jf, js, jn0, jn1 = (np.asarray(x) for x in jindex.probe(jd, jnp.asarray(keys), span))
    tf, ts, tn0, tn1 = (x.numpy() for x in tindex.probe(td, i64(keys), span))
    assert jf.sum() > keys.size // 2  # most sampled seeds are found
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tn0, jn0)
    np.testing.assert_array_equal(tn1, jn1)

    count = np.where(jf, jn0 + jn1, 0).astype(np.int32)
    for cap in (8, 32):
        jl, jv = jindex.gather_hits(jd.hits, jnp.asarray(js), jnp.asarray(count), cap)
        tl, tv = tindex.gather_hits(td.hits, torch.from_numpy(ts), torch.from_numpy(count), cap)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl).astype(np.int64))


def test_high_load_index_spans_three_buckets():
    """A table filled near capacity needs a bucket span of 3 or more:
    every genome seed must still be found, identically in both."""
    rng = np.random.default_rng(21)
    codes = make_codes("repeat25", rng, 20_000)
    genome = padded_genome(codes)
    arrays = jbuild.build_index(genome, seed_len=16, load_factor=0.97)
    assert arrays["max_probe"] >= 3
    jd = jindex.make_device_index(arrays, genome.bases)
    td = tindex.make_device_index(arrays, genome.bases, device="cpu")
    keys = _query_keys(codes, rng, n_reads=64, L=40, seed_len=16)
    span = arrays["max_probe"]
    ref = [np.asarray(x) for x in jindex.probe(jd, jnp.asarray(keys), span)]
    got = [x.numpy() for x in tindex.probe(td, i64(keys), span)]
    assert ref[0][: keys.size - 64].all()
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b, a)


def test_pack_read_seeds_match():
    rng = np.random.default_rng(4)
    bases = rng.integers(0, 4, (12, 50)).astype(np.uint8)
    bases[rng.random(bases.shape) < 0.03] = 4  # N breaks seeds
    for seed_len in (16, 20, 24):
        jf, jr, jv = (np.asarray(x) for x in jindex.pack_read_seeds(jnp.asarray(bases), seed_len))
        tf, tr, tv = tindex.pack_read_seeds(torch.from_numpy(bases), seed_len)
        np.testing.assert_array_equal(u64(tf), jf)
        np.testing.assert_array_equal(u64(tr), jr)
        np.testing.assert_array_equal(tv.numpy(), jv)


def test_saved_index_loads_in_the_other_package(built, tmp_path):
    codes, genome, arrays = built
    jidx = jindex.GenomeIndex(genome, arrays)
    jidx.save(str(tmp_path / "from_jax"))
    tidx = tindex.GenomeIndex.load(str(tmp_path / "from_jax"), device="cpu")
    assert tidx.seed_len == jidx.seed_len and tidx.max_probe == jidx.max_probe
    np.testing.assert_array_equal(tidx.device.table.numpy().view(np.uint32), np.asarray(arrays["table"]))
    np.testing.assert_array_equal(tidx.genome_meta.bases, np.asarray(genome.bases))

    tidx.save(str(tmp_path / "from_torch"))
    back = jindex.GenomeIndex.load(str(tmp_path / "from_torch"))
    assert back.max_probe == jidx.max_probe
    np.testing.assert_array_equal(np.asarray(back.device.table), np.asarray(jidx.device.table))
    np.testing.assert_array_equal(np.asarray(back.device.hits), np.asarray(jidx.device.hits))
    assert [c.name for c in back.genome_meta.contigs] == ["c1"]
