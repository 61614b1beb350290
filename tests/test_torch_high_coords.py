"""snap_tpu_torch against snap_tpu at genome locations past 2^31.

The port keeps uint32 locations as int32 bit patterns or in int64 and
widens them with & 0xFFFFFFFF; a missed widening shows only at locations
of 2^31 and above (GRCh38's chr13 from 70.4 Mbp on, chr14-chrM). These
twins feed both packages synthetic inputs at such locations, made from a
numpy seed, without a genome of that length (tools/parity_at_scale.py
--layout hg38 and chip_smoke.py's hg38 phase run the whole path at
GRCh38's coordinates). Every comparison is exact: integer fields equal,
float fields equal bit for bit, and each test also holds the port to the
location it was built to find.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import snap_tpu.align.intersect_device as JD
import snap_tpu.align.pipeline as JP
import snap_tpu.index.build as jbuild
import snap_tpu.index.index as jindex
import snap_tpu_torch.align.intersect_device as TD
import snap_tpu_torch.align.pipeline as TP
import snap_tpu_torch.index.build as tbuild
import snap_tpu_torch.index.index as tindex
from test_torch_intersect_device import assert_same_pcd

torch.set_num_threads(1)

TWO31 = 1 << 31
SEED_LEN = 20
SMALL_GENOME = np.full(1024, 4, np.uint8)  # probe and gather never read it


def high_index(keys, orient, locs):
    """snap_tpu's v3 arrays for synthetic (key, orientation, location)
    triples, the port's assemble_table held to them, and both packages'
    device indexes (the port's on the CPU)."""
    locs_s, uk, start, n0, n1 = jbuild._dedup_sorted_triples(keys, orient, locs)
    arrays = jbuild.assemble_table(locs_s, uk, start, n0, n1)
    mine = tbuild.assemble_table(*tbuild._dedup_sorted_triples(keys, orient, locs))
    np.testing.assert_array_equal(mine["table"], arrays["table"])
    np.testing.assert_array_equal(mine["hits"], arrays["hits"])
    assert mine["max_probe"] == arrays["max_probe"]
    return (arrays, jindex.make_device_index(arrays, SMALL_GENOME),
            tindex.make_device_index(arrays, SMALL_GENOME, device="cpu"))


def test_pack_unpack_high_locations():
    """pack_winners -> HostWinners with end_loc / body_loc drawn up to
    2^32 (the twin of tests/test_winner_packing.py::test_pack_unpack_bit_exact):
    the port's packed words equal snap_tpu's, and HostWinners gives the
    locations back."""
    rng = np.random.default_rng(7)
    B = 257
    locs = rng.integers(TWO31 - 4096, 1 << 32, (2, B), dtype=np.int64)
    locs[:, :4] = [[TWO31 - 1, TWO31, (1 << 32) - 1, 0]] * 2
    vals = dict(
        found=rng.integers(0, 2, B).astype(bool),
        fallback=rng.integers(0, 2, B).astype(bool),
        cand_k=rng.integers(0, 512, B).astype(np.int32),
        direction=rng.integers(0, 2, B).astype(np.uint8),
        dist=rng.integers(-1, 300, B).astype(np.int16),
        mapq=rng.integers(0, 71, B).astype(np.uint8),
        clip_before=rng.integers(0, 30000, B).astype(np.int16),
        clip_after=rng.integers(0, 30000, B).astype(np.int16),
        escalated=rng.integers(0, 2, B).astype(bool),
        indels=rng.integers(0, 128, B).astype(np.int32),
        len_eff=rng.integers(0, 30000, B).astype(np.int16),
        popular=rng.integers(0, 64, B).astype(np.int16),
        valid_count=rng.integers(0, 1024, B).astype(np.int16),
        esc_count=rng.integers(0, 1024, B).astype(np.int16),
        truncated=rng.integers(0, 2, B).astype(bool),
        edge_indel=rng.integers(0, 2, B).astype(bool),
        ag_flip=rng.integers(0, 2, B).astype(bool),
    )
    for overflow in (False, True):
        ref = np.asarray(JP.pack_winners(JP.WinnerOut(
            **{k: jnp.asarray(v) for k, v in vals.items()},
            end_loc=jnp.asarray(locs[0].astype(np.uint32)),
            body_loc=jnp.asarray(locs[1].astype(np.uint32)),
            dp_overflow=jnp.asarray(overflow),
        )))
        got = TP.pack_winners(TP.WinnerOut(
            **{k: torch.from_numpy(v) for k, v in vals.items()},
            end_loc=torch.from_numpy(locs[0]), body_loc=torch.from_numpy(locs[1]),
            dp_overflow=torch.tensor(overflow),
        )).numpy()
        np.testing.assert_array_equal(got, ref)
        w = TP.HostWinners(got)
        np.testing.assert_array_equal(w.end_loc, locs[0])
        np.testing.assert_array_equal(w.body_loc, locs[1])
        assert w.dp_overflow == overflow


def test_probe_and_gather_high_hits():
    """probe and gather_hits on a table whose hit lists hold locations in
    [2^31, 2^32): the same starts, counts and locations in both packages,
    and each list is the key's locations in descending order."""
    rng = np.random.default_rng(11)
    n_keys = 300
    keys = np.unique(rng.integers(0, 1 << (2 * SEED_LEN), n_keys, dtype=np.uint64))
    per = rng.integers(1, 12, keys.size)
    tk = np.repeat(keys, per)
    orient = rng.integers(0, 2, tk.size).astype(bool)
    locs = rng.integers(TWO31, 1 << 32, tk.size, dtype=np.int64).astype(np.uint32)
    locs[:4] = [TWO31, TWO31 + 1, (1 << 32) - 1, (1 << 32) - 2]
    arrays, jd, td = high_index(tk, orient, locs)
    miss = rng.integers(1 << 41, 1 << 42, 64, dtype=np.uint64)
    q = np.concatenate([keys, miss])
    span = arrays["max_probe"]
    jf, js, jn0, jn1 = (np.asarray(x) for x in jindex.probe(jd, jnp.asarray(q), span))
    tf, ts, tn0, tn1 = (x.numpy() for x in tindex.probe(td, torch.from_numpy(q.view(np.int64)), span))
    for a, b in ((tf, jf), (ts, js), (tn0, jn0), (tn1, jn1)):
        np.testing.assert_array_equal(a, b)
    assert tf[: keys.size].all() and not tf[keys.size :].any()

    count = np.where(tf, tn0 + tn1, 0).astype(np.int32)
    cap = 16  # snap_tpu gathers rows of 8
    jl, jv = jindex.gather_hits(jd.hits, jnp.asarray(js), jnp.asarray(count), cap)
    tl, tv = tindex.gather_hits(td.hits, torch.from_numpy(ts), torch.from_numpy(count), cap)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl).astype(np.int64))
    tl, tv = tl.numpy(), tv.numpy()
    for i, k in enumerate(keys):
        for o, n in ((0, tn0[i]), (1, tn1[i])):
            want = np.sort(locs[(tk == k) & (orient == bool(o))].astype(np.int64))[::-1]
            got = tl[i, tn0[i] * o : tn0[i] * o + n]
            np.testing.assert_array_equal(got, want)
        assert (tl[i][tv[i]] >= TWO31).all()


def synthetic_scored(rng, B: int, K: int):
    """A SingleAlignOut's fields (numpy) whose candidates lie within a
    few 48 bp bins of 2^31, with ties in distance and log-probability
    inside bins and across them; row 0 is the hand case of
    test_finalize_high_locations."""
    base = TWO31 + rng.integers(-200, 200, B)
    steps = np.array([-97, -49, -48, -47, -2, -1, 0, 1, 2, 47, 48, 49, 96, 500])
    cand = base[:, None] + rng.choice(steps, (B, K))
    cand[:, -1] = rng.integers(0, 1 << 32, B)  # one anywhere in [0, 2^32)
    dist = rng.choice([0, 1, 1, 2, 3, 5], (B, K)).astype(np.int32)
    lp_levels = np.array([-0.5, -1.25, -3.0, -7.5], np.float32)
    f = dict(
        dist=dist, lv_dist=dist.copy(),
        indels=rng.choice([0, 0, 1, 2], (B, K)).astype(np.int32),
        log_prob=rng.choice(lp_levels, (B, K)).astype(np.float32),
        ag_score=(100 - 3 * dist).astype(np.int32),
        end_loc=(cand + 100 + rng.integers(-2, 3, (B, K))).astype(np.int64),
        body_loc=(cand + rng.integers(-2, 3, (B, K))).astype(np.int64),
        cand_loc=cand.astype(np.int64),
        escalated=rng.random((B, K)) < 0.2,
        clip_before=np.zeros((B, K), np.int32),
        clip_after=np.zeros((B, K), np.int32),
        seed_off=rng.integers(0, 76, (B, K)).astype(np.int32),
        direction=rng.integers(0, 2, (B, K)).astype(np.int32),
        valid=rng.random((B, K)) < 0.9,
        len_eff=np.full(B, 100, np.int32),
        popular=rng.integers(0, 14, B).astype(np.int32),
        n_lookups=np.full(B, 25, np.int32),
        truncated=rng.random(B) < 0.1,
    )
    # row 0: two forward candidates 20 bp apart across 2^31 share one
    # 48 bp bin (2^31 - 10 and 2^31 + 10 both lie in bin 44,739,242), so
    # the distance-0 one is the bin's only representative: no merge
    # fallback, and it wins with MAPQ 70 against a far candidate
    f["cand_loc"][0, :3] = [TWO31 - 10, TWO31 + 10, 1_000_000]
    f["dist"][0, :3] = f["lv_dist"][0, :3] = [0, 1, 5]
    f["ag_score"][0, :3] = 100 - 3 * f["dist"][0, :3]
    f["log_prob"][0, :3] = [-0.5, -1.25, -30.0]
    f["direction"][0, :3] = 0
    f["valid"][0] = False
    f["valid"][0, :3] = True
    f["end_loc"][0, :3] = f["cand_loc"][0, :3] + 100
    f["popular"][0] = 0
    f["truncated"][0] = False
    return f


@pytest.mark.parametrize("alt_awareness", [False, True])
def test_finalize_high_locations(alt_awareness):
    """_device_finalize's winner selection (the per-row lexsort over
    direction, 48 bp bin, distance, -log_prob and location; the
    merge-distance block; the Ukkonen replay; the ALT split at a first
    ALT location above 2^31) on scored candidates straddling 2^31: every
    WinnerOut field and the replay's running bests equal snap_tpu's."""
    rng = np.random.default_rng(23)
    B, K = 96, 16
    f = synthetic_scored(rng, B, K)
    fas = TWO31 + 64
    args = (alt_awareness, 4, True)
    jout = JP.SingleAlignOut(**{k: jnp.asarray(v) for k, v in f.items()})
    tout = TP.SingleAlignOut(**{k: torch.from_numpy(v) for k, v in f.items()})
    jw, jra, jrn = JP._device_finalize(jout, jnp.int64(fas), *args, jnp.int32(3), 1024,
                                       return_scores=True)
    tw, tra, trn = TP._device_finalize(tout, torch.tensor(fas), *args, torch.tensor(3), 1024,
                                       return_scores=True)
    for name in JP.WinnerOut._fields:
        ref = np.asarray(getattr(jw, name))
        got = getattr(tw, name).numpy()
        np.testing.assert_array_equal(got.astype(np.int64), ref.astype(np.int64), err_msg=name)
    np.testing.assert_array_equal(tra.numpy(), np.asarray(jra))
    np.testing.assert_array_equal(trn.numpy(), np.asarray(jrn))
    np.testing.assert_array_equal(TP.pack_winners(tw).numpy(), np.asarray(JP.pack_winners(jw)))
    assert tw.found[0] and not tw.fallback[0] and tw.mapq[0] == 70
    assert int(tw.end_loc[0]) == TWO31 - 10 + 100 and int(tw.cand_k[0]) == 0
    assert (tw.end_loc.numpy() >= TWO31 - 1000).mean() > 0.5


def test_intersect_entries_across_2_31():
    """intersect_device's phase-1 entry keys and the intersection's
    outputs for pairs whose ends lie on either side of 2^31: end 1's
    seeds hit forward at X_i + offset, end 2's reverse at its mate start
    Y_i = X_i + insert - L, with X_i within 600 bp of 2^31 (plus noise
    hits in [0, 2^32)). Equal to snap_tpu's bit for bit, and each pair's
    best end-1 candidate is X_i, forward, with every lookup's vote."""
    rng = np.random.default_rng(31)
    B, L, S = 24, 100, 8
    R = 2 * B
    bases = rng.integers(0, 4, (R, L)).astype(np.uint8)
    len_eff = np.full(R, L, np.int32)
    offsets, set_ids = TD.probe_offsets_for(len_eff, L, SEED_LEN, S)
    X = TWO31 + rng.integers(-600, 600, B)
    Y = X + rng.integers(250, 350, B) - L
    keys, orient, locs = [], [], []
    for r in range(R):
        i, mate = r % B, r >= B
        for o in offsets[r][offsets[r] >= 0]:
            seed = bases[r, o : o + SEED_LEN].astype(np.uint64)
            fwd = rc = np.uint64(0)
            for j, b in enumerate(seed):
                fwd = (fwd << np.uint64(2)) | b
                rc |= (np.uint64(3) - b) << np.uint64(2 * j)
            canon_fwd = fwd <= rc
            if mate:  # end 2: a reverse hit normalizing to Y_i
                loc, o_key = Y[i] + L - SEED_LEN - o, not canon_fwd
            else:     # end 1: a forward hit normalizing to X_i
                loc, o_key = X[i] + o, not canon_fwd
            keys += [min(fwd, rc)] * 2
            orient += [o_key, bool(rng.integers(0, 2))]
            locs += [loc, rng.integers(0, 1 << 32)]
    arrays, jd, td = high_index(np.array(keys, np.uint64), np.array(orient),
                                np.array(locs, np.int64).astype(np.uint32))
    geom = dict(seed_len=SEED_LEN, max_probe=arrays["max_probe"], num_seeds=S)
    jp, tp = JD.DeviceIntersectParams(**geom), TD.DeviceIntersectParams(**geom)
    ins = (bases, len_eff, offsets, set_ids)
    jent = JD._phase1_entries(jd, *map(jnp.asarray, ins), jp)
    tent = TD._phase1_entries(td, *map(torch.from_numpy, ins), tp)
    for name, a, b in zip(("e_key", "rec_by_set", "popular", "n_lookups", "over"),
                          jent, tent):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    ref = JD.paired_candidates_device(jd, *map(jnp.asarray, ins), jnp.int64(50),
                                      jnp.int64(1000), jp)
    got = assert_same_pcd(ref, TD.paired_candidates_device(
        td, *map(torch.from_numpy, ins), 50, 1000, tp))
    np.testing.assert_array_equal(got["loc"][:B, 0], X)
    np.testing.assert_array_equal(got["dir"][:B, 0], 0)
    np.testing.assert_array_equal(got["weight"][:B, 0], (offsets[:B] >= 0).sum(axis=1))
    assert (X < TWO31).any() and (Y >= TWO31).any()


@pytest.mark.parametrize("G", [1, 15, 16, 17, 127, 128, 129, 1000, 4099])
def test_chunked_packing_matches_snap_tpu(monkeypatch, G):
    """The port packs the genome PACK_CHUNK bases at a time (a 3.1 Gbp
    genome in whole-genome uint32 temporaries would take ~28 GB of host
    memory): at a chunk of 64 bases, so that genomes of every remainder
    span several chunks, its packed and bad words equal snap_tpu's
    whole-genome packing."""
    monkeypatch.setattr(tindex, "PACK_CHUNK", 64)
    g = np.random.default_rng(G).integers(0, 6, G).astype(np.uint8)
    ref_packed, _ = jindex.pack_genome_words(g)
    packed = tindex.pack_genome_words(g)
    np.testing.assert_array_equal(packed, ref_packed)
    np.testing.assert_array_equal(tindex.pack_bad16(g, packed.shape[0]),
                                  jindex.pack_bad16(g, ref_packed.shape[0]))


@pytest.mark.parametrize("G", [640, 1000, 4099])
def test_chunked_packing_skips_n_chunks(monkeypatch, G):
    """Chunks with no ACGT base (N and padding throughout: most of a
    genome laid out at GRCh38's coordinates) are not packed, and the
    words still equal snap_tpu's whole-genome packing: sequenced runs
    that fill a chunk, cross a chunk's edge or end the genome, between
    chunks of N (4) and padding (5) alone."""
    monkeypatch.setattr(tindex, "PACK_CHUNK", 64)
    rng = np.random.default_rng(G)
    g = rng.integers(4, 6, G).astype(np.uint8)
    for s, n in ((64, 64), (300, 40), (G - 30, 30)):
        g[s : s + n] = rng.integers(0, 4, n)
    packed_chunks = []
    pack = tindex._pack_chunked

    def counted(bases, out, values, fill):
        def v(c):
            packed_chunks.append(c.shape[0])
            return values(c)
        return pack(bases, out, v, fill)

    monkeypatch.setattr(tindex, "_pack_chunked", counted)
    ref_packed, _ = jindex.pack_genome_words(g)
    packed = tindex.pack_genome_words(g)
    np.testing.assert_array_equal(packed, ref_packed)
    np.testing.assert_array_equal(tindex.pack_bad16(g, packed.shape[0]),
                                  jindex.pack_bad16(g, ref_packed.shape[0]))
    with_bases = sum(bool((g[lo : lo + 64] < 4).any()) for lo in range(0, G, 64))
    assert len(packed_chunks) == 2 * with_bases < 2 * (-(-G // 64))


def test_seed_scan_skips_n_chunks():
    """extract_canonical_seeds skips the chunks whose seeds touch no ACGT
    base (most of a layout sequenced in windows) and gives snap_tpu's
    triples: a genome of N stretches and short sequenced runs, scanned in
    chunks of 64 positions, some all N, some holding a run's edge."""
    from snap_tpu.genome import Genome as JGenome
    from snap_tpu_torch.genome import Genome as TGenome

    rng = np.random.default_rng(5)
    g = np.full(6000, 4, np.uint8)
    for s, n in ((0, 40), (700, 300), (2047, 100), (5900, 100)):
        g[s : s + n] = rng.integers(0, 4, n)
    g[2100] = 4
    ref = jbuild.extract_canonical_seeds(JGenome(bases=g), SEED_LEN, chunk=64)
    got = tbuild.extract_canonical_seeds(TGenome(bases=g), SEED_LEN, chunk=64)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert not tbuild.has_bases(g, 64, 128, SEED_LEN)
    assert tbuild.has_bases(g, 640, 704, SEED_LEN)


def test_mesh_placement_kept_for_the_same_mesh():
    """GenomeIndex.to_mesh places the genome and the shards once for a
    given mesh: the CLI calls it on the cached index in every -ishards
    run, and each placement of a 3.1 Gbp genome packs it anew. Another
    shard count places anew."""
    from snap_tpu_torch.genome import Genome as TGenome
    from snap_tpu_torch.index.index import GenomeIndex
    from snap_tpu_torch.parallel import mesh as TM

    rng = np.random.default_rng(9)
    g = np.full(4096, 5, np.uint8)
    g[2000:3000] = rng.integers(0, 4, 1000)
    idx = GenomeIndex.build(TGenome(bases=g), SEED_LEN, device="cpu")
    cpu = [torch.device("cpu")] * 2
    first = idx.to_mesh(TM.make_mesh(1, 2, cpu), 2).device_sharded
    assert idx.to_mesh(TM.make_mesh(1, 2, cpu), 2).device_sharded is first
    assert idx.to_mesh(TM.make_mesh(2, 1, cpu), 1).device_sharded is not first
