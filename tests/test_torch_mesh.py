"""parallel.mesh: snap_tpu_torch's sharded steps on meshes of eight CPU
devices (data x index = 4 x 2, 2 x 4 and 1 x 8) against snap_tpu's on
conftest's eight virtual devices (the twins of tests/test_sharded.py),
and the mesh rules. The same meshes with their rows spread over two
processes are held to these one-process runs by
tools/multiproc_check_torch.py (tests/test_torch_multiproc.py).

Each package reshards the same flat index with its own reshard_index
(the port's copy must give equal arrays, test_torch_chunked_build.py);
both get the same reads and the same ln P(error) table
(test_torch_pipeline's same_logq says why). Integer arrays must be equal and float arrays equal
bit for bit, with one exception stated where it is checked: the
log_prob of escalated (affine-gap) candidates in the per-candidate
output, which XLA's shard_map graph may round once instead of twice in
a fused multiply-add (the packed winners built from them stay
bit-identical).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from snap_tpu.align import intersect_device as JI
from snap_tpu.align import pipeline as J
from snap_tpu.index.build import build_index, reshard_index
from snap_tpu.parallel import mesh as JM
from snap_tpu_torch.align import intersect_device as TI
from snap_tpu_torch.align import pipeline as T
from snap_tpu_torch.index.build import reshard_index as treshard_index
from snap_tpu_torch.index.index import make_device_index as tmake
from snap_tpu_torch.parallel import mesh as TM
from test_torch_index import make_codes, padded_genome
from test_torch_pipeline import assert_same, same_logq, sample_reads  # noqa: F401

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 JAX devices")

B, L = 64, 100
CPU8 = [torch.device("cpu")] * 8
MESHES = ((4, 2), (2, 4), (1, 8))  # (n_data, n_index)


_WORLDS: dict = {}


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def world(same_logq, request):
    return make_world(*request.param)


@pytest.fixture(scope="module")
def world_4x2(same_logq):
    return make_world(4, 2)


def make_world(n_data, n_index):
    """Both packages' index, reads and mesh of one shape, built once."""
    if (n_data, n_index) in _WORLDS:
        return _WORLDS[(n_data, n_index)]
    rng = np.random.default_rng(7)
    codes = make_codes("repeat25", rng, 30_000)
    genome = padded_genome(codes)
    flat = build_index(genome, seed_len=20)
    sharded = reshard_index(flat, n_index)
    tsharded = treshard_index(flat, n_index)
    seqs = sample_reads(codes, np.random.default_rng(11), B)
    quals = np.random.default_rng(3).choice(
        np.array([35, 43, 53, 63, 73], np.uint8), (B, L)
    )
    lens = np.full(B, L, np.int32)
    kw = dict(seed_len=20, max_probe=max(flat["max_probe"], sharded["max_probe"]),
              num_seeds=25, hit_cap=8, max_cand=16)
    jmesh = JM.make_mesh(n_data, n_index)
    tmesh = TM.make_mesh(n_data, n_index, CPU8)
    ds = NamedSharding(jmesh, P("data"))
    _WORLDS[(n_data, n_index)] = {
        "codes": codes, "genome": genome, "flat": flat, "sharded": sharded,
        "np": (seqs, quals, lens),
        "jax": (JM.sharded_device_index(sharded, genome.bases, jmesh),
                *(jax.device_put(jnp.asarray(x), ds) for x in (seqs, quals, lens)),
                J.AlignParams(**kw), jmesh),
        "torch": (TM.sharded_device_index(tsharded, genome.bases, tmesh),
                  *map(torch.from_numpy, (seqs, quals, lens)),
                  T.AlignParams(**kw), tmesh),
        "fas": int(genome.bases.shape[0]), "n_index": n_index,
    }
    return _WORLDS[(n_data, n_index)]


def assert_out_same(jo, to, what):
    """Every field bit for bit, but log_prob of escalated candidates
    within 4 ulps (the module docstring says why)."""
    assert tuple(to._fields) == tuple(jo._fields)
    for f in jo._fields:
        if f != "log_prob":
            assert_same(getattr(jo, f), getattr(to, f), f"{what}.{f}")
    a = np.asarray(jo.log_prob).view(np.int32).astype(np.int64)
    b = to.log_prob.numpy().view(np.int32).astype(np.int64)
    esc = np.asarray(jo.escalated)
    np.testing.assert_array_equal(b[~esc], a[~esc], err_msg=f"{what}.log_prob")
    assert np.abs(b - a)[esc].max(initial=0) <= 4, f"{what}.log_prob (escalated)"


def test_align_single_sharded_matches(world):
    jd, jb, jq, jl, jp, jm = world["jax"]
    td, tb, tq, tl, tp, tm = world["torch"]
    jo = JM.align_single_sharded(jd, jb, jq, jl, jp, jm)
    to = TM.align_single_sharded(td, tb, tq, tl, tp, tm)
    assert tuple(to.dist.shape) == (B, world["n_index"] * tp.max_cand)  # K from every shard
    assert_out_same(jo, to, "align_single_sharded")


def test_align_winners_sharded_matches(world):
    jd, jb, jq, jl, jp, jm = world["jax"]
    td, tb, tq, tl, tp, tm = world["torch"]
    jw, jo = JM.align_winners_sharded(jd, jb, jq, jl, jnp.int64(world["fas"]), jp, jm)
    tw, to = TM.align_winners_sharded(td, tb, tq, tl, world["fas"], tp, tm)
    assert tw.dtype == torch.int32 and tuple(tw.shape) == (B + 1, T.PACK_WORDS)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert_out_same(jo, to, "merged")
    w = T.HostWinners(tw)
    assert not w.dp_overflow and w.found.sum() > 0.9 * B


def test_winners_sharded_match_single_device(world_4x2):
    """The port's mesh step against its own single-device monolithic step:
    the same final alignment of every found read (test_sharded.py's
    check, on the port alone), on the 4 x 2 mesh. With 4 or 8 index
    shards the merged tile holds K candidates from each shard, and one
    read of 64 ends with another alignment or MAPQ than on the flat
    index (K in all); the port's meshes equal snap_tpu's there
    (test_align_winners_sharded_matches), so snap_tpu's differ from its
    flat index alike."""
    world = world_4x2
    td, tb, tq, tl, tp, tm = world["torch"]
    single = tmake(world["flat"], world["genome"].bases, "cpu")
    w1 = T.HostWinners(T.align_winners_device(single, tb, tq, tl, torch.tensor(world["fas"]), tp)[0])
    w8 = T.HostWinners(TM.align_winners_sharded(td, tb, tq, tl, world["fas"], tp, tm)[0])
    np.testing.assert_array_equal(w1.found, w8.found)
    m = w1.found
    for f in ("direction", "dist", "mapq", "end_loc", "clip_before", "clip_after", "popular"):
        np.testing.assert_array_equal(getattr(w1, f)[m], getattr(w8, f)[m], err_msg=f)


def test_dp_overflow_redo_matches(world):
    """A DP tier of 16 rows per data row overflows: both packages raise the
    tail flag, and the redo's sharded tier 1 (align_tier1_sharded) is
    equal, gapless log-probabilities bit for bit."""
    jd, jb, jq, jl, jp, jm = world["jax"]
    td, tb, tq, tl, tp, tm = world["torch"]
    jw, _ = JM.align_winners_sharded(
        jd, jb, jq, jl, jnp.int64(world["fas"]), jp, jm, dp_rows=16
    )
    tw, _ = TM.align_winners_sharded(td, tb, tq, tl, world["fas"], tp, tm, dp_rows=16)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert T.HostWinners(tw).dp_overflow
    jt = JM.align_tier1_sharded(jd, jb, jq, jl, jp, jm)
    tt = TM.align_tier1_sharded(td, tb, tq, tl, tp, tm)
    assert tuple(tt._fields) == tuple(jt._fields)
    for f in jt._fields:
        assert_same(getattr(jt, f), getattr(tt, f), f"tier1.{f}")
    assert tuple(tt.cand_loc.shape) == (B, world["n_index"] * tp.max_cand)


def test_paired_candidates_sharded_matches(world):
    """Device paired intersection (phases 1-2) on the mesh, held against
    snap_tpu's mesh and against the port's single-index intersection."""
    codes, genome = world["codes"], world["genome"]
    rng = np.random.default_rng(23)
    n = 8
    p1 = rng.integers(0, codes.size - 500, size=n)
    ins = rng.integers(250, 450, size=n)
    r1 = codes[p1[:, None] + np.arange(L)[None, :]].copy()
    r2f = codes[(p1 + ins - L)[:, None] + np.arange(L)[None, :]]
    r2 = ((3 - r2f[:, ::-1]) % 4).astype(np.uint8)
    mut = rng.random(r1.shape) < 0.01
    r1 = np.where(mut, rng.integers(0, 4, r1.shape), r1).astype(np.uint8)
    bases = np.concatenate([r1, r2], axis=0)
    len_eff = np.full(2 * n, L, np.int32)
    kw = dict(seed_len=20, max_probe=world["torch"][4].max_probe, num_seeds=8,
              max_cand=8, max_k_indels=40)
    offsets, set_ids = JI.probe_offsets_for(len_eff, L, 20, 8)
    jd, jm = world["jax"][0], world["jax"][5]
    td, tm = world["torch"][0], world["torch"][5]
    halves = lambda a: (a[:n], a[n:])  # noqa: E731
    jargs = [jnp.asarray(h) for a in (bases, len_eff, offsets, set_ids) for h in halves(a)]
    jout = JM.paired_candidates_sharded(
        jd, *jargs, jnp.int64(50), jnp.int64(500), JI.DeviceIntersectParams(**kw), jm
    )
    targs = [torch.from_numpy(np.ascontiguousarray(h))
             for a in (bases, len_eff, offsets, set_ids) for h in halves(a)]
    tout = TM.paired_candidates_sharded(td, *targs, 50, 500, TI.DeviceIntersectParams(**kw), tm)
    single = TI.paired_candidates_device(
        tmake(world["flat"], genome.bases, "cpu"),
        *map(torch.from_numpy, (bases, len_eff, offsets, set_ids)),
        50, 500, TI.DeviceIntersectParams(**kw),
    )
    keys = ("loc", "off", "dir", "valid", "weight", "big_indel", "popular",
            "n_lookups", "overflow")
    assert sorted(tout) == sorted(jout) == sorted(keys)
    for k in keys:
        assert_same(jout[k], tout[k], k)
        assert_same(single[k].numpy(), tout[k], f"single.{k}")
    assert tout["valid"].any()


@pytest.mark.parametrize("n_dev, ishards, b, shape, b_out", [
    (1, 1, 64, None, 64),        # one device, no -ishards: no mesh
    (1, 2, 64, (1, 1), 64),      # -ishards 2 on one device: a 1 x 1 mesh
    (8, 2, 10, (4, 2), 12),      # -b rounds up to a multiple of n_data
    (8, 1, 64, (8, 1), 64),
    (6, 4, 64, (6, 1), 66),      # 6 % 4 != 0: one index shard
])
def test_maybe_mesh_rules(n_dev, ishards, b, shape, b_out):
    from snap_tpu_torch.cli import _maybe_mesh

    opts = {"ishards": ishards, "batch_size": b}
    mesh, n_index = _maybe_mesh(opts, "cpu", [torch.device("cpu")] * n_dev)
    if shape is None:
        assert mesh is None and n_index == 1
    else:
        assert (mesh.shape["data"], mesh.shape["index"]) == shape
        assert n_index == shape[1]
    assert opts["batch_size"] == b_out


def test_maybe_mesh_matches_snap_tpu_on_eight_devices():
    import snap_tpu.cli as jcli
    from snap_tpu_torch.cli import _maybe_mesh

    for ishards, b in ((1, 1000), (2, 1021), (4, 64), (3, 512)):
        jo = {"ishards": ishards, "batch_size": b}
        to = dict(jo)
        jmesh, jn = jcli._maybe_mesh(jo)
        tmesh, tn = _maybe_mesh(to, "cpu", CPU8)
        assert (jn, jo["batch_size"]) == (tn, to["batch_size"])
        assert dict(jmesh.shape) == tmesh.shape


def test_mesh_layout():
    assert TM.default_devices("cpu") == ([torch.device("cpu")], None)
    m = TM.make_mesh(2, 2, CPU8)
    assert m.local_rows == (0, 1) and m.primary == torch.device("cpu")
    assert m.local_cols == {0: (0, 1), 1: (0, 1)} and not m.row_groups
    assert not m.multiprocess
    # a data row may span ranks, but only inside an initialised group
    with pytest.raises(RuntimeError, match="initialised torch.distributed group"):
        TM.make_mesh(2, 2, CPU8[:4], ranks=[0, 1, 0, 1])
    with pytest.raises(ValueError, match="rank grid"):
        TM.Mesh([CPU8[:2]] * 2, ranks=[[0, 0]])
    with pytest.raises(ValueError, match="needs 8 devices"):
        TM.make_mesh(4, 2, CPU8[:4])
