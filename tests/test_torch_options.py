"""The non-fast single paths and the alignment options: twins of
tests/test_filters_secondary.py, test_disable_opts.py and
test_ag_penalties.py, and a -dp run.

The CLI cases run `single` in both packages on one genome with a
400 bp segment duplicated (test_filters_secondary.py's, with a third
copy on a second contig) and 64 reads of every kind, under each option
set, and hold the SAM files equal byte for byte. -om and -dp take the
two-phase path from the first batch (SingleEndAligner.branches names it
`non_fast`; -ea is tests/test_torch_alt.py's); -F, -= and -nu/-nt run
the fast path. The -g penalties are held to snap_tpu in the affine
extension itself. Both packages run as tests/test_torch_single.py runs
them.
"""

import numpy as np
import pytest
import torch

from snap_tpu_torch.align.cigar import OP_D, OP_I, OP_M, ops_to_cigar
from snap_tpu_torch.align.post import collect_secondary_results
from snap_tpu_torch.options import (
    FILTER_PRESETS,
    FILTER_SINGLE_HIT,
    FILTER_TOO_SHORT,
    FILTER_UNALIGNED,
    pass_filter,
)
from test_torch_cli_cuda import DEC
from test_torch_pipeline import same_logq  # noqa: F401
from test_torch_single import run_jax, run_torch

torch.set_num_threads(1)

N_READS = 64
INDEX = ["index", "g.fa", "idx", "-s", "20"]


def test_pass_filter_semantics():
    """test_filters_secondary.py's cases, and every (flags, status,
    secondary) against snap_tpu's pass_filter."""
    from snap_tpu import options as J

    fa, fs, fu = FILTER_PRESETS["a"], FILTER_PRESETS["s"], FILTER_PRESETS["u"]
    assert pass_filter(0, "notfound")
    assert pass_filter(fa, "single") and pass_filter(fa, "multi")
    assert not pass_filter(fa, "notfound") and pass_filter(fa, "filtered")
    assert pass_filter(fs, "single") and not pass_filter(fs, "multi")
    assert pass_filter(fs, "multi", secondary=True)
    assert not pass_filter(fu, "single") and pass_filter(fu, "notfound")
    assert pass_filter(FILTER_UNALIGNED | FILTER_SINGLE_HIT, "single")
    assert not pass_filter(FILTER_TOO_SHORT, "single")
    assert pass_filter(FILTER_TOO_SHORT, "filtered")
    assert FILTER_PRESETS == J.FILTER_PRESETS
    for flags in range(64):
        for status in ("single", "multi", "notfound", "filtered"):
            for sec in (False, True):
                assert pass_filter(flags, status, secondary=sec) == J.pass_filter(
                    flags, status, secondary=sec), (flags, status, sec)


def test_collect_secondary_results_matches():
    """test_filters_secondary.py's candidates under -om 1 and 3, -omax 1
    and ALT flags: the same secondaries as snap_tpu's."""
    from snap_tpu.align.post import collect_secondary_results as jcollect

    dist = np.array([1, 2, 5, 3], dtype=np.int32)
    logp = np.array([-1.0, -2.0, -9.0, -3.0], dtype=np.float32)
    ag = np.array([90, 85, 40, 80], dtype=np.int32)
    end = np.array([1000, 5000, 9000, 13000], dtype=np.int64)
    args = (dist, logp, ag, end, end - 100, np.zeros(4, np.int32), np.ones(4, bool), 0, 1, 27)
    is_alt = np.array([False, True, False, False])
    cases = [((1,), {}), ((3,), {}), ((3,), {"max_secondary": 1}), ((3,), {"is_alt": is_alt})]
    for extra, kw in cases:
        got = collect_secondary_results(*args, *extra, **kw)
        ref = jcollect(*args, *extra, **kw)
        assert [vars(s) for s in got] == [vars(s) for s in ref], (extra, kw)
    assert [s.dist for s in collect_secondary_results(*args, 1)] == [2]
    secs = collect_secondary_results(*args, 3, is_alt=is_alt)
    assert secs[0].supplementary and not secs[1].supplementary


def test_eq_x_cigar_style():
    pattern = np.array([0, 1, 2, 3, 0, 1], dtype=np.uint8)
    text = np.array([0, 1, 3, 3, 0, 1], dtype=np.uint8)
    ops = np.array([OP_M] * 6, dtype=np.int8)
    assert ops_to_cigar(ops, use_m=True) == "6M"
    assert ops_to_cigar(ops, use_m=False, pattern=pattern, text=text) == "2=1X3="
    ops2 = np.array([OP_M, OP_M, OP_I, OP_M, OP_M, OP_M], dtype=np.int8)
    text2 = np.array([0, 1, 3, 0, 1], dtype=np.uint8)
    assert ops_to_cigar(ops2, use_m=False, pattern=pattern, text=text2) == "2=1I3="
    assert ops_to_cigar(ops2, front_clip=2, back_clip=1) == "2S2M1I3M1S"
    ops3 = np.array([OP_M, OP_M, OP_D, OP_M], dtype=np.int8)
    assert ops_to_cigar(ops3) == "2M1D1M"


def _case():
    rng = np.random.default_rng(5)
    N, L, T = 8, 60, 80
    text = rng.integers(0, 4, size=(N, T)).astype(np.uint8)
    pattern = text[:, :L].copy()
    for i in range(N):
        for _ in range(3):
            pattern[i, rng.integers(0, L)] = rng.integers(0, 4)
    logq = np.full((N, L), -4.0, np.float32)
    plen = np.full(N, L, np.int32)
    tlen = np.full(N, T, np.int32)
    return pattern, logq, plen, text, tlen, plen.copy(), np.full(N, 7, np.int32)


@pytest.mark.parametrize("pen", [{}, {"sub": 8}, dict(match=2, sub=6, gap_open=5, gap_extend=2)])
def test_affine_penalties_match(pen):
    """test_ag_penalties.py: the port's affine extension with the -g
    penalties equals snap_tpu's in every field; a harsher mismatch
    lowers scores."""
    import jax.numpy as jnp

    from snap_tpu.ops.affine import affine_extend
    from snap_tpu_torch.ops.affine import affine_extend_plain

    case = _case()
    ref = affine_extend(*(jnp.asarray(a) for a in case), **pen)
    got = affine_extend_plain(*(torch.from_numpy(a) for a in case), **pen)
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), f)
    if pen == {"sub": 8}:
        base = affine_extend_plain(*(torch.from_numpy(a) for a in case))
        assert (got.score <= base.score).all() and (got.score < base.score).any()


def test_max_k_same_derived_from_penalties():
    from snap_tpu_torch.align.pipeline import AlignParams

    assert AlignParams().max_k_same == 2
    assert AlignParams(ag_open=12, ag_sub=5, ag_extend=1).max_k_same == 3


def write_dup_inputs(d):
    """g.fa: chr1 holds a 400 bp segment twice, chr2 a third copy with
    1% substitutions; r.fq: reads from the segment, from unique
    sequence (substitutions, 1-3 bp indels), junk and a short read,
    every other one reverse complemented."""
    rng = np.random.default_rng(11)
    rand = lambda n: rng.integers(0, 4, size=n).astype(np.uint8)
    seg = rand(400)
    seg3 = np.where(rng.random(400) < 0.01, rand(400), seg)
    chr1 = np.concatenate([rand(1200), seg, rand(1200), seg, rand(1200)])
    chr2 = np.concatenate([rand(1500), seg3, rand(1500)])
    with open(d / "g.fa", "wb") as f:
        for name, c in ((b"chr1", chr1), (b"chr2", chr2)):
            f.write(b">%s\n%s\n" % (name, DEC[c].tobytes()))
    genome = np.concatenate([chr1, chr2])
    with open(d / "r.fq", "wb") as f:
        for i in range(N_READS):
            kind = i % 8
            if kind in (0, 1):
                s = int(rng.integers(0, 300))
                r = seg[s : s + 100].copy()
            elif kind == 6:
                r = rand(100)
            else:
                s = int(rng.integers(0, genome.size - 120))
                r = genome[s : s + 108].copy()
                p = int(rng.integers(20, 80))
                if kind == 3:
                    r = np.delete(r, slice(p, p + int(rng.integers(1, 4))))
                elif kind == 4:
                    r = np.insert(r, p, rand(int(rng.integers(1, 4))))
                r = r[:100]
                m = rng.random(100) < 0.03
                r = np.where(m, rand(100), r)
            if kind == 7:
                r = r[:40]
            if i % 2:
                r = (3 - r)[::-1]
            q = rng.choice(np.frombuffer(b"#+5?II", np.uint8), len(r))
            f.write(b"@q%d_%d\n%s\n+\n%s\n" % (i, kind, DEC[r].tobytes(), q.tobytes()))


@pytest.fixture(scope="module")
def dup_dirs(same_logq, tmp_path_factory):
    dirs = {}
    for side, run in (("jax", run_jax), ("torch", run_torch)):
        d = tmp_path_factory.mktemp(f"opts_{side}")
        write_dup_inputs(d)
        run(d, INDEX)
        dirs[side] = d
    return dirs


OPTION_SETS = {
    "filter_secondary": ["-F", "a", "-om", "2", "-omax", "10"],
    "eq_x": ["-="],
    "om_omax_mpc": ["-om", "3", "-omax", "2", "-mpc", "1"],
    "dp": ["-dp", "0.1"],
    "nu_nt": ["-nu", "-nt"],
    "filter_single": ["-F", "s", "-E", "u"],
}
NON_FAST = {"filter_secondary", "om_omax_mpc", "dp"}


def sam_body(sam: bytes) -> list[bytes]:
    return [ln for ln in sam.split(b"\n") if ln and not ln.startswith(b"@")]


@pytest.mark.parametrize("name", sorted(OPTION_SETS))
def test_cli_options_match(dup_dirs, name):
    """`single` with each option set: the same SAM bytes in both
    packages; the non-fast option sets take the two-phase path."""
    argv = ["single", "idx", "r.fq", "-o", f"{name}.sam", "-b", "32", *OPTION_SETS[name]]
    run_jax(dup_dirs["jax"], argv)
    br = run_torch(dup_dirs["torch"], argv)
    ref = (dup_dirs["jax"] / f"{name}.sam").read_bytes()
    got = (dup_dirs["torch"] / f"{name}.sam").read_bytes()
    if got != ref:
        diff = [(a, b) for a, b in zip(sam_body(ref), sam_body(got)) if a != b]
        pytest.fail(f"{len(diff)} records differ, first: {diff[:2]}")
    assert (br.get("non_fast") == N_READS) == (name in NON_FAST), br
    recs = [ln.split(b"\t") for ln in sam_body(got)]
    if name == "filter_secondary":
        # -F a drops the junk reads; the segment reads get a secondary
        assert not any(r[0].endswith(b"_6") for r in recs)
        seg = [r for r in recs if r[0] == b"q0_0"]
        assert len(seg) >= 2 and any(int(r[1]) & 0x100 for r in seg)
    if name == "eq_x":
        assert any(b"=" in r[5] for r in recs) and not any(b"M" in r[5] for r in recs)
    if name == "om_omax_mpc":
        sec = [r for r in recs if int(r[1]) & 0x100]
        assert sec and max(sum(1 for s in sec if s[0] == q) for q in {s[0] for s in sec}) <= 2


def test_nu_nt_match_defaults(dup_dirs):
    """test_disable_opts.py: on the port, -nu -nt change no record of
    the default run for reads with substitutions only, from sequence
    that occurs once (kinds 2 and 5): the optimizations they turn off
    only skip work that cannot alter those."""
    argv = ["single", "idx", "r.fq", "-o", "default.sam", "-b", "32"]
    run_torch(dup_dirs["torch"], argv)
    nu = dup_dirs["torch"] / "nu_nt.sam"
    if not nu.exists():
        run_torch(dup_dirs["torch"], argv[:4] + ["nu_nt.sam", "-b", "32", "-nu", "-nt"])
    unique = lambda sam: [ln for ln in sam_body(sam.read_bytes())
                          if ln.split(b"\t")[0].endswith((b"_2", b"_5"))]
    got = unique(nu)
    assert len(got) == N_READS // 4
    assert unique(dup_dirs["torch"] / "default.sam") == got
