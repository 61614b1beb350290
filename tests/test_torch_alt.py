"""ALT-contig awareness in the port: twin of tests/test_alt.py.

- align_single_device (the monolithic call: candidates, then both
  scoring tiers on every candidate) equals snap_tpu's bit for bit in
  every field of SingleAlignOut, on test_alt.py's genome (chr1 and an
  ALT contig duplicating a window of it) and reads from inside and
  outside the window;
- finalize_read on those candidates gives snap_tpu's answers with ALT
  awareness, with -ea (the ALT copy as a supplementary record) and
  without awareness (-A-);
- the ALT classification, .alt liftover parsing and projection;
- `single -ea` through the CLI: the same SAM bytes in both packages,
  supplementary records included.
"""

import numpy as np
import pytest
import torch

from snap_tpu_torch.align import pipeline as TP
from snap_tpu_torch.align.post import finalize_read
from snap_tpu_torch.constants import PAD
from snap_tpu_torch.genome import Contig, Genome, load_fasta, parse_alt_file
from snap_tpu_torch.index.index import GenomeIndex
from test_torch_pipeline import same_logq  # noqa: F401
from test_torch_single import run_jax, run_torch

torch.set_num_threads(1)

ENC = {"A": 0, "C": 1, "G": 2, "T": 3}


def _write_fasta(path, contigs: dict[str, str]) -> str:
    with open(path, "w") as f:
        for name, seq in contigs.items():
            f.write(f">{name}\n{seq}\n")
    return str(path)


def _random_seq(rng, n: int) -> str:
    return "".join("ACGT"[c] for c in rng.integers(0, 4, size=n))


@pytest.fixture(scope="module")
def alt_case(same_logq, tmp_path_factory):
    """test_alt.py's genome in both packages, and 8 reads: inside the
    duplicated window (forward, reverse, with substitutions), outside
    it, and across its edge."""
    from snap_tpu.genome import load_fasta as jload
    from snap_tpu.index.index import GenomeIndex as JIndex

    rng = np.random.default_rng(7)
    chr1 = _random_seq(rng, 6000)
    tmp = tmp_path_factory.mktemp("altg")
    fa = _write_fasta(tmp / "g.fa", {"chr1": chr1, "chr1_x_alt": chr1[2000:3500]})
    genome = load_fasta(fa, chromosome_padding=2000)
    idx = GenomeIndex.build(genome, seed_len=20, device="cpu")
    jidx = JIndex.build(jload(fa, chromosome_padding=2000), seed_len=20)
    starts = [2400, 2100, 3000, 500, 4800, 1950, 3450, 2700]
    L = 100
    bases = np.full((8, L), 4, np.uint8)
    for i, s in enumerate(starts):
        r = np.array([ENC[c] for c in chr1[s : s + L]], np.uint8)
        if i == 2:
            r[[10, 50, 90]] = (r[[10, 50, 90]] + 1) % 4
        if i % 2:
            r = (3 - r)[::-1]
        bases[i] = r
    quals = np.full((8, L), ord("I"), np.uint8)
    quals[:, ::7] = ord("+")
    lens = np.full(8, L, np.int32)
    return genome, idx, jidx, chr1, (bases, quals, lens)


def _params(idx):
    return TP.AlignParams(seed_len=idx.seed_len, max_probe=idx.max_probe,
                          num_seeds=14, hit_cap=8, max_cand=16)


def test_alt_classification_and_reorder(alt_case):
    genome = alt_case[0]
    assert [c.name for c in genome.contigs] == ["chr1", "chr1_x_alt"]
    assert not genome.contigs[0].is_alt and genome.contigs[1].is_alt
    fas = genome.first_alt_start()
    assert fas == genome.contigs[1].start
    assert genome.is_location_alt(fas) and not genome.is_location_alt(fas - 1)


def test_align_single_device_matches(alt_case):
    """Every field of SingleAlignOut, bit for bit."""
    import jax.numpy as jnp
    from snap_tpu.align import pipeline as JP

    _, idx, jidx, _, (bases, quals, lens) = alt_case
    got = TP.align_single_device(
        idx.device, torch.from_numpy(bases), torch.from_numpy(quals),
        torch.from_numpy(lens), _params(idx),
    )
    ref = JP.align_single_device(
        jidx.device, jnp.asarray(bases), jnp.asarray(quals), jnp.asarray(lens),
        JP.AlignParams(seed_len=jidx.seed_len, max_probe=jidx.max_probe,
                       num_seeds=14, hit_cap=8, max_cand=16),
    )
    assert got._fields == ref._fields
    for f in ref._fields:
        g, r = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        assert g.dtype == r.dtype, f
        np.testing.assert_array_equal(g.view(np.uint8), r.view(np.uint8), f)
    assert bool(got.valid[0].any())


def _finalize_both(alt_case, row, **kw):
    from snap_tpu.align.post import finalize_read as jfinalize

    genome, idx, _, _, (bases, quals, lens) = alt_case
    out = TP.align_single_device(
        idx.device, torch.from_numpy(bases), torch.from_numpy(quals),
        torch.from_numpy(lens), _params(idx),
    )
    c = {f: getattr(out, f)[row].numpy() for f in (
        "dist", "log_prob", "ag_score", "end_loc", "cand_loc", "direction", "valid")}
    popular = int(out.popular[row])
    is_alt = c["cand_loc"] >= genome.first_alt_start()
    args = (c["dist"], c["log_prob"], c["ag_score"], c["end_loc"], c["cand_loc"],
            c["direction"], c["valid"], popular)
    return finalize_read(*args, is_alt=is_alt, **kw), jfinalize(*args, is_alt=is_alt, **kw)


@pytest.mark.parametrize("mode", ["aware", "emit_alt", "unaware"])
def test_finalize_alt_modes(alt_case, mode):
    """test_alt.py's three modes on the duplicated-window read: the
    port's finalize_read equals snap_tpu's, and behaves as test_alt.py
    asserts."""
    kw = {"aware": dict(alt_awareness=True, emit_alt=False),
          "emit_alt": dict(alt_awareness=True, emit_alt=True),
          "unaware": dict(alt_awareness=False)}[mode]
    (ra, supp), (jra, jsupp) = _finalize_both(alt_case, 0, **kw)
    assert vars(ra) == vars(jra)
    assert (supp is None) == (jsupp is None)
    if supp is not None:
        assert vars(supp) == vars(jsupp)
    fas = alt_case[0].first_alt_start()
    if mode == "aware":
        assert ra.end_loc < fas and ra.mapq >= 10 and supp is None
    elif mode == "emit_alt":
        assert supp is not None and supp.supplementary and supp.end_loc >= fas
    else:
        assert supp is None and ra.mapq <= 3


def test_parse_alt_file_and_projection(tmp_path):
    alt_file = tmp_path / "ref.alt"
    alt_file.write_text(
        "chr1_x_alt\t0\tchr1\t2001\t60\t1500M\t*\t0\t0\t*\t*\n"
        "chr9_rc_alt\t16\tchr9\t501\t60\t100M\t*\t0\t0\t*\t*\n"
        "unmapped_alt\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*\n"
    )
    lift = parse_alt_file(str(alt_file))
    assert lift["chr1_x_alt"] == ("chr1", 2001, False)
    assert lift["chr9_rc_alt"] == ("chr9", 501, True)
    assert "unmapped_alt" not in lift
    g = Genome(
        bases=np.full(20000, PAD, dtype=np.uint8),
        contigs=[
            Contig(name="chr1", start=1000, length=8000),
            Contig(name="chr1_x_alt", start=11000, length=1500, is_alt=True,
                   proj_name="chr1", proj_offset=2001),
        ],
    )
    assert g.project_location(11000 + 100) == 1000 + 2000 + 100
    assert g.project_location(1500) == 1500


def test_cli_emit_alt_matches(alt_case, tmp_path_factory):
    """`single -ea` (and the same run with -A-) in both packages: the
    same SAM bytes; -ea writes supplementary records at the ALT copy."""
    chr1 = alt_case[3]
    rng = np.random.default_rng(3)
    dirs = {}
    for side in ("jax", "torch"):
        d = tmp_path_factory.mktemp(f"ea_{side}")
        _write_fasta(d / "g.fa", {"chr1": chr1, "chr1_x_alt": chr1[2000:3500]})
        dirs[side] = d
    reads = []
    for i in range(24):
        s = int(rng.integers(1500, 3900))
        r = list(chr1[s : s + 100])
        if i % 3 == 1:
            r[40] = "ACGT"[("ACGT".index(r[40]) + 1) % 4]
        reads.append((f"a{i}_{s}", "".join(r)))
    for d in dirs.values():
        (d / "r.fq").write_text("".join(f"@{n}\n{r}\n+\n{'I' * 100}\n" for n, r in reads))
    index = ["index", "g.fa", "idx", "-s", "20"]
    runs = {"ea": ["-ea"], "no_alt_awareness": ["-A-"]}
    for side, run in (("jax", run_jax), ("torch", run_torch)):
        run(dirs[side], index)
        for name, extra in runs.items():
            br = run(dirs[side], ["single", "idx", "r.fq", "-o", f"{name}.sam", "-b", "32", *extra])
            if side == "torch" and name == "ea":
                assert br.get("non_fast") == 24, br
    for name in runs:
        ref = (dirs["jax"] / f"{name}.sam").read_bytes()
        got = (dirs["torch"] / f"{name}.sam").read_bytes()
        assert got == ref, name
    body = [ln.split("\t") for ln in (dirs["torch"] / "ea.sam").read_text().splitlines()
            if not ln.startswith("@")]
    assert any(int(r[1]) & 0x800 and r[2] == "chr1_x_alt" for r in body)
