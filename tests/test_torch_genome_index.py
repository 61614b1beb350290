"""Genome loading and seed extraction in snap_tpu_torch against snap_tpu
(the twins of tests/test_genome_index.py's test_load_fasta,
test_alt_reordering and test_extract_canonical_counts; the build, probe
and seed packing are in test_torch_index.py)."""

import numpy as np
import pytest

import snap_tpu.genome as JG
import snap_tpu.index.build as JB
import snap_tpu_torch.genome as TG
import snap_tpu_torch.index.build as TB
from snap_tpu_torch.constants import BASE_ENCODE, PAD


def same_genome(a, b):
    np.testing.assert_array_equal(np.asarray(b.bases), np.asarray(a.bases))
    ca = [(c.name, c.start, c.length, c.is_alt, c.original_index) for c in a.contigs]
    cb = [(c.name, c.start, c.length, c.is_alt, c.original_index) for c in b.contigs]
    assert cb == ca


def test_load_fasta(tmp_path):
    fa = tmp_path / "g.fa"
    fa.write_text(">c1 description\nACGTACGT\nGGGG\n>c2\nTTTT\n>c3 x\nacgtNNnnRYACGT\n")
    g = TG.load_fasta(str(fa), chromosome_padding=10)
    same_genome(JG.load_fasta(str(fa), chromosome_padding=10), g)
    assert [c.name for c in g.contigs] == ["c1", "c2", "c3"]
    c1, c2, _ = g.contigs
    assert c1.start == 10 and c1.length == 12 and c2.length == 4
    assert g.decode(c1.start, 12) == "ACGTACGTGGGG"
    assert np.all(g.bases[c1.start + c1.length : c2.start] == PAD)
    # name terminators and spaces, as the -B / -bSpace- index options
    kw = dict(chromosome_padding=7, name_terminators="_", space_terminates=False)
    (tmp_path / "h.fa").write_text(">a_b c\nACGT\n>d e\nGGCC\n")
    same_genome(JG.load_fasta(str(tmp_path / "h.fa"), **kw),
                TG.load_fasta(str(tmp_path / "h.fa"), **kw))


@pytest.mark.parametrize("text", [
    b"ACGT\nGG\n>c1\nAC\n\n\nGT\n>c2\n>c3\nTTTT",      # lines before any header
    b">c1\nAC GT\n\tGG\r\nCC\x0b\n>c2 x\nA\x0cA\n",      # whitespace inside records
    b">c1\nACGT\n  >c2 y\nGGCC\n>c3\nA>C\n",              # a header after spaces, '>' inside
    b">c1\r\nACGT\r\nGG\r\n>c2\r\nTT\r\n",             # CRLF line ends
    b"\n\n>c1\n\nACGT\n\n>c2\n",                         # blank lines, an empty record
])
def test_load_fasta_line_rules(tmp_path, text):
    """The port parses a record's sequence lines at once where they hold
    no whitespace but their newlines, and line by line elsewhere: both
    give snap_tpu's genome (each line stripped, blank lines skipped, a
    stripped line starting with '>' a header)."""
    fa = tmp_path / "g.fa"
    fa.write_bytes(text)
    same_genome(JG.load_fasta(str(fa), chromosome_padding=3),
                TG.load_fasta(str(fa), chromosome_padding=3))


@pytest.mark.parametrize("kw", [
    {}, {"auto_alt": False}, {"alt_names": {"chr1"}}, {"non_alt_names": {"chr1_alt"}},
])
def test_alt_reordering(tmp_path, kw):
    fa = tmp_path / "g.fa"
    fa.write_text(">chr1_alt\nACGTACGTAC\n>chr1\nTTTTGGGGCC\n>chr2_alt\nGGGGAAAA\n")
    g = TG.load_fasta(str(fa), chromosome_padding=4, **kw)
    same_genome(JG.load_fasta(str(fa), chromosome_padding=4, **kw), g)
    if not kw:
        assert [c.name for c in g.contigs] == ["chr1", "chr1_alt", "chr2_alt"]
        assert g.contigs[0].is_alt is False and g.contigs[1].is_alt is True
        assert g.contigs[0].original_index == 1
    assert g.first_alt_start() == JG.load_fasta(str(fa), chromosome_padding=4, **kw).first_alt_start()


def make_genome(mod, seq: str, padding: int = 16):
    codes = BASE_ENCODE[np.frombuffer(seq.encode(), dtype=np.uint8)]
    bases = np.full(len(seq) + 2 * padding, PAD, dtype=np.uint8)
    bases[padding : padding + len(seq)] = codes
    return mod.Genome(bases=bases, contigs=[mod.Contig(name="test", start=padding, length=len(seq))])


@pytest.mark.parametrize("seq, seed_len", [
    ("ACGTACGTACGT", 4), ("ACGTTGCANACGTACCA", 4), ("GGGGCCCCAAAATTTT" * 8, 8),
    ("ACGT" * 40 + "N" + "TTGCA" * 30, 20),
])
def test_extract_canonical_counts(seq, seed_len):
    ref = JB.extract_canonical_seeds(make_genome(JG, seq), seed_len)
    got = TB.extract_canonical_seeds(make_genome(TG, seq), seed_len)
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    if seq == "ACGTACGTACGT":
        keys, orient, locs = got
        assert len(keys) == 9 and np.all(np.sort(locs) == np.arange(16, 25))
