"""SAM emission.

Behavioral reference: SNAP's SAMFormat writer (SAM.cpp:1424-2350) and
the emission spec in SURVEY.md Appendix A. Field/flag semantics are
mirrored so that records diff cleanly against reference SNAP output:

- header `@HD VN:1.6 GO:query` (unsorted), default `@RG ID:FASTQ
  PL:Illumina PU:pu LB:lb SM:sm`, `@PG`, then `@SQ` per contig;
- QNAME truncated at first whitespace (SAM.cpp:1750-1753);
- SEQ/QUAL are the unclipped read, reverse-complemented in place for
  RC alignments (SAM.cpp:1514-1539);
- unmapped: FLAG 4, RNAME *, POS 0, MAPQ 0, CIGAR *, forward SEQ;
- tag order: PG:Z:SNAP, NM:i (mapped only), RG + @RG attribute block
  (SAM.cpp:1854-1875).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..genome import Genome

COMPLEMENT = bytes.maketrans(b"ACGTacgtN", b"TGCAtgcaN")

FLAG_UNMAPPED = 0x4
FLAG_RC = 0x10
FLAG_PAIRED = 0x1
FLAG_PROPER = 0x2
FLAG_NEXT_UNMAPPED = 0x8
FLAG_NEXT_RC = 0x20
FLAG_FIRST = 0x40
FLAG_LAST = 0x80
FLAG_SECONDARY = 0x100
FLAG_DUPLICATE = 0x400
FLAG_SUPPLEMENTARY = 0x800


@dataclass
class ReadGroup:
    rg_id: str = "FASTQ"
    attrs: tuple[tuple[str, str], ...] = (
        ("PL", "Illumina"),
        ("PU", "pu"),
        ("LB", "lb"),
        ("SM", "sm"),
    )

    def header_line(self) -> str:
        parts = [f"@RG\tID:{self.rg_id}"]
        parts += [f"{k}:{v}" for k, v in self.attrs]
        return "\t".join(parts)

    def record_tags(self) -> str:
        parts = [f"RG:Z:{self.rg_id}"]
        parts += [f"{k}:Z:{v}" for k, v in self.attrs]
        return "\t".join(parts)


@dataclass
class SamWriter:
    out: object                  # binary file-like
    genome: Genome
    command_line: str = ""
    read_group: ReadGroup = field(default_factory=ReadGroup)
    program_id: str = "SNAP"     # emitted in PG:Z: record tags
    program_version: str = "2.0.5-tpu"
    sort_order: str | None = None

    # a bare SamWriter always streams SAM text in record order, so the
    # aligners' batched native emission plan applies (OutputWriter sets
    # this False for BAM/sorted paths, io/output.py)
    _stream_sam = True

    def __post_init__(self):
        # contig starts for absolute->relative mapping
        self._contigs = sorted(
            self.genome.contigs, key=lambda c: c.start
        )
        self._starts = [c.start for c in self._contigs]

    def write_header(self) -> None:
        lines = []
        if self.sort_order:
            lines.append(f"@HD\tVN:1.6\tSO:{self.sort_order}")
        else:
            lines.append("@HD\tVN:1.6\tGO:query")
        lines.append(self.read_group.header_line())
        lines.append(
            f"@PG\tID:{self.program_id}\tPN:{self.program_id}"
            f"\tCL:{self.command_line}\tVN:{self.program_version}"
        )
        # @SQ in original FASTA order (SNAP sorts output by original
        # contig order too, SortedDataWriter.cpp:184)
        for c in sorted(self.genome.contigs, key=lambda x: x.original_index):
            lines.append(f"@SQ\tSN:{c.name}\tLN:{c.length}")
        self.out.write(("\n".join(lines) + "\n").encode())

    def locate(self, genome_loc: int) -> tuple[str, int] | None:
        """Absolute location -> (contig name, 1-based POS), or None if pad."""
        import bisect

        i = bisect.bisect_right(self._starts, genome_loc) - 1
        if i < 0:
            return None
        c = self._contigs[i]
        if genome_loc >= c.start + c.length:
            return None
        return c.name, genome_loc - c.start + 1

    def write_record(
        self,
        qname: bytes,
        flag: int,
        rname: str,
        pos: int,
        mapq: int,
        cigar: str,
        seq: bytes,
        qual: bytes,
        nm: int | None,
        rnext: str = "*",
        pnext: int = 0,
        tlen: int = 0,
        extra_tags=(),
        input_aux: bytes = b"",
    ) -> None:
        qname = qname.split()[0]
        if flag & FLAG_RC and not flag & FLAG_UNMAPPED:
            seq = seq.translate(COMPLEMENT)[::-1]
            qual = qual[::-1]
        # input SAM aux fields come first, ahead of our own tags
        # (SAM.cpp:1854-1875 format string starts with the copied aux)
        tags = [input_aux.decode()] if input_aux else []
        tags.append(f"PG:Z:{self.program_id}")
        # unmapped reads carry NM:i:-1 in the reference's output
        tags.append(f"NM:i:{-1 if nm is None else nm}")
        tags.append(self.read_group.record_tags())
        tags.extend(extra_tags)
        line = (
            qname
            + f"\t{flag}\t{rname}\t{pos}\t{mapq}\t{cigar}\t{rnext}\t{pnext}\t{tlen}\t".encode()
            + seq
            + b"\t"
            + qual
            + b"\t"
            + "\t".join(tags).encode()
            + b"\n"
        )
        self.out.write(line)
