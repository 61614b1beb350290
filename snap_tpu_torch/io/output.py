"""Unified output pipeline: SAM/BAM, optional coordinate sort, duplicate
marking, and BAM index.

Behavioral reference: SNAP's DataWriter filter chain (DataWriter.h:36-139)
composed as sort -> dup-mark -> BGZF -> .bai (SortedDataWriter.cpp,
SAM.cpp:3707/Bam.cpp:2619 dup filters, Bam.cpp:950-964). Semantics kept:

- sort order = (original FASTA contig order, position), the
  GenomeLocationOrderedByOriginalContigs rule (SortedDataWriter.cpp:184);
  unmapped reads sort last;
- duplicate marking on sorted output, default ON for sorted
  (-S d disables): groups keyed by library + unclipped 5' location(s) +
  strand(s), best member by Picard-style base-quality sum (phred >= 15)
  keeps FLAG 0x400 clear (Bam.cpp:2398-2464);
- @HD says SO:coordinate when sorted, GO:query otherwise (SAM.cpp:1204).

SNAP streams through temp files with a parallel merge; here batches are
collected in memory and sorted at close (spill-to-disk is a scale
follow-up), which is simpler and plenty for single-host outputs.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from ..genome import Genome
from .bam import BamWriter, cigar_ref_span, encode_record, encode_tags
from .sam import COMPLEMENT, FLAG_DUPLICATE, FLAG_RC, FLAG_UNMAPPED, ReadGroup


@dataclass
class OutRecord:
    qname: bytes
    flag: int
    rname: str          # '*' if unmapped
    pos: int            # 1-based; 0 if unmapped
    mapq: int
    cigar: str
    rnext: str
    pnext: int
    tlen: int
    seq: bytes          # FORWARD orientation as read from input
    qual: bytes
    nm: int | None
    comment: bytes = b""  # FASTQ comment, emitted under -pfc
    extra_tags: tuple = ()  # -is / AT:i: / QS:i: / LB:Z: etc.
    # input SAM aux fields, emitted first (SAM.cpp:1854-1875); dropped
    # on BAM output like the reference's untranslated-aux path
    input_aux: bytes = b""


def _clips(cigar: str) -> tuple[int, int]:
    m = re.match(r"^(?:\d+H)?(\d+)S", cigar)
    front = int(m.group(1)) if m else 0
    m = re.search(r"(\d+)S(?:\d+H)?$", cigar)
    back = int(m.group(1)) if m else 0
    return front, back


def unclipped_5prime(rec: OutRecord) -> int:
    """Unclipped 5' coordinate used by duplicate keys (Bam.cpp:2398)."""
    front, back = _clips(rec.cigar)
    if rec.flag & FLAG_RC:
        return rec.pos + cigar_ref_span(rec.cigar) - 1 + back
    return rec.pos - front


def quality_sum(qual: bytes) -> int:
    """Picard-style sum of phred values >= 15 (SAM.cpp:1826-1837)."""
    return sum(q - 33 for q in qual if q - 33 >= 15)


class OutputWriter:
    """Collects or streams records; applies sort/dup/format at close."""

    def __init__(
        self,
        out,
        genome: Genome,
        command_line: str = "",
        read_group: ReadGroup | None = None,
        bam: bool = False,
        sort: bool = False,
        mark_duplicates: bool | None = None,
        build_bai: bool | None = None,
        bai_path: str | None = None,
        program_id: str = "SNAP",
        program_version: str = "2.0.5-tpu",
        preserve_fastq_comments: bool = False,
        sort_memory_mb: int | None = None,
        sort_tmp_dir: str | None = None,
        sam_no_sq: bool = False,
    ):
        self.out = out
        self.genome = genome
        self.command_line = command_line
        self.read_group = read_group or ReadGroup()
        self.bam = bam
        self.sort = sort
        self.mark_duplicates = sort if mark_duplicates is None else mark_duplicates
        self.build_bai = (bam and sort) if build_bai is None else build_bai
        self.bai_path = bai_path
        self.program_id = program_id
        self.program_version = program_version
        self.preserve_fastq_comments = preserve_fastq_comments
        # -sm: spill-to-disk external sort (SortedDataWriter.cpp's
        # SortBlock temp file + merge design). None = fully in-memory.
        self.sort_memory_mb = sort_memory_mb
        self.sort_tmp_dir = sort_tmp_dir
        self.sam_no_sq = sam_no_sq
        self._spill_files: list = []
        self._approx_bytes = 0
        self._ordinal = 0
        self._dup_sigs: list = []  # per-record (hash128-hi, lo, qualsum, ordinal)
        self._records: list[OutRecord] = []
        self._stream_sam = not (bam or sort)
        # unsorted BAM streams straight through the BGZF writer instead
        # of buffering every record until close (DataWriter's unsorted
        # path is a plain async multi-buffer stream, DataWriter.h:36-139)
        self._stream_bam = bam and not sort
        self._bw = None
        self._contig_order = {
            c.name: c.original_index for c in genome.contigs
        }
        self._header_written = False
        self._sorted_contigs = sorted(genome.contigs, key=lambda c: c.start)
        self._starts = [c.start for c in self._sorted_contigs]

    def locate(self, genome_loc: int) -> tuple[str, int] | None:
        """Absolute genome location -> (contig name, 1-based POS)."""
        import bisect

        i = bisect.bisect_right(self._starts, genome_loc) - 1
        if i < 0:
            return None
        c = self._sorted_contigs[i]
        if genome_loc >= c.start + c.length:
            return None
        return c.name, genome_loc - c.start + 1

    # -- header ---------------------------------------------------------
    def header_text(self) -> str:
        lines = []
        if self.sort:
            lines.append("@HD\tVN:1.6\tSO:coordinate")
        else:
            lines.append("@HD\tVN:1.6\tGO:query")
        lines.append(self.read_group.header_line())
        lines.append(
            f"@PG\tID:{self.program_id}\tPN:{self.program_id}"
            f"\tCL:{self.command_line}\tVN:{self.program_version}"
        )
        for c in sorted(self.genome.contigs, key=lambda x: x.original_index):
            if not self.sam_no_sq:
                lines.append(f"@SQ\tSN:{c.name}\tLN:{c.length}")
        return "\n".join(lines) + "\n"

    def write_header(self) -> None:
        if self._stream_sam and not self._header_written:
            self.out.write(self.header_text().encode())
            self._header_written = True
        elif self._stream_bam and self._bw is None:
            self._bw = BamWriter(
                self.out, self.genome, self.header_text(),
                build_index=self.build_bai,
            )

    # -- records --------------------------------------------------------
    def write_record(
        self, qname, flag, rname, pos, mapq, cigar, seq, qual, nm,
        rnext="*", pnext=0, tlen=0, extra_tags=(), input_aux=b"",
    ) -> None:
        # QNAME truncates at the first space (SAM.cpp:1750-1753); the
        # remainder is the FASTQ comment, kept under -pfc
        parts = qname.split(None, 1)
        comment = (
            parts[1]
            if self.preserve_fastq_comments and len(parts) > 1
            else b""
        )
        rec = OutRecord(
            qname=parts[0] if parts else qname, flag=flag, rname=rname,
            pos=pos, mapq=mapq, cigar=cigar, rnext=rnext, pnext=pnext,
            tlen=tlen, seq=seq, qual=qual, nm=nm, comment=comment,
            extra_tags=tuple(extra_tags), input_aux=input_aux,
        )
        if self._stream_sam:
            self.out.write(self._format_sam(rec))
            return
        if self._stream_bam:
            if self._bw is None:
                self.write_header()
            self._emit_bam_record(self._bw, rec)
            return
        self._records.append(rec)
        if self.sort_memory_mb is not None and self.sort:
            self._approx_bytes += (
                64 + len(rec.qname) + 2 * len(rec.seq) + len(rec.cigar)
            )
            if self._approx_bytes >= self.sort_memory_mb * (1 << 20):
                self._spill_block()

    # -- external sort spill (the SortBlock/mergeSort pipeline,
    #    SortedDataWriter.cpp:98-196,942-1235) ------------------------------
    def _record_dup_sig(self, rec: OutRecord, ordinal: int) -> None:
        """Compact duplicate signature so spilled dup marking doesn't
        need all records in memory: 128-bit key hash + quality sum."""
        import hashlib

        key = self._dup_key(rec)
        if key is None:
            return
        h = hashlib.blake2b(repr(key).encode(), digest_size=16).digest()
        self._dup_sigs.append((
            int.from_bytes(h[:8], "little"),
            int.from_bytes(h[8:], "little"),
            quality_sum(rec.qual),
            ordinal,
        ))

    def _spill_block(self) -> None:
        import pickle
        import tempfile

        recs = self._records
        self._records = []
        self._approx_bytes = 0
        if self.mark_duplicates:
            base = self._ordinal
            for local_i, rec in enumerate(recs):
                self._record_dup_sig(rec, base + local_i)
        tagged = sorted(
            ((self._sort_key(r), self._ordinal + i, r)
             for i, r in enumerate(recs)),
            key=lambda t: t[0],
        )
        self._ordinal += len(recs)
        f = tempfile.TemporaryFile(dir=self.sort_tmp_dir)
        for item in tagged:  # one object per record so merge can stream
            pickle.dump(item, f, protocol=pickle.HIGHEST_PROTOCOL)
        f.flush()
        f.seek(0)
        self._spill_files.append(f)

    @staticmethod
    def _iter_spill(f):
        import pickle

        while True:
            try:
                yield pickle.load(f)
            except EOFError:
                f.close()
                return

    def _dup_key(self, rec: OutRecord):
        """The DuplicateReadKey / DuplicateFragmentKey (Bam.cpp:2398-2468)."""
        if rec.flag & FLAG_UNMAPPED or rec.rname == "*":
            return None
        if rec.flag & 0x100 or rec.flag & 0x800:
            return None
        self_5p = unclipped_5prime(rec)
        if rec.flag & 0x1 and rec.rnext != "*" and not rec.flag & 0x8:
            mate_rname = rec.rname if rec.rnext == "=" else rec.rnext
            a = (rec.rname, self_5p, bool(rec.flag & FLAG_RC))
            b = (mate_rname, rec.pnext, bool(rec.flag & 0x20))
            return ("P",) + (a + b if a <= b else b + a)
        return ("F", rec.rname, self_5p, bool(rec.flag & FLAG_RC))

    def _spilled_dup_ordinals(self) -> np.ndarray:
        """Ordinals to flag 0x400, from the compact signatures.

        Sort so each duplicate-key group's best member (highest quality
        sum, then lowest ordinal — the DuplicateMateInfo rule) comes
        first; every later member of the group is a duplicate.
        """
        if not self._dup_sigs:
            return np.empty(0, dtype=np.int64)
        sig = np.array(self._dup_sigs, dtype=np.uint64)
        inv_qs = np.uint64(0xFFFFFFFFFFFFFFFF) - sig[:, 2]
        order = np.lexsort((sig[:, 3], inv_qs, sig[:, 1], sig[:, 0]))
        s = sig[order]
        first = np.ones(len(s), dtype=bool)
        first[1:] = (s[1:, 0] != s[:-1, 0]) | (s[1:, 1] != s[:-1, 1])
        return np.sort(s[~first][:, 3].astype(np.int64))

    def _tags(self, rec: OutRecord, bam: bool = False) -> list[str]:
        rg = [f"RG:Z:{self.read_group.rg_id}"]
        rg += [f"{k}:Z:{v}" for k, v in self.read_group.attrs]
        pg = f"PG:Z:{self.program_id}"
        nm = f"NM:i:{-1 if rec.nm is None else rec.nm}"
        extra = list(rec.extra_tags)
        if bam:
            # the reference's BAM records order tags RG-block, PG, NM;
            # input SAM aux is not translated to BAM (reference warns)
            return rg + [pg, nm] + extra
        # tag order: input aux first, then PG, NM, RG block, then the
        # optional tail tags (internal score, AT:i:, QS:i:, LB:Z:;
        # SAM.cpp:1854-1875)
        aux = [rec.input_aux.decode()] if rec.input_aux else []
        return aux + [pg, nm] + rg + extra

    def _oriented(self, rec: OutRecord) -> tuple[bytes, bytes]:
        seq, qual = rec.seq, rec.qual
        if rec.flag & FLAG_RC and not rec.flag & FLAG_UNMAPPED:
            seq = seq.translate(COMPLEMENT)[::-1]
            qual = qual[::-1]
        return seq, qual

    def _format_sam(self, rec: OutRecord) -> bytes:
        seq, qual = self._oriented(rec)
        tags = "\t".join(self._tags(rec))
        # -pfc: the preserved FASTQ comment trails the tags
        # (SAM.cpp record assembly, preserveFASTQComments)
        tail = b"\t" + rec.comment if rec.comment else b""
        return (
            rec.qname
            + f"\t{rec.flag}\t{rec.rname}\t{rec.pos}\t{rec.mapq}\t"
              f"{rec.cigar}\t{rec.rnext}\t{rec.pnext}\t{rec.tlen}\t".encode()
            + seq + b"\t" + qual + b"\t" + tags.encode() + tail + b"\n"
        )

    # -- close: sort, dup-mark, emit -------------------------------------
    def _sort_key(self, rec: OutRecord):
        if rec.flag & FLAG_UNMAPPED or rec.rname == "*":
            return (1 << 30, 0)
        return (self._contig_order.get(rec.rname, 1 << 29), rec.pos)

    def _mark_dups(self) -> None:
        """Group by duplicate key; best quality-sum keeps the flag clear."""
        groups: dict[tuple, list[OutRecord]] = {}
        for rec in self._records:
            if rec.flag & FLAG_UNMAPPED or rec.rname == "*":
                continue
            if rec.flag & 0x100 or rec.flag & 0x800:
                continue
            self_5p = unclipped_5prime(rec)
            if rec.flag & 0x1 and rec.rnext != "*" and not rec.flag & 0x8:
                mate_5p = rec.pnext
                mate_rname = rec.rname if rec.rnext == "=" else rec.rnext
                a = (rec.rname, self_5p, bool(rec.flag & FLAG_RC))
                b = (mate_rname, mate_5p, bool(rec.flag & 0x20))
                key = ("P",) + (a + b if a <= b else b + a)
            else:
                key = ("F", rec.rname, self_5p, bool(rec.flag & FLAG_RC))
            groups.setdefault(key, []).append(rec)
        for key, members in groups.items():
            if len(members) < 2:
                continue
            best = max(
                range(len(members)),
                key=lambda i: (quality_sum(members[i].qual), -i),
            )
            for i, rec in enumerate(members):
                if i != best:
                    rec.flag |= FLAG_DUPLICATE

    def close(self) -> None:
        if self._stream_sam:
            return
        if self._stream_bam:
            if self._bw is None:
                self.write_header()
            self._bw.close(self.bai_path)
            return
        if self._spill_files:
            # external merge: stream every sorted block + dup marking by
            # precomputed ordinal (SortedDataWriter's merge phase)
            import heapq

            if self._records:
                self._spill_block()
            dup_ords = (
                self._spilled_dup_ordinals()
                if self.mark_duplicates
                else np.empty(0, dtype=np.int64)
            )
            merged = heapq.merge(
                *[self._iter_spill(f) for f in self._spill_files],
                key=lambda t: t[0],
            )

            def stream():
                for _key, ordinal, rec in merged:
                    if dup_ords.size:
                        j = int(np.searchsorted(dup_ords, ordinal))
                        if j < dup_ords.size and dup_ords[j] == ordinal:
                            rec.flag |= FLAG_DUPLICATE
                    yield rec

            self._emit_all(stream())
            self._spill_files = []
            return
        if self.sort:
            self._records.sort(key=self._sort_key)
            if self.mark_duplicates:
                self._mark_dups()
        self._emit_all(self._records)

    def _emit_bam_record(self, bw: BamWriter, rec: OutRecord) -> None:
        seq, qual = self._oriented(rec)
        rid = bw.ref_ids.get(rec.rname, -1)
        nrid = rid if rec.rnext == "=" else bw.ref_ids.get(rec.rnext, -1)
        span = cigar_ref_span(rec.cigar)
        data = encode_record(
            rec.qname, rec.flag, rid, rec.pos - 1, rec.mapq,
            rec.cigar, nrid, rec.pnext - 1, rec.tlen, seq, qual,
            encode_tags(self._tags(rec, bam=True)),
        )
        bw.write_record_bytes(data, rid, rec.pos - 1, span)

    def _emit_all(self, records) -> None:
        if self.bam:
            bw = BamWriter(
                self.out, self.genome, self.header_text(),
                build_index=self.build_bai,
            )
            for rec in records:
                self._emit_bam_record(bw, rec)
            bw.close(self.bai_path)
        else:
            self.out.write(self.header_text().encode())
            for rec in records:
                self.out.write(self._format_sam(rec))
