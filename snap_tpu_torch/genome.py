"""Reference genome: one contiguous code array + contig table.

Behavioral reference: SNAP's Genome.{h,cpp} and FASTA.cpp:190
(ReadFASTAGenome). The genome is a single contiguous array of base codes
with `chromosome_padding` pad bases preceding each contig and one
trailing run after the last — EXACTLY the reference's layout (first
contig begins at absolute location chromosomePadding, GenomeIndex.cpp:48
DEFAULT_PADDING). Matching the absolute coordinates matters beyond
cosmetics: the 48-wide candidate-merge buckets (BaseAligner.h:213
hashTableElementSize) quantize absolute locations, so a different base
offset moves bucket boundaries and flips MAPQ on indel reads whose
split candidates straddle them. Padding uses the PAD code (the analogue
of SNAP's lowercase 'n', Genome.h:345) so that read Ns never match
padding. Contigs carry ALT flags (ref: Genome.h:383-400);
ALT contigs are reordered to the end so "is ALT" is a single location
comparison (ref: Genome.h:436-438).

Unlike SNAP (byte chars + pointer arithmetic), bases are stored as a
numpy uint8 code array (0..3 ACGT, 4 N, 5 pad) ready for device transfer
and 2-bit packing.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from .constants import (
    BASE_DECODE,
    BASE_ENCODE,
    DEFAULT_CONTIG_PADDING,
    PAD,
)


@dataclass
class Contig:
    name: str
    start: int          # genome-array offset of first real base
    length: int         # number of real bases
    is_alt: bool = False
    original_index: int = 0  # position in the input FASTA (for SAM header / sort order)
    # ALT->primary liftover projection (ref: Genome.h:383-400, parsed from
    # bwa-kit .alt SAM lines, GenomeIndex.cpp:315-423). proj_name is the
    # primary-assembly contig this ALT contig projects onto; proj_offset is
    # the 1-based position there; proj_rc marks a reverse-strand projection.
    proj_name: str = ""
    proj_offset: int = 0
    proj_rc: bool = False


@dataclass
class Genome:
    bases: np.ndarray                 # uint8 codes, full padded array
    contigs: list[Contig] = field(default_factory=list)

    @property
    def num_bases(self) -> int:
        return int(self.bases.shape[0])

    # -- contig queries ------------------------------------------------------
    def contig_starts(self) -> np.ndarray:
        return np.array([c.start for c in self.contigs], dtype=np.int64)

    def contig_at(self, location: int) -> Contig | None:
        """The contig containing `location`, or None if it's padding.

        Mirrors Genome::getContigAtLocation semantics: a location inside a
        contig's [start, start+length) span.
        """
        for c in self.contigs:
            if c.start <= location < c.start + c.length:
                return c
        return None

    def contig_index_at(self, location: int) -> int:
        starts = self.contig_starts()
        i = int(np.searchsorted(starts, location, side="right")) - 1
        if i < 0:
            return -1
        c = self.contigs[i]
        return i if location < c.start + c.length else -1

    def substring(self, start: int, length: int) -> np.ndarray:
        return self.bases[start : start + length]

    def first_alt_start(self) -> int:
        """Genome-array boundary above which every location is ALT.

        ALT contigs are reordered to the end of the array, so "is ALT" is
        one comparison (ref: Genome.h:436-438 isGenomeLocationALT). Returns
        num_bases when there are no ALT contigs.
        """
        for c in self.contigs:
            if c.is_alt:
                return c.start
        return self.num_bases

    def is_location_alt(self, location: int) -> bool:
        return location >= self.first_alt_start()

    def project_location(self, location: int, ref_span: int = 0) -> int:
        """ALT location -> primary-assembly location via the liftover
        projection (ref: Genome::getProjLocation, used for paired mate
        positions, IntersectingPairedEndAligner.cpp:2907-2920). Returns
        `location` unchanged when there is no projection."""
        i = self.contig_index_at(location)
        if i < 0:
            return location
        c = self.contigs[i]
        if not c.is_alt or not c.proj_name:
            return location
        target = next((t for t in self.contigs if t.name == c.proj_name), None)
        if target is None:
            return location
        off_in_alt = location - c.start
        if c.proj_rc:
            # projection maps the ALT contig reverse-complemented onto the
            # primary: ALT offset o covers primary bases ending at
            # proj_offset + (length - o)
            return target.start + (c.proj_offset - 1) + (
                c.length - off_in_alt - ref_span
            )
        return target.start + (c.proj_offset - 1) + off_in_alt

    def decode(self, start: int, length: int) -> str:
        return BASE_DECODE[self.substring(start, length)].tobytes().decode()

    # -- persistence ---------------------------------------------------------
    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        np.save(os.path.join(directory, "genome_bases.npy"), self.bases)
        meta = {
            "contigs": [
                {
                    "name": c.name,
                    "start": c.start,
                    "length": c.length,
                    "is_alt": c.is_alt,
                    "original_index": c.original_index,
                    "proj_name": c.proj_name,
                    "proj_offset": c.proj_offset,
                    "proj_rc": c.proj_rc,
                }
                for c in self.contigs
            ],
        }
        with open(os.path.join(directory, "genome_meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, directory: str, mmap: bool = True) -> "Genome":
        bases = np.load(
            os.path.join(directory, "genome_bases.npy"),
            mmap_mode="r" if mmap else None,
        )
        with open(os.path.join(directory, "genome_meta.json")) as f:
            meta = json.load(f)
        contigs = [Contig(**c) for c in meta["contigs"]]
        return cls(bases=bases, contigs=contigs)


def parse_alt_file(path: str) -> dict[str, tuple[str, int, bool]]:
    """Parse a bwa-kit style `.alt` file (SAM lines mapping ALT contigs
    onto the primary assembly; ref: GenomeIndex.cpp:315-423 which reads
    the same format for -altLiftoverFile). Returns
    {alt_contig_name: (primary_contig, 1-based pos, is_rc)}."""
    from .io.genericfile import open_generic

    out: dict[str, tuple[str, int, bool]] = {}
    with open_generic(path, "rb") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(b"@"):
                continue
            t = line.split(b"\t")
            if len(t) < 4:
                continue
            name = t[0].decode()
            flag = int(t[1])
            rname = t[2].decode()
            pos = int(t[3])
            if rname == "*":
                continue
            out[name] = (rname, pos, bool(flag & 0x10))
    return out


def load_fasta(
    path: str,
    chromosome_padding: int = DEFAULT_CONTIG_PADDING,
    alt_names: set[str] | None = None,
    non_alt_names: set[str] | None = None,
    auto_alt: bool = True,
    max_alt_contig_size: int = 0,
    alt_liftover: dict[str, tuple[str, int, bool]] | None = None,
    name_terminators: str = "",     # -B chars (GenomeIndex.cpp:63-68)
    space_terminates: bool = True,  # -bSpace[-]
) -> Genome:
    """Parse a (optionally gzipped) FASTA into a padded Genome.

    ALT classification follows the reference's auto rule (FASTA.cpp /
    GenomeIndex.cpp:315-423): names containing '_alt' or starting 'HLA-'
    are ALT, plus any explicitly named (or listed in the liftover file),
    minus any named non-ALT; ALT contigs are moved after all non-ALT
    contigs (ref: Genome.h:436-438 comment on contig reordering).
    """
    from .io.genericfile import open_generic

    def opener(p, mode):
        return open_generic(p, mode)

    names: list[str] = []
    seqs: list[np.ndarray] = []
    cur: list[bytes] = []
    encode = BASE_ENCODE.tobytes()  # a bytes.translate table

    def flush():
        if names and cur is not None:
            raw = b"".join(cur)
            seqs.append(np.frombuffer(raw.translate(encode), dtype=np.uint8))

    def take_line(line: bytes):
        line = line.strip()
        if not line:
            return
        if line.startswith(b">"):
            if names:
                flush()
                cur.clear()
            # contig name ends at the first terminator: whitespace
            # by default (-bSpace), plus any -B characters
            # (GenomeIndex.cpp:63-68)
            nm = line[1:].decode()
            cut = len(nm)
            terms = name_terminators + (" \t" if space_terminates else "")
            for ch in terms:
                j = nm.find(ch)
                if j >= 0:
                    cut = min(cut, j)
            names.append(nm[:cut])
        else:
            cur.append(line)

    with opener(path, "rb") as f:
        data = f.read()
    # Line by line, each line stripped, blank lines skipped, a line
    # starting with '>' a header. Whole records at once where that is
    # the same thing: a record's sequence lines (from after its header
    # line to the next line starting with '>') that hold no whitespace
    # but their newlines are those lines joined.
    starts = [0] if data.startswith(b">") else []
    at = data.find(b"\n>")
    while at >= 0:
        starts.append(at + 1)
        at = data.find(b"\n>", at + 1)
    if not starts or starts[0] != 0:
        for line in data[: starts[0] if starts else len(data)].split(b"\n"):
            take_line(line)
    for k, lo in enumerate(starts):
        hi = starts[k + 1] if k + 1 < len(starts) else len(data)
        eol = data.find(b"\n", lo, hi)
        eol = hi if eol < 0 else eol
        take_line(data[lo:eol])
        body = data[eol + 1 : hi]
        if any(ch in body for ch in (b" ", b"\t", b"\r", b"\x0b", b"\x0c")):
            for line in body.split(b"\n"):
                take_line(line)
        elif body:
            cur.append(body.replace(b"\n", b""))
    del data
    if names:
        flush()

    if not names:
        raise ValueError(f"no contigs found in {path}")

    def is_alt(name: str, seq_len: int) -> bool:
        if non_alt_names and name in non_alt_names:
            return False
        if alt_names and name in alt_names:
            return True
        if alt_liftover and name in alt_liftover:
            return True
        if auto_alt and ("_alt" in name or name.startswith("HLA-")):
            return True
        if max_alt_contig_size > 0 and seq_len <= max_alt_contig_size:
            return True
        return False

    order = list(range(len(names)))
    # Stable partition: non-ALT first, ALT last (preserving input order within
    # each class) — mirrors SNAP's ALT-last reordering.
    order.sort(key=lambda i: (is_alt(names[i], len(seqs[i])), 0))

    # SNAP layout: padding before every contig plus one trailing run
    # (chr1 of a fresh index sits at absolute location
    # chromosome_padding, matching the reference's Genome file).
    total = (
        sum(len(s) for s in seqs)
        + chromosome_padding * (len(seqs) + 1)
    )
    bases = np.full(total, PAD, dtype=np.uint8)
    contigs: list[Contig] = []
    pos = 0
    for i in order:
        pos += chromosome_padding
        seq = seqs[i]
        bases[pos : pos + len(seq)] = seq
        proj = (alt_liftover or {}).get(names[i])
        contigs.append(
            Contig(
                name=names[i],
                start=pos,
                length=len(seq),
                is_alt=is_alt(names[i], len(seq)),
                original_index=i,
                proj_name=proj[0] if proj else "",
                proj_offset=proj[1] if proj else 0,
                proj_rc=proj[2] if proj else False,
            )
        )
        pos += len(seq)

    return Genome(bases=bases, contigs=contigs)


def reverse_complement_codes(codes: np.ndarray) -> np.ndarray:
    """RC in code space: complement = 3 - code for ACGT; N/pad unchanged."""
    out = codes[::-1].copy()
    acgt = out < 4
    out[acgt] = 3 - out[acgt]
    return out
