"""BAM writing/reading + .bai index.

Behavioral reference: SNAP's Bam.{h,cpp}: BAMAlignment record layout
(Bam.h:93-136), reg2bin/reg2bins (Bam.h:171-174), the BAMFormat writer
chain (BGZF + optional dup-mark + index filters, Bam.cpp:950-964), and
the BAMIndexSupplier .bai builder (Bam.cpp:3216-3254). Implements the
standard BAM spec so outputs are consumable by samtools/picard and by
SNAP itself.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from .bgzf import BgzfReader, BgzfWriter

CIGAR_OPS = "MIDNSHP=X"
CIGAR_CODE = {op: i for i, op in enumerate(CIGAR_OPS)}
# 4-bit sequence codes: =ACMGRSVTWYHKDBN
SEQ_NIBBLE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
NIBBLE_SEQ = "=ACMGRSVTWYHKDBN"


def reg2bin(beg: int, end: int) -> int:
    """UCSC binning scheme (ref: Bam.h:171-174)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def parse_cigar(cigar: str) -> list[tuple[int, str]]:
    import re

    if cigar == "*":
        return []
    return [
        (int(n), op) for n, op in re.findall(r"(\d+)([MIDNSHP=X])", cigar)
    ]


def cigar_ref_span(cigar: str) -> int:
    return sum(n for n, op in parse_cigar(cigar) if op in "MDN=X")


def encode_record(
    qname: bytes,
    flag: int,
    ref_id: int,
    pos0: int,          # 0-based; -1 if unmapped
    mapq: int,
    cigar: str,
    next_ref_id: int,
    next_pos0: int,
    tlen: int,
    seq: bytes,         # already output-oriented (RC applied)
    qual: bytes,        # raw phred+33 bytes, output-oriented
    tags: bytes,
) -> bytes:
    ops = parse_cigar(cigar)
    ref_span = sum(n for n, op in ops if op in "MDN=X")
    if pos0 >= 0:
        bin_ = reg2bin(pos0, pos0 + max(ref_span, 1))
    else:
        bin_ = reg2bin(-1, 0)
    l_seq = len(seq)
    body = bytearray()
    body += struct.pack(
        "<iiBBHHHiiii",
        ref_id,
        pos0,
        len(qname) + 1,
        mapq,
        bin_,
        len(ops),
        flag,
        l_seq,
        next_ref_id,
        next_pos0,
        tlen,
    )
    body += qname + b"\x00"
    for n, op in ops:
        body += struct.pack("<I", (n << 4) | CIGAR_CODE[op])
    nib = bytearray((l_seq + 1) // 2)
    for i, c in enumerate(seq.decode()):
        v = SEQ_NIBBLE.get(c.upper(), 15)
        if i % 2 == 0:
            nib[i // 2] = v << 4
        else:
            nib[i // 2] |= v
    body += bytes(nib)
    body += bytes((q - 33) & 0xFF for q in qual) if qual else b""
    body += tags
    return struct.pack("<i", len(body)) + bytes(body)


def encode_tags(sam_tags: list[str]) -> bytes:
    """Encode 'TAG:TYPE:VALUE' SAM tag strings as BAM tag bytes."""
    out = bytearray()
    for t in sam_tags:
        tag, typ, val = t.split(":", 2)
        out += tag.encode()
        if typ == "i":
            v = int(val)
            # smallest-fit integer type, like the reference's BAM writer
            # (golden NM tags use 'C')
            if 0 <= v <= 0xFF:
                out += b"C" + struct.pack("<B", v)
            elif -128 <= v < 128:
                out += b"c" + struct.pack("<b", v)
            elif 0 <= v <= 0xFFFF:
                out += b"S" + struct.pack("<H", v)
            elif -32768 <= v < 32768:
                out += b"s" + struct.pack("<h", v)
            else:
                out += b"i" + struct.pack("<i", v)
        elif typ == "Z":
            out += b"Z" + val.encode() + b"\x00"
        elif typ == "A":
            out += b"A" + val.encode()[:1]
        else:
            raise ValueError(f"unsupported tag type {typ}")
    return bytes(out)


class BamWriter:
    """BAM output with optional .bai index construction."""

    def __init__(self, out, genome, header_text: str, build_index: bool = True):
        self.bgzf = BgzfWriter(out)
        contigs = sorted(genome.contigs, key=lambda c: c.original_index)
        self.ref_ids = {c.name: i for i, c in enumerate(contigs)}
        self.n_ref = len(contigs)
        hdr = header_text.encode()
        self.bgzf.write(b"BAM\x01" + struct.pack("<i", len(hdr)) + hdr)
        self.bgzf.write(struct.pack("<i", self.n_ref))
        for c in contigs:
            name = c.name.encode() + b"\x00"
            self.bgzf.write(struct.pack("<i", len(name)) + name)
            self.bgzf.write(struct.pack("<i", c.length))
        # .bai state
        self.build_index = build_index
        self.bins: list[dict[int, list[list[int]]]] = [
            {} for _ in range(self.n_ref)
        ]
        self.linear: list[dict[int, int]] = [{} for _ in range(self.n_ref)]
        self.n_unmapped = 0

    def write_record_bytes(
        self, rec: bytes, ref_id: int, pos0: int, ref_span: int
    ) -> None:
        vstart = self.bgzf.virtual_offset
        self.bgzf.write(rec)
        vend = self.bgzf.virtual_offset
        if ref_id < 0 or pos0 < 0:
            self.n_unmapped += 1
            return
        if not self.build_index:
            return
        b = reg2bin(pos0, pos0 + max(ref_span, 1))
        chunks = self.bins[ref_id].setdefault(b, [])
        if chunks and chunks[-1][1] == vstart:
            chunks[-1][1] = vend
        else:
            chunks.append([vstart, vend])
        for w in range(pos0 >> 14, (pos0 + max(ref_span, 1) - 1 >> 14) + 1):
            lin = self.linear[ref_id]
            if w not in lin or vstart < lin[w]:
                lin[w] = vstart

    def close(self, bai_path: str | None = None) -> None:
        self.bgzf.close()
        if self.build_index and bai_path:
            self._write_bai(bai_path)

    def _write_bai(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(b"BAI\x01" + struct.pack("<i", self.n_ref))
            for r in range(self.n_ref):
                f.write(struct.pack("<i", len(self.bins[r])))
                for b in sorted(self.bins[r]):
                    chunks = self.bins[r][b]
                    f.write(struct.pack("<Ii", b, len(chunks)))
                    for beg, end in chunks:
                        f.write(struct.pack("<QQ", beg, end))
                lin = self.linear[r]
                n_intv = (max(lin) + 1) if lin else 0
                f.write(struct.pack("<i", n_intv))
                last = 0
                for w in range(n_intv):
                    if w in lin:
                        last = lin[w]
                    f.write(struct.pack("<Q", last))


@dataclass
class BamRecord:
    qname: bytes
    flag: int
    ref_id: int
    pos0: int
    mapq: int
    cigar: str
    next_ref_id: int
    next_pos0: int
    tlen: int
    seq: bytes
    qual: bytes   # phred+33
    tags: bytes


def _parse_bam_record(body: bytes) -> BamRecord:
    (
        ref_id, pos0, l_qname, mapq, _bin, n_cigar, flag, l_seq,
        next_ref, next_pos, tlen,
    ) = struct.unpack_from("<iiBBHHHiiii", body, 0)
    off = 32
    qname = body[off : off + l_qname - 1]
    off += l_qname
    ops = []
    for _ in range(n_cigar):
        (v,) = struct.unpack_from("<I", body, off)
        ops.append(f"{v >> 4}{CIGAR_OPS[v & 0xF]}")
        off += 4
    cigar = "".join(ops) if ops else "*"
    nib = body[off : off + (l_seq + 1) // 2]
    off += (l_seq + 1) // 2
    seq = bytearray()
    for i in range(l_seq):
        v = nib[i // 2] >> 4 if i % 2 == 0 else nib[i // 2] & 0xF
        seq.append(ord(NIBBLE_SEQ[v]))
    qual_raw = body[off : off + l_seq]
    off += l_seq
    qual = bytes((q + 33) & 0xFF for q in qual_raw)
    return BamRecord(
        qname=bytes(qname), flag=flag, ref_id=ref_id, pos0=pos0,
        mapq=mapq, cigar=cigar, next_ref_id=next_ref,
        next_pos0=next_pos, tlen=tlen, seq=bytes(seq), qual=qual,
        tags=body[off:],
    )


def open_bam_stream(path: str):
    """Open a BAM for streaming: returns (header_text, ref_names,
    record iterator). Blocks decompress on demand through a rolling
    window, so memory stays bounded by the window, not the file
    (the reference's BGZF DataReader, Bam.h:93-398)."""
    from .bgzf import BgzfStreamReader

    r = BgzfStreamReader(path)
    magic = r.read(4)
    if magic != b"BAM\x01":
        raise ValueError("not a BAM file")
    (l_text,) = struct.unpack("<i", r.read(4))
    header_text = r.read(l_text).decode(errors="replace")
    (n_ref,) = struct.unpack("<i", r.read(4))
    ref_names = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", r.read(4))
        name = r.read(l_name)[:-1].decode()
        r.read(4)  # l_ref
        ref_names.append(name)

    def records():
        while not r.at_eof():
            head = r.read(4)
            if len(head) < 4:
                break
            (block_size,) = struct.unpack("<i", head)
            body = r.read(block_size)
            if len(body) < block_size:
                break
            yield _parse_bam_record(body)
        r.close()

    return header_text, ref_names, records()


def read_bam(path: str):
    """Parse a whole BAM file -> (header_text, ref_names, records)."""
    header_text, ref_names, it = open_bam_stream(path)
    return header_text, ref_names, list(it)
