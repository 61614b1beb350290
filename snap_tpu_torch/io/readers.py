"""Unified read supply: FASTQ / SAM / BAM inputs -> dense batches.

Behavioral reference: SNAP's reader stack (SAMReader SAM.h:56-156,
BAMReader Bam.h:93-398, SNAPFile input-type sniffing
AlignerOptions.h:60-72, PairedReadMatcher.cpp:44-95). Semantics kept:

- secondary (0x100) and supplementary (0x800) records are skipped;
- RC-flagged records are un-reverse-complemented so the aligner sees
  the read as sequenced;
- paired SAM/BAM streams are matched by QNAME with FIRST/LAST flags
  (PairedReadMatcher's id-hash pairing); by default, reads whose
  RNEXT/PNEXT say "no mate" are quickly dropped as probable
  single-end-aligned records, and -ku keeps them in the matcher
  (quicklyDropUnpairedReads, PairedReadMatcher.cpp:247-258); reads
  still unmatched at EOF are discarded with a warning either way
  (PairedReadMatcher.cpp:207-210);
- input type by extension: .sam / .bam / anything else = FASTQ
  (optionally .gz).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from ..constants import BASE_ENCODE
from .fastq import ReadBatch, paired_read_batches, read_batches
from .sam import COMPLEMENT

FLAG_PAIRED = 0x1
FLAG_UNMAPPED = 0x4
FLAG_RC = 0x10
FLAG_FIRST = 0x40
FLAG_LAST = 0x80
FLAG_SECONDARY = 0x100
FLAG_SUPPLEMENTARY = 0x800


def input_kind(path: str) -> str:
    p = path.lower()
    if p.endswith(".sam"):
        return "sam"
    if p.endswith(".bam"):
        return "bam"
    return "fastq"


def iter_sam_reads(
    path: str, keep_secondary: bool = False
) -> Iterator[tuple[bytes, bytes, bytes, int]]:
    """Yield (qname, seq, qual, flag) with orientation restored.
    keep_secondary = -sa (ignoreSecondaryAlignments off,
    AlignerOptions.cpp:592-594); supplementary records are always
    skipped like the reference SAMReader."""
    from .genericfile import open_generic

    def opener(p, mode):
        return open_generic(p, mode)

    skip = FLAG_SUPPLEMENTARY if keep_secondary else (
        FLAG_SECONDARY | FLAG_SUPPLEMENTARY
    )
    with opener(path, "rb") as f:
        for line in f:
            if line.startswith(b"@"):
                continue
            t = line.rstrip(b"\r\n").split(b"\t")
            if len(t) < 11:
                continue
            flag = int(t[1])
            if flag & skip:
                continue
            seq, qual = t[9], t[10]
            if flag & FLAG_RC:
                seq = seq.translate(COMPLEMENT)[::-1]
                qual = qual[::-1]
            has_mate_info = bool(flag & 0x8) or not (
                t[7] == b"0" or t[6] == b"*"
            )
            # input aux fields ride through to the output record
            # (SAM.cpp:1854-1875 puts them first after QUAL)
            aux = b"\t".join(t[11:]) if len(t) > 11 else b""
            yield t[0], seq, qual, flag, has_mate_info, aux


def iter_bam_reads(
    path: str, keep_secondary: bool = False
) -> Iterator[tuple[bytes, bytes, bytes, int]]:
    from .bam import open_bam_stream

    skip = FLAG_SUPPLEMENTARY if keep_secondary else (
        FLAG_SECONDARY | FLAG_SUPPLEMENTARY
    )
    _, _, records = open_bam_stream(path)
    for r in records:
        if r.flag & skip:
            continue
        seq, qual = r.seq, r.qual
        if r.flag & FLAG_RC:
            seq = seq.translate(COMPLEMENT)[::-1]
            qual = qual[::-1]
        has_mate_info = bool(r.flag & 0x8) or not (
            r.next_pos0 < 0 or r.next_ref_id < 0
        )
        # BAM aux is not translated (the reference SAMFormat warns
        # "BAM aux data not translated to SAM" and drops it)
        yield r.qname, seq, qual, r.flag, has_mate_info, b""


def _to_batch(
    records: list[tuple[bytes, bytes, bytes, bytes]], max_len: int
) -> ReadBatch:
    n = len(records)
    bases = np.full((n, max_len), 4, dtype=np.uint8)
    quals = np.zeros((n, max_len), dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int32)
    ids = []
    aux = []
    for i, (rid, seq, qual, ax) in enumerate(records):
        ids.append(rid)
        aux.append(ax)
        L = min(len(seq), max_len)
        lengths[i] = L
        bases[i, :L] = BASE_ENCODE[np.frombuffer(seq[:L], dtype=np.uint8)]
        quals[i, :L] = np.frombuffer(qual[:L], dtype=np.uint8)
    return ReadBatch(
        ids=ids, bases=bases, quals=quals, lengths=lengths,
        aux=aux if any(aux) else None,
    )


def single_batches(
    path: str, batch_size: int = 1024, max_len: int = 128,
    keep_secondary: bool = False,
    force_kind: str | None = None,     # -fastq / -compressedFastq
    force_gzip: bool = False,
) -> Iterator[ReadBatch]:
    kind = force_kind or input_kind(path)
    if kind == "fastq":
        yield from read_batches(
            path, batch_size, max_len, force_gzip=force_gzip
        )
        return
    it = (
        iter_sam_reads(path, keep_secondary)
        if kind == "sam"
        else iter_bam_reads(path, keep_secondary)
    )
    buf = []
    for qname, seq, qual, _flag, _mi, aux in it:
        buf.append((qname, seq, qual, aux))
        if len(buf) == batch_size:
            yield _to_batch(buf, max_len)
            buf = []
    if buf:
        yield _to_batch(buf, max_len)


def paired_batches(
    path1: str,
    path2: str | None,
    batch_size: int = 512,
    max_len: int = 128,
    keep_secondary: bool = False,
    force_kind: str | None = None,
    force_gzip: bool = False,
    keep_unpaired: bool = False,
) -> Iterator[tuple[ReadBatch, ReadBatch]]:
    kind = force_kind or input_kind(path1)
    if kind == "fastq":
        yield from paired_read_batches(
            path1, path2, batch_size, max_len, force_gzip=force_gzip
        )
        return
    # SAM/BAM single stream: match mates by qname (PairedReadMatcher)
    it = (
        iter_sam_reads(path1, keep_secondary)
        if kind == "sam"
        else iter_bam_reads(path1, keep_secondary)
    )
    pending: dict[bytes, tuple[bytes, bytes, int, bytes]] = {}
    buf1, buf2 = [], []
    quickly_dropped = 0
    for qname, seq, qual, flag, has_mate_info, aux in it:
        if not flag & FLAG_PAIRED:
            continue
        if not keep_unpaired and not has_mate_info:
            # quicklyDropUnpairedReads: no RNEXT/PNEXT -> probably from
            # a single-end alignment; -ku keeps them in the matcher
            quickly_dropped += 1
            continue
        key = qname.split()[0]
        if key in pending:
            oseq, oqual, oflag, oaux = pending.pop(key)
            if oflag & FLAG_FIRST:
                buf1.append((key, oseq, oqual, oaux))
                buf2.append((key, seq, qual, aux))
            else:
                buf1.append((key, seq, qual, aux))
                buf2.append((key, oseq, oqual, oaux))
            if len(buf1) == batch_size:
                yield _to_batch(buf1, max_len), _to_batch(buf2, max_len)
                buf1, buf2 = [], []
        else:
            pending[key] = (seq, qual, flag, aux)
    if buf1:
        yield _to_batch(buf1, max_len), _to_batch(buf2, max_len)
    from ..errors import write_error

    if pending:
        write_error(
            f" warning: PairedReadMatcher discarding {len(pending)} "
            "unpaired reads at eof\n"
        )
    if quickly_dropped:
        write_error(
            f" warning: PairedReadMatcher dropped {quickly_dropped} reads "
            "because they didn't have RNEXT and PNEXT filled in.\n"
            " If your input file was generated by a single-end alignment "
            "(or this seems too big), use the -ku flag\n"
        )


class ReadAheadQueue:
    """Bounded read-ahead supplier thread: the TPU-driver analogue of
    SNAP's ReadSupplierQueue + double-buffered async readers
    (ReadSupplierQueue.cpp, DataReader.cpp:1641 BufferedAsync). A
    daemon thread parses upcoming batches while the aligner works the
    current one; depth=2 double-buffers like the reference's
    two-buffer readers. The native FASTQ scanner releases the GIL in
    C, so parse genuinely overlaps host finalization/emission.
    """

    _DONE = object()

    def __init__(self, iterable, depth: int = 2):
        import queue
        import threading

        self._q = queue.Queue(maxsize=max(1, depth))
        self._it = iter(iterable)
        self._exc = None
        self._t = threading.Thread(
            target=self._run, name="read-ahead", daemon=True
        )
        self._t.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        except BaseException as e:  # surfaced on the consumer side
            self._exc = e
        finally:
            self._q.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item
