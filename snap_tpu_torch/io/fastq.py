"""FASTQ reading -> fixed-shape read batches.

Behavioral reference: SNAP's FASTQ.{h,cpp} (FASTQReader) and Read.h
(quality clipping). Instead of SNAP's per-read pointer batches with
refcounted buffers, reads are parsed into dense numpy tensors
[batch, max_len] ready for H2D transfer: base codes, quality bytes,
lengths, plus the id/comment strings host-side for SAM emission.

Supports plain and gzipped FASTQ, single-end, two-file paired, and
interleaved paired (ref: FASTQ.h:37,94,133).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..constants import BASE_ENCODE


@dataclass
class ReadBatch:
    """A dense batch of reads. Arrays are padded to [n, max_len]."""

    ids: list[bytes]          # full id lines (without '@', with comment)
    bases: np.ndarray         # [n, L] uint8 codes (pad = 4/N beyond length)
    quals: np.ndarray         # [n, L] uint8 raw phred+33 bytes (pad = 0)
    lengths: np.ndarray       # [n] int32
    # SAM-input aux tags per read (b"" when none): passed through to the
    # output record ahead of our own tags (SAM.cpp:1854-1875). None for
    # FASTQ/BAM inputs (BAM aux is not translated, like the reference).
    aux: list[bytes] | None = None

    def __len__(self) -> int:
        return len(self.ids)


def _open(path: str, force_gzip: bool = False):
    if path == "-":
        import sys

        raw = sys.stdin.buffer
        return gzip.GzipFile(fileobj=raw) if force_gzip else raw
    if "://" in path:
        # remote inputs (http(s)://, registered schemes) go through the
        # GenericFile factory, which also applies the gzip wrap
        from .genericfile import open_generic

        return open_generic(path, "rb", gzipped=force_gzip or None)
    if force_gzip or path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def iter_fastq_records(path: str, force_gzip: bool = False) -> Iterator[tuple[bytes, bytes, bytes]]:
    """Yield (id_line, seq, qual) byte tuples."""
    with _open(path, force_gzip) as f:
        while True:
            id_line = f.readline()
            if not id_line:
                return
            id_line = id_line.rstrip(b"\r\n")
            if not id_line:
                continue
            if not id_line.startswith(b"@"):
                raise ValueError(f"malformed FASTQ id line: {id_line[:80]!r}")
            seq = f.readline().rstrip(b"\r\n")
            plus = f.readline()
            if not plus.startswith(b"+"):
                raise ValueError("malformed FASTQ: expected '+' line")
            qual = f.readline().rstrip(b"\r\n")
            if len(seq) != len(qual):
                raise ValueError("FASTQ seq/qual length mismatch")
            yield id_line[1:], seq, qual


def _to_batch(records: list[tuple[bytes, bytes, bytes]], max_len: int) -> ReadBatch:
    n = len(records)
    bases = np.full((n, max_len), 4, dtype=np.uint8)  # N-pad
    quals = np.zeros((n, max_len), dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int32)
    ids = []
    for i, (rid, seq, qual) in enumerate(records):
        ids.append(rid)
        L = min(len(seq), max_len)
        lengths[i] = L
        arr = np.frombuffer(seq[:L], dtype=np.uint8)
        bases[i, :L] = BASE_ENCODE[arr]
        quals[i, :L] = np.frombuffer(qual[:L], dtype=np.uint8)
    return ReadBatch(ids=ids, bases=bases, quals=quals, lengths=lengths)


def _native_read_batches(
    path: str, batch_size: int, max_len: int, force_gzip: bool = False
) -> Iterator[ReadBatch]:
    """Batch scan via the native runtime (native/snapio.cpp), the
    equivalent of SNAP's C++ FASTQReader hot loop."""
    from . import native

    CHUNK = 8 << 20
    with _open(path, force_gzip) as f:
        buf = b""
        eof = False
        while True:
            while not eof and len(buf) < CHUNK:
                chunk = f.read(CHUNK)
                if not chunk:
                    eof = True
                    break
                buf += chunk
            if not buf:
                return
            n, bases, quals, lens, ids, consumed = native.parse_fastq_buffer(
                buf, batch_size, max_len
            )
            if n < batch_size and not eof:
                # grow the buffer so mid-stream batches stay full-size
                more = f.read(CHUNK)
                if more:
                    buf += more
                    continue
                eof = True
            if n == 0:
                if buf.strip():
                    raise ValueError("truncated final FASTQ record")
                return
            yield ReadBatch(ids=ids, bases=bases, quals=quals, lengths=lens)
            buf = buf[consumed:]


def read_batches(
    path: str, batch_size: int = 4096, max_len: int = 400,
    force_gzip: bool = False,
) -> Iterator[ReadBatch]:
    """Stream single-end batches. The final batch may be short."""
    from . import native

    if native.available():
        yield from _native_read_batches(path, batch_size, max_len, force_gzip)
        return
    buf: list[tuple[bytes, bytes, bytes]] = []
    for rec in iter_fastq_records(path, force_gzip):
        buf.append(rec)
        if len(buf) == batch_size:
            yield _to_batch(buf, max_len)
            buf = []
    if buf:
        yield _to_batch(buf, max_len)


def paired_read_batches(
    path1: str,
    path2: str | None = None,
    batch_size: int = 4096,
    max_len: int = 400,
    force_gzip: bool = False,
) -> Iterator[tuple[ReadBatch, ReadBatch]]:
    """Paired batches: two files, or one interleaved file (path2=None)."""
    buf1: list[tuple[bytes, bytes, bytes]] = []
    buf2: list[tuple[bytes, bytes, bytes]] = []

    def flush():
        return _to_batch(buf1, max_len), _to_batch(buf2, max_len)

    if path2 is None:
        it = iter_fastq_records(path1, force_gzip)
        for rec1 in it:
            try:
                rec2 = next(it)
            except StopIteration:
                raise ValueError("interleaved FASTQ has odd record count")
            buf1.append(rec1)
            buf2.append(rec2)
            if len(buf1) == batch_size:
                yield flush()
                buf1, buf2 = [], []
    else:
        for rec1, rec2 in zip(
            iter_fastq_records(path1, force_gzip),
            iter_fastq_records(path2, force_gzip), strict=True
        ):
            buf1.append(rec1)
            buf2.append(rec2)
            if len(buf1) == batch_size:
                yield flush()
                buf1, buf2 = [], []
    if buf1:
        yield flush()
