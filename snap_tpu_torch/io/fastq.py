"""FASTQ reading -> fixed-shape read batches (pure-Python scanner).

Counterpart of snap_tpu.io.fastq: reads are parsed into dense numpy
tensors [batch, max_len] ready for the host->device copy: base codes,
quality bytes, lengths, plus the id strings for SAM emission.
Plain and gzipped FASTQ, single-end.
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
    aux: list[bytes] | None = None

    def __len__(self) -> int:
        return len(self.ids)


def _open(path: str, force_gzip: bool = False):
    if path == "-":
        import sys

        raw = sys.stdin.buffer
        return gzip.GzipFile(fileobj=raw) if force_gzip else raw
    if "://" in path:
        from .genericfile import open_generic

        return open_generic(path, "rb", gzipped=force_gzip or None)
    if force_gzip or path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def iter_fastq_records(
    path: str, force_gzip: bool = False
) -> Iterator[tuple[bytes, bytes, bytes]]:
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


def read_batches(
    path: str, batch_size: int = 4096, max_len: int = 400,
    force_gzip: bool = False,
) -> Iterator[ReadBatch]:
    """Stream single-end batches. The final batch may be short."""
    buf: list[tuple[bytes, bytes, bytes]] = []
    for rec in iter_fastq_records(path, force_gzip):
        buf.append(rec)
        if len(buf) == batch_size:
            yield _to_batch(buf, max_len)
            buf = []
    if buf:
        yield _to_batch(buf, max_len)
