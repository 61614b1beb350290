"""Input range splitting + parallel FASTQ parse.

Behavioral reference: SNAP's RangeSplitter (RangeSplitter.h:38) hands
each aligner thread a byte range of the input, and FASTQReader snaps a
range start forward to the next record boundary (FASTQ.cpp, the
"look for a line starting '@' whose +2 line starts '+'" scan — '@' is
ambiguous because quality strings may begin with it).

TPU-first shape: alignment parallelism lives on the device mesh, so
ranges feed PARSER threads instead of aligner threads — each worker
runs the native GIL-releasing FASTQ scanner over its range and the
consumer drains batches in range order, preserving the single-reader
output ordering (record emission order == input order).

Plain (uncompressed) FASTQ only: gzip streams are not
random-access-splittable, so .gz inputs keep the single scanner
thread (the reference splits only plain files too — compressed input
goes through the DataSupplier's single decompressor).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator

from .fastq import ReadBatch, _native_read_batches, read_batches


def _snap_to_record_start(f, pos: int, limit: int) -> int:
    """First FASTQ record boundary at or after pos (< limit), using the
    reference's disambiguation: a line starting '@' begins a record iff
    the line two below starts '+' (FASTQ.cpp record-start scan)."""
    if pos == 0:
        return 0
    f.seek(pos)
    f.readline()  # discard the (possibly partial) current line
    while True:
        cand = f.tell()
        if cand >= limit:
            return limit
        line = f.readline()
        if not line:
            return limit
        if line.startswith(b"@"):
            save = f.tell()
            f.readline()  # sequence
            plus = f.readline()
            if plus.startswith(b"+"):
                return cand
            f.seek(save)


def split_fastq_ranges(path: str, n_ranges: int) -> list[tuple[int, int]]:
    """Split a plain FASTQ into record-aligned byte ranges."""
    size = os.path.getsize(path)
    if n_ranges <= 1 or size == 0:
        return [(0, size)]
    cuts = [0]
    with open(path, "rb") as f:
        for i in range(1, n_ranges):
            target = size * i // n_ranges
            b = _snap_to_record_start(f, target, size)
            if b > cuts[-1]:
                cuts.append(b)
    cuts.append(size)
    return [(cuts[i], cuts[i + 1]) for i in range(len(cuts) - 1)]


def _range_batches(
    path: str, start: int, end: int, batch_size: int, max_len: int
) -> Iterator[ReadBatch]:
    """Parse the records whose first byte lies in [start, end)."""
    from . import native

    CHUNK = 8 << 20
    with open(path, "rb") as f:
        f.seek(start)
        remaining = end - start
        buf = b""
        eof = False
        while True:
            while not eof and len(buf) < CHUNK:
                take = min(CHUNK, remaining)
                chunk = f.read(take) if take > 0 else b""
                if not chunk:
                    eof = True
                    break
                remaining -= len(chunk)
                buf += chunk
            if not buf:
                return
            n, bases, quals, lens, ids, consumed = (
                native.parse_fastq_buffer(buf, batch_size, max_len)
            )
            if n < batch_size and not eof:
                take = min(CHUNK, remaining)
                more = f.read(take) if take > 0 else b""
                if more:
                    remaining -= len(more)
                    buf += more
                    continue
                eof = True
            if n == 0:
                if buf.strip():
                    if remaining <= 0 and end < os.path.getsize(path):
                        # final record of the range spills past `end`:
                        # it belongs to this range (its '@' is inside),
                        # so pull its tail from beyond the boundary and
                        # parse exactly ONE record (the rest of the
                        # tail belongs to the next range)
                        tail = f.read(CHUNK)
                        if tail:
                            buf += tail
                            n2, bases, quals, lens, ids, _ = (
                                native.parse_fastq_buffer(buf, 1, max_len)
                            )
                            if n2 == 1:
                                yield ReadBatch(
                                    ids=ids, bases=bases,
                                    quals=quals, lengths=lens,
                                )
                                return
                    raise ValueError("truncated FASTQ record in range")
                return
            yield ReadBatch(ids=ids, bases=bases, quals=quals, lengths=lens)
            buf = buf[consumed:]


def parallel_read_batches(
    path: str,
    batch_size: int = 4096,
    max_len: int = 400,
    threads: int = 2,
    depth: int = 2,
) -> Iterator[ReadBatch]:
    """N parser threads over record-aligned ranges, drained in range
    order (output order stays exactly the single-reader order)."""
    from . import native

    if (
        threads <= 1
        or not native.available()
        or path.endswith(".gz")
        or not os.path.isfile(path)
    ):
        yield from read_batches(path, batch_size, max_len)
        return
    ranges = split_fastq_ranges(path, threads)
    qs = [queue.Queue(maxsize=depth) for _ in ranges]
    DONE = object()

    def worker(rg, q):
        try:
            for b in _range_batches(path, rg[0], rg[1], batch_size, max_len):
                q.put(b)
            q.put(DONE)
        except BaseException as e:
            q.put(e)

    ts = [
        threading.Thread(target=worker, args=(rg, q), daemon=True)
        for rg, q in zip(ranges, qs)
    ]
    for t in ts:
        t.start()
    for q in qs:
        while True:
            item = q.get()
            if item is DONE:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
