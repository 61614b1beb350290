"""The window's plumbing, run as a child process of the benchmark so that
none of its work runs beside the port in the benchmark's own process:

  python3 plumb.py <pool FASTQ> <batch bytes> <batches> <FASTQ pipe> \
      <SAM pipe> <judged .npy> <result file>

Once it has loaded its inputs it prints "ready" and opens the pipes. A
thread writes `batches` whole batches of the pool file (`batch bytes`
each, cycling through the file) into the FASTQ pipe and closes it, and
the main thread reads the SAM pipe in large chunks: it counts the
records and keeps the lines of the judged records (record i is read i
of the window). The result file holds the count on its first line, then
one line per kept record: its number, a tab, the record.
"""

from __future__ import annotations

import os
import sys
import threading

import numpy as np

CHUNK = 1 << 20


def feed(data: bytes, batch_bytes: int, batches: int, fifo: str, errors: list) -> None:
    try:
        per_pool = len(data) // batch_bytes
        view = memoryview(data)
        fd = os.open(fifo, os.O_WRONLY)
        try:
            for i in range(batches):
                k = i % per_pool
                out = view[k * batch_bytes : (k + 1) * batch_bytes]
                while out:
                    out = out[os.write(fd, out[:CHUNK]) :]
        finally:
            os.close(fd)
    except BaseException as e:  # reported by main()
        errors.append(e)


class Tap:
    """Counts the records of a SAM stream and keeps those numbered in
    `judged` (sorted)."""

    def __init__(self, judged: np.ndarray):
        self.judged = judged
        self.records = 0
        self.kept: dict[int, bytes] = {}

    def take(self, buf: bytes) -> None:
        n = buf.count(b"\n")
        r0 = self.records
        self.records += n
        lo, hi = np.searchsorted(self.judged, [r0, r0 + n])
        if lo == hi:
            return
        ends = np.flatnonzero(np.frombuffer(buf, np.uint8) == 10)
        starts = np.concatenate(([0], ends[:-1] + 1))
        for r in self.judged[lo:hi].tolist():
            j = r - r0
            self.kept[r] = buf[starts[j] : ends[j]]

    def run(self, fifo: str) -> None:
        with open(fifo, "rb", buffering=0) as f:
            tail, in_header = b"", True
            while True:
                chunk = f.read(CHUNK)
                if not chunk:
                    break
                buf = tail + chunk
                cut = buf.rfind(b"\n") + 1
                buf, tail = buf[:cut], buf[cut:]
                while in_header and buf.startswith(b"@"):
                    nl = buf.find(b"\n")
                    buf = buf[nl + 1 :]
                if buf:
                    in_header = False
                    self.take(buf)
            if tail:
                self.take(tail + b"\n")


def main(argv) -> int:
    pool, batch_bytes, batches, fq, sam, judged, result = argv
    errors: list[BaseException] = []
    with open(pool, "rb") as f:
        data = f.read()
    tap = Tap(np.load(judged))
    print("ready", flush=True)
    t = threading.Thread(target=feed, args=(data, int(batch_bytes), int(batches), fq, errors))
    t.start()
    tap.run(sam)
    t.join()
    if errors:
        raise errors[0]
    with open(result + ".tmp", "wb") as f:
        f.write(b"%d\n" % tap.records)
        for r, line in sorted(tap.kept.items()):
            f.write(b"%d\t%s\n" % (r, line))
    os.replace(result + ".tmp", result)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
