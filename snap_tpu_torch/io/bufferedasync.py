"""Double-buffered async byte streams: the BufferedAsync analogue.

Behavioral reference: SNAP's BufferedAsyncReader/Writer
(BufferedAsync.h:1-66) — two buffers per stream, one owned by the
caller being filled/drained while the other is in flight on an
AsyncFile, with a blocking handoff when the caller catches up. SNAP
uses them under the sort and BAM paths so disk latency overlaps
compute (DataWriter.h:36-139 multi-buffer writers are the same idea
wider).

TPU-first shape: device compute never blocks on the filesystem — these
wrap the *host* ends of the pipeline (SAM/BAM emission, sort spill,
FASTQ read-ahead). Python threads are the right tool because every
hot call here (file.write, file.read, zlib) releases the GIL; `depth`
buffers in flight generalizes SNAP's two.
"""

from __future__ import annotations

import queue
import threading


class BufferedAsyncWriter:
    """File-like append sink whose physical writes happen on a worker
    thread. `write()` copies into the current buffer and only blocks
    when `depth` full buffers are already in flight (the reference
    blocks on the previous buffer's AsyncFile completion the same way,
    BufferedAsync.h:40-66)."""

    def __init__(self, out, buffer_size: int = 1 << 22, depth: int = 2):
        self.out = out
        self.buffer_size = buffer_size
        self._buf = bytearray()
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth - 1))
        self._exc: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        self._closed = False

    def _run(self):
        while True:
            chunk = self._q.get()
            try:
                if chunk is None:
                    return
                if self._exc is None:
                    self.out.write(chunk)
            except BaseException as e:  # surfaced on the next write/close
                self._exc = e
            finally:
                self._q.task_done()

    def _raise_pending(self):
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def write(self, data) -> int:
        self._raise_pending()
        self._buf += data
        if len(self._buf) >= self.buffer_size:
            self._q.put(bytes(self._buf))
            self._buf.clear()
        return len(data)

    def flush(self) -> None:
        """Drain both buffers through to the underlying stream."""
        self._raise_pending()
        if self._buf:
            self._q.put(bytes(self._buf))
            self._buf.clear()
        self._q.join()
        self._raise_pending()
        if hasattr(self.out, "flush"):
            self.out.flush()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self.flush()
        finally:
            self._q.put(None)
            self._thread.join()
        self._raise_pending()


class BufferedAsyncReader:
    """Read-ahead chunk iterator: a worker thread keeps up to `depth`
    chunks decoded/read ahead of the consumer (BufferedAsync.h reader
    half; ReadSupplierQueue.h:31-76 is the record-level big sibling,
    implemented separately in io.readers.ReadAheadQueue)."""

    def __init__(self, f, chunk_size: int = 1 << 22, depth: int = 2):
        self.f = f
        self.chunk_size = chunk_size
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._exc: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        self._leftover = b""
        self._done = False

    def _run(self):
        try:
            while True:
                chunk = self.f.read(self.chunk_size)
                if not chunk:
                    break
                self._q.put(chunk)
        except BaseException as e:
            self._exc = e
        finally:
            self._q.put(b"")

    def chunks(self):
        """Yield raw chunks until EOF."""
        while True:
            c = self._q.get()
            if not c:
                if self._exc is not None:
                    raise self._exc
                return
            yield c

    def read(self, n: int = -1) -> bytes:
        """Sequential read() over the prefetched stream."""
        if n < 0:
            parts = [self._leftover]
            self._leftover = b""
            parts.extend(self.chunks())
            return b"".join(parts)
        while len(self._leftover) < n and not self._done:
            c = self._q.get()
            if not c:
                self._done = True
                if self._exc is not None:
                    raise self._exc
                break
            self._leftover += c
        out, self._leftover = self._leftover[:n], self._leftover[n:]
        return out
