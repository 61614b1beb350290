"""BGZF (blocked gzip) writer/reader.

Behavioral reference: SNAP's GzipDataWriter in BAM mode
(GzipDataWriter.cpp:242-340): 64KB-max blocks, each a gzip member with
the BC extra field carrying BSIZE (total block size - 1), and the
standard 28-byte BGZF EOF marker. SNAP parallelizes compression across
ParallelCoworker threads; here compression is chunk-batched so a native
or multi-process backend can slot in behind the same interface.
"""

from __future__ import annotations

import struct
import zlib

BGZF_BLOCK = 0xFF00  # max uncompressed payload per block (SNAP BAM_BLOCK ~64KB)
EOF_MARKER = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def compress_block(data: bytes, level: int = 6) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    payload = c.compress(data) + c.flush()
    bsize = len(payload) + 25 + 1
    if bsize > 0xFFFF:
        raise ValueError("BGZF block too large after compression")
    header = (
        b"\x1f\x8b\x08\x04"      # gzip magic, deflate, FEXTRA
        + b"\x00\x00\x00\x00"    # mtime
        + b"\x00\xff"            # XFL, OS
        + b"\x06\x00"            # XLEN=6
        + b"BC\x02\x00"          # extra subfield id, len 2
        + struct.pack("<H", bsize - 1)
    )
    footer = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))
    return header + payload + footer


class BgzfWriter:
    """Buffered BGZF stream with virtual-offset tracking (for .bai)."""

    def __init__(self, out, level: int = 6):
        self.out = out
        self.level = level
        self._buf = bytearray()
        self._coffset = 0  # compressed bytes written so far

    @property
    def virtual_offset(self) -> int:
        """coffset << 16 | uoffset within the current block."""
        return (self._coffset << 16) | len(self._buf)

    def write(self, data: bytes) -> None:
        self._buf.extend(data)
        nfull = len(self._buf) // BGZF_BLOCK
        if nfull >= 2:
            from . import native

            if native.available():
                # parallel multi-block compression (the native equivalent
                # of GzipDataWriter's ParallelCoworker threads)
                chunk = bytes(self._buf[: nfull * BGZF_BLOCK])
                del self._buf[: nfull * BGZF_BLOCK]
                comp = native.bgzf_compress(chunk, self.level)
                self.out.write(comp)
                self._coffset += len(comp)
                return
        while len(self._buf) >= BGZF_BLOCK:
            self._flush_block(BGZF_BLOCK)

    def _flush_block(self, n: int) -> None:
        chunk = bytes(self._buf[:n])
        del self._buf[:n]
        block = compress_block(chunk, self.level)
        self.out.write(block)
        self._coffset += len(block)

    def close(self) -> None:
        if self._buf:
            self._flush_block(len(self._buf))
        self.out.write(EOF_MARKER)
        self._coffset += len(EOF_MARKER)


def decompress_all(data: bytes) -> bytes:
    """Decompress a whole BGZF byte string (for readers/tests)."""
    out = bytearray()
    pos = 0
    while pos < len(data):
        if data[pos : pos + 2] != b"\x1f\x8b":
            raise ValueError(f"bad gzip magic at {pos}")
        xlen = struct.unpack_from("<H", data, pos + 10)[0]
        extra = data[pos + 12 : pos + 12 + xlen]
        bsize = None
        e = 0
        while e < len(extra):
            sid, slen = extra[e : e + 2], struct.unpack_from("<H", extra, e + 2)[0]
            if sid == b"BC":
                bsize = struct.unpack_from("<H", extra, e + 4)[0] + 1
            e += 4 + slen
        if bsize is None:
            raise ValueError("missing BGZF BC field")
        payload = data[pos + 12 + xlen : pos + bsize - 8]
        out.extend(zlib.decompress(payload, -15))
        pos += bsize
    return bytes(out)


class BgzfReader:
    """Simple whole-file BGZF reader."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.data = decompress_all(f.read())
        self.pos = 0

    def read(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b


class BgzfStreamReader:
    """Streaming BGZF reader: decompresses block-by-block on demand,
    holding only a rolling window (the bounded-memory analogue of the
    reference's BGZF-decompressing DataReader, DataReader.cpp:2209)."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._buf = bytearray()
        self._off = 0           # consumed bytes within _buf
        self._eof = False

    def _fill(self, need: int) -> None:
        while len(self._buf) - self._off < need and not self._eof:
            hdr = self._f.read(12)
            if len(hdr) < 12:
                self._eof = True
                break
            if hdr[:2] != b"\x1f\x8b":
                raise ValueError("bad gzip magic in BGZF stream")
            (xlen,) = struct.unpack_from("<H", hdr, 10)
            extra = self._f.read(xlen)
            bsize = None
            e = 0
            while e < len(extra):
                sid = extra[e : e + 2]
                (slen,) = struct.unpack_from("<H", extra, e + 2)
                if sid == b"BC":
                    (bs,) = struct.unpack_from("<H", extra, e + 4)
                    bsize = bs + 1
                e += 4 + slen
            if bsize is None:
                raise ValueError("missing BGZF BC field")
            body = self._f.read(bsize - 12 - xlen)
            payload = body[:-8]
            self._buf.extend(zlib.decompress(payload, -15))
            # drop consumed prefix so memory stays bounded
            if self._off > (1 << 20):
                del self._buf[: self._off]
                self._off = 0

    def read(self, n: int) -> bytes:
        self._fill(n)
        b = bytes(self._buf[self._off : self._off + n])
        self._off += len(b)
        return b

    def at_eof(self) -> bool:
        self._fill(1)
        return self._off >= len(self._buf) and self._eof

    def close(self) -> None:
        self._f.close()
