"""Uniform file abstraction: the GenericFile family.

Behavioral reference: SNAP's GenericFile hierarchy
(GenericFile.cpp:108 `GenericFile::open` factory, GenericFile_stdio,
GenericFile_Blob in-memory reads, GenericFile_map mmap with prefetch,
GenericFile_HDFS behind -DSNAP_HDFS). Loaders open every input through
the factory so index/genome files can come from local disk, an
in-memory blob, a memory map, or a registered remote scheme without
the callers caring.

TPU-first shape: the compute path never touches files — this layer
feeds the host-side loaders (FASTA/FASTQ/index). Remote schemes
register a handler (`register_scheme`); `http://`/`https://` ship by
default (stdlib urllib streaming reads — the cluster-filesystem
analogue of the reference's GenericFile_HDFS read path,
GenericFile_HDFS.cpp:160-238, which is likewise sequential-read-only),
while unknown schemes like `hdfs://` fail with an instructive error
instead of a stack trace, exactly like a non-HDFS reference build
("recompile with SNAP_HDFS").
"""

from __future__ import annotations

import gzip
import io
import mmap
import os
from typing import BinaryIO, Callable

_SCHEMES: dict[str, Callable[[str, str], BinaryIO]] = {}


def register_scheme(scheme: str, opener: Callable[[str, str], BinaryIO]):
    """Register `scheme://` support (the -DSNAP_HDFS analogue): opener
    receives (url, mode) and returns a binary file object."""
    _SCHEMES[scheme.lower()] = opener


def _scheme_of(path: str) -> str | None:
    i = path.find("://")
    if i <= 0:
        return None
    s = path[:i]
    return s.lower() if s.isalpha() else None


def _open_http(url: str, mode: str = "rb") -> BinaryIO:
    """Shipped remote handler: stream a GET response. Read-only and
    sequential, matching the reference HDFS handler's surface
    (GenericFile_HDFS.cpp: hdfsRead loop; no write path in SNAP's
    aligner inputs). The returned HTTPResponse is a BufferedIOBase:
    read/readinto/readline all work, so FASTA/FASTQ/SAM loaders
    consume it like any local stream."""
    if "r" not in mode or "+" in mode:
        raise IOError(f"{url}: http(s):// inputs are read-only")
    import urllib.request

    return urllib.request.urlopen(url)


_SCHEMES["http"] = _open_http
_SCHEMES["https"] = _open_http


class BlobFile(io.BytesIO):
    """GenericFile_Blob: read a file image already in memory (the
    reference uses it to parse hash tables out of a mapped index)."""

    def __init__(self, data: bytes | bytearray | memoryview):
        super().__init__(bytes(data))


def open_mapped(path: str) -> mmap.mmap:
    """GenericFile_map: read-only memory map (the reference maps index
    files and madvises; numpy loaders use np.load(mmap_mode) on top)."""
    with open(path, "rb") as f:
        return mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)


def open_generic(
    path: str, mode: str = "rb", *, gzipped: bool | None = None
) -> BinaryIO:
    """GenericFile::open — the one factory every loader goes through.

    - `scheme://...` dispatches to a registered handler;
    - `.gz` (or gzipped=True) wraps the stream in gzip;
    - plain paths open as buffered local files (GenericFile_stdio).
    """
    scheme = _scheme_of(path)
    if gzipped is None:
        gzipped = path.endswith(".gz")
    if scheme is not None and scheme != "file":
        opener = _SCHEMES.get(scheme)
        if opener is None:
            raise IOError(
                f"no handler registered for '{scheme}://' URLs; call "
                "snap_tpu_torch.io.genericfile.register_scheme() with a "
                "storage client (the reference gates HDFS the same "
                "way behind -DSNAP_HDFS)"
            )
        f = opener(path, mode)
        if gzipped and "r" in mode:
            f = gzip.GzipFile(fileobj=f, mode="rb")
        return f
    if scheme == "file":
        path = path[len("file://"):]
    if gzipped:
        if "r" not in mode:
            return gzip.open(path, mode)
        return gzip.open(path, "rb")
    return open(path, mode)


def exists_generic(path: str) -> bool:
    scheme = _scheme_of(path)
    if scheme is None or scheme == "file":
        if scheme == "file":
            path = path[len("file://"):]
        return os.path.exists(path)
    return scheme in _SCHEMES
