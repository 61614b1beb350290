"""ctypes bindings for the native host-I/O runtime (native/snapio.cpp).

The reference's I/O stack is C++ (FASTQ.cpp, GzipDataWriter.cpp with
ParallelCoworker compression threads, DataWriter.cpp); this module loads
the repo's equivalent shared library and exposes it to the Python
drivers. The port builds its own copy of the library from
native/snapio.cpp at first use, into snap_tpu_torch/build/ (the command
of native/Makefile); if that fails, callers take the pure-Python paths:
every entry point here has a Python twin. `USED` counts the calls that
went through the library and `BUILD_ERROR` holds why a build failed, so
a run can say which path it took.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.abspath(os.path.join(_PKG_DIR, "..", "native", "snapio.cpp"))
_BUILD_DIR = os.path.join(_PKG_DIR, "build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libsnapio.so")

_lock = threading.Lock()
_lib = None
_tried = False

USED = {"fastq_scanner": 0, "sam_formatter": 0, "sam_formatter_paired": 0,
        "ag_cigar_batch": 0}
BUILD_ERROR: str | None = None


def _fresh() -> bool:
    return os.path.exists(_LIB_PATH) and (
        not os.path.exists(_SRC)
        or os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC)
    )


def _build() -> bool:
    global BUILD_ERROR
    if not os.path.exists(_SRC):
        BUILD_ERROR = f"{_SRC} not found"
        return False
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = _LIB_PATH + f".tmp{os.getpid()}"
    cmd = [
        os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-Wall", "-std=c++17",
        "-shared", "-o", tmp, _SRC, "-lz", "-lpthread",
    ]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        BUILD_ERROR = f"{cmd[0]}: {e}"
        return False
    if out.returncode != 0:
        BUILD_ERROR = (out.stderr or out.stdout).strip()[-2000:]
        return False
    os.replace(tmp, _LIB_PATH)
    return True


def load():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _fresh() and not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None

        lib.snapio_parse_fastq.restype = ctypes.c_int64
        lib.snapio_parse_fastq.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.snapio_bgzf_compress.restype = ctypes.c_int64
        lib.snapio_bgzf_compress.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ]
        lib.snapio_bgzf_bound.restype = ctypes.c_int64
        lib.snapio_bgzf_bound.argtypes = [ctypes.c_int64]
        try:
            lib.snapio_ag_traceback.restype = ctypes.c_int32
            lib.snapio_ag_traceback.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
            ]
        except AttributeError:
            pass  # stale library without the traceback entry point
        try:
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.snapio_format_sam_simple.restype = ctypes.c_int64
            lib.snapio_format_sam_simple.argtypes = [
                u8p, u8p, ctypes.c_int64,            # bases, quals, stride
                u8p, i64p,                            # qname buf/off
                u8p, i64p,                            # rname buf/off
                i32p, ctypes.c_int64,                 # rows, n
                i32p, i32p, i64p,                     # flag, rname_id, pos
                i32p, i32p, i32p, i32p, i32p, i32p,   # mapq fs mlen bs nm rlen
                u8p, ctypes.c_int64,                  # tag_pg
                u8p, ctypes.c_int64,                  # tag_tail
                u8p, ctypes.c_int64, i64p,            # out, cap, rec_end
            ]
        except AttributeError:
            pass  # stale library without the SAM formatter
        try:
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.snapio_format_sam_paired.restype = ctypes.c_int64
            lib.snapio_format_sam_paired.argtypes = [
                u8p, u8p, ctypes.c_int64,            # bases, quals, stride
                u8p, i64p,                            # qname buf/off
                u8p, i64p,                            # rname buf/off
                i32p, ctypes.c_int64,                 # rows, n
                i32p, i32p, i64p,                     # flag, rname_id, pos
                i32p, i32p, i32p, i32p, i32p, i32p,   # mapq fs mlen bs nm rlen
                i64p, i64p, i32p,                     # pnext, tlen, qs
                u8p, ctypes.c_int64,                  # tag_pg
                u8p, ctypes.c_int64,                  # tag_tail
                u8p, ctypes.c_int64, i64p,            # out, cap, rec_end
            ]
        except AttributeError:
            pass  # stale library without the paired formatter
        try:
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.snapio_ag_cigar_batch.restype = ctypes.c_int64
            lib.snapio_ag_cigar_batch.argtypes = [
                u8p, ctypes.c_int64,                 # genome, glen
                u8p, u8p,                             # pat_buf, qual_buf
                i64p, i64p,                           # pat_off, locs
                i32p, i32p, i32p,                     # fclips bclips margins
                ctypes.c_int64,                       # n
                ctypes.c_int32, ctypes.c_int32,       # open, ext
                ctypes.c_int32, ctypes.c_int32,       # match, sub
                ctypes.c_int32,                       # use_m
                i64p, i32p,                           # out_loc, out_nm
                u8p, ctypes.c_int64, i64p,            # cigar buf/cap/end
            ]
        except AttributeError:
            pass  # stale library without the batched AG cigar
        _lib = lib
        return _lib


# reusable scratch for ag_traceback (called per escalated winner on the
# emission path — per-call np.empty/ctypes setup was measurable)
_AG_TB_CAP = 0
_AG_TB_OPS = None
_AG_TB_COUNTS = None
_AG_TB_USED = ctypes.c_int32(0)


def ag_traceback(text, pattern, open_cost, ext_cost, match_sc, sub_sc):
    """Native affine-gap DP + traceback; None if unavailable.

    Returns (runs, text_used) with runs = [[op, count], ...] in
    traceback order, matching agcigar.ag_global_alignment."""
    import numpy as np

    global _AG_TB_CAP, _AG_TB_OPS, _AG_TB_COUNTS
    lib = load()
    if lib is None or not hasattr(lib, "snapio_ag_traceback"):
        return None
    t = np.ascontiguousarray(text, dtype=np.uint8)
    p = np.ascontiguousarray(pattern, dtype=np.uint8)
    max_ops = int(len(t) + len(p) + 4)
    if max_ops > _AG_TB_CAP:
        _AG_TB_CAP = max(2 * max_ops, 4096)
        _AG_TB_OPS = np.empty(_AG_TB_CAP, dtype=np.uint8)
        _AG_TB_COUNTS = np.empty(_AG_TB_CAP, dtype=np.int32)
    ops, counts = _AG_TB_OPS, _AG_TB_COUNTS
    n = lib.snapio_ag_traceback(
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(t),
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(p),
        open_cost, ext_cost, match_sc, sub_sc,
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _AG_TB_CAP, ctypes.byref(_AG_TB_USED),
    )
    if n < 0:
        return None
    ot = ops[:n].tobytes()
    cl = counts[:n].tolist()
    runs = [[chr(ot[i]), cl[i]] for i in range(n)]
    return runs, int(_AG_TB_USED.value)


def available() -> bool:
    return load() is not None


def has_sam_formatter() -> bool:
    lib = load()
    return lib is not None and hasattr(lib, "snapio_format_sam_simple")


def has_paired_formatter() -> bool:
    lib = load()
    return lib is not None and hasattr(lib, "snapio_format_sam_paired")


def format_sam_paired(
    bases: np.ndarray,          # [2B, L] u8 base codes (stacked ends)
    quals: np.ndarray,          # [2B, L] u8 phred+33 bytes
    qname_buf: bytes,           # b"".join(per-row qnames)
    qname_off: np.ndarray,      # [2B+1] i64
    rname_buf: bytes,
    rname_off: np.ndarray,
    rows: np.ndarray,           # [n] i32 stacked-row index per record
    flag: np.ndarray,           # [n] i32 full pair flags
    rname_id: np.ndarray,
    pos: np.ndarray,            # [n] i64 1-based
    mapq: np.ndarray,
    fs: np.ndarray, mlen: np.ndarray, bs: np.ndarray,
    nm: np.ndarray, rlen: np.ndarray,
    pnext: np.ndarray,          # [n] i64 (RNEXT is always "=")
    tlen: np.ndarray,           # [n] i64
    qs: np.ndarray,             # [n] i32 mate quality sums (QS:i:)
    tag_pg: bytes, tag_tail: bytes,
) -> tuple[memoryview, np.ndarray] | None:
    """Format n simple paired SAM records in one native call; None when
    the native library (or this entry point) is unavailable."""
    lib = load()
    if lib is None or not hasattr(lib, "snapio_format_sam_paired"):
        return None
    n = len(rows)
    if n == 0:
        return memoryview(b""), np.zeros(0, dtype=np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    name_lens = qname_off[1:] - qname_off[:-1]
    cap = int(
        name_lens[rows].sum()
        + 2 * rlen.astype(np.int64).sum()
        + n * (128 + len(tag_pg) + len(tag_tail))
    )
    out = np.empty(cap, dtype=np.uint8)
    rec_end = np.empty(n, dtype=np.int64)
    bases = np.ascontiguousarray(bases)
    quals = np.ascontiguousarray(quals)
    args = [np.ascontiguousarray(a) for a in (
        qname_off, rows, flag, rname_id, pos, mapq, fs, mlen, bs, nm,
        rlen, pnext, tlen, qs,
    )]
    (qname_off, rows, flag, rname_id, pos, mapq, fs, mlen, bs, nm,
     rlen, pnext, tlen, qs) = args
    as_u8 = lambda b: ctypes.cast(ctypes.c_char_p(b), u8p)
    total = lib.snapio_format_sam_paired(
        bases.ctypes.data_as(u8p), quals.ctypes.data_as(u8p),
        bases.shape[1],
        as_u8(qname_buf), qname_off.ctypes.data_as(i64p),
        as_u8(rname_buf), rname_off.ctypes.data_as(i64p),
        rows.ctypes.data_as(i32p), n,
        flag.ctypes.data_as(i32p), rname_id.ctypes.data_as(i32p),
        pos.ctypes.data_as(i64p), mapq.ctypes.data_as(i32p),
        fs.ctypes.data_as(i32p), mlen.ctypes.data_as(i32p),
        bs.ctypes.data_as(i32p), nm.ctypes.data_as(i32p),
        rlen.ctypes.data_as(i32p),
        pnext.ctypes.data_as(i64p), tlen.ctypes.data_as(i64p),
        qs.ctypes.data_as(i32p),
        as_u8(tag_pg), len(tag_pg), as_u8(tag_tail), len(tag_tail),
        out.ctypes.data_as(u8p), cap,
        rec_end.ctypes.data_as(i64p),
    )
    if total < 0:
        return None
    USED["sam_formatter_paired"] += 1
    return memoryview(out.data)[:total], rec_end


def format_sam_simple(
    bases: np.ndarray,          # [B, L] u8 base codes (as sequenced)
    quals: np.ndarray,          # [B, L] u8 phred+33 bytes
    qname_buf: bytes,           # b"".join(ids)
    qname_off: np.ndarray,      # [B+1] i64
    rname_buf: bytes,           # b"".join(contig names)
    rname_off: np.ndarray,      # [n_contigs+1] i64
    rows: np.ndarray,           # [n] i32 batch-row index per record
    flag: np.ndarray,           # [n] i32 (0 or 16)
    rname_id: np.ndarray,       # [n] i32
    pos: np.ndarray,            # [n] i64 1-based
    mapq: np.ndarray,
    fs: np.ndarray, mlen: np.ndarray, bs: np.ndarray,
    nm: np.ndarray, rlen: np.ndarray,
    tag_pg: bytes, tag_tail: bytes,
) -> tuple[memoryview, np.ndarray] | None:
    """Format n simple SAM records in one native call.

    Returns (blob memoryview, rec_end cumulative offsets) so callers
    can slice per-record runs zero-copy; None if the native library
    (or this entry point) is unavailable.
    """
    lib = load()
    if lib is None or not hasattr(lib, "snapio_format_sam_simple"):
        return None
    n = len(rows)
    if n == 0:
        return memoryview(b""), np.zeros(0, dtype=np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    name_lens = qname_off[1:] - qname_off[:-1]
    cap = int(
        name_lens[rows].sum()
        + 2 * rlen.astype(np.int64).sum()
        + n * (96 + len(tag_pg) + len(tag_tail))
    )
    out = np.empty(cap, dtype=np.uint8)
    rec_end = np.empty(n, dtype=np.int64)
    # keep the contiguous copies alive through the call
    bases = np.ascontiguousarray(bases)
    quals = np.ascontiguousarray(quals)
    args = [np.ascontiguousarray(a) for a in (
        qname_off, rows, flag, rname_id, pos, mapq, fs, mlen, bs, nm, rlen
    )]
    qname_off, rows, flag, rname_id, pos, mapq, fs, mlen, bs, nm, rlen = args
    as_u8 = lambda b: ctypes.cast(ctypes.c_char_p(b), u8p)
    total = lib.snapio_format_sam_simple(
        bases.ctypes.data_as(u8p), quals.ctypes.data_as(u8p),
        bases.shape[1],
        as_u8(qname_buf), qname_off.ctypes.data_as(i64p),
        as_u8(rname_buf), rname_off.ctypes.data_as(i64p),
        rows.ctypes.data_as(i32p), n,
        flag.ctypes.data_as(i32p), rname_id.ctypes.data_as(i32p),
        pos.ctypes.data_as(i64p), mapq.ctypes.data_as(i32p),
        fs.ctypes.data_as(i32p), mlen.ctypes.data_as(i32p),
        bs.ctypes.data_as(i32p), nm.ctypes.data_as(i32p),
        rlen.ctypes.data_as(i32p),
        as_u8(tag_pg), len(tag_pg), as_u8(tag_tail), len(tag_tail),
        out.ctypes.data_as(u8p), cap,
        rec_end.ctypes.data_as(i64p),
    )
    if total < 0:
        return None
    USED["sam_formatter"] += 1
    return memoryview(out.data)[:total], rec_end


def parse_fastq_buffer(
    buf: bytes, max_reads: int, max_len: int
) -> tuple[int, np.ndarray, np.ndarray, np.ndarray, list[bytes], int]:
    """Parse complete FASTQ records from buf.

    Returns (n, bases [n,max_len], quals, lens, ids, consumed_bytes).
    Raises ValueError on malformed input.
    """
    lib = load()
    assert lib is not None
    bases = np.empty((max_reads, max_len), dtype=np.uint8)
    quals = np.empty((max_reads, max_len), dtype=np.uint8)
    lens = np.empty(max_reads, dtype=np.int32)
    id_off = np.empty(max_reads, dtype=np.int64)
    id_len = np.empty(max_reads, dtype=np.int64)
    consumed = ctypes.c_int64(0)
    n = lib.snapio_parse_fastq(
        buf, len(buf), max_reads, max_len,
        bases.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        quals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        id_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        id_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.byref(consumed),
    )
    if n < 0:
        raise ValueError("malformed FASTQ input (native parser)")
    USED["fastq_scanner"] += 1
    ids = [
        buf[int(id_off[i]) : int(id_off[i]) + int(id_len[i])]
        for i in range(n)
    ]
    return int(n), bases[:n], quals[:n], lens[:n], ids, int(consumed.value)


def bgzf_compress(
    data: bytes | np.ndarray,
    level: int = 6,
    n_threads: int | None = None,
    add_eof: bool = False,
) -> bytes:
    """Parallel BGZF compression (GzipDataWriter.cpp:233-340 equivalent)."""
    lib = load()
    assert lib is not None
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else data
    out = np.empty(int(lib.snapio_bgzf_bound(arr.size)), dtype=np.uint8)
    total = lib.snapio_bgzf_compress(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr.size,
        level, n_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        1 if add_eof else 0,
    )
    if total < 0:
        raise RuntimeError("native BGZF compression failed")
    return out[:total].tobytes()


def ag_cigar_batch(
    genome: np.ndarray,          # [G] u8 base codes
    pat_buf: np.ndarray,         # concatenated oriented body codes (u8)
    qual_buf: np.ndarray,        # concatenated quality bytes (u8)
    pat_off: np.ndarray,         # [n+1] i64
    locs: np.ndarray,            # [n] i64 starting body locations
    fclips: np.ndarray,          # [n] i32
    bclips: np.ndarray,          # [n] i32
    margins: np.ndarray,         # [n] i32 text margin per row
    open_cost: int, ext_cost: int, match_sc: int, sub_sc: int,
    use_m: bool = True,
):
    """Batched writer-side AG CIGARs (snapio_ag_cigar_batch).

    Returns (out_loc [n] i64 with -1 = failed row, out_nm [n] i32,
    cigars list[str]) or None when the native library is unavailable.
    """
    lib = load()
    if lib is None or not hasattr(lib, "snapio_ag_cigar_batch"):
        return None
    n = len(locs)
    if n == 0:
        return (
            np.empty(0, np.int64), np.empty(0, np.int32), [],
        )
    g = np.ascontiguousarray(genome, dtype=np.uint8)
    pb = np.ascontiguousarray(pat_buf, dtype=np.uint8)
    qb = np.ascontiguousarray(qual_buf, dtype=np.uint8)
    po = np.ascontiguousarray(pat_off, dtype=np.int64)
    lo = np.ascontiguousarray(locs, dtype=np.int64)
    fc = np.ascontiguousarray(fclips, dtype=np.int32)
    bc = np.ascontiguousarray(bclips, dtype=np.int32)
    mg = np.ascontiguousarray(margins, dtype=np.int32)
    out_loc = np.empty(n, np.int64)
    out_nm = np.empty(n, np.int32)
    cend = np.empty(n, np.int64)
    cap = max(4096, 64 * n)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    while True:
        buf = np.empty(cap, np.uint8)
        rc = lib.snapio_ag_cigar_batch(
            g.ctypes.data_as(u8p), len(g),
            pb.ctypes.data_as(u8p), qb.ctypes.data_as(u8p),
            po.ctypes.data_as(i64p), lo.ctypes.data_as(i64p),
            fc.ctypes.data_as(i32p), bc.ctypes.data_as(i32p),
            mg.ctypes.data_as(i32p), n,
            open_cost, ext_cost, match_sc, sub_sc,
            1 if use_m else 0,
            out_loc.ctypes.data_as(i64p), out_nm.ctypes.data_as(i32p),
            buf.ctypes.data_as(u8p), cap, cend.ctypes.data_as(i64p),
        )
        if rc == -2:
            cap *= 4
            continue
        if rc != n:
            return None
        break
    USED["ag_cigar_batch"] += 1
    blob = buf.tobytes()
    cigars = []
    prev = 0
    for i in range(n):
        e = int(cend[i])
        cigars.append(blob[prev:e].decode())
        prev = e
    return out_loc, out_nm, cigars
