"""The emission-time affine-gap alignment of a batch of rows on the card
(csrc/agcigar.cu), its plain PyTorch version, and the host's one call
around them.

Each row aligns a pattern (a read's oriented body) globally against T
bases of the genome from `loc`, as native/snapio.cpp ag_tb_core does one
row at a time on the host: the answer is the run-length ops in traceback
order and the text rows used, bit for bit. A row is a line of `meta`
[n, 4] int64: (offset of its pattern in the pattern buffer, L, loc, T).
The result is int32 [n, R]: (runs, text rows used, then each run as
count << 2 | code, code 0 M, 1 D, 2 I, then zeros); runs -1 for an
empty row.

CUDA tensors launch the kernel; CPU tensors run the plain version.
`fits(T, L)`: whether a row's traceback plane fits in one block's shared
memory; the other rows run the kernel's global-plane case, their planes
in a scratch buffer of at most SCRATCH_BYTES (or one row's plane).
`ag_traceback_rows` is the host's one call: numpy in, numpy out, on a
stream of its own.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from ..stats import RECORDER
from . import _build

HEADER = 2              # csrc/agcigar.cu kHeader
MAX_SMEM = 232_448      # csrc/agcigar.cu kMaxSmem
LANE_COLS = (1, 2, 3, 4, 6, 8, 12, 16)   # csrc/agcigar.cu SNAP_AG_CASE
GLOBAL_COLS = 16        # csrc/agcigar.cu kGlobalCols: the global plane's C
SCRATCH_BYTES = 256 << 20   # the global planes of one launch, at most
NEG = -10_000_000       # ag_tb_core's NEG
OPS = "MDI"             # run codes 0, 1, 2

KERNEL = _build.Kernel(
    "agcigar", "ag_traceback_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 9 + [ctypes.c_void_p],
)


def lane_cols(L: int) -> int | None:
    """Columns a lane of the kernel's case for L pattern columns, or
    None past the widest case."""
    need = -(-L // 32)
    return next((c for c in LANE_COLS if c >= need), None)


def smem_bytes(T: int, C: int) -> int:
    """Shared memory of a launch whose longest text is T at C columns a
    lane: the text, then a T x 32C plane of traceback bytes."""
    return ((T + 15) & ~15) + T * 32 * C


def fits(T: int, L: int) -> bool:
    """Whether the row's plane fits in shared memory."""
    C = lane_cols(L)
    return C is not None and smem_bytes(T, C) <= MAX_SMEM


def slot_bytes(T: int, L: int) -> int:
    """A global-plane row's slot: the stripes' hand-over words (csrc
    handover_bytes), then a T x P plane, P = L rounded up to stripes of
    32 GLOBAL_COLS columns."""
    S = 32 * GLOBAL_COLS
    return ((16 * T + 15) & ~15) + T * (-(-L // S) * S)


def case_of(T: int, L: int) -> int:
    """The row's launch case: its lane columns where its plane fits in
    shared memory, else 0 (the global plane)."""
    return lane_cols(L) if fits(T, L) else 0


GLOBAL_KEY = 1 << 30   # the global plane's rows' order key: last


def _order_keys(meta: np.ndarray) -> np.ndarray:
    """case_of of each row of numpy `meta`, GLOBAL_KEY for 0: the rows'
    launch order."""
    L, T = meta[:, 1], meta[:, 3]
    cases = np.asarray(LANE_COLS)
    at = np.searchsorted(cases, -(-L // 32))   # the first case of at least ceil(L / 32)
    C = cases[np.minimum(at, len(cases) - 1)]
    shared = (at < len(cases)) & (((T + 15) & ~15) + T * 32 * C <= MAX_SMEM)
    return np.where(shared, C, GLOBAL_KEY)


def launch_plan(meta: np.ndarray) -> tuple[int, list]:
    """(R, groups) for the rows of numpy `meta`, which come in order of
    their case (shared-plane cases by lane columns, then the global
    plane's rows): R the result's columns, each group (first row, end
    row, C, shared memory bytes, slot bytes, blocks) one launch. A
    shared-plane group has slot bytes 0 and a block a row; the global
    plane's has C GLOBAL_COLS, no shared memory, and as many blocks,
    each with its slot, as SCRATCH_BYTES holds (at least one)."""
    n = len(meta)
    if n == 0:
        return HEADER, []
    R = int((meta[:, 1] + meta[:, 3]).max()) + HEADER
    keys = _order_keys(meta)
    if (np.diff(keys) < 0).any():
        raise ValueError("ag_traceback: rows must come in order of their case")
    groups = []
    for key in np.unique(keys):
        rows = np.flatnonzero(keys == key)
        a, b = int(rows[0]), int(rows[-1]) + 1
        Ts, Ls = meta[a:b, 3], meta[a:b, 1]
        if key != GLOBAL_KEY:
            groups.append((a, b, int(key), smem_bytes(int(Ts.max()), int(key)), 0, b - a))
        else:
            slot = max(slot_bytes(int(T), int(L)) for T, L in zip(Ts, Ls))
            groups.append((a, b, GLOBAL_COLS, 0, slot,
                           min(b - a, max(1, SCRATCH_BYTES // slot))))
    return R, groups


def ag_traceback_cuda(genome, meta, pat, R, groups, open_, ext, match, sub):
    """One kernel launch a group of launch_plan over the rows of `meta`
    (int64 [n, 4] on the card), on the current stream: int32 [n, R] on
    the card. CPU tensors run ag_traceback_plain."""
    if not genome.is_cuda:
        return ag_traceback_plain(genome, meta, pat, R, open_, ext, match, sub)
    dev = genome.device
    n = meta.shape[0]
    for name, t, dt in (("genome", genome, torch.uint8), ("meta", meta, torch.int64),
                        ("pat", pat, torch.uint8)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"ag_traceback_cuda: {name} must be contiguous {dt} on {dev}, "
                             f"got {t.dtype} on {t.device}")
    if tuple(meta.shape) != (n, 4) or R < HEADER:
        raise ValueError(f"ag_traceback_cuda: meta [n, 4] and R >= {HEADER}, got "
                         f"{tuple(meta.shape)} and {R}")
    out = torch.zeros((n, R), dtype=torch.int32, device=dev)   # the plain version's past the runs
    with torch.cuda.device(dev):   # the launcher's shared-memory opt-in is per device
        stream = _build.stream_ptr(dev)
        for a, b, C, smem, slot, blocks in groups:
            shared = slot == 0
            if (not (0 <= a < b <= n) or C not in LANE_COLS or smem > MAX_SMEM
                    or (blocks != b - a if shared else
                        C != GLOBAL_COLS or smem or not 0 < blocks <= b - a)):
                raise ValueError(f"ag_traceback_cuda: group rows {a}-{b}, {C} columns a "
                                 f"lane, {smem} bytes of shared memory, slots of {slot} "
                                 f"bytes, {blocks} blocks")
            scratch = None if shared else torch.empty(
                (blocks * slot,), dtype=torch.uint8, device=dev)
            err = KERNEL(
                ctypes.c_void_p(genome.data_ptr()),
                ctypes.c_void_p(meta.data_ptr() + 32 * a), _build.ptr(pat),
                ctypes.c_void_p(out.data_ptr() + 4 * R * a),
                ctypes.c_void_p(None if shared else scratch.data_ptr()), slot,
                b - a, blocks, R, C, smem, open_, ext, match, sub, stream,
            )
            _build.check(err, "ag_traceback")
            ag_traceback_cuda.launches += 1
            RECORDER.tally("launch.agcigar")
    return out


ag_traceback_cuda.launches = 0


def ag_traceback_plain(genome, meta, pat, R, open_, ext, match, sub):
    """ag_tb_core over the rows of `meta` in torch: the DP for every row
    at once, text row by text row, and each row's traceback from the
    same four bits a cell that the kernel keeps."""
    n = meta.shape[0]
    out = torch.zeros((n, R), dtype=torch.int32)
    if n == 0:
        return out
    i32 = torch.int32
    off, Ls, locs, Ts = meta.to(torch.int64).unbind(1)
    Lm, Tm = max(int(Ls.max()), 1), max(int(Ts.max()), 1)
    jj = torch.arange(Lm, dtype=torch.int64)
    tt = torch.arange(Tm, dtype=torch.int64)
    in_p = jj[None, :] < Ls[:, None]
    in_t = tt[None, :] < Ts[:, None]
    P = torch.full((n, Lm), 4, dtype=i32)
    P[in_p] = pat[(off[:, None] + jj[None, :])[in_p]].to(i32)
    X = torch.full((n, Tm), 4, dtype=i32)
    X[in_t] = genome[(locs[:, None] + tt[None, :])[in_t]].to(i32)
    j = jj.to(i32)[None, :]
    hp = (-(open_ + j * ext)).expand(n, Lm).clone()
    ev = torch.full((n, Lm), NEG, dtype=i32)
    neg_col = torch.full((n, 1), NEG, dtype=i32)
    bits = torch.empty((n, Tm, Lm), dtype=torch.uint8)
    hlast = torch.empty((n, Tm), dtype=i32)
    last = (Ls.clamp(min=1) - 1)[:, None]
    for i in range(Tm):
        tch = X[:, i : i + 1]
        h_init = 0 if i == 0 else -(open_ + (i - 1) * ext)
        diag = torch.cat([torch.full((n, 1), h_init, dtype=i32), hp[:, :-1]], 1)
        s = torch.where((tch >= 4) | (P >= 4), -1,
                        torch.where(tch == P, match, -sub)).to(i32)
        m = diag + s
        pmax = torch.cummax(m - open_ + j * ext, dim=1).values
        f = torch.cat([neg_col, pmax[:, :-1] - (j[:, 1:] - 1) * ext], 1)
        me = torch.maximum(m, ev)
        h = torch.maximum(me, f)
        bits[:, i] = ((f > me).to(torch.uint8) | ((ev > m).to(torch.uint8) << 1)
                      | ((ev - ext > m - open_).to(torch.uint8) << 2)
                      | ((f - ext > m - open_).to(torch.uint8) << 3))
        hlast[:, i] = h.gather(1, last)[:, 0]
        ev = torch.maximum(ev - ext, m - open_)
        hp = h
    # best readout at column L - 1, ties to the later text row
    hl = torch.where(in_t, hlast, NEG - 1)
    best = hl.max(dim=1, keepdim=True).values
    best_row = torch.where(hl == best, tt[None, :], -1).max(dim=1).values
    bits_np = bits.numpy()
    for r in range(n):
        L, T = int(Ls[r]), int(Ts[r])
        if L <= 0 or T <= 0:
            out[r, 0] = -1
            continue
        runs = _walk(bits_np[r], int(best_row[r]), L - 1)
        out[r, 0] = len(runs)
        out[r, 1] = int(best_row[r]) + 1
        out[r, HEADER : HEADER + len(runs)] = torch.tensor(
            [(c << 2) | OPS.index(a) for a, c in runs], dtype=i32)
    return out


def _walk(tb, i: int, j: int) -> list:
    """ag_tb_core's traceback from (i, j) in H over a row's bits [T, L]:
    [(op, count), ...] in traceback order."""
    runs: list = []

    def push(a, k=1):
        if runs and runs[-1][0] == a:
            runs[-1][1] += k
        else:
            runs.append([a, k])

    state = "H"
    while i >= 0 and j >= 0:
        if state == "H":
            b = tb[i, j]
            if b & 1:
                state = "I"
            elif b & 2:
                state = "D"
            else:
                push("M")
                i -= 1
                j -= 1
        elif state == "D":
            push("D")
            cont = i >= 1 and bool(tb[i - 1, j] & 4)
            i -= 1
            state = "D" if cont else "H"
        else:
            push("I")
            cont = j >= 1 and bool(tb[i, j - 1] & 8)
            j -= 1
            state = "I" if cont else "H"
    if i >= 0:
        push("D", i + 1)
    if j >= 0:
        push("I", j + 1)
    return [tuple(x) for x in runs]


_STREAMS: dict = {}   # device -> ag_traceback_rows' stream
_READY = weakref.WeakValueDictionary()   # id -> a genome tensor the stream has waited for


def _stream(genome_t):
    """ag_traceback_rows' stream on genome_t's device. It waits once for
    the work queued on the current stream before a genome tensor's first
    use (its upload among it); later calls read only that genome, which
    nothing writes again, so they do not wait for the device steps queued
    on the current stream since."""
    dev = genome_t.device
    s = _STREAMS.get(dev)
    if s is None:
        s = _STREAMS[dev] = torch.cuda.Stream(dev)
    if _READY.get(id(genome_t)) is not genome_t:
        s.wait_stream(torch.cuda.current_stream(dev))
        _READY[id(genome_t)] = genome_t
    return s


def ag_traceback_rows(genome_t, meta: np.ndarray, pat: np.ndarray,
                      open_: int, ext: int, match: int, sub: int) -> np.ndarray:
    """The rows of `meta` (numpy [n, 4] int64) over `pat` (numpy uint8)
    against the genome tensor `genome_t`, as numpy int32 [n, R]. The
    rows go in order of their case, one launch a case; on the card the
    metadata and patterns go up in one pinned copy and the result comes
    back in one, on a stream of their own, which alone is synchronized."""
    meta = np.ascontiguousarray(meta, dtype=np.int64).reshape(-1, 4)
    pat = np.ascontiguousarray(pat, dtype=np.uint8)
    n = len(meta)
    order = np.argsort(_order_keys(meta), kind="stable")
    meta = np.ascontiguousarray(meta[order])
    R, groups = launch_plan(meta)
    if genome_t.is_cuda:
        dev = genome_t.device
        head = meta.nbytes
        up = torch.empty((head + max(pat.size, 1),), dtype=torch.uint8, pin_memory=True)
        up_np = up.numpy()
        up_np[:head] = meta.view(np.uint8).reshape(-1)
        up_np[head : head + pat.size] = pat
        side = _stream(genome_t)
        with torch.cuda.stream(side):
            buf = up.to(dev, non_blocking=True)
            out = ag_traceback_cuda(genome_t, buf[:head].view(torch.int64).view(n, 4),
                                    buf[head:], R, groups, open_, ext, match, sub)
            host = torch.empty((n, R), dtype=torch.int32, pin_memory=True)
            host.copy_(out, non_blocking=True)
        side.synchronize()
    else:
        host = ag_traceback_plain(genome_t, torch.from_numpy(meta), torch.from_numpy(pat),
                                  R, open_, ext, match, sub)
    res = np.empty((n, R), np.int32)
    res[order] = host.numpy()
    return res
