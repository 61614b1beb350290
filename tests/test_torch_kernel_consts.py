"""The CUDA kernels' launch and scratch constants against their Python
mirrors, on the CPU.

The wrappers (ops/dp_cuda.py, ops/affine_cuda.py, ops/agcigar_cuda.py,
ops/_build.py) size
the blocks, the row counters and the scratch that csrc/dp.cu and
csrc/affine.cu index from their own `constexpr`s, and ops/gapless_cuda.py
and ops/affine_cuda.py name the routes that csrc/gapless.cu and
csrc/affine.cu choose by their thresholds. A drift between the two is an
out-of-bounds write on the card or a route the tests miss, so these
tests read the constants out of the sources and hold the mirrors to
them.
"""

import os
import re

import pytest

from snap_tpu_torch.align import agcigar
from snap_tpu_torch.ops import _build, affine_cuda, agcigar_cuda, dp_cuda, gapless_cuda


def _source(name: str) -> str:
    """csrc/<name>.cu with its macros' line continuations joined."""
    with open(os.path.join(_build.CSRC_DIR, f"{name}.cu")) as f:
        return f.read().replace("\\\n", "\n")


def _constants(name: str) -> dict:
    """The namespace-level `constexpr int`s of csrc/<name>.cu, each
    evaluated from the literals and the constants before it."""
    out = {}
    for key, expr in re.findall(r"^constexpr int (\w+) = ([^;,]+);", _source(name),
                                flags=re.M):
        out[key] = eval(expr, {"__builtins__": {}}, dict(out))
    return out


def _launches(name: str, kernel: str) -> list[tuple[list[str], str, str]]:
    """(template arguments, grid, block) of each launch of `kernel` in
    csrc/<name>.cu."""
    pat = r"\b" + kernel + r"<([^<>]+)>\s*<<<\(unsigned\)(.+?), (\w+), 0, s>>>"
    return [([t.strip() for t in targs.split(",")], grid, block)
            for targs, grid, block in re.findall(pat, _source(name), flags=re.S)]


def _cases(name: str, macro: str) -> list[list[str]]:
    """The arguments of the `macro(...)` lines of csrc/<name>.cu."""
    return [[a.strip() for a in args.split(",")]
            for args in re.findall(r"^\s*" + macro + r"\(([\w, ]+)\)\s*$", _source(name),
                                   flags=re.M)]


def test_dp_one_warp_limit():
    """The one-warp kernel's widest case, 32 lanes of its largest
    SNAP_DP_CASE, is kWarpCols and dp_cuda.MAX_COLS: past it the wrapper
    allocates the row counter that the block kernels take rows from."""
    k = _constants("dp")
    cases = [int(c) for (c,) in _cases("dp", "SNAP_DP_CASE")]
    assert cases == sorted(cases)
    assert 32 * cases[-1] == k["kWarpCols"] == dp_cuda.MAX_COLS


def test_dp_mid_route():
    """Rows of MAX_COLS < W + 1 <= MID_COLS take the mid-width kernel, in
    one of two families of (threads, columns, blocks per SM) instances,
    at the first SNAP_DP_MID column count that covers the row: each
    family's widest instance covers MID_COLS columns, and each instance
    is built and launched with its family's blocks per SM. Past
    MID_COLS the wrapper sizes the long rows' blocks and scratch."""
    k = _constants("dp")
    family = {"kMidThreads": ("kMidC", "kMidBlocksPerSM"),
              "kMidFewThreads": ("kMidFewC", "kMidFewBlocksPerSM")}
    seen = {}
    for threads, cols, blocks in _cases("dp", "SNAP_DP_MID"):
        assert blocks == family[threads][1]
        seen.setdefault(threads, []).append(k[cols] if cols in k else int(cols))
    assert set(seen) == set(family)
    for threads, cols in seen.items():
        assert cols == sorted(cols) and cols[-1] == k[family[threads][0]]
        assert k[threads] * cols[-1] == k["kMidCols"] == dp_cuda.MID_COLS
        assert (k["kWarpCols"] + 1 + k[threads] - 1) // k[threads] >= cols[0]
    assert dp_cuda.MAX_COLS < dp_cuda.MID_COLS <= _build.LONG_ROW_STRIP_COLS


@pytest.mark.parametrize("name", ["dp", "affine"])
def test_long_row_strip_and_blocks(name):
    """A strip of the 256-thread instance is LONG_ROW_STRIP_COLS wide (the
    scratch holds one strip edge per block and row), and its blocks per
    SM are LONG_ROW_BLOCKS_PER_SM (long_row_blocks sizes the grid and the
    scratch from it)."""
    k = _constants(name)
    assert k["kRowThreads"] * k["kRowC"] == k["kRowCols"] == _build.LONG_ROW_STRIP_COLS
    assert k["kRowBlocksPerSM"] == _build.LONG_ROW_BLOCKS_PER_SM


@pytest.mark.parametrize("name,kernel,launch", [
    ("dp", "fitting_dp_mid_kernel",
     (["PP", "CC", "BB"], "min((N + per - 1) / per, sms * BB)", "PP")),
    ("affine", "pass_xl_row_kernel",
     (["kMidThreads", "kMidBlocksPerSM"], "min(N, sms * kMidBlocksPerSM)", "kMidThreads")),
])
def test_mid_instances_launch_as_built(name, kernel, launch):
    """The mid-width kernels are launched with the threads they were built
    for, over at most SMs x the resident blocks per SM of their launch
    bound blocks, all resident at once (the DP's one-warp route over one
    block per kMidRowsPerWarp rows)."""
    k = _constants(name)
    assert _launches(name, kernel) == [launch]
    assert k["kMidThreads"] % 32 == 0


@pytest.mark.parametrize("name,kernel", [("dp", "fitting_dp_row_kernel"),
                                         ("affine", "pass_row_kernel")])
def test_long_row_instance_launch_as_built(name, kernel):
    """The long-row kernel is launched with the threads and columns of its
    strip over the wrapper's `blocks` (long_row_blocks), and built for
    kRowBlocksPerSM resident blocks."""
    k = _constants(name)
    assert _launches(name, kernel) == [(["kRowThreads", "kRowC"], "blocks", "kRowThreads")]
    bound = re.search(r"__launch_bounds__\(P, (\w+)\) " + kernel + r"\(", _source(name))
    assert bound and bound.group(1) == "kRowBlocksPerSM"
    assert k["kRowThreads"] % 32 == 0


def test_affine_widths_and_plan():
    """affine_cuda.MAX_L is kMaxCols, the widest xl row: one strip of the
    xl kernel at its largest column count, kMidC; plan_ints leaves room
    for kHeader ints after the N x 7 outputs (at a 16-byte boundary), N
    pass records of 8 ints, N xl or big rows and N mid rows."""
    k = _constants("affine")
    assert k["kMaxCols"] == k["kMidThreads"] * k["kMidC"] == affine_cuda.MAX_L
    assert "wavefront_row<P, kMidC>(a, row, nullptr, xf, red);" in _source("affine")
    assert k["kXlCols"] < k["kMaxCols"]
    assert k["kHeader"] == affine_cuda.PLAN_HEADER and k["kHeader"] % 4 == 0
    for n in (1, 2, 3, 4, 1000, 1023):
        assert affine_cuda.plan_ints(n) == ((7 * n + 3) & ~3) + k["kHeader"] + 10 * n


def _pass_width(mp: int, wide: bool) -> int:
    """csrc/affine.cu pass_width: lanes a row of a pass whose largest row
    has mp columns."""
    return 32 if wide else (8 if mp <= 40 else (16 if mp <= 80 else 32))


def test_affine_block_route():
    """Rows of more than affine_cuda.BLOCK_COLS (kBlockCols) columns leave
    the passes for the block kernel; every (G, C) a pass of shorter rows
    takes, wide or not, has its SNAP_AG_PASS instance, no instance takes
    more than 5 columns a lane (the passes' 128 registers) and each is a
    function of its own; every block row's C = ceil(plen / kMidThreads)
    has its SNAP_AG_ROW case or is kMidC, and the mid list splits inside
    the mid rows."""
    k = _constants("affine")
    assert k["kBlockCols"] == affine_cuda.BLOCK_COLS
    assert 80 <= k["kBlockCols"] < k["kMidSplit"] < k["kXlCols"] < k["kMaxCols"]
    passes = {(int(g), int(c)) for g, c in _cases("affine", "SNAP_AG_PASS")
              if int(g) * (int(c) - 1) < k["kBlockCols"]}
    need = {(g, (mp + g - 1) // g) for wide in (False, True)
            for mp in range(1, k["kBlockCols"] + 1) for g in [_pass_width(mp, wide)]}
    assert need == passes and max(c for _, c in passes) <= 5
    assert "__device__ __noinline__ void run_pass(" in _source("affine")
    rows = {int(c) for (c,) in _cases("affine", "SNAP_AG_ROW")}
    P = k["kMidThreads"]
    for plen in range(k["kBlockCols"] + 1, k["kMaxCols"] + 1):
        c = (plen + P - 1) // P
        assert c == k["kMidC"] or (c in rows and c < k["kMidC"] and P * c > k["kBlockCols"])
    assert "if (L <= kBlockCols) {  // no row leaves the passes" in _source("affine")


def test_gapless_routes():
    """The one-thread kernel up to gapless_cuda.ONE_THREAD_L positions;
    past it the split kernel at split_threads(L, pairs) threads a pair
    (warps a block), a power of two up to kMaxSplit with an instance
    each, whose shared memory (two stages of words and the window sums of
    a chunk) fits the 48 KB a launch takes without asking; reads up to
    MAX_L positions (kMaxLevels window levels)."""
    k = _constants("gapless")
    src = _source("gapless")
    assert k["kOneThreadL"] == gapless_cuda.ONE_THREAD_L
    assert (k["kMaxSplit"], k["kWindowsPerThread"], k["kMaxChunk"]) == (
        gapless_cuda.MAX_SPLIT, gapless_cuda.WINDOWS_PER_THREAD, gapless_cuda.MAX_CHUNK)
    assert "constexpr long kFillPairs = 1L << 16;" in src and gapless_cuda.FILL_PAIRS == 1 << 16
    assert gapless_cuda.MAX_L == 32 ** (k["kMaxLevels"] + 1)
    built = {int(n) for (n,) in _cases("gapless", "SNAP_GL_SPLIT")}
    assert built == {1 << i for i in range(k["kMaxSplit"].bit_length())}
    for L in (129, 256, 400, 1500, 20000):
        for pairs in (1, 1000, 4096, 1 << 14, 1 << 17):
            assert gapless_cuda.split_threads(L, pairs) in built
    for G in sorted(built):
        chunk = gapless_cuda.split_chunk(G)
        assert chunk == min(k["kWindowsPerThread"] * G, k["kMaxChunk"]) >= G
        assert (2 * (2 * chunk + 1) * 33 + chunk * 32 + G * 32) * 4 <= 48 * 1024
        assert 32 * G <= 1024
    assert "const int chunk = min(kWindowsPerThread * split, kMaxChunk);" in src
    assert "const size_t smem = (size_t)(2 * (2 * chunk + 1) * 33 + chunk * 32 + split * 32) * 4;" in src
    assert "__launch_bounds__(32 * G) gapless_split_kernel(" in src
    assert "gapless_split_kernel<GG><<<blocks, 32 * GG, smem, s>>>(" in src


def test_agcigar_cases_and_shared_memory():
    """agcigar_cuda's header, shared-memory limit, NEG, lane-column cases
    and global-plane columns are csrc/agcigar.cu's, and its slot layout
    mirrors the kernel's; the widest case's shared memory for -rl 256
    rows at the MAX_K margin fits a block."""
    k = _constants("agcigar")
    src = _source("agcigar")
    assert (k["kHeader"], k["kMaxSmem"], k["kNeg"], k["kGlobalCols"]) == (
        agcigar_cuda.HEADER, agcigar_cuda.MAX_SMEM, agcigar_cuda.NEG, agcigar_cuda.GLOBAL_COLS)
    assert agcigar_cuda.NEG == agcigar.NEG
    assert tuple(int(c) for (c,) in _cases("agcigar", "SNAP_AG_CASE")) == agcigar_cuda.LANE_COLS
    assert "__host__ __device__ inline int text_bytes(int T) { return (T + 15) & ~15; }" in src
    assert "tb = smem + text_bytes(T);" in src
    assert "return ((int64_t)16 * T + 15) & ~(int64_t)15;" in src   # handover_bytes
    assert "tb = slot + handover_bytes(T);" in src
    assert "const int64_t P = (int64_t)nst * S;" in src
    assert "constexpr int S = kLanes * C;" in src
    assert "return launch<kGlobalCols, true>(" in src
    assert "agcigar" in _build.KERNELS
    assert agcigar_cuda.smem_bytes(383, 8) <= agcigar_cuda.MAX_SMEM
    assert agcigar_cuda.slot_bytes(10, 513) == 160 + 10 * 1024
