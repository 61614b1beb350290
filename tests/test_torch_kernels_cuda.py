"""Each CUDA kernel against its plain PyTorch version on the card.

Marked `cuda`: they skip where torch sees no CUDA device. On a machine
with a card (and no JAX, so without tests/conftest.py):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

chip_smoke.py runs the same comparisons at the main path's shapes.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()


def _rows(rng, N, L, W):
    pat = rng.integers(0, 5, (N, L)).astype(np.uint8)
    txt = rng.integers(0, 6, (N, W)).astype(np.uint8)
    k = min(L, W)
    keep = rng.random((N, k)) < 0.9
    txt[:, :k] = np.where(keep, pat[:, :k], txt[:, :k])
    logq = np.log(rng.uniform(1e-4, 0.3, (N, L))).astype(np.float32)
    plen = rng.integers(0, L + 1, N).astype(np.int32)
    return pat, logq, plen, txt


@pytest.mark.parametrize("anchored", [False, True])
@pytest.mark.parametrize("L,W", [(100, 33), (100, 156), (100, 400), (100, 511),
                                 (250, 278), (400, 428), (483, 511), (100, 512),
                                 (484, 512), (1500, 1820), (2000, 4200),
                                 (600, 2046), (600, 2047), (600, 2048), (300, 4095),
                                 (300, 4096), (200, 6200), (200, 255), (200, 256),
                                 (200, 257)])
def test_dp_kernel_bit_exact(cuda, anchored, L, W):
    """Up to the one-warp kernel's limit W + 1 = 256 and across it
    (W + 1 = 256, 257, 258), the mid-width rows (64 threads a row) up to
    W + 1 = 512, the long-read shapes (pattern L, text window L + 28) of
    -rl 256, 400 and 483, and past 512 the long-row kernel (256 threads a
    row): 1500 bp at -d 160, W + 1 at a 2048-column strip's edge
    (2047-2049, 4096, 4097) and over three and four strips; plen 0, 1, 2,
    7-9, L - 1, L and L + 1 (no harvest row) among random rows."""
    from snap_tpu_torch.ops.dp import fitting_edit_distance_core_plain
    from snap_tpu_torch.ops.dp_cuda import fitting_edit_distance_core_cuda

    pat, logq, plen, txt = _rows(np.random.default_rng(W), 300, L, W)
    plen[:9] = [0, 1, 2, 7, 8, 9, L - 1, L, L + 1]
    args = [cuda(a) for a in (pat, logq, plen, txt)]
    got = fitting_edit_distance_core_cuda(*args, anchored)
    ref = fitting_edit_distance_core_plain(*args, anchored)
    for g, r in zip(got, ref):
        assert torch.equal(g.view(torch.int32), r.view(torch.int32))


def _affine_bit_exact(args, pens=((1, 4, 6, 1), (2, 6, 8, 2))):
    from snap_tpu_torch.ops.affine import affine_extend_core_plain
    from snap_tpu_torch.ops.affine_cuda import affine_extend_core_cuda

    for pen in pens:
        kw = dict(zip(("match", "sub", "gap_open", "gap_extend"), pen))
        got = affine_extend_core_cuda(*args, **kw)
        ref = affine_extend_core_plain(*args, **kw)
        torch.cuda.synchronize()
        for g, r, field in zip(got, ref, ref._fields):
            assert torch.equal(g.contiguous().view(torch.int32),
                               r.view(torch.int32)), (pen, field)


@pytest.mark.parametrize("many", [False, True])
@pytest.mark.parametrize("L", [30, 128, 250])
def test_affine_kernel_bit_exact(cuda, L, many):
    """Random rows, and plen 0, 1, 31, 32, 33 and L each with tlen
    plen + 27, 0, 1 and T - 1, and tlen beyond T: short and long rows in
    one launch, N no multiple of the kernel's 32-row window. `many`
    passes the kernel's 4 rows per resident warp (16 per SM), above
    which rows share a warp 8 or 16 lanes each; below it, every row
    has 32 lanes."""
    rng = np.random.default_rng(L)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    N, T = (64 * sms + 75 if many else 303), L + 28
    pat, logq, plen, txt = _rows(rng, N, L, T)
    plen[:24] = np.repeat(np.minimum([0, 1, 31, 32, 33, L], L), 4)
    tlen = np.minimum(plen + 27, L + 27).astype(np.int32)
    tlen[1:24:4], tlen[2:24:4], tlen[3:24:4] = 0, 1, T - 1
    tlen[24:30] = T + np.arange(1, 7)
    sinit = rng.integers(0, 150, N).astype(np.int32)
    _affine_bit_exact([cuda(a) for a in (pat, logq, plen, txt, tlen, sinit)])


@pytest.mark.parametrize("many", [False, True])
@pytest.mark.parametrize("L", [257, 400, 512, 513, 1500])
def test_affine_kernel_long_rows(cuda, L, many):
    """Patterns past 256 columns (the xl passes, 10-16 columns a lane)
    and past 512 (the big rows, a block each): plen at each pass's edges
    beside random rows, so big, xl, long and short rows share a launch;
    `many` as in test_affine_kernel_bit_exact."""
    rng = np.random.default_rng(L)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    N, T = (64 * sms + 75 if many else 303), L + 28
    pat, logq, plen, txt = _rows(rng, N, L, T)
    edges = [e for e in (0, 1, 255, 256, 257, 288, 289, 320, 321, 352, 353, 384,
                         385, 416, 417, 448, 449, 480, 481, 511, 512, 513, 767,
                         768, 769, 1500) if e <= L]
    plen[: 2 * len(edges)] = np.repeat(edges, 2)
    tlen = np.minimum(plen + 27, T - 1).astype(np.int32)
    tlen[1 : 2 * len(edges) : 2] = T + 3
    sinit = rng.integers(0, 600, N).astype(np.int32)
    _affine_bit_exact([cuda(a) for a in (pat, logq, plen, txt, tlen, sinit)])


@pytest.mark.parametrize("many", [False, True])
@pytest.mark.parametrize("L,T", [(80, 110), (256, 284), (400, 430), (512, 540),
                                 (1500, 1540)])
def test_affine_kernel_ties(cuda, many, L, T):
    """Periodic pattern and text, N runs and low score_init: many equal
    scores, so the global (later row), local (earlier row, larger
    column) and F (later run start) tie rules all decide, in rows of up
    to 1500 columns; `many` as in test_affine_kernel_bit_exact."""
    rng = np.random.default_rng(7)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    N = 64 * sms + 75 if many else 150
    pat = np.tile(np.array([0, 1], np.uint8), (N, L // 2))
    txt = np.tile(np.array([0, 1], np.uint8), (N, T // 2))
    txt[::3, 5:9] = 4
    pat[::4, 10:12] = 4
    txt[1::5] = 4
    txt[2::7, 20:] = np.tile(np.array([0, 0, 1, 1], np.uint8), (1, (T - 20) // 4 + 1))[:, : T - 20]
    logq = np.full((N, L), np.float32(np.log(0.01)))
    plen = rng.integers(0, L + 1, N).astype(np.int32)
    tlen = rng.integers(0, T + 3, N).astype(np.int32)
    sinit = rng.integers(0, 10, N).astype(np.int32)
    sinit[::2] = 0
    _affine_bit_exact([cuda(a) for a in (pat, logq, plen, txt, tlen, sinit)],
                      pens=((1, 4, 6, 1), (2, 6, 8, 2), (1, 1, 0, 1)))


def _dp_bit_exact(args, anchors=(False, True)):
    from snap_tpu_torch.ops.dp import fitting_edit_distance_core_plain
    from snap_tpu_torch.ops.dp_cuda import fitting_edit_distance_core_cuda

    for anchored in anchors:
        got = fitting_edit_distance_core_cuda(*args, anchored)
        ref = fitting_edit_distance_core_plain(*args, anchored)
        torch.cuda.synchronize()
        for g, r, field in zip(got, ref, ("packed", "log_prob", "end")):
            assert torch.equal(g.view(torch.int32), r.view(torch.int32)), (anchored, field)


# The mid-width rows (csrc/dp.cu W + 1 of 257-512, csrc/affine.cu plen of
# 257-512): the DP on one warp a row of up to 16 columns a lane when a
# launch has more than 4 rows per SM, else on 128 threads of up to 4
# columns; the affine on 64 threads of 5-8 columns.


def _resident_and_more(sms):
    """More rows than the mid-width kernels keep resident at once (at most
    8 blocks per SM) and than the DP's few-rows route takes, so blocks
    take the next row when done."""
    return 16 * sms + 75


@pytest.mark.parametrize("W", [256, 287, 288, 428, 479, 511])
def test_dp_mid_rows_many(cuda, W):
    """The one-warp mid-width route over more rows than resident blocks, at
    each column count's edge (W + 1 = 32 C, 32 C + 1) and -rl 400's W =
    428: plen at 0, 1, L - 1, L, L + 1 and 376 beside random rows."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(W)
    L = 400
    pat, logq, plen, txt = _rows(rng, _resident_and_more(sms), L, W)
    plen[:12] = [0, 1, L - 1, L, L + 1, 376, 376, 376, 255, 256, 257, 258]
    _dp_bit_exact([cuda(a) for a in (pat, logq, plen, txt)])


@pytest.mark.parametrize("many", [False, True])
@pytest.mark.parametrize("W", [256, 257, 428, 511])
def test_dp_mid_row_ties(cuda, W, many):
    """Periodic pattern and text with N runs at the mid-width route's
    edges and at -rl 400's width: the deletion carry (earlier run start)
    and the answer (smallest end column) tie rules decide; `many` takes
    the one-warp route, else the 128-thread one."""
    rng = np.random.default_rng(W)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    N, L = (_resident_and_more(sms) if many else 300), 400
    pat = np.tile(np.array([0, 1], np.uint8), (N, L // 2))
    txt = np.tile(np.array([0, 1], np.uint8), (N, (W + 1) // 2))[:, :W]
    txt[::3, 5:9] = 4
    pat[::4, 10:12] = 4
    txt[1::5, :100] = 4
    txt[2::7, 20:] = np.tile(np.array([0, 0, 1, 1], np.uint8), (1, (W - 20) // 4 + 1))[:, : W - 20]
    logq = np.full((N, L), np.float32(np.log(0.01)))
    plen = rng.integers(0, L + 2, N).astype(np.int32)
    _dp_bit_exact([cuda(a) for a in (np.ascontiguousarray(pat), logq, plen,
                                     np.ascontiguousarray(txt))])


@pytest.mark.parametrize("size", ["few", "mid", "many"])
def test_affine_block_rows_l256(cuda, size):
    """-rl 256's width (L = 256): rows of 120-256 columns, the mid rows'
    threshold BLOCK_COLS - 1, BLOCK_COLS, BLOCK_COLS + 1 and the mid
    list's split (191-193) beside rows of fewer than 40 columns; tlen 0,
    1, plen + 27 and past T. "few" rows (at most 4 an SM) run the mid
    rows on 128 threads, more on 64; "many" passes 4 rows per resident
    pass warp, so the passes share warps (G = 8, 16), else every pass is
    one row on 32 lanes."""
    from snap_tpu_torch.ops.affine_cuda import BLOCK_COLS

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    N, seed = {"few": (303, 1), "mid": (16 * sms + 75, 2), "many": (64 * sms + 75, 3)}[size]
    rng = np.random.default_rng(seed)
    L, T = 256, 284
    pat, logq, plen, txt = _rows(rng, N, L, T)
    plen[:] = np.where(rng.random(N) < 0.5, rng.integers(120, L + 1, N),
                       rng.integers(0, 40, N))
    edges = [BLOCK_COLS - 1, BLOCK_COLS, BLOCK_COLS + 1, 191, 192, 193, 255, 256,
             0, 1, 39, 40]
    plen[: 4 * len(edges)] = np.repeat(edges, 4)
    tlen = np.minimum(plen + 27, T).astype(np.int32)
    tlen[0 : 4 * len(edges) : 4] = 0
    tlen[1 : 4 * len(edges) : 4] = 1
    tlen[2 : 4 * len(edges) : 4] = T + 5
    sinit = rng.integers(0, 300, N).astype(np.int32)
    _affine_bit_exact([cuda(a) for a in (pat, logq, plen, txt, tlen, sinit)])


@pytest.mark.parametrize("many", [False, True])
def test_affine_mid_rows_mixed(cuda, many):
    """plen 255, 256, 257 and 258 (the short passes' last width and the
    block kernel's first) in one launch with short rows (0, 1, 40, 41,
    80, 81, 160, 161) and random ones; tlen 0, 1, plen + 27 and past T;
    `many` passes the rows that the mid-width kernel keeps resident."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(257)
    L, T = 400, 428
    N = _resident_and_more(sms) if many else 303
    pat, logq, plen, txt = _rows(rng, N, L, T)
    edges = [255, 256, 257, 258, 0, 1, 40, 41, 80, 81, 160, 161]
    plen[: 4 * len(edges)] = np.repeat(edges, 4)
    tlen = np.minimum(plen + 27, T).astype(np.int32)
    tlen[0 : 4 * len(edges) : 4] = 0
    tlen[1 : 4 * len(edges) : 4] = 1
    tlen[2 : 4 * len(edges) : 4] = T + 5
    sinit = rng.integers(0, 400, N).astype(np.int32)
    _affine_bit_exact([cuda(a) for a in (pat, logq, plen, txt, tlen, sinit)])


def test_affine_mid_rows_rl400(cuda):
    """-rl 400's longest rows, plen 376 and tlen 403, over more rows than
    the mid-width kernel keeps resident, a quarter of them short."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(376)
    L, T = 400, 428
    N = _resident_and_more(sms)
    pat, logq, plen, txt = _rows(rng, N, L, T)
    plen[: 3 * N // 4] = 376
    tlen = np.full(N, 403, np.int32)
    tlen[3 * N // 4 :] = np.minimum(plen[3 * N // 4 :] + 27, T)
    sinit = rng.integers(100, 600, N).astype(np.int32)
    _affine_bit_exact([cuda(a) for a in (pat, logq, plen, txt, tlen, sinit)])


@pytest.mark.parametrize("many", [False, True])
def test_affine_mid_row_ties(cuda, many):
    """Periodic pattern and text, N runs and low score_init in rows of
    257-512 columns only: the global (later row), local (earlier row,
    larger column) and F (later run start) tie rules decide in the block
    kernel."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(11)
    L, T = 512, 540
    N = _resident_and_more(sms) if many else 150
    pat = np.tile(np.array([0, 1], np.uint8), (N, L // 2))
    txt = np.tile(np.array([0, 1], np.uint8), (N, T // 2))
    txt[::3, 5:9] = 4
    pat[::4, 10:12] = 4
    txt[1::5] = 4
    txt[2::7, 20:] = np.tile(np.array([0, 0, 1, 1], np.uint8), (1, (T - 20) // 4 + 1))[:, : T - 20]
    logq = np.full((N, L), np.float32(np.log(0.01)))
    plen = rng.integers(257, L + 1, N).astype(np.int32)
    tlen = rng.integers(0, T + 3, N).astype(np.int32)
    sinit = rng.integers(0, 10, N).astype(np.int32)
    sinit[::2] = 0
    _affine_bit_exact([cuda(a) for a in (pat, logq, plen, txt, tlen, sinit)],
                      pens=((1, 4, 6, 1), (2, 6, 8, 2), (1, 1, 0, 1)))


# The long-row kernels (csrc/dp.cu, csrc/affine.cu): 256 threads of 8
# columns a row, rows wider than 2048 columns strip by strip.


def test_dp_long_row_snapxl(cuda):
    """The snapxl shape: -rl 20000 -d 1000 gives W = L + 2 * M3 + 1, so
    W + 1 = 22,002 columns (11 strips) over 20,000 pattern rows."""
    rng = np.random.default_rng(20000)
    L, W = 20000, 22001
    pat, logq, plen, txt = _rows(rng, 4, L, W)
    plen[:] = [L, L - 1, 2049, 1]
    # the read near the window's middle, as the aligner places it
    txt[:, 1000 : 1000 + L] = np.where(rng.random((4, L)) < 0.97, pat, txt[:, 1000 : 1000 + L])
    _dp_bit_exact([cuda(a) for a in (pat, logq, plen, txt)])


@pytest.mark.parametrize("W", [1820, 4200])
def test_dp_long_row_ties(cuda, W):
    """Periodic pattern and text with N runs: many equal costs, so the
    deletion carry (earlier run start) and the answer (smallest end
    column) tie rules decide, in one strip and in three."""
    rng = np.random.default_rng(3)
    N, L = 60, 1500
    pat = np.tile(np.array([0, 1], np.uint8), (N, L // 2))
    txt = np.tile(np.array([0, 1], np.uint8), (N, W // 2))
    txt[::3, 5:9] = 4
    pat[::4, 10:12] = 4
    txt[1::5, :300] = 4
    txt[2::7, 20:] = np.tile(np.array([0, 0, 1, 1], np.uint8), (1, (W - 20) // 4 + 1))[:, : W - 20]
    logq = np.full((N, L), np.float32(np.log(0.01)))
    plen = rng.integers(0, L + 2, N).astype(np.int32)
    _dp_bit_exact([cuda(a) for a in (pat, logq, plen, txt)])


def test_dp_long_row_many(cuda):
    """More rows than the resident long-row blocks (2 per SM): blocks
    take the next row when done."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(11)
    pat, logq, plen, txt = _rows(rng, 6 * sms + 7, 300, 700)
    _dp_bit_exact([cuda(a) for a in (pat, logq, plen, txt)], anchors=(False,))


@pytest.mark.parametrize("L", [2047, 2048, 2049, 4200])
def test_affine_kernel_strip_edges(cuda, L):
    """Big rows at a strip's edge and across strips: plen at 513, at a
    thread's 8-column tile edges, at 2047-2049, 4095-4097 and L; tlen 1,
    2, T and past T."""
    rng = np.random.default_rng(L + 1)
    T = L + 28
    edges = [e for e in (513, 519, 520, 521, 2047, 2048, 2049, 4095, 4096, 4097, L)
             if e <= L]
    N = 4 * len(edges) + 8
    pat, logq, plen, txt = _rows(rng, N, L, T)
    plen[: 4 * len(edges)] = np.repeat(edges, 4)
    tlen = np.minimum(plen + 27, T).astype(np.int32)
    tlen[0 : 4 * len(edges) : 4] = 1
    tlen[1 : 4 * len(edges) : 4] = 2
    tlen[2 : 4 * len(edges) : 4] = T + 5
    sinit = rng.integers(0, 600, N).astype(np.int32)
    _affine_bit_exact([cuda(a) for a in (pat, logq, plen, txt, tlen, sinit)])


def test_affine_kernel_20kb(cuda):
    """Rows of up to 20,000 pattern columns (10 strips), the snapxl
    reads' length, beside shorter big rows."""
    rng = np.random.default_rng(20000)
    L = 20000
    T = L + 28
    pat, logq, plen, txt = _rows(rng, 5, L, T)
    plen[:] = [L, L - 1, 6145, 2049, 513]
    tlen = np.array([T, L - 40, 6200, T, 600], np.int32)
    sinit = rng.integers(100, 600, 5).astype(np.int32)
    _affine_bit_exact([cuda(a) for a in (pat, logq, plen, txt, tlen, sinit)],
                      pens=((1, 4, 6, 1),))


def _gapless_bit_exact(cuda, L, B, K, seed):
    from snap_tpu_torch.ops.gapless import gapless_prescreen_plain
    from snap_tpu_torch.ops.gapless_cuda import gapless_prescreen_cuda

    rng = np.random.default_rng(seed)
    PW = (L + 15) // 16
    w = lambda *s: rng.integers(-(1 << 31), 1 << 31, s, dtype=np.int64).astype(np.int32)
    even = np.int32(0x55555555)
    arrays = (
        w(B, K * PW), w(B, K * PW) & even, w(B, PW), w(B, PW),
        w(B, PW) & even & np.int32(0x01010101), w(B, PW) & even & np.int32(0x10101010),
        np.log(rng.uniform(1e-4, 0.3, (B, L))).astype(np.float32),
        np.log(rng.uniform(1e-4, 0.3, (B, L))).astype(np.float32),
        rng.integers(0, 2, (B, K)).astype(np.int32),
        rng.integers(0, L + 1, B).astype(np.int32),
    )
    args = [cuda(a) for a in arrays]
    d, lp = gapless_prescreen_cuda(*args, K, PW)
    rd, rlp = gapless_prescreen_plain(*args, K, PW)
    assert torch.equal(d, rd)
    # bit for bit: up to ONE_THREAD_L positions the kernel skips only
    # +0.0 terms, and no partial sum of ln P(error) values is -0.0; past
    # it, it adds the plain version's terms in its order
    assert torch.equal(lp.view(torch.int32), rlp.view(torch.int32))


@pytest.mark.parametrize("L", [40, 100, 128, 129, 256, 257, 400, 1024, 1025, 1500,
                               20000])
def test_gapless_kernel(cuda, L):
    """Reads of one window level (L <= 1024) and of two or three (the
    sums of ops/sums.py nest a level per 32-fold): one thread a pair up
    to 128 positions, the split kernel past it (8-16 threads a pair for
    these 3,200 pairs, by the windows); lo (the zeros padded in front of
    the windows) 15 at 129, 257 and 1025, 8 at 400, 0 at 256 and 1024."""
    _gapless_bit_exact(cuda, L, 200 if L <= 1500 else 24, 16, L)


@pytest.mark.parametrize("B", [32, 64, 128])
@pytest.mark.parametrize("L", [400, 1500])
def test_gapless_kernel_many_pairs(cuda, L, B):
    """K = 512 candidates a read, as -rl 400's largest launches have:
    16,384-65,536 pairs, so the split kernel takes 4, 2 and 1 threads a
    pair (gapless_cuda.split_threads), with 64 windows a chunk and
    fewer."""
    _gapless_bit_exact(cuda, L, B, 512, L + B)


@pytest.mark.parametrize("L", [129, 256, 400, 1500])
def test_gapless_kernel_few_pairs(cuda, L):
    """Two reads of 16 and of 64 candidates: the split kernel's last block
    holds lanes past the last pair, which take part in the shuffles with
    no windows."""
    _gapless_bit_exact(cuda, L, 2, 16, L + 2)
    _gapless_bit_exact(cuda, L, 2, 64, L + 3)
