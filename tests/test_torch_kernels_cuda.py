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
                                 (484, 512), (1500, 1820), (2000, 4200)])
def test_dp_kernel_bit_exact(cuda, anchored, L, W):
    """Up to the one-warp kernel's limit W + 1 = 512, the long-read
    shapes (pattern L, text window L + 28) of -rl 256, 400 and 483, and
    past it the long-row kernel (a block a row): 1500 bp at -d 160 and a
    window of more than 16 columns a thread."""
    from snap_tpu_torch.ops.dp import fitting_edit_distance_core_plain
    from snap_tpu_torch.ops.dp_cuda import fitting_edit_distance_core_cuda

    args = [cuda(a) for a in _rows(np.random.default_rng(W), 300, L, W)]
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
@pytest.mark.parametrize("L,T", [(80, 110), (400, 430), (512, 540), (1500, 1540)])
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


@pytest.mark.parametrize("L", [40, 100, 128, 1025, 1500, 20000])
def test_gapless_kernel(cuda, L):
    """Reads of one window level (L <= 1024) and of two or three (the
    sums of ops/sums.py nest a level per 32-fold)."""
    from snap_tpu_torch.ops.gapless import gapless_prescreen_plain
    from snap_tpu_torch.ops.gapless_cuda import gapless_prescreen_cuda

    rng = np.random.default_rng(L)
    B, K, PW = (200 if L <= 1500 else 24), 16, (L + 15) // 16
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
    # bit for bit: the kernel skips only +0.0 terms, and no partial sum
    # of ln P(error) values is -0.0
    assert torch.equal(lp.view(torch.int32), rlp.view(torch.int32))
