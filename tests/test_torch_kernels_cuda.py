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
@pytest.mark.parametrize("W", [33, 156, 400])
def test_dp_kernel_bit_exact(cuda, anchored, W):
    from snap_tpu_torch.ops.dp import fitting_edit_distance_core_plain
    from snap_tpu_torch.ops.dp_cuda import fitting_edit_distance_core_cuda

    args = [cuda(a) for a in _rows(np.random.default_rng(W), 300, 100, W)]
    got = fitting_edit_distance_core_cuda(*args, anchored)
    ref = fitting_edit_distance_core_plain(*args, anchored)
    for g, r in zip(got, ref):
        assert torch.equal(g.view(torch.int32), r.view(torch.int32))


@pytest.mark.parametrize("L", [30, 128, 250])
def test_affine_kernel_bit_exact(cuda, L):
    from snap_tpu_torch.ops.affine import affine_extend_core_plain
    from snap_tpu_torch.ops.affine_cuda import affine_extend_core_cuda

    rng = np.random.default_rng(L)
    pat, logq, plen, txt = _rows(rng, 300, L, L + 28)
    tlen = np.minimum(plen + 27, L + 27).astype(np.int32)
    sinit = rng.integers(0, 150, 300).astype(np.int32)
    args = [cuda(a) for a in (pat, logq, plen, txt, tlen, sinit)]
    for pen in ((1, 4, 6, 1), (2, 6, 8, 2)):
        kw = dict(zip(("match", "sub", "gap_open", "gap_extend"), pen))
        got = affine_extend_core_cuda(*args, **kw)
        ref = affine_extend_core_plain(*args, **kw)
        for g, r in zip(got, ref):
            assert torch.equal(g.contiguous().view(torch.int32), r.view(torch.int32))


@pytest.mark.parametrize("L", [40, 100, 128])
def test_gapless_kernel(cuda, L):
    from snap_tpu_torch.ops.gapless import gapless_prescreen_plain
    from snap_tpu_torch.ops.gapless_cuda import gapless_prescreen_cuda

    rng = np.random.default_rng(L)
    B, K, PW = 200, 16, (L + 15) // 16
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
    assert float((lp - rlp).abs().max()) <= 1e-5
