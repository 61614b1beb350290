"""Long reads in the port: twins of tests/test_long_reads.py, CLI twins
at -rl 256 and -rl 400, and the kernel wrappers at long rows.

- The fitting DP beyond the short-read MAX_K of 127: the port's plain
  version against snap_tpu's fitting_edit_distance, every field.
- test_long_reads.py's 1500 bp and 20 kb CLI runs are twinned in
  tests/test_torch_long_reads_1500.py (a file of their own, so that
  another worker runs them).
- `single` at -rl 256 with 250 bp reads and at -rl 400 with 400 bp
  reads (substitutions, 1-3 bp indels, both strands) on a 25%-repeat
  genome: the same SAM bytes. On the card these are shapes past the
  TPU kernels' bounds, which the CUDA kernels take.
- The DP and affine wrappers at rows past their one-warp kernels
  (W + 1 > 512, L > 512; on the card, a block a row): on CPU tensors
  the plain version's results, and no launch counted.

Both packages run as tests/test_torch_single.py runs them: the same
relative argv in directories of their own, the same ln P(error) table
(same_logq), no mesh for snap_tpu.
"""

import numpy as np
import pytest
import torch

from snap_tpu_torch.align import pipeline as TP
from snap_tpu_torch.ops import affine_cuda, dp_cuda
from test_torch_cli_cuda import genome_codes, simulate_long_reads
from test_torch_pipeline import same_logq  # noqa: F401
from test_torch_single import run_jax, run_torch

torch.set_num_threads(1)


def test_fitting_dp_beyond_short_read_max_k():
    """180 planted mismatches at L = 1200: the port's plain DP gives
    snap_tpu's dist, log-prob, end column and indels."""
    import jax.numpy as jnp

    from snap_tpu.ops.dp import fitting_edit_distance
    from snap_tpu_torch.ops.dp import fitting_edit_distance_plain

    rng = np.random.default_rng(0)
    L = 1200
    text_codes = rng.integers(0, 4, size=L + 40).astype(np.uint8)
    pat = text_codes[20 : 20 + L].copy()
    mism = np.arange(5, 5 + 180 * 6, 6)
    pat[mism] = (pat[mism] + 1) % 4
    logq = np.full((1, L), np.log(1e-3), np.float32)
    plen = np.array([L], np.int32)
    ref = fitting_edit_distance(
        jnp.asarray(pat[None, :]), jnp.asarray(logq), jnp.asarray(plen),
        jnp.asarray(text_codes[None, :]),
    )
    got = fitting_edit_distance_plain(
        torch.from_numpy(pat[None, :]), torch.from_numpy(logq),
        torch.from_numpy(plen), torch.from_numpy(text_codes[None, :]),
    )
    assert int(got.dist[0]) == 180
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), f)


def run_twins(tmp_path_factory, tag, write, index_argv, single_argv):
    """Both CLIs on the inputs `write(dir)` makes; returns (snap_tpu's
    SAM, the port's SAM, the port's host branches)."""
    dirs = {}
    for side in ("jax", "torch"):
        d = tmp_path_factory.mktemp(f"{tag}_{side}")
        write(d)
        dirs[side] = d
    run_jax(dirs["jax"], index_argv)
    run_jax(dirs["jax"], single_argv)
    run_torch(dirs["torch"], index_argv)
    br = run_torch(dirs["torch"], single_argv)
    return (dirs["jax"] / "out.sam").read_bytes(), (dirs["torch"] / "out.sam").read_bytes(), br


def assert_same_sam(ref: bytes, got: bytes, n: int):
    body = [ln for ln in got.split(b"\n") if ln and not ln.startswith(b"@")]
    assert len(body) == n
    if got != ref:
        diff = [(a, b) for a, b in zip(ref.split(b"\n"), got.split(b"\n")) if a != b]
        pytest.fail(f"{len(diff)} SAM lines differ, first: {diff[:2]}")


@pytest.mark.parametrize("read_len,rl", [(250, 256), (400, 400)])
def test_rl_cli_twin(same_logq, tmp_path_factory, read_len, rl):
    """`single -rl 256` on 250 bp reads and `-rl 400` on 400 bp reads
    (the shapes past the TPU kernels' bounds that the CUDA kernels now
    take) give the same SAM bytes in both packages."""
    from test_torch_cli_cuda import write_inputs

    codes = genome_codes("repeat25")
    n = 24

    def write(d):
        write_inputs(str(d), "repeat25", 0)
        with open(d / "r.fq", "wb") as f:
            for name, seq, qual in simulate_long_reads(codes, n, read_len, rl):
                f.write(b"@%s\n%s\n+\n%s\n" % (name, seq, qual))

    ref, got, br = run_twins(
        tmp_path_factory, f"rl{rl}", write, ["index", "g.fa", "idx", "-s", "20"],
        ["single", "idx", "r.fq", "-o", "out.sam", "-b", "32", "-rl", str(rl)],
    )
    assert_same_sam(ref, got, n)
    assert br.get("reader_serial") == n and "non_fast" not in br, br


@pytest.mark.parametrize("L,T", [(513, 541), (700, 760)])
def test_wrappers_take_long_rows(L, T):
    """_score_rows calls the wrappers at every read length: past the
    one-warp kernels' widths they accept the shapes and, on CPU tensors,
    give the plain results without counting a launch."""
    from snap_tpu_torch.ops.affine import affine_extend_plain
    from snap_tpu_torch.ops.dp import fitting_edit_distance_plain

    assert TP.affine_extend_cuda is affine_cuda.affine_extend_cuda
    assert TP.fitting_edit_distance_cuda is dp_cuda.fitting_edit_distance_cuda
    rng = np.random.default_rng(L)
    N = 3
    text = torch.from_numpy(rng.integers(0, 4, (N, T)).astype(np.uint8))
    pat = text[:, 5 : 5 + L].clone()
    pat[:, ::37] = 4
    logq = torch.from_numpy(np.log(rng.uniform(1e-4, 0.3, (N, L))).astype(np.float32))
    plen = torch.tensor([L, L - 100, 0], dtype=torch.int32)
    tlen = torch.tensor([T - 1, L, T - 1], dtype=torch.int32)
    eb = torch.full((N,), 5, dtype=torch.int32)
    a0 = affine_cuda.affine_extend_core_cuda.launches
    d0 = dp_cuda.fitting_edit_distance_core_cuda.launches
    got = affine_cuda.affine_extend_cuda(pat, logq, plen, text, tlen, plen, eb)
    ref = affine_extend_plain(pat, logq, plen, text, tlen, plen, eb)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    got = dp_cuda.fitting_edit_distance_cuda(pat, logq, plen, text, anchored=True)
    ref = fitting_edit_distance_plain(pat, logq, plen, text, anchored=True)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert affine_cuda.affine_extend_core_cuda.launches == a0
    assert dp_cuda.fitting_edit_distance_core_cuda.launches == d0
