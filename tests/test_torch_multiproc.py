"""tools/multiproc_check_torch.py in Tier-1: two OS processes joined by
torch.distributed over gloo, each owning 4 CPU positions of a global
mesh (data = 8 x index = 1, and data = 4 x index = 2), must produce the
single-process run's winner rows and sum their AlignerStats (the twin of
tests/test_multiproc.py, held against the port's own single-process
run). On three meshes whose data rows span both processes (1 x 8, and
2 x 4 with interleaved and with uneven columns) the winners, tier-1
tiles and paired candidates of both ranks of a shared row must be
identical and equal the single-process run's. The tool's processes
import no JAX; the test gives the run a time limit of its own."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_multiproc_torch_check():
    env = dict(os.environ, PYTHONPATH=REPO)
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(k, None)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "multiproc_check_torch.py")],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=480,
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1].startswith("MULTIPROC OK"), lines[-5:]
    assert "8x1: 512 winner rows identical" in out.stdout
    assert "4x2: 512 winner rows identical" in out.stdout
    assert out.stdout.count("stats_total=512 OK") == 2
    for name in ("1x8", "2x4-alt", "2x4-uneven"):
        assert (f"{name}: 128 winner and tier-1 rows and 64 paired rows identical "
                "to the single-process run; shared rows identical across ranks"
                ) in out.stdout, name
        assert out.stdout.count(f"{name} stats_total=128 OK") == 2, name
