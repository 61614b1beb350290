"""On the card only (marked cuda; skips elsewhere): one short run of a
cell through the benchmark's command, read as the driver reads it."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_on_the_card(cuda_device, trace):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ecoli.single", "--seed",
         str(2**31 + 3), "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
    assert out.stderr.strip().splitlines()[-1].startswith("check wrong_share ")
    if trace:
        assert res["device"]["busy_s"] > 0 and "device_idle_frac" in res["metrics"]
    else:
        assert res["metrics"]["reads_per_s"]["value"] > 0
