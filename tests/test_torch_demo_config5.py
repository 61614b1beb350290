"""tools/demo_config5_torch.py on the CPU at a small size: BASELINE config
5 in one run through the port's CLI (paired over a data 4 x index 2 mesh
of eight CPU positions to a sorted, duplicate-marked BAM and its .bai).
The tool's process imports no JAX; its JSON must pass every check, with
every planted duplicate record flagged (golden_harness's pairs have no
unmapped ends)."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_demo_config5_torch_on_cpu(tmp_path):
    out = tmp_path / "c5.json"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    run = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "demo_config5_torch.py"),
         "--device", "cpu", "--pairs", "300", "--genome-size", "200000",
         "--batch", "256", "--workdir", str(tmp_path / "work"), "--out", str(out)],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300,
    )
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-4000:]
    rec = json.loads(out.read_text())
    assert rec["pass"] and rec["mesh"] == {"data": 4, "index": 2}
    assert rec["pairs"] == 324 and rec["records"] == 648
    assert rec["coordinate_sorted"] and rec["bai_present"] and rec["sort_order_header"]
    assert rec["planted_dup_records_flagged"] == rec["planted_dup_records"] == 48
