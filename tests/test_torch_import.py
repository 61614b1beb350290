"""snap_tpu_torch imports torch and numpy only, and its entry points
refuse a missing CUDA device instead of moving to the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "snap_tpu_torch",
    "snap_tpu_torch.constants",
    "snap_tpu_torch.genome",
    "snap_tpu_torch.io.genericfile",
    "snap_tpu_torch.io.fastq",
    "snap_tpu_torch.index.build",
    "snap_tpu_torch.index.index",
    "snap_tpu_torch.ops.sums",
    "snap_tpu_torch.ops.gapless",
    "snap_tpu_torch.ops.gapless_cuda",
    "snap_tpu_torch.ops.dp",
    "snap_tpu_torch.ops.dp_cuda",
    "snap_tpu_torch.ops.affine",
    "snap_tpu_torch.ops.affine_cuda",
    "snap_tpu_torch.ops.agcigar_cuda",
    "snap_tpu_torch.align.pipeline",
    "snap_tpu_torch.options",
    "snap_tpu_torch.errors",
    "snap_tpu_torch.stats",
    "snap_tpu_torch.io.native",
    "snap_tpu_torch.io.readers",
    "snap_tpu_torch.io.sam",
    "snap_tpu_torch.io.output",
    "snap_tpu_torch.io.bam",
    "snap_tpu_torch.io.bgzf",
    "snap_tpu_torch.io.bufferedasync",
    "snap_tpu_torch.index.host_lookup",
    "snap_tpu_torch.align.cigar",
    "snap_tpu_torch.align.agcigar",
    "snap_tpu_torch.align.adjust",
    "snap_tpu_torch.align.post",
    "snap_tpu_torch.align.intersect",
    "snap_tpu_torch.align.intersect_device",
    "snap_tpu_torch.align.paired",
    "snap_tpu_torch.align.single",
    "snap_tpu_torch.align.paired_driver",
    "snap_tpu_torch.cli",
    "snap_tpu_torch.__main__",
    "snap_tpu_torch.parallel",
    "snap_tpu_torch.parallel.mesh",
    "snap_tpu_torch.apps",
    "snap_tpu_torch.ops.probdist",
]

_CHECK = """
import importlib, sys
for m in {mods!r}:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "snap_tpu.")) or m == "snap_tpu")
assert not bad, bad
print("ok", len({mods!r}))
"""


def test_port_imports_neither_jax_nor_snap_tpu():
    # a fresh interpreter: this test process already imported jax
    # (tests/conftest.py)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _CHECK.format(mods=MODULES)],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f"ok {len(MODULES)}"


def test_chip_smoke_imports_neither_jax_nor_snap_tpu():
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    for line in src.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert words[1].split(".")[0] not in ("jax", "jaxlib", "snap_tpu"), line


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from snap_tpu_torch import resolve_device
    from snap_tpu_torch.index.index import make_device_index

    arrays = {
        "table": np.zeros((1, 16, 4), np.uint32),
        "hits": np.zeros(8, np.uint32),
        "seed_len": 20,
        "max_probe": 1,
    }
    bases = np.zeros(64, np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_device_index(arrays, bases)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_device_index(arrays, bases, device="cuda")
    assert make_device_index(arrays, bases, device="cpu").genome.device.type == "cpu"
