"""The benchmark's independence: no module a run loads is JAX's, its
libraries' or the JAX package's (top-level names compared whole, so
snap_tpu_torch passes), the reference imports nothing of the port, and
a run without a card, or without the port beside it, prints no result."""

import ast
import glob
import os
import shutil
import subprocess
import sys

from conftest import BENCH, ROOT
from snapbench.independence import forbidden_modules


def test_names_compared_whole():
    assert forbidden_modules(["snap_tpu_torch", "snap_tpu_torch.cli", "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["snap_tpu.cli", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "snap_tpu"]


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_port():
    files = glob.glob(os.path.join(BENCH, "reference", "*.py"))
    assert files
    for f in files:
        names = set(_imports(f))
        assert not names & {"snap_tpu_torch", "snap_tpu", "jax", "jaxlib", "snapbench"}, f


def test_no_benchmark_file_imports_jax():
    for f in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True):
        assert not set(_imports(f)) & {"snap_tpu", "jax", "jaxlib", "flax"}, f


def test_a_run_loads_no_jax_module():
    # everything a run imports, in a fresh interpreter
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import run, readings\n"
        "from snapbench import runner, trace, check, genome, traffic, layout\n"
        "from snapbench.layout import load_cell, metric_reader\n"
        "import json\n"
        "for m in json.load(open(%r))['per_layer']: metric_reader(m['name'])\n"
        "import snap_tpu_torch.cli, snap_tpu_torch.align.single\n"
        "import snap_tpu_torch.ops.affine_cuda, snap_tpu_torch.ops.dp_cuda, snap_tpu_torch.ops.gapless_cuda\n"
        "from snapbench.independence import forbidden_modules\n"
        "print(forbidden_modules(), 'snap_tpu_torch' in sys.modules)\n"
    ) % (BENCH, ROOT, os.path.join(ROOT, "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == "[] True"


def _run(cwd, workload="ecoli.single"):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload, "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_without_the_port_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = _run(str(tmp_path))
    assert out.returncode != 0 and out.stdout == ""
