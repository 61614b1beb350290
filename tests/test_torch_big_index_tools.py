"""The port's BASELINE config 4 tools on the CPU at their smallest size,
against the JAX package's: tools/build_big_index_torch.py against
tools/build_big_index.py, tools/bench_big_torch.py against
tools/bench_big.py.

(a) both builders at --gbp 0.003 (the smallest genome their synthesizer
takes) with a budget of 2-8 banks write the same index files byte for
byte; (b) both benches on that index count the same reads, aligned
reads, positions within 32 bases and MAPQ >= 10 reads, and the port's
card_index_bytes is the builder's card_bytes; (c) neither port tool
imports jax or snap_tpu; (d) --device cuda without a card raises;
(e) the fit check stops an index larger than the card's free bytes
before any tensor is made. Both packages get the port's ln P(error)
table (test_torch_pipeline's same_logq says why).
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from test_torch_pipeline import same_logq  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
sys.path.insert(0, TOOLS)

import bench_big as jax_bench  # noqa: E402
import bench_big_torch as bench  # noqa: E402
import build_big_index as jax_build  # noqa: E402
import build_big_index_torch as build  # noqa: E402

torch.set_num_threads(1)

GBP = "0.003"
BUDGET = "0.07"   # 3.05e6 triples x 65 B over 0.07 GiB: 4 banks
INDEX_FILES = ("table.npy", "hits.npy", "genome_bases.npy", "genome_meta.json",
               "index_meta.json")
BENCH_ARGV = ["--reads", "2048", "--batch", "1024"]
SAME_KEYS = ("genome_bases", "reads", "frac_aligned", "frac_pos_correct_of_aligned",
             "mapq_ge_10")


def quiet(fn, *args):
    """fn(*args) with its progress lines captured: (result, stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return result, out.getvalue()


def run_jax_tool(module, argv):
    with mock.patch.object(sys, "argv", [module.__file__, *argv]):
        return quiet(module.main)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Both builders' index directories and the port builder's JSON."""
    d = tmp_path_factory.mktemp("bigidx")
    port, jax = str(d / "port"), str(d / "jax")
    result, out = quiet(build.main, [port, "--gbp", GBP, "--budget-gb", BUDGET])
    run_jax_tool(jax_build, [jax, "--gbp", GBP, "--budget-gb", BUDGET])
    return port, jax, result, out


def test_build_equals_jax_builder(built):
    port, jax, result, out = built
    assert 2 <= result["n_banks"] <= 8
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax)) == sorted(INDEX_FILES)
    for f in INDEX_FILES:
        with open(os.path.join(port, f), "rb") as a, open(os.path.join(jax, f), "rb") as b:
            assert a.read() == b.read(), f
    lines = out.strip().splitlines()
    assert lines[-2].startswith("TOTAL ") and json.loads(lines[-1]) == result
    assert result["file_bytes"] == {f: os.path.getsize(os.path.join(port, f))
                                    for f in INDEX_FILES}
    assert result["table_shape"][0] == result["n_banks"]
    assert not os.path.exists(port + ".tmp")


def test_bench_equals_jax_bench(built, tmp_path, same_logq):  # noqa: F811
    port, _, built_result, _ = built
    first = str(tmp_path / "first.npy")
    rec, out = quiet(bench.main, [port, *BENCH_ARGV, "--device", "cpu",
                                  "--out", str(tmp_path / "port.json"),
                                  "--first-winners", first, "--cpu-check", "32"])
    _, jout = run_jax_tool(jax_bench, [port, *BENCH_ARGV, "--out", str(tmp_path / "jax.json")])
    jrec = json.loads(jout.strip().splitlines()[-1])
    assert {k: rec[k] for k in SAME_KEYS} == {k: jrec[k] for k in SAME_KEYS}
    assert json.loads(out.strip().splitlines()[-1]) == rec
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == rec
    assert rec["backend"] == "cpu" and rec["card_peak_bytes"] is None
    assert rec["card_index_bytes"] == built_result["card_bytes"]
    assert round(rec["found"] / rec["reads"], 4) == rec["frac_aligned"]
    assert np.load(first).shape == (1024 + 1, 6)
    assert rec["step_ms_median"] > 0 and rec["host_peak_rss_bytes"] > 0
    assert rec["cpu_check"] == {"reads": 32, "rows_differ": 0, "first_rows": []}


@pytest.mark.parametrize("tool", ["build_big_index_torch", "bench_big_torch"])
def test_tool_imports_no_jax(tool, tmp_path):
    """A fresh interpreter imports the tool and runs it at its smallest
    size; neither jax nor snap_tpu is imported."""
    idx = str(tmp_path / "idx")
    run = ["build_big_index_torch.main([%r, '--gbp', %r, '--budget-gb', %r])"
           % (idx, GBP, BUDGET)]
    if tool == "bench_big_torch":
        run.append("bench_big_torch.main([%r, '--reads', '64', '--batch', '64', "
                   "'--device', 'cpu', '--out', %r])" % (idx, str(tmp_path / "b.json")))
    code = (f"import sys; sys.path.insert(0, {TOOLS!r}); import torch; "
            "torch.set_num_threads(1); import build_big_index_torch, bench_big_torch; "
            + "; ".join(run) + "; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'snap_tpu', 'bench')); "
            "print('imported:', bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-2])["metric"].startswith("hg38_scale")


def test_bench_raises_on_cuda_without_card(built):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([built[0], "--device", "cuda"])


# the 3.1 Gbp index of build_big_index.py's defaults: 8 banks of 2^26
# buckets (2^32 slots), 3.1e9 hits
FULL_TABLE = (8, ((1 << 26) + 64) * 8, 4)
FULL_HITS = 3_099_999_448
FULL_BASES = 3_100_049_984
H100_TOTAL = 85_031_714_816


def test_fit_check_needs_more_than_free():
    need = bench.card_bytes(FULL_TABLE, FULL_HITS, FULL_BASES)
    assert need > 85e9
    with pytest.raises(RuntimeError, match=f"needs {need:,} bytes.*gives 84,000,000,000 "
                                           f"bytes free of {H100_TOTAL:,}"):
        bench.fit_check(FULL_TABLE, FULL_HITS, FULL_BASES, 84_000_000_000, H100_TOTAL)
    assert bench.fit_check(FULL_TABLE, FULL_HITS, FULL_BASES, need, H100_TOTAL) == need


def test_bench_stops_before_any_copy(built):
    """With a card that has too little free memory, main raises the fit
    check's error before the index is loaded or any tensor is made."""
    port, _, result, _ = built

    def no_tensor(*a, **k):
        raise AssertionError("a tensor was made before the fit check")

    free = result["card_bytes"] - 1
    with mock.patch.object(bench, "index_shapes", wraps=bench.index_shapes) as shapes, \
            mock.patch("snap_tpu_torch.resolve_device", return_value=torch.device("cuda", 0)), \
            mock.patch("torch.cuda.mem_get_info", return_value=(free, H100_TOTAL)), \
            mock.patch("snap_tpu_torch.index.index.GenomeIndex.load", no_tensor), \
            mock.patch("torch.from_numpy", no_tensor), mock.patch("torch.full", no_tensor), \
            mock.patch("torch.tensor", no_tensor):
        with pytest.raises(RuntimeError, match=f"needs {result['card_bytes']:,} bytes.*"
                                               f"gives {free:,} bytes free"):
            bench.main([port, "--device", "cuda"])
    shapes.assert_called_once_with(port)


def test_load_keeps_one_host_copy_of_the_table(built):
    """make_device_index reads a chunked build's table through its memory
    map: on the CPU the index's table is the mapped file itself, so the
    host never holds a second copy of it (on a card, .to() copies from
    the mapped pages)."""
    from snap_tpu_torch.index.index import GenomeIndex

    index = GenomeIndex.load(built[0], "cpu")
    table = index._host_arrays["table"]
    assert isinstance(table.base, np.memmap) and not table.flags.owndata
    assert index.device.table.data_ptr() == table.ctypes.data


def test_config4_script_on_the_cpu(tmp_path):
    """tools/config4_one_card.sh at the smallest size with DEVICE=cpu:
    the build, the table check, one bench batch with its 1,024-read
    check, the host's resources sampled, and no process left behind."""
    out = tmp_path / "out"
    proc = subprocess.Popen(
        ["bash", os.path.join(TOOLS, "config4_one_card.sh"), str(tmp_path / "idx"),
         str(out), GBP, BUDGET, "1"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True,
        env=dict(os.environ, DEVICE="cpu", PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    log, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, log[-3000:]
    assert subprocess.run(["pgrep", "-s", str(proc.pid)]).returncode == 1
    build_lines = (out / "build.log").read_text().strip().splitlines()
    assert json.loads((out / "build.json").read_text()) == json.loads(build_lines[-1])
    rec = json.loads((out / "BIGIDX_torch.json").read_text())
    assert rec["reads"] == 16384 and rec["backend"] == "cpu"
    assert rec["cpu_check"]["rows_differ"] == 0
    assert "mem_available" in (out / "resources.log").read_text()
