"""Shared set-up of the benchmark's CPU tests: a temporary copy of the
benchmark (BENCHMARK.json and benchmark/) to which a tiny configuration,
a tiny cell, its traffic and limits, and one more per-layer metric are
added as files alone, and a CPU run of the cell there."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CELLS = {
    # cell: (traffic of the real benchmark it shrinks, batch, pool batches, sample)
    "tiny.single": ("human100.b16384", 16, 2, 16),
}
EXTRA_METRIC = "judged_reads"


def add_tiny_cells(root: str) -> None:
    """Add the tiny configuration, cells, traffic, limits and a metric
    to the copy at root, as files and BENCHMARK.json entries only."""
    bdir = os.path.join(root, "benchmark")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(bdir, "configs", "chr21.json")) as f:
        cfg = json.load(f)
    # N runs at the start, inside and at the end, as chr21 has them
    cfg.update(name="tiny", contig="tiny", genome_bp=200_000, repeat_frac=0.1,
               n_runs=[[0, 3000], [120_000, 1000], [199_000, 1000]],
               genome_seed=5, index_options=["-s", "20"], reduced=[])
    with open(os.path.join(bdir, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    bench["configs"].append({"name": "tiny", "source": "https://example.org/tiny",
                             "file": "benchmark/configs/tiny.json", "reduced": [],
                             "why": "a genome a CPU test aligns in seconds"})
    for cell, (src, batch, pool_batches, sample) in TINY_CELLS.items():
        with open(os.path.join(bdir, "traffic", src + ".json")) as f:
            tr = json.load(f)
        tr.update(batch=batch, pool_batches=pool_batches, sample=sample,
                  sizing_reads_per_s=1)
        # a quarter of the reads with an indel (chip_smoke's stress model),
        # so the few reads of a tiny window hold some for the control to miss
        tr["errors"]["indel_share"] = 0.25
        with open(os.path.join(bdir, "traffic", cell + ".json"), "w") as f:
            json.dump(tr, f)
        with open(os.path.join(bdir, "limits", cell + ".json"), "w") as f:
            json.dump({"wrong_share": 0.2}, f)
        bench["workloads"].append({"name": cell, "config": "tiny", "traffic": cell,
                                   "chips": 1, "why": "CPU test"})
    for m in bench["per_layer"]:
        m["workloads"] = m["workloads"] + list(TINY_CELLS)
    bench["per_layer"].append({"name": EXTRA_METRIC, "unit": "reads", "better": "higher",
                               "source": "program_counter", "layer": "CLI, readers and writers",
                               "moves": "reads_per_s", "workloads": list(TINY_CELLS)})
    with open(os.path.join(bdir, "metrics", EXTRA_METRIC + ".py"), "w") as f:
        f.write('"""Reads the window aligned."""\n\n\ndef read(record):\n'
                '    return record["reads"]\n')
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bench_copy"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    add_tiny_cells(root)
    return root


@pytest.fixture(scope="session")
def tiny_cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_cache"))


@pytest.fixture(scope="session")
def cpu():
    import torch

    torch.set_num_threads(min(4, torch.get_num_threads()))
    return torch.device("cpu")


def run_tiny(root, cache, cell_name, seed, trace_on, device):
    """One CPU run of a tiny cell: (result, record, log text)."""
    import io

    from snapbench import runner
    from snapbench.layout import load_cell

    log = io.StringIO()
    r = runner.run_cell(load_cell(cell_name, root), seed, 1.0, trace_on, device,
                        log=log, root=root, cache_dir=cache)
    return r, r.pop("_record"), log.getvalue()


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
