"""The port's profiling tools on the CPU at a small size, against
snap_tpu: tools/profile_step_torch.py, profile_host_torch.py and
profile_e2e_torch.py. This file holds (a), (b) and (e);
test_torch_profile_host.py the single-end half of (c),
test_torch_profile_paired.py its paired half, test_torch_profile_e2e.py
(d).

(a) each tool's main(argv) with --device cpu prints one JSON object as
its last line, holding its figures; (b) the step tool's stages are the
port's own functions, and their outputs on the tool's inputs equal
snap_tpu's functions of the same name bit for bit; (c) the host tool's
branch counts and SAM bytes equal snap_tpu's aligners' on the same batch
(single end, with and without a DP-tier overflow; paired end); (d) the
end-to-end tool's SAM equals `snap_tpu single`'s on its FASTQ, and its
phases add up to at most its wall; (e) no tool imports JAX or snap_tpu,
and --device cuda without a card raises. Both packages get the port's
ln P(error) table (test_torch_pipeline's same_logq says why).
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import snap_tpu.align.pipeline as JP
from snap_tpu.genome import Contig as JContig
from snap_tpu.genome import Genome as JGenome
from snap_tpu.index import index as JI
from snap_tpu.io.fastq import ReadBatch as JReadBatch
from test_torch_pipeline import assert_same, same_logq  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
sys.path.insert(0, TOOLS)

import profile_e2e_torch as e2e_tool  # noqa: E402
import profile_host_torch as host_tool  # noqa: E402
import profile_step_torch as step_tool  # noqa: E402

torch.set_num_threads(1)

GENOME = 60_000
SMALL = ["--device", "cpu", "--genome", str(GENOME), "--iters", "1", "--warm", "0"]


def run_main(main, argv):
    """main(argv) with its stdout captured: (its result, the last line
    parsed as JSON)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return result, json.loads(out.getvalue().strip().splitlines()[-1])


def jax_genome(g):
    return JGenome(bases=g.bases, contigs=[
        JContig(name=c.name, start=c.start, length=c.length) for c in g.contigs])


def jax_batch(b):
    return JReadBatch(ids=list(b.ids), bases=b.bases, quals=b.quals, lengths=b.lengths)


# ------------------------------------------------------------ (a), (b): step


def test_step_tool_prints_its_figures(capsys):
    stages = "sync,pack_read_seeds,probe,gather_hits,candidates,align_tier1,d2h"
    result = step_tool.main([*SMALL, "--batch", "32", "--stages", stages,
                             "--sizes", "32"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == json.loads(json.dumps(result))
    assert last["device"] == "cpu" and "nvidia_smi" not in last
    assert list(last["stages"]) == stages.split(",")
    for r in last["stages"].values():
        assert r["wall_ms"] > 0 and r["device_ms"] is None and r["busy_ms"] is None
    assert set(last["inline"]) == {"rank_select", "sort_dedup_topk"}
    (sw,) = last["sweep"]
    assert sw["batch"] == 32 and sw["reads_per_s"] > 0 and sw["steps"] == 1


@pytest.fixture(scope="module")
def step_case(same_logq):
    """The step tool's context (64 reads) and snap_tpu's inputs from the
    same numpy arrays."""
    ctx = step_tool.make_context(torch.device("cpu"), 64, 100, GENOME, 0.01)
    jd = JI.make_device_index(ctx.arrays, ctx.genome.bases)
    jin = tuple(map(jnp.asarray, (ctx.reads, ctx.quals, ctx.lens)))
    stages, prepare = step_tool.build_stages(ctx)
    return SimpleNamespace(ctx=ctx, jd=jd, jin=jin, stages=stages, prepare=prepare,
                           jp=JP.AlignParams(**ctx.params_kw))


def jax_stage(case, name):
    """snap_tpu's function of the stage's name on the same inputs."""
    jd, (b, q, l), jp = case.jd, case.jin, case.jp
    B, L = case.ctx.reads.shape
    if name == "pack_read_seeds":
        return JI.pack_read_seeds(b, jp.seed_len)
    fwd, rc, _ = JI.pack_read_seeds(b, jp.seed_len)
    offs = jnp.asarray(step_tool.probe_offsets(jp, L))
    canon = jnp.minimum(fwd[:, offs], rc[:, offs]).reshape(-1)
    _, start, n0, n1 = probe = JI.probe(jd, canon, jp.max_probe)
    if name == "probe":
        return probe
    if name == "gather_hits":
        f = JI.gather_hits(jd.hits, start, n0, jp.hit_cap)
        r = JI.gather_hits(jd.hits, start + n0.astype(jnp.int64), n1, jp.hit_cap)
        return (*f, *r)
    if name == "align_tier1":
        return JP.align_tier1(jd, b, q, l, jp)
    jp_a, dp_a = step_tool.phase_a(jp, B, L)
    assert jp_a == dataclasses.replace(jp, num_seeds=jp_a.num_seeds, max_cand=4)
    bundle, lowest = JP._awd_candidates(jd, b, q, l, jp_a, return_lowest=True)
    if name == "a_candidates":
        return (*bundle, lowest)
    out_a, needs_a = JP._awd_score(jd, b, q, bundle, jp_a, dp_a)
    if name == "a_score":
        return (*out_a, needs_a)
    packed, _, run_all, run_na = JP._awd_finalize(
        jd, b, out_a, jnp.int64(case.ctx.genome.bases.shape[0]), needs_a, jp, dp_a,
        True, 64, return_scores=True)
    return packed, run_all, run_na


def port_stage(case, name):
    case.prepare(name)
    got = case.stages[name]()
    if name == "gather_hits":
        return (*got[0], *got[1])
    if name == "a_candidates":
        return (*got[0], got[1])
    if name == "a_score":
        return (*got[0], got[1])
    if name == "a_finalize":
        return got[0], got[2], got[3]
    return got


@pytest.mark.parametrize("name", ["pack_read_seeds", "probe", "gather_hits", "align_tier1",
                                  "a_candidates", "a_score", "a_finalize"])
def test_step_stage_equals_snap_tpu(step_case, name):
    ref, got = jax_stage(step_case, name), port_stage(step_case, name)
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(ref, got)):
        a = np.asarray(a)
        if a.dtype == np.uint64:  # the port holds uint64 bits in int64
            a = a.view(np.int64)
        assert_same(a, b, f"{name}[{i}]")
    if name == "a_score":
        assert int(got[-1]) > 0  # the DP tier ran


# -------------------------------------------------------------------- (e)


TINY = ["--device", "cpu", "--genome", "20000", "--iters", "1", "--warm", "0"]


@pytest.mark.parametrize("tool,argv", [
    ("profile_step_torch", ["--batch", "8", "--stages", "sync,candidates", *TINY]),
    ("profile_host_torch", ["single", "--batch", "8", *TINY]),
    ("profile_host_torch", ["paired", "--pairs", "16", *TINY]),
    ("profile_e2e_torch", ["--batch", "8", "--batches", "1", "--genome", "20000",
                           "--device", "cpu"]),
], ids=["step", "host_single", "host_paired", "e2e"])
def test_tool_imports_no_jax(tool, argv):
    """A fresh interpreter imports the tool and runs it at a tiny size;
    neither jax nor snap_tpu (nor bench.py) is imported."""
    code = (f"import sys; sys.path.insert(0, {TOOLS!r}); import {tool}; "
            f"{tool}.main({argv!r}); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'snap_tpu', 'bench')); "
            "print('imported:', bad); sys.exit(1 if bad else 0)")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    assert json.loads(run.stdout.strip().splitlines()[-2])["device"] == "cpu"


@pytest.mark.parametrize("argv", [
    ["--stages", "sync"], ["single"], ["paired"], ["--batches", "1"]],
    ids=["step", "host_single", "host_paired", "e2e"])
def test_tool_raises_on_cuda_without_card(argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    main = {"--stages": step_tool.main, "single": host_tool.main,
            "paired": host_tool.main, "--batches": e2e_tool.main}[argv[0]]
    with pytest.raises(RuntimeError, match="CUDA"):
        main([*argv, "--device", "cuda"])
