"""tools/profile_host_torch.py single on the CPU at a small size against
snap_tpu's SingleEndAligner on the same batch: its JSON line, plan_ok,
the reads of each host branch and the SAM bytes, on the fast path and on
a batch whose DP tier overflowed (test_torch_profile_tools.py says what
the other files hold)."""

import io
import json
from types import SimpleNamespace

import pytest
import torch

import snap_tpu.align.pipeline as JP
import snap_tpu_torch.align.pipeline as TP
from snap_tpu.align.single import SingleEndAligner as JSingle
from snap_tpu.index import index as JI
from snap_tpu.io.output import OutputWriter as JWriter
from test_torch_pipeline import same_logq  # noqa: F401
from test_torch_profile_tools import GENOME, SMALL, host_tool, jax_batch, jax_genome, run_main

torch.set_num_threads(1)


def run_jax_single(genome, batch):
    """snap_tpu's SingleEndAligner on the tool's genome and batch, as the
    tool drives the port's: (SAM bytes, plan_ok, planned rows)."""
    index = JI.GenomeIndex.build(jax_genome(genome), seed_len=24)
    aligner = JSingle(index, JP.AlignParams(seed_len=24, max_probe=index.max_probe,
                                            num_seeds=25, hit_cap=8, max_cand=16),
                      batch_size=len(batch))
    sink = io.BytesIO()
    writer = JWriter(out=sink, genome=index.genome_meta, command_line="profile")
    plan_ok = aligner._plan_ok(writer)
    jb = jax_batch(batch)
    handles, fc = aligner._submit(jb)
    results, plan = aligner._finalize(jb, handles, fc, plan_writer=writer)
    planned = 0 if plan is None else len(plan["rows"])
    if plan is not None:
        aligner._emit_planned(writer, jb, results, plan)
    else:
        for i, res in enumerate(results):
            aligner._emit(writer, jb, i, res)
    return sink.getvalue(), plan_ok, planned


def overflowed(base, seen: list):
    """A HostWinners that records each batch's dp_overflow flag, and sets
    it (test_torch_single's way to reach the DP tier's overflow redo)."""
    class Overflowed(base):
        def __init__(self, packed):
            super().__init__(packed)
            seen.append(self.dp_overflow)
            self.dp_overflow = True

    return Overflowed


@pytest.mark.parametrize("overflow", [False, True], ids=["fast", "dp_overflow"])
def test_host_single_equals_snap_tpu(same_logq, tmp_path, overflow):
    argv = ["single", *SMALL, "--batch", "64", "--sam", str(tmp_path / "t.sam"), "--top", "5"]
    if overflow:
        argv += ["--repeat-frac", "0.25"]
    else:
        argv.append("--cprofile")
    seen_t, seen_j = [], []
    with pytest.MonkeyPatch.context() as mp:
        if overflow:
            mp.setattr(TP, "HostWinners", overflowed(TP.HostWinners, seen_t))
            mp.setattr(JP, "HostWinners", overflowed(JP.HostWinners, seen_j))
        result, last = run_main(host_tool.main, argv)
        args = SimpleNamespace(genome=GENOME, repeat_frac=0.25 if overflow else 0.0,
                               batch=64, read_len=100, err=0.01)
        genome, batch = host_tool.single_inputs(args)
        ref_sam, plan_ok, planned = run_jax_single(genome, batch)
    assert last == json.loads(json.dumps(result))
    assert last["mode"] == "single" and last["device"] == "cpu"
    for k in ("submit", "getwin", "finalize", "emit", "host_half"):
        assert last[k]["min_ms"] >= 0
    (p,) = last["passes"]
    br = p["branches"]
    assert last["plan_ok"] is plan_ok is True
    assert (tmp_path / "t.sam").read_bytes() == ref_sam
    assert last["sam_bytes"] == len(ref_sam)
    if overflow:
        # the redo ran on both sides, and its time is in the redo calls
        assert seen_t and seen_j and len(seen_t) == len(seen_j)
        assert br.get("dp_overflow") == br.get("two_phase") == 64 and planned == 0
        assert "planned" not in br
        assert {"align_tier1", "two_phase_merge"} <= set(p["calls"])
    else:
        assert br.get("planned") == planned > 0
        assert "dp_overflow" not in br
        top = last["cprofile"]["top"]
        assert len(top) == 5 and not any(r["wait"] for r in top)  # no card


