"""tools/profile_host_torch.py paired on the CPU at a small size against
snap_tpu's PairedEndAligner on the same pairs: its JSON line, plan_ok,
the pairs of each branch (the device intersection's wide tier, the
host overflow redo, slow and planned rows) and the SAM bytes, on a
random genome and on one of 25% repeats with narrowed intersection
tiers (test_torch_profile_tools.py says what the other files hold)."""

import functools
import io
import json
from types import SimpleNamespace

import pytest
import torch

import snap_tpu.align.intersect_device as JD
import snap_tpu.align.pipeline as JP
import snap_tpu_torch.align.intersect_device as TD
from snap_tpu.align.paired_driver import PairedEndAligner as JPaired
from snap_tpu.index import index as JI
from snap_tpu.io.output import OutputWriter as JWriter
from test_torch_pipeline import same_logq  # noqa: F401
from test_torch_profile_tools import GENOME, SMALL, host_tool, jax_batch, jax_genome, run_main

torch.set_num_threads(1)


def narrow_tiers(mp):
    """Both packages' device intersection at test_torch_paired's narrow
    tiers (standard 32/32, wide 96/64), so that a 200 kbp genome of 25%
    repeats reaches the wide tier and the host overflow redo."""
    for m in (JD, TD):
        mp.setattr(m, "DeviceIntersectParams",
                   functools.partial(m.DeviceIntersectParams, hit_cap=32, cand_width=32))
        mp.setattr(m, "paired_wide_redo",
                   functools.partial(m.paired_wide_redo, hit_cap=96, cand_width=64))


@pytest.mark.parametrize("genome,repeat_frac", [(GENOME, 0.0), (200_000, 0.25)],
                         ids=["random", "repeats_narrow_tiers"])
def test_host_paired_equals_snap_tpu(same_logq, tmp_path, genome, repeat_frac):
    argv = ["paired", *SMALL, "--genome", str(genome), "--repeat-frac", str(repeat_frac),
            "--pairs", "64", "--sam", str(tmp_path / "t.sam"), "--cprofile", "--top", "5"]
    with pytest.MonkeyPatch.context() as mp:
        if repeat_frac:
            narrow_tiers(mp)
        result, last = run_main(host_tool.main, argv)
        args = SimpleNamespace(genome=genome, repeat_frac=repeat_frac, pairs=64, read_len=100,
                               err=0.01, indel_frac=0.10)
        g, (b0, b1) = host_tool.paired_inputs(args)
        index = JI.GenomeIndex.build(jax_genome(g), seed_len=24)
        aligner = JPaired(index, JP.AlignParams(seed_len=24, max_probe=index.max_probe,
                                                num_seeds=8, hit_cap=8, max_cand=16),
                          batch_size=64)
        sink = io.BytesIO()
        writer = JWriter(out=sink, genome=index.genome_meta, command_line="profile")
        assert aligner._plan_ok(writer) is last["plan_ok"] is True
        j0, j1 = jax_batch(b0), jax_batch(b1)
        results, plan = aligner.align_batch(j0, j1, plan_writer=writer)
        aligner._emit_planned_pairs(writer, j0, j1, results, plan)
    assert last == json.loads(json.dumps(result))
    (p,) = last["passes"]
    st = p["stats"]
    assert st == {k: getattr(aligner.stats, k) for k in host_tool.PAIRED_STATS}
    assert st["paired_slow_rows"] > 0 and st["paired_planned_rows"] > 0
    assert p["branches"].get("planned") == plan["pairs"].size
    assert (tmp_path / "t.sam").read_bytes() == sink.getvalue()
    parts = p["calls"]
    assert {"_device_intersect", "two_phase_merge", "_plan_pairs"} <= set(parts)
    assert 0 < p["per_pair_loop"] <= p["align_batch"] <= p["wall"]
    assert len(last["cprofile"]["top"]) == 5
    if repeat_frac:  # both the wide tier and the overflow redo ran
        assert st["intersect_wide_pairs"] > 0 and st["intersect_overflow_pairs"] > 0
        assert p["branches"]["host_overflow_redo"] == st["intersect_overflow_pairs"]
        assert parts["_redo_overflow_pairs"]["calls"] == 1
