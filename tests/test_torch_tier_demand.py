"""The DP tier's demand and the two-phase device re-run in the port's
stage spans (snap_tpu_torch.stats.RECORDER), on the CPU: each batch's
first finalize.unpack span counts the rows each phase of the device step
needed and held, as align/pipeline.py computed them for that batch; a
batch whose tier overflowed shows a two_phase.tier1 span inside
redo.dp_overflow, a clean one none; with the recorder off the demand
is not copied.

One test is marked `cuda` and skips without a card: the kernel wrappers'
route counts add up to their launches. On a machine with a card (and no
JAX, so without tests/conftest.py):

    python -m pytest --noconftest -m cuda tests/test_torch_tier_demand.py -s
"""

from collections import Counter

import pytest
import torch

from snap_tpu_torch import cli
from snap_tpu_torch.align import pipeline as TP
from snap_tpu_torch.align import single as tsingle
from snap_tpu_torch.stats import RECORDER
from test_torch_cli_cuda import write_inputs

torch.set_num_threads(1)

N_READS = 192   # three batches of -b 64
SINGLE = ["single", "idx", "r.fq", "-o", "out.sam", "-b", "64"]
PHASES = ("a", "b", "c")


def _run(directory, argv, device="cpu", record=True, tier_rows=None) -> dict:
    """The port's `single` in `directory` with the recorder on (or off):
    its spans, its SAM, and for each device step whether its demand was
    copied and the (rows needed, rows held) of each _awd_score call
    inside it, in the order the phases ran. tier_rows replaces phase A's
    DP tier."""
    steps, scores = [], []
    step, score = TP.align_winners_device, TP._awd_score
    prefetch = tsingle.SingleEndAligner._start_win_prefetch

    def counted_step(*a, **kw):
        scores.append([])
        return step(*a, **kw)

    def counted_prefetch(self, win, demand=None):
        steps.append(demand is not None)
        return prefetch(self, win, demand)

    def counted_score(didx, bases, quals, bundle, params, dp_rows):
        out, needs = score(didx, bases, quals, bundle, params, dp_rows)
        scores[-1].append((int(needs), dp_rows))
        return out, needs

    RECORDER.drain()
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(directory)
        mp.setattr(TP, "align_winners_device", counted_step)
        mp.setattr(TP, "_awd_score", counted_score)
        mp.setattr(tsingle.SingleEndAligner, "_start_win_prefetch", counted_prefetch)
        if tier_rows is not None:
            mp.setattr(TP, "_dp_rows_a", lambda B, params: tier_rows)
        if record:
            RECORDER.enable()
        try:
            assert cli.main(argv, device=device) == 0
        finally:
            RECORDER.disable()
    return {"spans": RECORDER.drain(), "sam": (directory / "out.sam").read_bytes(),
            "steps": steps, "scores": scores}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiers")
    write_inputs(str(d), "repeat25", N_READS)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(d)
        assert cli.main(["index", "g.fa", "idx", "-s", "20"], device="cpu") == 0
    return {"off": _run(d, SINGLE, record=False), "on": _run(d, SINGLE),
            # a tier of 4 rows: phase A of every batch needs more
            "overflow": _run(d, SINGLE, tier_rows=4)}


def _tier_counts(spans) -> dict:
    """{batch: the counts of its first finalize.unpack span}."""
    out = {}
    for name, _, _, _, batch, counts in sorted(spans, key=lambda s: s[1]):
        if name == "finalize.unpack" and batch not in out:
            out[batch] = counts
    return out


@pytest.mark.parametrize("run", ["on", "overflow"])
def test_unpack_counts_are_the_steps_demand(runs, run):
    r = runs[run]
    assert r["steps"] == [True] * 3
    got = _tier_counts(r["spans"])
    assert sorted(got) == [0, 1, 2]
    for batch, scores in enumerate(r["scores"]):
        assert len(scores) >= 2   # the adaptive step's phases A and B at least
        want = {}
        for phase, (need, rows) in zip(PHASES, scores):
            want[f"dp_need_{phase}"] = need
            want[f"dp_rows_{phase}"] = rows
        assert got[batch] == want
        assert want["dp_need_a"] > 0


def test_clean_batches_show_no_device_rerun(runs):
    spans = runs["on"]["spans"]
    for counts in _tier_counts(spans).values():
        assert all(counts[f"dp_need_{p}"] <= counts[f"dp_rows_{p}"]
                   for p in PHASES if f"dp_rows_{p}" in counts)
    names = {s[0] for s in spans}
    assert "two_phase.tier1" not in names and "redo.dp_overflow" not in names


def test_an_overflowed_batch_reruns_tier1_inside_the_redo(runs):
    spans = runs["overflow"]["spans"]
    tiers = _tier_counts(spans)
    assert all(c["dp_rows_a"] == 4 and c["dp_need_a"] > 4 for c in tiers.values())
    redo = {s[4]: s for s in spans if s[0] == "redo.dp_overflow"}
    tier1 = {s[4]: s for s in spans if s[0] == "two_phase.tier1"}
    assert sorted(redo) == sorted(tier1) == [0, 1, 2]
    for batch, (_, s, e, parent, _, counts) in tier1.items():
        assert parent == "redo.dp_overflow"
        assert counts == {"reads": 64}
        assert redo[batch][1] <= s <= e <= redo[batch][2]


def test_recorder_off_asks_for_no_demand(runs):
    off, on = runs["off"], runs["on"]
    assert off["steps"] == [False] * 3 and off["spans"] == []
    assert off["sam"] == on["sam"] and off["scores"] == on["scores"]


@pytest.mark.cuda
def test_route_counts_add_up_to_the_launches(tmp_path):
    """On the card, at -rl 256 (the long routes: gapless_split, dp_mid,
    affine_xl) and at the default -rl 128: every launch of the four
    wrappers (the emission AG CIGARs' too) counts once, by route, in the
    span open around it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from snap_tpu_torch.ops import affine_cuda, agcigar_cuda, dp_cuda, gapless_cuda

    write_inputs(str(tmp_path), "repeat25", N_READS)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path)
        assert cli.main(["index", "g.fa", "idx", "-s", "20"], device="cuda") == 0
    wrappers = {"gapless": gapless_cuda.gapless_prescreen_cuda,
                "dp": dp_cuda.fitting_edit_distance_core_cuda,
                "affine": affine_cuda.affine_extend_core_cuda,
                "agcigar": agcigar_cuda.ag_traceback_cuda}
    for rl, long_routes in (("256", {"gapless_split", "dp_mid", "affine_xl"}),
                            ("128", set())):
        before = {k: w.launches for k, w in wrappers.items()}
        r = _run(tmp_path, SINGLE + ["-rl", rl], device="cuda")
        torch.cuda.synchronize()
        routes = Counter()
        for *_, counts in r["spans"]:
            for k, v in counts.items():
                if k.startswith("launch."):
                    routes[k[len("launch."):]] += v
        by_family = Counter()
        for route, n in routes.items():
            by_family[route.split("_")[0]] += n
        assert by_family == {k: w.launches - before[k] for k, w in wrappers.items()}
        assert long_routes <= set(routes), routes
        print(rl, dict(routes))
