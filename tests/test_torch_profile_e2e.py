"""tools/profile_e2e_torch.py on the CPU at a small size: its JSON line,
its phases against its wall, and its SAM against `snap_tpu single` run
on its FASTQ with the same relative command line (test_torch_profile_
tools.py says what the other files hold)."""

import json

import snap_tpu.cli as jcli
from test_torch_pipeline import same_logq  # noqa: F401
from test_torch_profile_tools import GENOME, e2e_tool, run_main


def test_e2e_sam_equals_snap_tpu_single(same_logq, tmp_path, monkeypatch):
    wd = tmp_path / "port"
    result, last = run_main(e2e_tool.main, [
        "--device", "cpu", "--batch", "64", "--batches", "2", "--genome", str(GENOME),
        "--workdir", str(wd)])
    assert last == json.loads(json.dumps(result))
    sec = last["seconds"]
    assert set(sec) == {*e2e_tool.PHASES, "wall"}
    assert sum(sec[k] for k in e2e_tool.PHASES) <= sec["wall"]
    assert last["reads"] == 128 and last["plan_ok"] is True
    ref = tmp_path / "jax"
    ref.mkdir()
    for f in ("g.fa", "r.fq"):
        (ref / f).write_bytes((wd / f).read_bytes())
    monkeypatch.chdir(ref)
    monkeypatch.setattr(jcli, "_maybe_mesh", lambda opts: (None, 1))
    assert jcli.main(["index", "g.fa", "idx", "-s", "24"]) == 0
    assert jcli.main(["single", "idx", "r.fq", "-o", "out.sam", "-b", "64", "-rl", "100"]) == 0
    want = (ref / "out.sam").read_bytes()
    assert (wd / "out.sam").read_bytes() == want
    assert last["sam_bytes"] == len(want)


