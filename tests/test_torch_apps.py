"""The apps and driver features through snap_tpu_torch against snap_tpu
(the twins of tests/test_apps.py): parse_wgsim_id, roc, tofastq, read
groups, the comma multi-run, the daemon round trip over a Unix socket,
and depth.

Each package builds its own index of the same 4 kbp genome in a
directory of its own and runs the same relative argv there, so the
@PG line's CL: field is the same and whole files compare byte for byte.
snap_tpu runs its CLI without a mesh and with the port's ln P(error)
table (test_torch_single.py says why). The port runs on the CPU.
"""

import gzip
import os
import threading
import time

import numpy as np
import pytest
import torch

import snap_tpu.apps as japps
import snap_tpu.cli as jcli
import snap_tpu_torch.apps as tapps
import snap_tpu_torch.cli as tcli
from test_torch_pipeline import same_logq  # noqa: F401

torch.set_num_threads(1)

SIM_SAM = [
    "@HD\tVN:1.6",
    "@SQ\tSN:chr1\tLN:10000",
    "chr1_100_250_a\t0\tchr1\t120\t70\t100M\t*\t0\t0\tACGT\tIIII",
    "chr1_100_250_b\t16\tchr1\t240\t70\t100M\t*\t0\t0\tACGT\tIIII",
    "chr1_100_250_c\t0\tchr1\t5000\t60\t100M\t*\t0\t0\tACGT\tIIII",
    "chr2_100_250_d\t0\tchr1\t100\t70\t100M\t*\t0\t0\tACGT\tIIII",
    "chr1_100_250_e\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\tIIII",
    "chr1_100_250_f\t256\tchr1\t100\t3\t100M\t*\t0\t0\tACGT\tIIII",
    "chr1_9_20_g\t0\tchr1\t75\t13\t100M\t*\t0\t0\tACGT\tIIII",
]


@pytest.mark.parametrize("qname", [
    b"chr1_100_250_0:0:0_0:0:0_1/1", b"chr6_alt_HLA_77_99_x", b"read1",
    b"a_1_2_", b"_1_2_", b"chr1_12_x_",
])
def test_parse_wgsim_id(qname):
    assert tapps.parse_wgsim_id(qname) == japps.parse_wgsim_id(qname)


@pytest.mark.parametrize("slack", [None, "5", "200"])
def test_roc(tmp_path, capsys, slack):
    sam = tmp_path / "sim.sam"
    sam.write_text("\n".join(SIM_SAM) + "\n")
    args = [str(sam)] + (["-slack", slack] if slack else [])
    assert japps.cmd_roc(args) == 0
    ref = capsys.readouterr()
    assert tapps.cmd_roc(args) == 0
    got = capsys.readouterr()
    assert got.out == ref.out and got.err == ref.err
    assert got.out.count("\n") >= 4


def test_roc_refuses_unparsable_ids(tmp_path, capsys):
    sam = tmp_path / "real.sam"
    sam.write_text("readX\t0\tchr1\t1\t60\t4M\t*\t0\t0\tACGT\tIIII\n")
    assert tapps.cmd_roc([str(sam)]) == japps.cmd_roc([str(sam)]) == 1


@pytest.mark.parametrize("out_name", ["out.fq", "out.fq.gz"])
def test_tofastq(tmp_path, out_name):
    sam = tmp_path / "in.sam"
    sam.write_text(
        "@SQ\tSN:chr1\tLN:100\n"
        "r1\t0\tchr1\t1\t70\t4M\t*\t0\t0\tACGT\tIIJJ\n"
        "r2\t16\tchr1\t5\t70\t4M\t*\t0\t0\tACGT\tIIJJ\n"
        "r3\t256\tchr1\t9\t0\t4M\t*\t0\t0\tACGT\tIIJJ\n"
        "r4\t2048\tchr1\t9\t0\t4M\t*\t0\t0\tACGT\tIIJJ\n"
    )
    outs = []
    for side, mod in (("jax", japps), ("torch", tapps)):
        out = tmp_path / f"{side}_{out_name}"
        assert mod.cmd_tofastq([str(sam), str(out)]) == 0
        opener = gzip.open if out_name.endswith(".gz") else open
        with opener(out, "rb") as f:
            outs.append(f.read())
    assert outs[1] == outs[0]
    assert outs[1].count(b"\n") == 8  # r3 and r4 skipped


def test_usage_errors():
    for cmd in ("cmd_tofastq", "cmd_roc", "cmd_depth", "cmd_daemon", "cmd_command"):
        assert getattr(tapps, cmd)([]) == getattr(japps, cmd)([]) == 1


def run_jax(directory, argv):
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(directory)
        mp.setattr(jcli, "_maybe_mesh", lambda opts: (None, 1))
        assert jcli.main(argv) == 0


def run_torch(directory, argv):
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(directory)
        assert tcli.main(argv, device="cpu") == 0


@pytest.fixture(scope="module")
def dirs(same_logq, tmp_path_factory):
    rng = np.random.default_rng(5)
    seq = "".join("ACGT"[c] for c in rng.integers(0, 4, size=4000))
    out = {}
    for side, run in (("jax", run_jax), ("torch", run_torch)):
        d = tmp_path_factory.mktemp(f"apps_{side}")
        (d / "g.fa").write_text(f">chr1\n{seq}\n")
        with open(d / "r.fq", "w") as f:
            for k, s in enumerate((1000, 2500, 3100)):
                read = seq[s : s + 100]
                if k == 1:
                    read = read[::-1].translate(str.maketrans("ACGT", "TGCA"))
                f.write(f"@chr1_{s + 1}_{s + 1}_r{k}\n{read}\n+\n{'I' * 100}\n")
        run(d, ["index", "g.fa", "idx", "-s", "20"])
        out[side] = d
    return out


def same_file(dirs, name) -> bytes:
    got = (dirs["torch"] / name).read_bytes()
    assert got == (dirs["jax"] / name).read_bytes(), name
    return got


def test_read_group_options(dirs):
    argv_r = ["single", "idx", "r.fq", "-o", "rg.sam", "-b", "16",
              "-R", "@RG\\tID:mylib\\tSM:sample7\\tPL:torrent"]
    argv_rg = ["single", "idx", "r.fq", "-o", "rg2.sam", "-b", "16", "-rg", "grp1"]
    for argv in (argv_r, argv_rg):
        run_jax(dirs["jax"], argv)
        run_torch(dirs["torch"], argv)
    text = same_file(dirs, "rg.sam").decode()
    assert "@RG\tID:mylib\tSM:sample7\tPL:torrent" in text
    body = [ln for ln in text.splitlines() if not ln.startswith("@")]
    assert len(body) == 3 and all("RG:Z:mylib" in ln for ln in body)
    assert "@RG\tID:grp1\tPL:Illumina" in same_file(dirs, "rg2.sam").decode()


def test_multi_run_comma(dirs):
    argv = ["single", "idx", "r.fq", "-o", "m1.sam", "-b", "16", ",",
            "single", "idx", "r.fq", "-o", "m2.sam", "-b", "16"]
    run_jax(dirs["jax"], argv)
    run_torch(dirs["torch"], argv)
    b = [[ln for ln in same_file(dirs, n).split(b"\n") if not ln.startswith(b"@")]
         for n in ("m1.sam", "m2.sam")]
    assert b[0] == b[1] and len(b[0]) == 4  # three records and the last newline


def test_daemon_roundtrip(dirs, monkeypatch):
    """The port's daemon on the CPU: `single` sent through `command` over
    a Unix socket writes the SAM the direct run writes (and snap_tpu's),
    the index stays cached between commands, and `exit` stops it."""
    d = dirs["torch"]
    argv = ["single", "idx", "r.fq", "-o", "daemon.sam", "-b", "16"]
    run_jax(dirs["jax"], argv)
    monkeypatch.chdir(d)
    sock = str(d / "d.sock")
    srv = threading.Thread(
        target=tapps.cmd_daemon, args=([sock], torch.device("cpu")), daemon=True
    )
    srv.start()
    for _ in range(200):
        if os.path.exists(sock):
            break
        time.sleep(0.05)
    assert os.path.exists(sock)
    assert tapps.cmd_command([sock] + argv) == 0
    same_file(dirs, "daemon.sam")
    cached = dict(tcli._INDEX_CACHE)
    assert tapps.cmd_command([sock] + argv[:4] + ["daemon2.sam", "-b", "16"]) == 0
    assert dict(tcli._INDEX_CACHE) == cached  # the same index object
    # a failing command returns its code and the daemon stays up
    assert tapps.cmd_command([sock, "single", "idx"]) == 1
    assert tapps.cmd_command([sock, "exit"]) == 0
    srv.join(timeout=10)
    assert not srv.is_alive() and not os.path.exists(sock)
    run_torch(d, ["single", "idx", "r.fq", "-o", "direct.sam", "-b", "16"])
    strip_pg = lambda p: [ln for ln in p.read_bytes().split(b"\n")  # noqa: E731
                          if not ln.startswith(b"@PG")]
    assert strip_pg(d / "daemon.sam") == strip_pg(d / "direct.sam")


def test_depth_tool(dirs):
    """HitDepth analogue: per-locus min seed-hit depth histogram, equal
    to snap_tpu's file; on this unique random genome nearly every locus
    has a depth-1 seed."""
    for side, run in (("jax", run_jax), ("torch", run_torch)):
        run(dirs[side], ["depth", "idx", "depth.tsv"])
        run(dirs[side], ["depth", "idx", "depth_c.tsv", "chr1"])
    text = same_file(dirs, "depth.tsv").decode()
    assert same_file(dirs, "depth_c.tsv").decode() == text
    rows = [ln.split("\t") for ln in text.splitlines()[1:] if ln.startswith("TOTAL\t")]
    hist = {int(v): int(c) for _, v, c in rows}
    assert sum(hist.values()) == 4000 and hist.get(1, 0) >= 3950
