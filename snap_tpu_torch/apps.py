"""Companion apps: ToFASTQ and ComputeROC, plus the daemon protocol.

Counterpart of snap_tpu.apps. Behavioral reference: the reference ships
auxiliary binaries alongside the aligner — apps/ToFASTQ (SAM/BAM back to
FASTQ), apps/ComputeROC (per-MAPQ misalignment rates on wgsim-style
simulated reads, ComputeROC.cpp:100-330), and apps/SNAPCommand + daemon
mode (long-lived server keeping the index loaded,
CommandProcessor.cpp:104-174). Here
they are subcommands of the one CLI, with the daemon speaking
newline-delimited JSON argv over a Unix socket instead of a named pipe.
`depth` loads its index on the caller's device, and the daemon runs
every command on its own device and devices, so a cached index stays on
the card between commands.
"""

from __future__ import annotations

import gzip
import json
import os
import re
import socket
import sys

COMMAND_EXECUTED = "**Command executed**"  # CommandProcessor.cpp:41


# ---------------------------------------------------------------------------
# ToFASTQ
# ---------------------------------------------------------------------------
def cmd_tofastq(args: list[str]) -> int:
    """snap-tpu tofastq <in.sam|in.bam> <out.fq[.gz]>

    Restores as-sequenced orientation for RC-flagged records and skips
    secondary/supplementary records (apps/ToFASTQ semantics).
    """
    if len(args) < 2:
        print("usage: snap-tpu tofastq <in.sam|bam> <out.fq[.gz]>",
              file=sys.stderr)
        return 1
    from .io.readers import input_kind, iter_bam_reads, iter_sam_reads

    src, dst = args[0], args[1]
    it = (
        iter_bam_reads(src)
        if input_kind(src) == "bam"
        else iter_sam_reads(src)
    )
    opener = gzip.open if dst.endswith(".gz") else open
    n = 0
    with opener(dst, "wb") as out:
        for qname, seq, qual, _flag, _mi, _aux in it:
            out.write(b"@" + qname + b"\n" + seq + b"\n+\n" + qual + b"\n")
            n += 1
    print(f"Wrote {n} reads to {dst}", file=sys.stderr)
    return 0


# ---------------------------------------------------------------------------
# ComputeROC
# ---------------------------------------------------------------------------
_WGSIM_ID = re.compile(rb"^(?P<chr>.+)_(?P<a>\d+)_(?P<b>\d+)_")


def parse_wgsim_id(qname: bytes) -> tuple[bytes, int, int] | None:
    """Parse ChrName_OffsetA_OffsetB_... simulated-read IDs
    (ComputeROC.cpp:144-214; chromosome names may contain '_', so match
    the two trailing numbers greedily)."""
    m = _WGSIM_ID.match(qname)
    if not m:
        return None
    return m.group("chr"), int(m.group("a")), int(m.group("b"))


def cmd_roc(args: list[str]) -> int:
    """snap-tpu roc <in.sam> [-slack n]

    Per-MAPQ alignment/misalignment counts for wgsim-style simulated
    reads: a read is correct when it aligned to the encoded chromosome
    within `slack` (default 50) of either encoded offset
    (ComputeROC.cpp:221-245).
    """
    if len(args) < 1:
        print("usage: snap-tpu roc <in.sam> [-slack n]", file=sys.stderr)
        return 1
    sam_path = args[0]
    slack = 50
    i = 1
    while i < len(args):
        if args[i] == "-slack" and i + 1 < len(args):
            slack = int(args[i + 1])
            i += 2
        else:
            i += 1

    count = [0] * 71
    wrong = [0] * 71
    unaligned = 0
    total = 0
    opener = gzip.open if sam_path.endswith(".gz") else open
    with opener(sam_path, "rb") as f:
        for line in f:
            if line.startswith(b"@"):
                continue
            t = line.rstrip(b"\r\n").split(b"\t")
            if len(t) < 11:
                continue
            flag = int(t[1])
            if flag & (0x100 | 0x800):
                continue
            total += 1
            if flag & 0x4:
                unaligned += 1
                continue
            mapq = min(70, int(t[4]))
            parsed = parse_wgsim_id(t[0])
            if parsed is None:
                print(f"Unable to parse read ID {t[0]!r}; not simulated "
                      "data?", file=sys.stderr)
                return 1
            chrom, a, b = parsed
            pos = int(t[3])
            ok = t[2] == chrom and (
                abs(pos - a) <= slack or abs(pos - b) <= slack
            )
            count[mapq] += 1
            if not ok:
                wrong[mapq] += 1

    print("MAPQ\tnReads\tnMisaligned\t%misaligned\tcumulative error rate")
    cum_reads = 0
    cum_wrong = 0
    for q in range(70, -1, -1):
        if count[q] == 0:
            continue
        cum_reads += count[q]
        cum_wrong += wrong[q]
        print(
            f"{q}\t{count[q]}\t{wrong[q]}\t"
            f"{100.0 * wrong[q] / count[q]:.4f}%\t"
            f"{cum_wrong / max(1, cum_reads):.6f}"
        )
    print(f"Total {total} reads, {unaligned} unaligned", file=sys.stderr)
    return 0


# ---------------------------------------------------------------------------
# HitDepth dev tool
# ---------------------------------------------------------------------------
def cmd_depth(args: list[str], device=None) -> int:
    """snap-tpu depth <index-dir> <out.tsv> [contig ...]

    HitDepth analogue (SNAPLib/HitDepth.cpp:32-139, compiled out by
    default behind HIT_DEPTH_COUNTING): per-locus alignment
    'difficulty' = the minimum hit-list size over all seeds covering
    that locus. NB the reference's CountHitDepth only ever loads the
    index (the metric computation was never finished upstream); this
    tool completes the stated intent: it writes a depth histogram
    (min-hit-depth -> number of loci) per contig plus a TOTAL section.
    Loci with no valid covering seed (Ns) report depth 0.
    """
    if len(args) < 2:
        print(
            "usage: snap-tpu depth <index-dir> <out.tsv> [contig ...]",
            file=sys.stderr,
        )
        return 1
    import numpy as np

    from .index.build import pack_seeds
    from .index.index import GenomeIndex

    index = GenomeIndex.load(args[0], device)
    out_path = args[1]
    want = set(args[2:])
    host = index.host
    s = index.seed_len
    bases = np.asarray(index.genome_meta.bases)
    totals: dict[int, int] = {}
    with open(out_path, "w") as out:
        out.write("contig\tmin_hit_depth\tn_loci\n")
        for contig in index.genome_meta.contigs:
            if want and contig.name not in want:
                continue
            lo, n = contig.start, contig.length
            if n < s:
                continue
            pos = np.arange(lo, lo + n - s + 1, dtype=np.int64)
            fwd, rc, valid = pack_seeds(bases, pos, s)
            canon = np.minimum(fwd, rc)
            found, _, n0, n1 = host.probe(canon)
            depth = np.where(
                valid & found, n0.astype(np.int64) + n1, np.int64(1 << 40)
            )
            # per-locus min over the <= s seeds covering it
            win = np.lib.stride_tricks.sliding_window_view(
                np.concatenate(
                    [np.full(s - 1, 1 << 40, np.int64), depth,
                     np.full(s - 1, 1 << 40, np.int64)]
                ),
                s,
            )
            per_locus = win.min(axis=1)[: n]
            per_locus = np.where(per_locus >= (1 << 40), 0, per_locus)
            vals, counts = np.unique(per_locus, return_counts=True)
            for v, c in zip(vals.tolist(), counts.tolist()):
                out.write(f"{contig.name}\t{v}\t{c}\n")
                totals[v] = totals.get(v, 0) + c
        for v in sorted(totals):
            out.write(f"TOTAL\t{v}\t{totals[v]}\n")
    print(f"Wrote hit-depth histogram to {out_path}", file=sys.stderr)
    return 0


# ---------------------------------------------------------------------------
# Daemon mode + command client
# ---------------------------------------------------------------------------
def cmd_daemon(args: list[str], device=None, devices=None) -> int:
    """snap-tpu daemon <socket-path>

    Long-lived server: accepts JSON argv lines over a Unix socket, runs
    each as a top-level command in-process (so loaded indexes stay
    cached, the analogue of g_index in AlignerContext.cpp:56-59), and
    replies with the CommandExecuted marker + exit code.
    """
    if len(args) < 1:
        print("usage: snap-tpu daemon <socket-path>", file=sys.stderr)
        return 1
    from . import cli

    sock_path = args[0]
    if os.path.exists(sock_path):
        os.unlink(sock_path)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock_path)
    srv.listen(4)
    print(f"snap-tpu daemon listening on {sock_path}", file=sys.stderr)
    try:
        while True:
            conn, _ = srv.accept()
            with conn:
                data = b""
                while not data.endswith(b"\n"):
                    chunk = conn.recv(65536)
                    if not chunk:
                        break
                    data += chunk
                if not data.strip():
                    continue
                try:
                    argv = json.loads(data)
                except json.JSONDecodeError:
                    conn.sendall(b"bad request\n")
                    continue
                if argv == ["exit"]:
                    conn.sendall(f"{COMMAND_EXECUTED} 0\n".encode())
                    return 0
                try:
                    code = cli.run_one_command(argv, device, devices)
                except SystemExit as e:  # a command called exit()
                    code = int(e.code or 0)
                except Exception as e:  # daemon survives command errors
                    print(f"command failed: {e}", file=sys.stderr)
                    code = 1
                conn.sendall(f"{COMMAND_EXECUTED} {code}\n".encode())
    finally:
        srv.close()
        if os.path.exists(sock_path):
            os.unlink(sock_path)


def cmd_command(args: list[str]) -> int:
    """snap-tpu command <socket-path> <args...> — the SNAPCommand client
    (apps/SNAPCommand/SNAPCommand.cpp): sends one command line to a
    running daemon and waits for the executed marker."""
    if len(args) < 2:
        print("usage: snap-tpu command <socket-path> <args...>",
              file=sys.stderr)
        return 1
    sock_path, argv = args[0], args[1:]
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.connect(sock_path)
    c.sendall(json.dumps(argv).encode() + b"\n")
    resp = b""
    while not resp.endswith(b"\n"):
        chunk = c.recv(65536)
        if not chunk:
            break
        resp += chunk
    c.close()
    text = resp.decode().strip()
    print(text)
    if text.startswith(COMMAND_EXECUTED):
        return int(text.rsplit(" ", 1)[1])
    return 1
