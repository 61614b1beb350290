"""Alignment adjustment: soft-clip alignments that hang off contig ends.

Behavioral reference: SNAP's AlignmentAdjuster (AlignmentAdjuster.h:
33-41, AlignmentAdjuster.cpp): an alignment whose reference span crosses
a contig boundary (into inter-contig padding) is re-clipped so that only
in-contig bases stay aligned; the overhanging read bases become soft
clips, the POS shifts for leading clips, and NM is recomputed. If
nothing alignable remains the read is demoted to unmapped (the SAM
writer's contig-crossing demotion, SAM.cpp:1659-1712).
"""

from __future__ import annotations

import re

import numpy as np

_CIG_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def parse_cigar(cigar: str) -> list[list]:
    return [[int(n), op] for n, op in _CIG_RE.findall(cigar)]


def render_cigar(ops: list[list]) -> str:
    # merge adjacent same-op runs
    out: list[list] = []
    for n, op in ops:
        if n <= 0:
            continue
        if out and out[-1][1] == op:
            out[-1][0] += n
        else:
            out.append([n, op])
    return "".join(f"{n}{op}" for n, op in out) if out else "*"


def adjust_to_contig(
    start_loc: int,
    cigar: str,
    body: np.ndarray,        # oriented read bases consumed by the body ops
    genome: np.ndarray,
    contig_start: int,
    contig_end: int,         # exclusive
    use_m: bool = True,
) -> tuple[int, str, int] | None:
    """Clip a CIGAR to [contig_start, contig_end).

    Returns (start_loc, cigar, nm) — possibly unchanged — or None when
    no aligned bases remain (caller demotes to unmapped).
    """
    ops = parse_cigar(cigar)
    ref_span = sum(n for n, op in ops if op in "MD=XN")
    if start_loc >= contig_start and start_loc + ref_span <= contig_end:
        return start_loc, cigar, _recompute_nm(ops, start_loc, body, genome)

    # split into (lead_clips, body_ops, tail_clips)
    lead: list[list] = []
    tail: list[list] = []
    while ops and ops[0][1] in "HS":
        lead.append(ops.pop(0))
    while ops and ops[-1][1] in "HS":
        tail.insert(0, ops.pop(-1))

    def add_soft(side: list[list], n: int, front: bool):
        if n <= 0:
            return
        if front:
            if side and side[-1][1] == "S":
                side[-1][0] += n
            else:
                side.append([n, "S"])
        else:
            if side and side[0][1] == "S":
                side[0][0] += n
            else:
                side.insert(0, [n, "S"])

    ref = start_loc
    # leading overhang
    while ops and ref < contig_start:
        n, op = ops[0]
        if op in "MD=XN":
            take = min(n, contig_start - ref)
            ref += take
            if op != "D" and op != "N":
                add_soft(lead, take, front=True)
                body = body[take:]
            ops[0][0] -= take
            if ops[0][0] == 0:
                ops.pop(0)
        else:  # I consumes read only; at the boundary it soft-clips
            add_soft(lead, n, front=True)
            body = body[n:]
            ops.pop(0)
    # alignments can't start with a deletion
    while ops and ops[0][1] in "DN":
        ref += ops[0][0]
        ops.pop(0)
    start_loc = ref

    ref_end = start_loc + sum(n for n, op in ops if op in "MD=XN")
    while ops and ref_end > contig_end:
        n, op = ops[-1]
        if op in "MD=XN":
            take = min(n, ref_end - contig_end)
            ref_end -= take
            if op != "D" and op != "N":
                add_soft(tail, take, front=False)
                body = body[: len(body) - take]
            ops[-1][0] -= take
            if ops[-1][0] == 0:
                ops.pop(-1)
        else:
            add_soft(tail, n, front=False)
            body = body[: len(body) - n]
            ops.pop(-1)
    while ops and ops[-1][1] in "DN":
        ops.pop(-1)

    if not any(op in "M=X" for _, op in ops):
        return None

    nm = _recompute_nm(ops, start_loc, body, genome)
    if not use_m:
        ops = _split_eq_x(ops, start_loc, body, genome)
    return start_loc, render_cigar(lead + ops + tail), nm


def _recompute_nm(ops, start_loc, body, genome) -> int:
    nm = 0
    r, p = start_loc, 0
    for n, op in ops:
        if op in "M=X":
            nm += int(np.sum(genome[r : r + n] != body[p : p + n]))
            r += n
            p += n
        elif op == "I":
            nm += n
            p += n
        elif op in "DN":
            nm += n if op == "D" else 0
            r += n
        # S/H consume neither `body` (which holds only aligned bases)
        # nor the reference
    return nm


def _split_eq_x(ops, start_loc, body, genome):
    out = []
    r, p = start_loc, 0
    for n, op in ops:
        if op in "M=X":
            mism = genome[r : r + n] != body[p : p + n]
            run_x, run = None, 0
            for j in range(n):
                x = bool(mism[j])
                if run_x is None or x == run_x:
                    run_x, run = x, run + 1
                else:
                    out.append([run, "X" if run_x else "="])
                    run_x, run = x, 1
            if run:
                out.append([run, "X" if run_x else "="])
            r += n
            p += n
        else:
            out.append([n, op])
            if op == "I":
                p += n
            elif op in "DN":
                r += n
    return out
