"""End-to-end paired-end driver.

Counterpart of snap_tpu.align.paired_driver. Behavioral reference: SNAP's PairedAlignerContext::runIterationThreadImpl
(PairedAligner.cpp:490-930) and SAMFormat::writePairs/fillMateInfo
(SAM.cpp:1575, 1308-1420). Both ends of every pair go through one device
batch (rows 0..B-1 = first ends, B..2B-1 = second ends) on the index's
device: the intersection (align/intersect_device.py, its wide tier, and
the exact host redo of the pairs still flagged) and the two-tier
scoring. On a (data x index) mesh the intersection's phases 1-2 run at
every mesh position (parallel.mesh.paired_candidates_sharded, no wide
tier, as in snap_tpu) and the scoring on the mesh's primary device, with
the flat view of shard 0 (scoring reads only the genome). Then pairing, chimeric fallback, CIGARs, and mate-info SAM
emission happen host-side.

`PairedEndAligner.branches` counts the pairs that took each path (the
device or host intersection, the wide tier, the host overflow redo, the
edge-indel fix, planned native or per-pair emission), the ends the
hamming rescue tried and placed, and the batches, so a run can show
which paths it exercised.
"""

from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch

from ..constants import (
    DEFAULT_MAX_SPACING,
    DEFAULT_MIN_READ_LENGTH,
    DEFAULT_MIN_SPACING,
    MAPQ_LIMIT_FOR_SINGLE_HIT,
)
from ..index.index import GenomeIndex
from ..io.fastq import ReadBatch
from ..io.readers import paired_batches
from ..io.sam import (
    FLAG_FIRST,
    FLAG_LAST,
    FLAG_NEXT_RC,
    FLAG_NEXT_UNMAPPED,
    FLAG_PAIRED,
    FLAG_PROPER,
    FLAG_RC,
    FLAG_UNMAPPED,
    SamWriter,
)
from ..stats import RECORDER, AlignerStats, ProgressReporter
from . import intersect_device, pipeline
from .intersect import IntersectParams, paired_candidates
from .paired import PairEndResult, finalize_pair
from .pipeline import AlignParams
from .single import _AG_NOT_CACHED, winner_record

# sentinel marking a pair fully handled by the vectorized plan
_PLANNED_PAIR = ({"status": "planned"}, {"status": "planned"})


@dataclass
class PairedEndAligner:
    index: GenomeIndex
    params: AlignParams
    batch_size: int = 512
    max_read_len: int = 128
    min_read_length: int = DEFAULT_MIN_READ_LENGTH
    min_spacing: int = DEFAULT_MIN_SPACING
    max_spacing: int = DEFAULT_MAX_SPACING
    alt_awareness: bool = True
    emit_alt: bool = False
    max_score_gap_to_prefer_non_alt: int = 64
    use_m: bool = True
    filter_flags: int = 0
    ignore_mismatched_ids: bool = False
    force_spacing: bool = False              # -fs
    infer_spacing: bool = False              # -ins
    internal_score_tag: str | None = None    # -is
    min_score_realignment: int = 3           # -en
    min_ag_improvement: int = 24             # -eg
    flatten_mapq_at_or_below: int = 3        # -fmb
    read_secondary: bool = False             # -sa
    keep_unpaired: bool = False              # -ku
    max_secondary_edit: int = -1             # -om
    max_secondary: int = 0x7FFFFFFF          # -omax
    max_secondary_per_contig: int = -1       # -mpc
    enable_hamming: bool = True              # -eh (default on,
                                             # PairedAligner.cpp:241)
    mesh: object = None                      # multi-device (data x index)
    force_kind: str | None = None            # -pairedFastq
    force_gzip: bool = False                 # -pairedCompressed...
    force_interleaved: bool = False          # -pairedInterleavedFastq
    attach_times: bool = False               # -at (accepted; paired
                                             # records carry no AT tag
                                             # in the reference either)
    infer_spacing_batch: int = 256 * 1024    # DEFAULT_BATCH_SIZE_IS_ESTIMATION
    device_intersect: bool = True            # phases 1-2 on device;
                                             # overflow rows redo on host
    stats: AlignerStats = field(default_factory=AlignerStats)
    branches: Counter = field(default_factory=Counter)

    def __post_init__(self):
        if self.mesh is not None and self.mesh.multiprocess:
            # as in snap_tpu, SAM is written by one process
            raise ValueError(
                "PairedEndAligner writes SAM from one process; its mesh "
                "spans several ranks"
            )
        # on a mesh the scoring runs on its primary device
        self.device = (
            self.index.torch_device if self.mesh is None else self.mesh.primary
        )
        if self.params.max_k_indels is None:
            # reference default: maxDistForIndels = 40
            # (AlignerOptions.cpp:108); consumed only by the paired
            # aligner, so the paired driver resolves the auto value
            import dataclasses

            from ..constants import DEFAULT_MAX_DIST_INDELS

            self.params = dataclasses.replace(
                self.params, max_k_indels=DEFAULT_MAX_DIST_INDELS
            )
        self.genome_np = np.asarray(self.index.genome_meta.bases)
        self.first_alt_start = self.index.genome_meta.first_alt_start()
        cs = sorted(self.index.genome_meta.contigs, key=lambda c: c.start)
        self.contig_bounds = (
            np.array([c.start for c in cs], dtype=np.int64),
            np.array([c.start + c.length for c in cs], dtype=np.int64),
        )
        self._sorted_contig_names = [
            c.name.encode() if isinstance(c.name, str) else c.name
            for c in cs
        ]
        self.stats.is_paired = True
        self._spacing_samples: list[int] = []
        # finalize_pair fills these; flushed into stats per batch
        self._ag_counters: dict = {}

    def _update_spacing(self, samples: list[int]) -> None:
        """-ins adaptive insert-size inference: after every
        infer_spacing_batch aligned pairs, recompute [min,max] spacing
        from quartiles + stddev (PairedAligner.cpp:424-456 with
        OUTLIER_BOUND=2, MAPPING_BOUND=3, MAX_STDDEV=4)."""
        self._spacing_samples.extend(samples)
        n = self.infer_spacing_batch
        if len(self._spacing_samples) < n:
            return
        s = np.sort(np.asarray(self._spacing_samples[:n], dtype=np.int64))
        self._spacing_samples = self._spacing_samples[n:]
        s25, s75 = int(s[int(0.25 * n)]), int(s[int(0.75 * n)])
        iqr = s75 - s25
        lo = max(s25 - 2 * iqr, 1)
        hi = s75 + 2 * iqr
        inliers = s[(s >= lo) & (s <= hi)]
        if inliers.size == 0:
            return
        avg = float(inliers.mean())
        stddev = float(inliers.std())
        new_min = min(int(s25 - 3 * iqr), int(avg - 4 * stddev))
        new_max = max(int(s75 + 3 * iqr), int(avg + 4 * stddev))
        self.min_spacing = max(new_min, 1)
        self.max_spacing = new_max

    def _pad_two(self, b0: ReadBatch, b1: ReadBatch):
        n = len(b0)
        B, L = self.batch_size, self.max_read_len
        bases = np.full((2 * B, L), 4, dtype=np.uint8)
        quals = np.zeros((2 * B, L), dtype=np.uint8)
        lens = np.zeros(2 * B, dtype=np.int32)
        for off, rb in ((0, b0), (B, b1)):
            bases[off : off + n] = rb.bases[:, :L]
            quals[off : off + n] = rb.quals[:, :L]
            lens[off : off + n] = np.minimum(rb.lengths, L)
        return bases, quals, lens

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _device_intersect(self, dev_bases, len_eff, dev_len, B, ip):
        """Phases 1-2 on the device (align/intersect_device.py): the
        standard geometry, then the wide second tier for the pairs it
        flagged (a fetch of the flags, as snap_tpu's device_get). Pairs
        that overflow even the wide tier keep their flag for the exact
        host redo. Returns the candidate dict of tensors."""
        offsets, set_ids = intersect_device.probe_offsets_for(
            len_eff, dev_bases.shape[1], ip.seed_len, ip.num_seeds
        )
        dip = intersect_device.DeviceIntersectParams(
            seed_len=ip.seed_len,
            max_probe=self.index.max_probe,
            num_seeds=ip.num_seeds,
            max_cand=ip.max_cand,
            max_k_indels=ip.max_k_indels,
        )
        dev_off, dev_sets = self._to_dev(offsets), self._to_dev(set_ids)
        if self.mesh is not None:
            # sharded index: per-shard phase-1 entry tables concatenate
            # along the 'index' mesh axis; snap_tpu runs no wide tier
            # here, so overflowed pairs go straight to the host redo
            from ..parallel.mesh import paired_candidates_sharded

            return paired_candidates_sharded(
                self.index.device_sharded,
                dev_bases[:B], dev_bases[B:], dev_len[:B], dev_len[B:],
                dev_off[:B], dev_off[B:], dev_sets[:B], dev_sets[B:],
                self.min_spacing, self.max_spacing, dip, self.mesh,
            )
        pcd = intersect_device.paired_candidates_device(
            self.index.device, dev_bases, dev_len, dev_off, dev_sets,
            self.min_spacing, self.max_spacing, dip,
        )
        # wide second tier: rerun overflowed pairs on the device at
        # HP=512/C=512 (repeat-dense seeds overflow the standard caps
        # on ~18% of pairs at 25% repeat content); only the residue
        # takes the exact host redo
        ovh = pcd["overflow"].cpu().numpy()
        ovp_h = ovh[:B] | ovh[B:]
        n_over = int(ovp_h.sum())
        if n_over > 0:
            self.stats.intersect_wide_pairs += n_over
            self.branches["wide_tier"] += n_over
            pcd = intersect_device.paired_wide_redo(
                self.index.device, dev_bases, dev_len, dev_off, dev_sets,
                pcd, np.flatnonzero(ovp_h),
                self.min_spacing, self.max_spacing, dip,
            )
        return pcd

    def align_batch(self, b0: ReadBatch, b1: ReadBatch, plan_writer=None):
        from ..index.host_lookup import host_clip_back

        n = len(b0)
        B = self.batch_size
        bases, quals, lens = self._pad_two(b0, b1)
        dev_bases = self._to_dev(bases)
        dev_quals = self._to_dev(quals)

        # Phases 1-2 of the intersecting aligner: by default on device
        # (align/intersect_device.py) with overflow rows redone through
        # the exact host path; host numpy (align/intersect.py) when
        # device_intersect is off. Scoring stays on device either way.
        len_eff = (
            host_clip_back(quals, lens)
            if self.params.clip_back
            else lens.astype(np.int32)
        )
        ip = IntersectParams(
            seed_len=self.params.seed_len,
            num_seeds=self.params.num_seeds,
            max_cand=self.params.max_cand,
            min_spacing=self.min_spacing,
            max_spacing=self.max_spacing,
            max_k_indels=self.params.mki,
        )
        if self.mesh is None:
            didx_sc = self.index.device
        else:
            from ..parallel.mesh import local_index_view

            didx_sc = local_index_view(self.index.device_sharded)
        dev_len = self._to_dev(len_eff)
        pc = None  # host candidates, fetched lazily (hamming rescue)
        if (
            self.device_intersect
            and ip.num_seeds <= 32  # device key packs lookup idx in 5b
        ):
            self.branches["device_intersect"] += n
            pcd = self._device_intersect(dev_bases, len_eff, dev_len, B, ip)
            ov = pcd["overflow"]
            ovp = ov[:B] | ov[B:]
            t1 = pipeline.score_candidates(
                didx_sc, dev_bases, dev_quals, dev_len,
                pcd["loc"], pcd["off"], pcd["dir"], pcd["valid"],
                pcd["weight"], pcd["popular"], self.params, tier1_only=True,
                truncated=torch.cat([ovp, ovp]),
                max_k_bonus=pcd["big_indel"],
            )
            self._pcd = pcd
        else:
            self.branches["host_intersect"] += n
            pc = paired_candidates(self.index.host, bases, len_eff, B, ip)
            t1 = pipeline.score_candidates(
                didx_sc, dev_bases, dev_quals, dev_len,
                *(self._to_dev(a) for a in (
                    pc.loc, pc.off, pc.dir, pc.valid, pc.weight, pc.popular
                )),
                self.params, tier1_only=True,
                max_k_bonus=self._to_dev(pc.big_indel),
            )
        f = pipeline.two_phase_merge(
            didx_sc, t1, dev_bases, dev_quals, self.params
        )
        if pc is None and f["truncated"].any():
            # device-intersect overflow: recompute the flagged pairs
            # with the exact host intersection (full hit lists) and
            # overwrite their rows in the merged result
            self._redo_overflow_pairs(
                f, bases, quals, len_eff, B, ip, didx_sc
            )
        self._fix_edge_indels(
            f, bases, len_eff, didx_sc, dev_bases, dev_quals
        )
        # LV-approximated agScore for phase-3 pair selection
        # (readLen*match - score*(match+sub), scoreLocation's LV path,
        # IntersectingPairedEndAligner.cpp:3352-3359)
        ms = self.params.ag_match + self.params.ag_sub
        f["lv_ag_score"] = (
            f["len_eff"][:, None].astype(np.int64) - ms * f["lv_dist"]
        )
        per_cand = (
            "dist", "lv_dist", "log_prob", "ag_score", "end_loc",
            "cand_loc", "direction", "valid", "escalated",
            "lv_ag_score", "lv_log_prob",
        )
        v, esc = f["valid"], f["escalated"]
        self.stats.lv_calls += int(v[:n].sum()) + int(v[B : B + n].sum())
        self.stats.affine_gap_calls += int((esc & v)[:n].sum()) + int(
            (esc & v)[B : B + n].sum()
        )
        arrays = {
            k: f[k]
            for k in ("len_eff", "clip_before", "clip_after", "escalated",
                      "body_loc", "indels")
        }

        plan = fast = sel = None
        if plan_writer is not None and b0.aux is None and b1.aux is None:
            plan, fast, fast_spacing, sel = self._plan_pairs(
                f, b0, b1, n, bases, quals
            )

        results = []
        spacing_samples: list[int] = []
        if fast is not None and self.infer_spacing:
            spacing_samples.extend(fast_spacing)
        # pass 1: per-pair selection (finalize_pair) for the slow rows;
        # record construction is deferred so every slow winner's CIGAR
        # traceback can run in one batched pass instead of per row
        slow: list[tuple] = []
        for i in range(n):
            if fast is not None and fast[i]:
                results.append(_PLANNED_PAIR)
                continue
            if sel is not None and sel["mask"][i]:
                # selection settled by the vectorized plan; only the
                # record construction (indel/clip CIGAR, contig edge)
                # needs the per-pair machinery below
                mq0 = int(sel["mapq0"][i])
                mq1 = int(sel["mapq1"][i])
                r0 = PairEndResult(
                    status="single" if mq0 >= 10 else "multi",
                    cand_index=int(sel["i0"][i]),
                    direction=int(sel["dir0"][i]),
                    end_loc=int(sel["end0"][i]),
                    dist=int(sel["dist0"][i]),
                    mapq=mq0, aligned_as_pair=True,
                )
                r1 = PairEndResult(
                    status="single" if mq1 >= 10 else "multi",
                    cand_index=int(sel["i1"][i]),
                    direction=int(sel["dir1"][i]),
                    end_loc=int(sel["end1"][i]),
                    dist=int(sel["dist1"][i]),
                    mapq=mq1, aligned_as_pair=True,
                )
                if self.infer_spacing:
                    spacing_samples.append(int(sel["spacing"][i]))
                slow.append(
                    (len(results), i, r0, r1, None, [], True, True)
                )
                results.append(None)
                continue
            j = B + i
            len_ok0 = int(b0.lengths[i]) >= self.min_read_length
            len_ok1 = int(b1.lengths[i]) >= self.min_read_length
            c0 = {k: f[k][i] for k in per_cand}
            c1 = {k: f[k][j] for k in per_cand}
            r0, r1, alt_pair, sec_pairs = finalize_pair(
                c0, c1, int(f["popular"][i]), int(f["popular"][j]),
                self.min_spacing, self.max_spacing, len_ok0, len_ok1,
                first_alt_start=self.first_alt_start,
                alt_awareness=self.alt_awareness,
                emit_alt=self.emit_alt,
                max_score_gap_to_prefer_non_alt=(
                    self.max_score_gap_to_prefer_non_alt
                ),
                force_spacing=self.force_spacing,
                min_score_realignment=self.min_score_realignment,
                min_ag_improvement=self.min_ag_improvement,
                flatten_mapq_at_or_below=self.flatten_mapq_at_or_below,
                max_secondary_edit=self.max_secondary_edit,
                max_secondary=self.max_secondary,
                max_k=self.params.max_k,
                extra_search_depth=self.params.extra_search_depth,
                use_ukkonen=self.params.use_ukkonen,
                counters=self._ag_counters,
            )
            if (
                self.infer_spacing
                and r0.aligned_as_pair
                and r0.cand_index >= 0
                and r1.cand_index >= 0
            ):
                spacing = abs(
                    int(c0["cand_loc"][r0.cand_index])
                    - int(c1["cand_loc"][r1.cand_index])
                )
                spacing_samples.append(spacing)

            slow.append(
                (len(results), i, r0, r1, alt_pair, sec_pairs,
                 len_ok0, len_ok1)
            )
            results.append(None)

        self.stats.paired_slow_rows += len(slow)
        self.stats.paired_planned_rows += n - len(slow)
        # pass 2: one batched LV start recovery + one native AG-CIGAR
        # call over every slow winner that needs a traceback
        pre = (
            self._precompute_slow_cigars(slow, b0, b1, arrays, B)
            if slow
            else {}
        )

        # pass 3: assemble the records
        for ridx, i, r0, r1, alt_pair, sec_pairs, len_ok0, len_ok1 in slow:
            j = B + i

            def to_rec(r, batch, row):
                if r.status in ("filtered", "notfound"):
                    return {"status": r.status}
                entry = pre.get((row, int(r.cand_index)))
                pag = _AG_NOT_CACHED
                if entry is not None and entry[1] == (
                    int(r.direction), int(r.dist), int(r.end_loc)
                ):
                    pag = entry[0]
                rec = winner_record(
                    self.genome_np, self.params.max_k, batch, i, arrays,
                    r.cand_index, r.direction, r.dist, r.end_loc,
                    arr_i=row, use_m=self.use_m,
                    contig_bounds=self.contig_bounds,
                    use_affine_gap=self.params.use_affine_gap,
                ag_penalties=(self.params.ag_match, self.params.ag_sub,
                              self.params.ag_open, self.params.ag_extend),
                    precomputed_ag=pag,
                )
                rec.update(
                    status=r.status, direction=r.direction, mapq=r.mapq,
                    dist=r.dist, aligned_as_pair=r.aligned_as_pair,
                    supplementary=r.supplementary,
                )
                return rec

            rec0 = to_rec(r0, b0, i)
            rec1 = to_rec(r1, b1, j)
            if self.enable_hamming and not self.force_spacing:
                # -eh Hamming rescue of still-unmapped ends
                # (ChimericPairedEndAligner.cpp:330-363)
                if rec0["status"] == "notfound" and len_ok0:
                    rec0 = self._try_hamming_rescue(
                        b0, i, i, f, pc := self._pc_host(pc)
                    ) or rec0
                if rec1["status"] == "notfound" and len_ok1:
                    rec1 = self._try_hamming_rescue(
                        b1, i, j, f, pc := self._pc_host(pc)
                    ) or rec1
            if alt_pair is not None:
                rec0["alt_supplementary"] = to_rec(alt_pair[0], b0, i)
                rec1["alt_supplementary"] = to_rec(alt_pair[1], b1, j)
            if sec_pairs:
                rec0["secondaries"] = [
                    to_rec(s0_, b0, i) if s0_ is not None else None
                    for s0_, _ in sec_pairs
                ]
                rec1["secondaries"] = [
                    to_rec(s1_, b1, j) if s1_ is not None else None
                    for _, s1_ in sec_pairs
                ]
            results[ridx] = (rec0, rec1)
        if self.infer_spacing:
            self._update_spacing(spacing_samples)
        self.stats.ag_forced_single += self._ag_counters.pop(
            "ag_forced_single", 0
        )
        self.stats.ag_used_single += self._ag_counters.pop(
            "ag_used_single", 0
        )
        if plan_writer is not None:
            return results, plan
        return results

    def _precompute_slow_cigars(self, slow, b0, b1, arrays, B):
        """Batch the slow pairs' CIGAR tracebacks.

        winner_record per row spends its time in two places: the
        anchored LV DP that recovers the alignment start of
        non-escalated indel winners, and the affine-gap traceback +
        fixup loop. Both batch cleanly: one vectorized DP sweep
        (cigar.recover_starts_batch) recovers every start, then one
        native call (agcigar.compute_ag_cigar_batch) produces every AG
        CIGAR; winner_record consumes them via precomputed_ag. The
        screen mirrors winner_record exactly — requests that would take
        its gapless fast path are left out — and entries are keyed by
        (row, cand) plus (direction, dist, end_loc) so a stale result
        can never be applied.
        """
        from ..genome import reverse_complement_codes
        from .agcigar import compute_ag_cigar_batch
        from .cigar import recover_starts_batch
        from .single import MAX_K_TRACEBACK, ag_restructure_possible

        reqs: list[tuple] = []

        def collect(r, bat, read_i, row):
            if r is None or r.status in ("filtered", "notfound"):
                return
            reqs.append((
                row, read_i, bat, int(r.cand_index), int(r.direction),
                int(r.dist), int(r.end_loc),
            ))

        for _ridx, i, r0, r1, alt_pair, sec_pairs, _l0, _l1 in slow:
            collect(r0, b0, i, i)
            collect(r1, b1, i, B + i)
            if alt_pair is not None:
                collect(alt_pair[0], b0, i, i)
                collect(alt_pair[1], b1, i, B + i)
            for s0_, s1_ in sec_pairs or ():
                collect(s0_, b0, i, i)
                collect(s1_, b1, i, B + i)
        if not reqs:
            return {}

        rows = np.array([q[0] for q in reqs])
        ks = np.array([q[3] for q in reqs])
        dirs = np.array([q[4] for q in reqs])
        dists = np.array([q[5] for q in reqs], np.int64)
        ends = np.array([q[6] for q in reqs], np.int64)
        ind = arrays["indels"][rows, ks].astype(np.int64)
        cb = arrays["clip_before"][rows, ks].astype(np.int64)
        ca = arrays["clip_after"][rows, ks].astype(np.int64)
        esc = np.asarray(arrays["escalated"][rows, ks]).astype(bool)
        plens = arrays["len_eff"][rows].astype(np.int64)

        gapless = (ind == 0) & (cb == 0) & (ca == 0)
        need = (dists > 0) | (cb > 0) | (ca > 0)
        take_ag = need & ~gapless
        if self.params.use_affine_gap:
            chk = np.flatnonzero(gapless & (dists >= 2))
            # the restructure screen reads raw per-batch bases; split
            # the candidates by which ReadBatch they came from
            for bat, m in ((b0, rows < B), (b1, rows >= B)):
                sel = chk[m[chk]]
                if sel.size == 0:
                    continue
                ridxs = np.array([reqs[t][1] for t in sel])
                flg = ag_restructure_possible(
                    self.genome_np, bat.bases, ridxs, dirs[sel],
                    ends[sel] - plens[sel], plens[sel],
                    np.zeros(sel.size, np.int64), dists[sel],
                )
                take_ag[sel[flg]] = True

        ag_idx = np.flatnonzero(take_ag)
        if ag_idx.size == 0:
            return {}

        pats: dict[int, np.ndarray] = {}
        oqs: dict[int, np.ndarray] = {}
        for t in ag_idx:
            _row, read_i, bat, _k, d, _dist, _end = reqs[t]
            plen = int(plens[t])
            clipped = bat.bases[read_i, :plen]
            cq = bat.quals[read_i, :plen]
            if d:
                pats[t] = reverse_complement_codes(clipped.copy())
                oqs[t] = cq[::-1].copy()
            else:
                pats[t] = np.ascontiguousarray(clipped)
                oqs[t] = cq.copy()
        locs = np.empty(len(reqs), np.int64)
        esc_idx = ag_idx[esc[ag_idx]]
        locs[esc_idx] = arrays["body_loc"][
            rows[esc_idx], ks[esc_idx]
        ].astype(np.int64)
        lv_idx = ag_idx[~esc[ag_idx]]
        if lv_idx.size:
            locs[lv_idx] = recover_starts_batch(
                [pats[t] for t in lv_idx], self.genome_np,
                ends[lv_idx],
                np.minimum(self.params.max_k, dists[lv_idx] + 2),
            )

        bodies, bquals, locs_l, fcs, bcs, mgs = [], [], [], [], [], []
        for t in ag_idx:
            _row, read_i, bat, _k, d, dist, _end = reqs[t]
            plen = int(plens[t])
            back_q = int(bat.lengths[read_i]) - plen
            f0, b0c = (back_q, 0) if d else (0, back_q)
            cbt, cat = int(cb[t]), int(ca[t])
            bodies.append(pats[t][cbt : plen - cat])
            bquals.append(oqs[t][cbt : plen - cat])
            locs_l.append(int(locs[t]))
            fcs.append(f0 + cbt)
            bcs.append(b0c + cat)
            mgs.append(min(MAX_K_TRACEBACK, max(8, 2 * dist + 8)))
        res_b = compute_ag_cigar_batch(
            self.genome_np, bodies, bquals,
            np.asarray(locs_l, np.int64),
            np.asarray(fcs, np.int32), np.asarray(bcs, np.int32),
            np.asarray(mgs, np.int32), use_m=self.use_m,
            genome_t=self.index.device.genome,
        )
        pre: dict[tuple, tuple] = {}
        for t, r in zip(ag_idx, res_b):
            row, _ri, _bat, k, d, dist, end = reqs[t]
            pre[(row, k)] = (r, (d, dist, end))
        return pre

    def _plan_ok(self, writer) -> bool:
        """Whether batched native paired-SAM emission applies (the
        paired analogue of SingleEndAligner._plan_ok): default
        streaming-SAM config with no per-pair variable tags, filters,
        secondaries, ALT supplementaries, or -fs semantics."""
        from ..io.native import has_paired_formatter

        return (
            self.use_m
            and self.internal_score_tag is None
            and self.filter_flags == 0
            and not self.force_spacing
            and self.max_secondary_edit < 0
            and not self.emit_alt
            and getattr(writer, "_stream_sam", False)
            and not getattr(writer, "preserve_fastq_comments", False)
            and has_paired_formatter()
        )

    def _plan_pairs(self, f, b0, b1, n, bases, quals):
        """Vectorized triage of the per-pair finalize.

        The overwhelmingly common pair shape — one or two same-contig
        combos, no ALT involvement, no chimeric-compare trigger, both
        winning ends gapless/unclipped inside one contig — is fully
        determined by the merged candidate arrays, so those pairs'
        results (pair choice, merge anchors, pair MAPQ, flags, TLEN)
        are computed for the whole batch at once and returned as a
        native-emission plan; everything else falls to finalize_pair
        row by row. Semantics mirror finalize_pair exactly for the
        covered shapes (combo enumeration order, lexsort-greedy merge
        anchors with (agScore, probability) rep choice, fillMateInfo
        TLEN; IntersectingPairedEndAligner.cpp:927-997, SAM.cpp:1368-1420).

        Returns (plan | None, fast_mask | None, spacing_samples).
        """
        from ..constants import PAIRED_MERGE_ANCHOR_DIST
        from .post import compute_mapq_array
        from .single import ag_restructure_possible

        B = self.batch_size
        K = f["valid"].shape[1]
        r0s, r1s = slice(0, n), slice(B, B + n)
        v0, v1 = f["valid"][r0s], f["valid"][r1s]
        loc0 = f["cand_loc"][r0s].astype(np.int64)
        loc1 = f["cand_loc"][r1s].astype(np.int64)
        dm0 = f["direction"][r0s].astype(np.int64)
        dm1 = f["direction"][r1s].astype(np.int64)
        delta = np.abs(loc0[:, :, None] - loc1[:, None, :])
        M = (
            v0[:, :, None]
            & v1[:, None, :]
            & (dm0[:, :, None] != dm1[:, None, :])
            & (delta >= self.min_spacing)
            & (delta <= self.max_spacing)
        )
        Mf = M.reshape(n, K * K)
        nc = Mf.sum(axis=1)
        ar = np.arange(n)

        len_ok0 = np.asarray(b0.lengths[:n]) >= self.min_read_length
        len_ok1 = np.asarray(b1.lengths[:n]) >= self.min_read_length
        # combos handled by the vectorized selection; busier rows (and
        # ALT-touching rows) keep the exact per-pair path
        CAP = min(48, K * K)
        fast = len_ok0 & len_ok1 & (nc >= 1) & (nc <= CAP)
        if self.alt_awareness and self.first_alt_start is not None:
            bd = self.first_alt_start
            has_alt = ((loc0 >= bd) & v0).any(axis=1) | (
                (loc1 >= bd) & v1
            ).any(axis=1)
            fast &= ~has_alt
        if not fast.any():
            return None, None, [], None

        # first-CAP combo ids in enumeration order (i0-major — the
        # np.nonzero order finalize_pair's _pair_combos walks)
        cid = np.argsort(~Mf, axis=1, kind="stable")[:, :CAP]
        cval = np.arange(CAP)[None, :] < np.minimum(nc, CAP)[:, None]
        ci0 = cid // K
        ci1 = cid % K
        AR = ar[:, None]
        ag0 = f["ag_score"][r0s].astype(np.int64)
        ag1 = f["ag_score"][r1s].astype(np.int64)
        lp0 = f["log_prob"][r0s].astype(np.float64)
        lp1 = f["log_prob"][r1s].astype(np.float64)
        # phase-3 (LV) selection values; affine only compares in the
        # phase-4 flip and supplies the winner's probability
        # (IntersectingPairedEndAligner.cpp:975-1005, 2509-2726)
        lvag0 = f["lv_ag_score"][r0s].astype(np.int64)
        lvag1 = f["lv_ag_score"][r1s].astype(np.int64)
        lvlp0 = f["lv_log_prob"][r0s].astype(np.float64)
        lvlp1 = f["lv_log_prob"][r1s].astype(np.float64)
        lvd0 = f["lv_dist"][r0s].astype(np.int64)
        lvd1 = f["lv_dist"][r1s].astype(np.int64)
        e0arr = f["end_loc"][r0s].astype(np.int64)
        e1arr = f["end_loc"][r1s].astype(np.int64)
        ce0 = e0arr[AR, ci0]
        ce1 = e1arr[AR, ci1]
        cag = lvag0[AR, ci0] + lvag1[AR, ci1]
        cpr = np.exp(lvlp0[AR, ci0] + lvlp1[AR, ci1])
        caga = ag0[AR, ci0] + ag1[AR, ci1]
        cpra = np.exp(lp0[AR, ci0] + lp1[AR, ci1])
        clvd = lvd0[AR, ci0] + lvd1[AR, ci1]

        # per-row stable lexsort by (e0, e1) — finalize_pair's
        # np.lexsort((e1, e0)) walk order; invalid combos sink
        BIGE = np.int64(1) << 60
        p1 = np.argsort(np.where(cval, ce1, BIGE), axis=1, kind="stable")
        k0 = np.take_along_axis(np.where(cval, ce0, BIGE), p1, axis=1)
        p2 = np.argsort(k0, axis=1, kind="stable")
        perm = np.take_along_axis(p1, p2, axis=1)

        def takep(a):
            return np.take_along_axis(a, perm, axis=1)

        ce0, ce1, cag, cpr, caga, cpra, clvd, ci0, ci1 = (
            takep(a) for a in (ce0, ce1, cag, cpr, caga, cpra, clvd,
                               ci0, ci1)
        )
        cval = takep(cval)

        # greedy merge-anchor walk (finalize_pair's reps loop),
        # vectorized across rows: reps occupy slots in insertion
        # order; a combo within 50bp of an existing rep on both ends
        # merges into the FIRST such rep and replaces it only when
        # strictly better by (LV agScore, LV probability)
        AD = PAIRED_MERGE_ANCHOR_DIST
        NEG = np.int64(-1) << 40
        re0 = np.zeros((n, CAP), np.int64)
        re1 = np.zeros((n, CAP), np.int64)
        rag = np.full((n, CAP), NEG)
        rpr = np.zeros((n, CAP))
        raga = np.full((n, CAP), NEG)
        rpra = np.zeros((n, CAP))
        rlvd = np.zeros((n, CAP), np.int64)
        ri0 = np.zeros((n, CAP), np.int64)
        ri1 = np.zeros((n, CAP), np.int64)
        ralive = np.zeros((n, CAP), bool)
        rcount = np.zeros(n, np.int64)
        slots = np.arange(CAP)[None, :]
        for t in range(CAP):
            v_t = cval[:, t]
            if not v_t.any():
                break
            near = (
                ralive
                & (np.abs(re0 - ce0[:, t : t + 1]) <= AD)
                & (np.abs(re1 - ce1[:, t : t + 1]) <= AD)
            )
            has = near.any(axis=1) & v_t
            j = np.where(near, slots, CAP).min(axis=1)
            jc = np.clip(j, 0, CAP - 1)
            better = has & (
                (cag[:, t] > rag[ar, jc])
                | ((cag[:, t] == rag[ar, jc]) & (cpr[:, t] > rpr[ar, jc]))
            )
            app = v_t & ~has
            dst = np.where(better, jc, rcount)
            w = np.flatnonzero(better | app)
            dw = dst[w]
            for arr, src in (
                (re0, ce0), (re1, ce1), (rag, cag), (rpr, cpr),
                (raga, caga), (rpra, cpra), (rlvd, clvd),
                (ri0, ci0), (ri1, ci1),
            ):
                arr[w, dw] = src[w, t]
            ralive[w, dw] = True
            rcount += app

        # set_best: first rep (insertion order) maximizing
        # (LV agScore, LV probability); pAll sums the LV probs
        mag = np.where(ralive, rag, NEG)
        m1 = ralive & (mag == mag.max(axis=1)[:, None])
        mpr = np.where(m1, rpr, -np.inf)
        m2 = m1 & (mpr == mpr.max(axis=1)[:, None])
        bi = np.clip(np.where(m2, slots, CAP).min(axis=1), 0, CAP - 1)
        p_all = np.where(ralive, rpr, 0.0).sum(axis=1)

        # phase-4 flip: reps within extraSearchDepth of the winner's
        # LV pair score compete on (affine agScore, affine prob); the
        # winner's probability swaps to its affine value in pBest and
        # pAll (IntersectingPairedEndAligner.cpp:2712-2726)
        D = np.int64(self.params.extra_search_depth)
        fl = ralive & (rlvd <= (rlvd[ar, bi] + D)[:, None])
        fag = np.where(fl, raga, NEG)
        f1m = fl & (fag == fag.max(axis=1)[:, None])
        fpr = np.where(f1m, rpra, -np.inf)
        f2m = f1m & (fpr == fpr.max(axis=1)[:, None])
        bi2 = np.clip(np.where(f2m, slots, CAP).min(axis=1), 0, CAP - 1)
        ch_i0 = ri0[ar, bi2]
        ch_i1 = ri1[ar, bi2]
        pr_ch = rpra[ar, bi2]
        p_all = p_all - rpr[ar, bi2] + pr_ch

        pop0 = f["popular"][r0s].astype(np.int64)
        pop1 = f["popular"][r1s].astype(np.int64)
        mapq0 = compute_mapq_array(p_all, pr_ch, pop0)
        mapq1 = compute_mapq_array(p_all, pr_ch, pop1)

        dist0 = f["dist"][r0s].astype(np.int64)
        dist1 = f["dist"][r1s].astype(np.int64)
        esc0 = f["escalated"][r0s].astype(bool)
        esc1 = f["escalated"][r1s].astype(bool)
        sc0 = dist0[ar, ch_i0]
        sc1 = dist1[ar, ch_i1]
        # chimeric double-check (ChimericPairedEndAligner.cpp:230-243,
        # 404-436), vectorized: single-end finalize of both ends via
        # finalize_batch, the (agScore >= single) min-MAPQ rule, and
        # the actual single-fallback pairs routed to the exact path
        agch0 = ag0[ar, ch_i0]
        agch1 = ag1[ar, ch_i1]
        cmp_mask = fast & (
            (esc0[ar, ch_i0] | esc1[ar, ch_i1])
            & (np.maximum(sc0, sc1) >= self.min_score_realignment)
        )
        cmp_rows = np.flatnonzero(cmp_mask)
        if cmp_rows.size:
            from .post import finalize_batch

            sub = np.concatenate([cmp_rows, B + cmp_rows])
            res = finalize_batch(
                f["dist"][sub], f["log_prob"][sub], f["ag_score"][sub],
                f["end_loc"][sub], f["cand_loc"][sub],
                f["direction"][sub], f["valid"][sub],
                f["popular"][sub].astype(np.int64),
                alt_awareness=self.alt_awareness,
                max_score_gap_to_prefer_non_alt=(
                    self.max_score_gap_to_prefer_non_alt
                ),
                max_k=self.params.max_k,
                extra_search_depth=self.params.extra_search_depth,
                lv_dists=(
                    f["lv_dist"][sub] if "lv_dist" in f else None
                ),
                use_ukkonen=self.params.use_ukkonen,
            )
            m = cmp_rows.size
            s_found = np.array([
                r[0].status not in ("notfound", "filtered") for r in res
            ])
            s_mapq = np.array([r[0].mapq for r in res], np.int64)
            s_ci = np.array([r[0].cand_index for r in res], np.int64)
            ag_sub = f["ag_score"][sub].astype(np.int64)
            sag = np.where(
                s_found, ag_sub[np.arange(2 * m), np.maximum(s_ci, 0)], 0
            )
            sag0, sag1 = sag[:m], sag[m:]
            choose = (agch0[cmp_rows] < sag0) & (agch1[cmp_rows] < sag1)
            fallback = (
                sag0 + sag1
                >= agch0[cmp_rows] + agch1[cmp_rows]
                + self.min_ag_improvement
            )
            fast[cmp_rows[fallback]] = False
            stayed = ~fallback
            m0 = stayed & choose & s_found[:m]
            m1 = stayed & choose & s_found[m:]
            mapq0[cmp_rows[m0]] = np.minimum(
                mapq0[cmp_rows[m0]], s_mapq[:m][m0]
            )
            mapq1[cmp_rows[m1]] = np.minimum(
                mapq1[cmp_rows[m1]], s_mapq[m:][m1]
            )
            # -proAg accounting for the fast compares (the slow path
            # counts its own in finalize_pair)
            self._ag_counters["ag_forced_single"] = (
                self._ag_counters.get("ag_forced_single", 0)
                + 2 * int(stayed.sum())
            )

        # selection is settled for every `fast` row at this point; the
        # conditions below are EMISSION safety only (record shape).
        # Rows passing selection but failing emission skip the per-pair
        # finalize_pair and only take winner_record for their CIGARs.
        sel_ok = fast.copy()

        plen0 = f["len_eff"][r0s].astype(np.int64)
        plen1 = f["len_eff"][r1s].astype(np.int64)
        orig0 = np.asarray(b0.lengths[:n]).astype(np.int64)
        orig1 = np.asarray(b1.lengths[:n]).astype(np.int64)
        back0 = orig0 - plen0
        back1 = orig1 - plen1
        dir0 = dm0[ar, ch_i0]
        dir1 = dm1[ar, ch_i1]
        end0 = e0arr[ar, ch_i0]
        end1 = e1arr[ar, ch_i1]
        start0 = end0 - plen0
        start1 = end1 - plen1
        starts, ends = self.contig_bounds
        ci0 = np.searchsorted(starts, start0, side="right") - 1
        ci1 = np.searchsorted(starts, start1, side="right") - 1
        ci0c = np.clip(ci0, 0, len(starts) - 1)
        ci1c = np.clip(ci1, 0, len(starts) - 1)
        inside0 = (
            (ci0 >= 0)
            & (start0 >= starts[ci0c])
            & (start0 + plen0 <= ends[ci0c])
        )
        inside1 = (
            (ci1 >= 0)
            & (start1 >= starts[ci1c])
            & (start1 + plen1 <= ends[ci1c])
        )
        fast &= (
            (f["indels"][r0s][ar, ch_i0] == 0)
            & (f["indels"][r1s][ar, ch_i1] == 0)
            & (f["clip_before"][r0s][ar, ch_i0] == 0)
            & (f["clip_after"][r0s][ar, ch_i0] == 0)
            & (f["clip_before"][r1s][ar, ch_i1] == 0)
            & (f["clip_after"][r1s][ar, ch_i1] == 0)
            & (back0 >= 0)
            & (back1 >= 0)
            & inside0
            & inside1
            & (ci0c == ci1c)
        )
        if self.params.use_affine_gap:
            # emission-time AG CIGAR rule (ReadWriter.cpp:231): ends
            # whose substitutions could restructure into a gap leave
            # the plan and take winner_record's AG traceback
            for bat, st, pl, dr, ds in (
                (b0, start0, plen0, dir0, sc0),
                (b1, start1, plen1, dir1, sc1),
            ):
                agrows = np.flatnonzero(fast & (ds >= 2))
                if agrows.size:
                    flg = ag_restructure_possible(
                        self.genome_np, bat.bases, agrows,
                        dr[agrows], st[agrows], pl[agrows],
                        np.zeros(agrows.size, np.int64), ds[agrows],
                        match=self.params.ag_match,
                        sub=self.params.ag_sub,
                        gap_open=self.params.ag_open,
                        gap_extend=self.params.ag_extend,
                    )
                    fast[agrows[flg]] = False

        sel_rows = sel_ok & ~fast
        sel = None
        if sel_rows.any():
            sel = {
                "mask": sel_rows,
                "i0": ch_i0, "i1": ch_i1,
                "mapq0": mapq0, "mapq1": mapq1,
                "dist0": sc0, "dist1": sc1,
                "dir0": dir0, "dir1": dir1,
                "end0": end0, "end1": end1,
                "spacing": np.abs(loc0[ar, ch_i0] - loc1[ar, ch_i1]),
            }
        fr = np.flatnonzero(fast)
        nf = fr.size
        if nf == 0:
            return None, None, [], sel

        fs0 = np.where(dir0 == 1, back0, 0)
        bs0 = np.where(dir0 == 1, 0, back0)
        fs1 = np.where(dir1 == 1, back1, 0)
        bs1 = np.where(dir1 == 1, 0, back1)
        my_s0 = start0 - fs0
        my_e0 = start0 + plen0 + bs0
        my_s1 = start1 - fs1
        my_e1 = start1 + plen1 + bs1
        tlen0 = _tl_vec(my_s0, my_e0, dir0 == 1, my_s1, my_e1, dir1 == 1)
        tlen1 = _tl_vec(my_s1, my_e1, dir1 == 1, my_s0, my_e0, dir0 == 1)
        pos0 = start0 - starts[ci0c] + 1
        pos1 = start1 - starts[ci1c] + 1
        flag0 = (
            FLAG_PAIRED | FLAG_PROPER | FLAG_FIRST
        ) + dir0 * FLAG_RC + dir1 * FLAG_NEXT_RC
        flag1 = (
            FLAG_PAIRED | FLAG_PROPER | FLAG_LAST
        ) + dir1 * FLAG_RC + dir0 * FLAG_NEXT_RC
        # QS:i: = the MATE's Picard quality sum (>= phred 15)
        q0 = quals[fr].astype(np.int32)
        q1 = quals[B + fr].astype(np.int32)
        qsum0 = ((q0 - 33) * (q0 >= 48)).sum(axis=1)
        qsum1 = ((q1 - 33) * (q1 >= 48)).sum(axis=1)

        def inter(a0, a1, dtype):
            out = np.empty(2 * nf, dtype=dtype)
            out[0::2] = a0[fr]
            out[1::2] = a1[fr]
            return out

        rows = np.empty(2 * nf, np.int32)
        rows[0::2] = fr
        rows[1::2] = B + fr
        qs = np.empty(2 * nf, np.int32)
        qs[0::2] = qsum1
        qs[1::2] = qsum0
        plan = {
            "mask": fast,
            "pairs": fr,
            "rows": rows,
            "flag": inter(flag0, flag1, np.int32),
            "rname_id": inter(ci0c, ci1c, np.int32),
            "pos": inter(pos0, pos1, np.int64),
            "mapq": inter(mapq0, mapq1, np.int32),
            "fs": inter(fs0, fs1, np.int32),
            "mlen": inter(plen0, plen1, np.int32),
            "bs": inter(bs0, bs1, np.int32),
            "nm": inter(sc0, sc1, np.int32),
            "rlen": inter(orig0, orig1, np.int32),
            "pnext": inter(pos1, pos0, np.int64),
            "tlen": inter(tlen0, tlen1, np.int64),
            "qs": qs,
            "bases": bases,
            "quals": quals,
        }
        spacing = (
            np.abs(loc0[ar, ch_i0] - loc1[ar, ch_i1])[fr].tolist()
            if self.infer_spacing
            else []
        )
        return plan, fast, spacing, sel

    def _emit_planned_pairs(self, writer, b0, b1, results, plan):
        """Batched paired emission: one native call formats every
        planned pair's two records; slow pairs interleave in input
        order through _emit_pair (mirrors the single-end path)."""
        from ..io import native as _native

        B = self.batch_size
        fr = plan["pairs"]
        nf = fr.size
        n = len(b0)
        # shared pair QNAME with the /1 + /2 truncation rule
        # (ReadWriter.cpp:406-421)
        q_ids = [b""] * (2 * B)
        for ii in fr:
            ii = int(ii)
            id0, id1 = b0.ids[ii], b1.ids[ii]
            if (
                len(id0) == len(id1)
                and len(id0) > 2
                and id0[-2:-1] == b"/"
                and id1[-2:-1] == b"/"
                and id0[-1:] in (b"1", b"2")
                and id1[-1:] in (b"1", b"2")
                and id0[-1:] != id1[-1:]
            ):
                id0 = id0[:-2]
            q_ids[ii] = q_ids[B + ii] = id0
        qname_off = np.zeros(2 * B + 1, dtype=np.int64)
        np.cumsum([len(x) for x in q_ids], out=qname_off[1:])
        qname_buf = b"".join(q_ids)
        names = self._sorted_contig_names
        rname_off = np.zeros(len(names) + 1, dtype=np.int64)
        np.cumsum([len(x) for x in names], out=rname_off[1:])
        rname_buf = b"".join(names)
        tag_pg = f"PG:Z:{writer.program_id}".encode()
        rg = [f"RG:Z:{writer.read_group.rg_id}"] + [
            f"{k}:Z:{v}" for k, v in writer.read_group.attrs
        ]
        tag_tail = ("\t" + "\t".join(rg)).encode()
        formatted = _native.format_sam_paired(
            plan["bases"], plan["quals"], qname_buf, qname_off,
            rname_buf, rname_off, plan["rows"], plan["flag"],
            plan["rname_id"], plan["pos"], plan["mapq"], plan["fs"],
            plan["mlen"], plan["bs"], plan["nm"], plan["rlen"],
            plan["pnext"], plan["tlen"], plan["qs"],
            tag_pg, tag_tail,
        )
        if formatted is None:
            raise RuntimeError(
                "native paired SAM formatter unavailable after planning"
            )
        blob, rec_end = formatted
        self.branches["planned"] += nf
        mq = plan["mapq"]
        self.stats.total += 2 * nf
        n_single = int((mq >= MAPQ_LIMIT_FOR_SINGLE_HIT).sum())
        self.stats.single += n_single
        self.stats.multi += 2 * nf - n_single
        self.stats.aligned_as_pairs += 2 * nf
        self.stats.mapq_histogram += np.bincount(
            np.minimum(mq, 70), minlength=71
        )
        out = writer.out
        complex_rows = np.flatnonzero(~plan["mask"][:n])
        k = 0  # planned pairs already flushed
        for i in complex_rows:
            j = int(np.searchsorted(fr, i))
            if j > k:
                a = 0 if k == 0 else int(rec_end[2 * k - 1])
                out.write(blob[a : int(rec_end[2 * j - 1])])
                k = j
            r0, r1 = results[int(i)]
            self._emit_pair(writer, b0, b1, int(i), r0, r1)
        if k < nf:
            a = 0 if k == 0 else int(rec_end[2 * k - 1])
            out.write(blob[a:])

    def _fix_edge_indels(
        self, f, bases, len_eff, didx_sc, dev_bases, dev_quals
    ) -> None:
        """Edge-indel honesty at candidate level (paired path).

        Gapless dist-2 candidates where one 1-base indel explains both
        mismatches (see single.one_indel_improves) are re-scored with
        the full DP via score_rows and patched into the merged arrays
        in place — before pair finalization, so the corrected distance
        and probability feed winner selection, pAll/MAPQ, and mate
        position alike. SNAP semantics: candidates are always LV-scored
        (BaseAligner.cpp:1160-1173).
        """
        if self.params.max_k_same < 2:
            return
        from .single import one_indel_improves

        d = f["dist"]
        cmask = (
            f["valid"]
            & (d == 2)
            & (f["indels"] == 0)
            & ~f["escalated"]
            & (f["clip_before"] == 0)
            & (f["clip_after"] == 0)
        )
        rows, ks = np.nonzero(cmask)
        if rows.size == 0:
            return
        locs = f["cand_loc"][rows, ks]
        dirs = f["direction"][rows, ks]
        plens = f["len_eff"][rows]
        ok = one_indel_improves(
            self.genome_np, bases, rows, dirs, locs, plens,
            np.zeros(len(rows), dtype=np.int64),
        )
        if not ok.any():
            return
        rows, ks = rows[ok], ks[ok]
        n = len(rows)
        self.branches["edge_indel_fix"] += int(np.unique(rows % self.batch_size).size)
        M = 16
        while M < n:
            M <<= 1
        pad = lambda a, dt: np.concatenate(
            [np.asarray(a, dt), np.zeros(M - n, dt)]
        )
        live = np.zeros(M, dtype=bool)
        live[:n] = True
        sub = pipeline.fetch_subset(pipeline.score_rows(
            didx_sc, dev_bases, dev_quals, self._to_dev(len_eff),
            self._to_dev(pad(rows, np.int64)),
            self._to_dev(pad(dirs[ok], np.int32)),
            self._to_dev(pad(locs[ok], np.int64)),
            self._to_dev(pad(f["seed_off"][rows, ks], np.int32)),
            self._to_dev(live), self.params,
        ))
        good = np.asarray(sub.valid)[:n]
        r2, k2 = rows[good], ks[good]
        sel = np.flatnonzero(good)
        f["dist"][r2, k2] = np.asarray(sub.dist)[sel]
        f["lv_dist"][r2, k2] = np.asarray(sub.lv_dist)[sel]
        f["indels"][r2, k2] = np.asarray(sub.indels)[sel]
        f["log_prob"][r2, k2] = np.asarray(sub.log_prob)[sel]
        f["ag_score"][r2, k2] = np.asarray(sub.ag_score)[sel]
        f["end_loc"][r2, k2] = np.asarray(sub.end_loc)[sel]
        f["body_loc"][r2, k2] = np.asarray(sub.body_loc)[sel]
        f["escalated"][r2, k2] = np.asarray(sub.escalated)[sel]
        f["clip_before"][r2, k2] = np.asarray(sub.clip_before)[sel]
        f["clip_after"][r2, k2] = np.asarray(sub.clip_after)[sel]

    def _pc_host(self, pc):
        """Candidate pool for the hamming rescue: the host
        PairedCandidates when the host intersection ran, else a one-time
        host fetch of the device-intersect candidate tile (rescue is
        rare, so the fetch is lazy)."""
        if pc is not None:
            return pc
        from .intersect import PairedCandidates

        pcd = self._pcd
        loc, off, dr, valid = (
            pcd[k].cpu().numpy() for k in ("loc", "off", "dir", "valid")
        )
        R, K = loc.shape
        out = PairedCandidates(R, K)
        out.loc = loc
        out.off = off
        out.dir = dr
        out.valid = valid
        return out

    def _redo_overflow_pairs(
        self, f, bases, quals, len_eff, B, ip, didx_sc
    ):
        """Exact host-intersection redo of pairs the device path
        flagged (a recorded lookup overflowed the gather cap, or the
        compaction cut could have dropped a top-K candidate). Both ends
        of a flagged pair rerun — mate windows read the full lists."""
        rows = np.flatnonzero(f["truncated"][:B])
        if rows.size == 0:
            return
        self.stats.intersect_overflow_pairs += int(rows.size)
        self.branches["host_overflow_redo"] += int(rows.size)
        nb = rows.size
        P2 = 1 << max(4, int(np.ceil(np.log2(nb))))
        pr = np.zeros(P2, dtype=np.int64)
        pr[:nb] = rows
        sub = np.concatenate([pr, pr + B])
        sb = np.ascontiguousarray(bases[sub])
        sq = np.ascontiguousarray(quals[sub])
        sl = len_eff[sub].copy()
        dead = np.concatenate(
            [np.arange(nb, P2), P2 + np.arange(nb, P2)]
        )
        sl[dead] = 0
        pc = paired_candidates(self.index.host, sb, sl, P2, ip)
        db, dq = self._to_dev(sb), self._to_dev(sq)
        t1 = pipeline.score_candidates(
            didx_sc, db, dq, self._to_dev(sl),
            *(self._to_dev(a) for a in (
                pc.loc, pc.off, pc.dir, pc.valid, pc.weight, pc.popular
            )),
            self.params, tier1_only=True,
            max_k_bonus=self._to_dev(pc.big_indel),
        )
        fs = pipeline.two_phase_merge(didx_sc, t1, db, dq, self.params)
        live = np.concatenate([np.arange(nb), P2 + np.arange(nb)])
        dst = np.concatenate([rows, rows + B])
        for k, v in f.items():
            if k == "truncated":
                continue
            v[dst] = fs[k][live]
        f["truncated"][dst] = False

    def _try_hamming_rescue(self, batch, i, row, f, pc):
        """Gapless soft-clip rescore of an unmapped end's candidates
        (-eh, ChimericPairedEndAligner.cpp:330-363). Returns a full
        emission record dict or None."""
        from .paired import hamming_rescue

        self.branches["hamming_rescue"] += 1
        plen = int(f["len_eff"][row])
        res = hamming_rescue(
            self.genome_np,
            batch.bases[i], batch.quals[i], plen,
            self.params.seed_len,
            pc.loc[row], pc.off[row], pc.dir[row], pc.valid[row],
            self.params.max_k // 2, int(f["popular"][row]),
            ag_match=self.params.ag_match, ag_sub=self.params.ag_sub,
        )
        if res is None:
            return None
        self.branches["hamming_rescued"] += 1
        mapq = res["mapq"] // 3  # chimeric penalty
        mapq = 0 if mapq <= self.flatten_mapq_at_or_below else mapq
        d = res["direction"]
        back_q = int(batch.lengths[i]) - plen
        cb, ca = res["clip_before"], res["clip_after"]
        fs = cb + (back_q if d else 0)
        bs = ca + (0 if d else back_q)
        body = res["ref_span"]
        if self.use_m:
            body_cig = f"{body}M"
        else:
            from ..genome import reverse_complement_codes
            from .adjust import _split_eq_x, render_cigar

            pat = batch.bases[i, :plen]
            pat = reverse_complement_codes(pat.copy()) if d else pat
            body_cig = render_cigar(
                _split_eq_x(
                    [[body, "M"]], res["start_loc"], pat[cb : plen - ca],
                    self.genome_np,
                )
            )
        cigar = (
            (f"{fs}S" if fs else "") + body_cig + (f"{bs}S" if bs else "")
        )
        return {
            "status": "single" if mapq >= 10 else "multi",
            "start_loc": res["start_loc"],
            "cigar": cigar,
            "nm": res["nm"],
            "front_soft": fs,
            "ref_span": body,
            "direction": d,
            "mapq": mapq,
            "dist": res["dist"],
            "aligned_as_pair": False,
            "supplementary": False,
        }

    def align_files(
        self, path1: str, path2: str | None, writer: SamWriter
    ) -> AlignerStats:
        writer.write_header()
        t0 = time.time()
        plan_ok = self._plan_ok(writer)
        progress = ProgressReporter()
        from ..io.readers import ReadAheadQueue

        batches = iter(ReadAheadQueue(paired_batches(
            path1, None if self.force_interleaved else path2,
            self.batch_size, self.max_read_len,
            keep_secondary=self.read_secondary,
            force_kind=self.force_kind, force_gzip=self.force_gzip,
            keep_unpaired=self.keep_unpaired,
        )))
        # the loop's stages, each a span with its batch number
        # (paired.read_wait, paired.align, paired.emit), feed AlignerStats
        k = 0
        while True:
            with RECORDER.timed("paired.read_wait", batch=k) as sp:
                item = next(batches, None)
            self.stats.seconds_reading += sp.seconds
            if item is None:
                break
            b0, b1 = item
            if not self.ignore_mismatched_ids:
                self._check_ids(b0, b1)
            self.branches["batches"] += 1
            with RECORDER.timed("paired.align", batch=k, pairs=len(b0)) as sp:
                if plan_ok:
                    results, plan = self.align_batch(
                        b0, b1, plan_writer=writer
                    )
                else:
                    results, plan = self.align_batch(b0, b1), None
            self.stats.seconds_aligning += sp.seconds
            with RECORDER.timed("paired.emit", batch=k, pairs=len(b0)) as sp:
                if plan is not None:
                    self._emit_planned_pairs(writer, b0, b1, results, plan)
                else:
                    for i, (r0, r1) in enumerate(results):
                        self._emit_pair(writer, b0, b1, i, r0, r1)
            self.stats.seconds_writing += sp.seconds
            k += 1
            progress.update(2 * len(b0))
        self.stats.align_seconds = time.time() - t0
        return self.stats

    @staticmethod
    def _check_ids(b0: ReadBatch, b1: ReadBatch) -> None:
        """Mate read-ID agreement (PairedAligner.cpp:520-528; -I skips)."""
        def mate_key(rid: bytes) -> bytes:
            k = rid.split()[0]
            # strip exactly one "/1" or "/2" mate suffix (readIdsMatch
            # allows the digit after '/' to differ; Read.h)
            if k[-2:] in (b"/1", b"/2"):
                k = k[:-2]
            return k

        for id0, id1 in zip(b0.ids, b1.ids):
            k0 = mate_key(id0)
            k1 = mate_key(id1)
            if k0 != k1:
                raise ValueError(
                    f"mismatched paired read IDs {id0!r} / {id1!r} "
                    "(use -I to ignore)"
                )

    def _emit_pair(self, writer, b0, b1, i, r0, r1):
        from ..constants import BASE_DECODE
        from ..options import FILTER_BOTH_MATES_MATCH, pass_filter

        self.branches["per_pair"] += 1
        if self.filter_flags:
            # pair-level filter: with -E b both ends must pass, else either
            # (PairedAligner.cpp:528-532)
            p0 = pass_filter(self.filter_flags, r0["status"])
            p1 = pass_filter(self.filter_flags, r1["status"])
            ok = (
                (p0 and p1)
                if self.filter_flags & FILTER_BOTH_MATES_MATCH
                else (p0 or p1)
            )
            if not ok:
                self.stats.total += 2
                self.stats.filtered += 2
                return

        # shared pair QNAME: truncate "/1"+"/2" suffixes when both ends
        # carry them with differing digits (ReadWriter.cpp:406-421)
        id0, id1 = b0.ids[i], b1.ids[i]
        if (
            len(id0) == len(id1)
            and len(id0) > 2
            and id0[-2:-1] == b"/"
            and id1[-2:-1] == b"/"
            and id0[-1:] in (b"1", b"2")
            and id1[-1:] in (b"1", b"2")
            and id0[-1:] != id1[-1:]
        ):
            id0, id1 = id0[:-2], id1[:-2]
        pair_ids = (id0, id1)

        recs = (r0, r1)
        located = []
        for r in recs:
            self.stats.total += 1
            if r["status"] in ("filtered", "notfound"):
                located.append(None)
                if r["status"] == "filtered":
                    self.stats.too_short += 1
                else:
                    self.stats.not_found += 1
                continue
            loc = writer.locate(r["start_loc"])
            if loc is None:
                located.append(None)
                self.stats.not_found += 1
                continue
            located.append(loc)
            if r["mapq"] >= MAPQ_LIMIT_FOR_SINGLE_HIT:
                self.stats.single += 1
            else:
                self.stats.multi += 1
            if r.get("aligned_as_pair"):
                self.stats.aligned_as_pairs += 1
            self.stats.mapq_histogram[min(70, r["mapq"])] += 1

        for which, (r, batch) in enumerate(((r0, b0), (r1, b1))):
            mate = recs[1 - which]
            mate_located = located[1 - which]
            my_located = located[which]
            L = int(batch.lengths[i])
            seq = BASE_DECODE[batch.bases[i, :L]].tobytes()
            qual = batch.quals[i, :L].tobytes()
            flag = FLAG_PAIRED | (FLAG_FIRST if which == 0 else FLAG_LAST)
            rname, pos, mapq, cigar, nm = "*", 0, 0, "*", None
            rnext, pnext, tlen = "*", 0, 0
            if my_located is None:
                flag |= FLAG_UNMAPPED
                if mate_located is not None:
                    # SAM spec: unmapped end copies mate RNAME/POS
                    rname, pos = mate_located
                    rnext, pnext = "=", pos
                    if mate["direction"]:
                        flag |= FLAG_NEXT_RC
            else:
                rname, pos = my_located
                mapq, cigar, nm = r["mapq"], r["cigar"], r["nm"]
                if r["direction"]:
                    flag |= FLAG_RC
                if mate_located is None:
                    flag |= FLAG_NEXT_UNMAPPED
                    rnext, pnext = "=", pos
                else:
                    mrname, mpos = mate_located
                    rnext = "=" if mrname == rname else mrname
                    pnext = mpos
                    if mate["direction"]:
                        flag |= FLAG_NEXT_RC
                    if r.get("aligned_as_pair"):
                        flag |= FLAG_PROPER
                    if mrname == rname:
                        tlen = _template_length(
                            r, mate, pos, mpos
                        )
            from ..io.output import quality_sum

            mate_batch = b1 if which == 0 else b0
            mate_qual = mate_batch.quals[i, : int(mate_batch.lengths[i])]
            # QS:i: = mate's Picard-style quality sum, the input to the
            # streaming duplicate marker (SAM.cpp:1826-1837); LB already
            # rides in the @RG attribute block
            extra = [f"QS:i:{quality_sum(bytes(mate_qual))}"]
            if self.internal_score_tag:
                sc = r.get("dist", -1) if my_located is not None else -1
                extra.insert(0, f"{self.internal_score_tag}:i:{sc}")
            writer.write_record(
                pair_ids[which], flag, rname, pos, mapq, cigar, seq, qual,
                nm=nm, rnext=rnext, pnext=pnext, tlen=tlen,
                extra_tags=extra,
                input_aux=(
                    batch.aux[i] if batch.aux is not None else b""
                ),
            )

        # ALT supplementary pair (-ea): both ends at the best ALT pair
        # location, flagged supplementary (0x800).
        supp0 = r0.get("alt_supplementary")
        supp1 = r1.get("alt_supplementary")
        if supp0 is not None and supp1 is not None:
            from ..io.sam import FLAG_SUPPLEMENTARY

            sloc0 = writer.locate(supp0["start_loc"])
            sloc1 = writer.locate(supp1["start_loc"])
            for which, (supp, mate_loc, batch) in enumerate(
                ((supp0, sloc1, b0), (supp1, sloc0, b1))
            ):
                sloc = sloc0 if which == 0 else sloc1
                if sloc is None:
                    continue
                L = int(batch.lengths[i])
                seq = BASE_DECODE[batch.bases[i, :L]].tobytes()
                qual = batch.quals[i, :L].tobytes()
                flag = (
                    FLAG_PAIRED | FLAG_SUPPLEMENTARY
                    | (FLAG_FIRST if which == 0 else FLAG_LAST)
                )
                if supp["direction"]:
                    flag |= FLAG_RC
                rnext, pnext = "*", 0
                if mate_loc is not None:
                    rnext = "=" if mate_loc[0] == sloc[0] else mate_loc[0]
                    pnext = mate_loc[1]
                writer.write_record(
                    pair_ids[which], flag, sloc[0], sloc[1], supp["mapq"],
                    supp["cigar"], seq, qual, nm=supp["nm"],
                    rnext=rnext, pnext=pnext, tlen=0,
                )
                self.stats.extra_alignments += 1

        # -om secondary pairs (and fallback per-end secondaries): each
        # emitted with 0x100, MAPQ 0, mate info from the paired
        # secondary when present else the primary mate
        # (IntersectingPairedEndAligner.cpp:999-1049)
        secs0 = r0.get("secondaries")
        secs1 = r1.get("secondaries")
        if secs0 or secs1:
            from ..io.sam import FLAG_SECONDARY

            contig_counts: dict[str, int] = {}
            for loc in located:
                if loc is not None:
                    contig_counts[loc[0]] = contig_counts.get(loc[0], 0) + 1
            n_rows = max(len(secs0 or ()), len(secs1 or ()))
            for row in range(n_rows):
                s_recs = (
                    (secs0 or [None] * n_rows)[row],
                    (secs1 or [None] * n_rows)[row],
                )
                s_locs = [
                    writer.locate(s["start_loc"]) if s is not None else None
                    for s in s_recs
                ]
                if self.max_secondary_per_contig > 0:
                    capped = False
                    for sl in s_locs:
                        if sl is None:
                            continue
                        n_ct = contig_counts.get(sl[0], 0) + 1
                        if n_ct > self.max_secondary_per_contig:
                            capped = True
                        contig_counts[sl[0]] = n_ct
                    if capped:
                        continue
                for which in (0, 1):
                    s = s_recs[which]
                    sloc = s_locs[which]
                    if s is None or sloc is None:
                        continue
                    batch = b0 if which == 0 else b1
                    L = int(batch.lengths[i])
                    seq = BASE_DECODE[batch.bases[i, :L]].tobytes()
                    qual = batch.quals[i, :L].tobytes()
                    flag = (
                        FLAG_PAIRED | FLAG_SECONDARY
                        | (FLAG_FIRST if which == 0 else FLAG_LAST)
                    )
                    if s["direction"]:
                        flag |= FLAG_RC
                    mate_loc = s_locs[1 - which]
                    mate_dir = (
                        s_recs[1 - which]["direction"]
                        if s_recs[1 - which] is not None
                        else (
                            recs[1 - which].get("direction", 0)
                            if located[1 - which] is not None
                            else 0
                        )
                    )
                    if mate_loc is None:
                        mate_loc = located[1 - which]
                    rnext, pnext, tlen = "*", 0, 0
                    if mate_loc is not None:
                        rnext = "=" if mate_loc[0] == sloc[0] else mate_loc[0]
                        pnext = mate_loc[1]
                        if mate_dir:
                            flag |= FLAG_NEXT_RC
                        if s.get("aligned_as_pair"):
                            flag |= FLAG_PROPER
                    writer.write_record(
                        pair_ids[which], flag, sloc[0], sloc[1], 0,
                        s["cigar"], seq, qual, nm=s["nm"],
                        rnext=rnext, pnext=pnext, tlen=tlen,
                    )
                    self.stats.extra_alignments += 1


def _trailing_clip(cigar: str) -> int:
    """Trailing S/H bases: SNAP's getRefSpanFromCigar skips only a
    LEADING clip and counts every later op except I — so trailing soft
    and hard clips extend the TLEN span (SAM.cpp getRefSpanFromCigar)."""
    import re

    n = 0
    m = re.search(r"(\d+)H$", cigar)
    if m:
        n += int(m.group(1))
        cigar = cigar[: m.start()]
    m = re.search(r"(\d+)S$", cigar)
    if m and m.start() > 0:
        n += int(m.group(1))
    return n


def _tl_vec(my_s, my_e, my_rc, mate_s, mate_e, mate_rc):
    """Vectorized _template_length over absolute unclipped spans (the
    planned-pair fast path; same FR/FF/RF/RR cases, SAM.cpp:1368-1420)."""
    lt = my_s < mate_s
    r_lt = np.where(
        ~my_rc,
        np.where(mate_rc, mate_e - my_s, mate_s - my_s),
        np.where(~mate_rc, mate_s - my_e, mate_e - my_e),
    )
    r_ge = np.where(
        my_rc,
        np.where(~mate_rc, -(my_e - mate_s), -(my_e - mate_e)),
        np.where(~mate_rc, -(my_s - mate_s), -(my_s - mate_e)),
    )
    return np.where(lt, r_lt, r_ge)


def _template_length(r: dict, mate: dict, pos: int, mpos: int) -> int:
    """TLEN per fillMateInfo (SAM.cpp:1368-1420): signed span between
    unclipped starts / unclipped CIGAR-derived ends, FR/FF/RF/RR
    cases. Ends include trailing clipped bases (the physical fragment
    boundary), matching getRefSpanFromCigar."""
    my_start = pos - r["front_soft"]
    my_end = pos + r["ref_span"] + _trailing_clip(r.get("cigar", ""))
    mate_start = mpos - mate["front_soft"]
    mate_end = mpos + mate["ref_span"] + _trailing_clip(
        mate.get("cigar", "")
    )
    my_rc = bool(r["direction"])
    mate_rc = bool(mate["direction"])
    if my_start < mate_start:
        if not my_rc:
            return mate_end - my_start if mate_rc else mate_start - my_start
        return mate_start - my_end if not mate_rc else mate_end - my_end
    else:
        if my_rc:
            return -(my_end - mate_start) if not mate_rc else -(my_end - mate_end)
        return -(my_start - mate_start) if not mate_rc else -(my_start - mate_end)
