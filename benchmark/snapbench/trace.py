"""The traced run's instruments, all set from the benchmark's own files
around calls into the port (nothing inside the port changes):

- host spans: every outermost call into align/pipeline.py's functions
  ("pipeline.<name>"), and the single-end aligner's batch-level methods
  ("single.<method>"), each with its wall-clock
  start and end (time.time_ns, the profiler's clock);
- kernel work: each launch of the three kernel wrappers adds the least
  time its inputs need (roofline.py) to a device-side total, with no
  synchronisation per launch;
- device intervals: torch.profiler (CUDA activity only) over the window,
  every kernel, copy and set on the card.

Tracer.record() returns the window as one JSON-able dict, which the
metric readers (benchmark/metrics/*.py) read.
"""

from __future__ import annotations

import functools
import inspect
import threading
import time

from . import roofline

SINGLE_METHODS = ("_submit", "_finalize", "_redo_wide", "_emit_planned", "_emit")


def _tensor_bytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


class Tracer:
    def __init__(self, device):
        import torch

        self.device = device
        self.spans: list[tuple[str, int, int]] = []
        self.work = {k: [0, torch.zeros((), dtype=torch.float64, device=device)]
                     for k in ("gapless", "dp", "affine")}
        self._local = threading.local()
        self._saved: list[tuple[object, str, object]] = []
        self._prof = None
        self.device_ops: list[tuple[str, int, int]] = []

    # -- wrappers -----------------------------------------------------
    def _patch(self, owner, name: str, new) -> None:
        old = getattr(owner, name)
        if hasattr(old, "launches"):
            # a kernel wrapper counts its launches on the module's name for
            # it, which is now the counting wrapper: carry the count over
            new.launches = old.launches
        self._saved.append((owner, name, old))
        setattr(owner, name, new)

    def _span(self, fn, label: str, outermost_of: str | None):
        spans, local = self.spans, self._local

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            depth = getattr(local, outermost_of, 0) if outermost_of else 0
            if outermost_of:
                setattr(local, outermost_of, depth + 1)
            t0 = time.time_ns()
            try:
                return fn(*a, **kw)
            finally:
                if depth == 0:
                    spans.append((label, t0, time.time_ns()))
                if outermost_of:
                    setattr(local, outermost_of, depth)

        return wrapped

    def _accumulate(self, family: str, nbytes: int, int_ops, fp_ops) -> None:
        import torch

        t = torch.maximum(int_ops / roofline.INT32_OPS_PER_S, fp_ops / roofline.FP32_OPS_PER_S)
        entry = self.work[family]
        entry[0] += 1
        entry[1] += 1e3 * torch.clamp(t, min=nbytes / roofline.HBM_BYTES_PER_S)

    def install(self) -> None:
        import torch

        from snap_tpu_torch.align import pipeline, single
        from snap_tpu_torch.ops import affine_cuda, dp_cuda

        for name, fn in list(vars(pipeline).items()):
            if inspect.isfunction(fn) and fn.__module__ == pipeline.__name__:
                self._patch(pipeline, name, self._span(fn, "pipeline." + name, "pipeline"))
        for name in SINGLE_METHODS:
            fn = getattr(single.SingleEndAligner, name)
            self._patch(single.SingleEndAligner, name, self._span(fn, f"single.{name}", None))

        gapless = pipeline.gapless_prescreen_cuda

        def gapless_counted(*a, **kw):
            out = gapless(*a, **kw)
            B, K, PW = a[0].shape[0], a[10], a[11]
            mism = out[0].sum().to(torch.float64)
            i_ops, f_ops = roofline.gapless_work(B, K, PW, mism)
            self._accumulate("gapless", _tensor_bytes(*a[:10]) + _tensor_bytes(*out), i_ops, f_ops)
            return out

        self._patch(pipeline, "gapless_prescreen_cuda", gapless_counted)

        dp = dp_cuda.fitting_edit_distance_core_cuda

        def dp_counted(pattern, pat_logq, plen, text, anchored):
            out = dp(pattern, pat_logq, plen, text, anchored)
            cells = plen.clamp(0, pattern.shape[1]).sum().to(torch.float64) * (text.shape[1] + 1)
            i_ops, f_ops = roofline.dp_work(cells)
            self._accumulate("dp", _tensor_bytes(pattern, pat_logq, plen, text, *out), i_ops, f_ops)
            return out

        self._patch(dp_cuda, "fitting_edit_distance_core_cuda", dp_counted)

        aff = affine_cuda.affine_extend_core_cuda

        def affine_counted(pattern, pat_logq, plen, text, tlen, score_init, **kw):
            out = aff(pattern, pat_logq, plen, text, tlen, score_init, **kw)
            cells = (plen.clamp(0, pattern.shape[1]).to(torch.float64)
                     * tlen.clamp(0, text.shape[1]).to(torch.float64)).sum()
            i_ops, f_ops = roofline.affine_work(cells)
            self._accumulate("affine", _tensor_bytes(pattern, pat_logq, plen, text, tlen,
                                                     score_init, *out), i_ops, f_ops)
            return out

        self._patch(affine_cuda, "affine_extend_core_cuda", affine_counted)

    def uninstall(self) -> None:
        while self._saved:
            owner, name, fn = self._saved.pop()
            if hasattr(fn, "launches"):
                fn.launches = getattr(owner, name).launches
            setattr(owner, name, fn)

    # -- the device trace ---------------------------------------------
    def start_profiler(self) -> None:
        if self.device.type != "cuda":
            return
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()

    def stop_profiler(self) -> None:
        if self._prof is None:
            return
        from torch.autograd import DeviceType

        self._prof.stop()
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                s = e.start_ns()
                self.device_ops.append((e.name(), s, s + e.duration_ns()))
        self._prof = None

    def record(self, t0_ns: int, t1_ns: int) -> dict:
        ops = [[n, max(s, t0_ns), min(e, t1_ns)] for n, s, e in self.device_ops
               if e > t0_ns and s < t1_ns]
        return {
            "window_ns": [t0_ns, t1_ns],
            "device_ops": ops,
            "spans": [list(s) for s in self.spans if s[2] > t0_ns and s[1] < t1_ns],
            "kernel_work": {k: {"launches": n, "bound_ms": float(acc)}
                            for k, (n, acc) in self.work.items()},
        }


def union_ns(intervals) -> int:
    """Total length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted((s, e) for s, e in intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def breakdown(record: dict, top: int = 10) -> dict:
    """The device operations that took most time (seconds, by name), and
    the longest idle gaps of the card, each named by the innermost host
    span open at its middle."""
    by_name: dict[str, int] = {}
    for n, s, e in record["device_ops"]:
        by_name[n] = by_name.get(n, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    t0, t1 = record["window_ns"]
    gaps, last = [], t0
    for s, e in sorted((s, e) for _, s, e in record["device_ops"]):
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if t1 > last:
        gaps.append((last, t1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    spans = record["spans"]
    named = []
    for a, b in gaps:
        mid = (a + b) // 2
        open_ = [sp for sp in spans if sp[1] <= mid < sp[2]]
        label = max(open_, key=lambda sp: sp[1])[0] if open_ else "outside the traced spans"
        named.append([label, (b - a) / 1e9])
    return {"device_ops": [[n, ns / 1e9] for n, ns in ops], "idle_gaps": named}
