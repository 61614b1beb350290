"""The dp kernel's share of its roofline in the window, in %: the sum of
its launches' least times (snapbench/roofline.py, counted from each
launch's inputs) over the device time of its kernels, csrc/dp.cu
(fitting_dp_kernel, fitting_dp_mid_kernel, fitting_dp_row_kernel), from
torch.profiler's intervals. Nothing to read without a launch."""

import re

KERNELS = re.compile(r"\bfitting_dp_(mid_|row_)?kernel\b")


def read(record):
    work = record.get("kernel_work", {}).get("dp")
    ms = sum(e - s for n, s, e in record.get("device_ops", []) if KERNELS.search(n)) / 1e6
    if not work or not work["launches"] or ms <= 0:
        return None
    return 100.0 * work["bound_ms"] / ms
