"""The benchmark of snap_tpu_torch: one cell of BENCHMARK.json run once.

A cell is a genome deployment (configs/<config>.json) under a traffic mix
(traffic/<traffic>.json). A run aligns the mix's reads through the port's
own entry point, `snap_tpu_torch.cli.main`, for a fixed window, prints
the cell's metrics as one JSON line, and judges the window's SAM records
against the plain reference in `reference/`. Nothing here imports JAX or
the JAX package.
"""
