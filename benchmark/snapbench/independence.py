"""The run's independence from JAX: no module whose top-level name (the
part before the first dot, compared whole) is JAX's, its libraries' or
the JAX package's. The port's own name, snap_tpu_torch, begins with the
JAX package's and passes."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "snap_tpu")


def forbidden_modules(names=None) -> list[str]:
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))
