"""Build and load the CUDA kernels in csrc/ at first use.

Each `csrc/<name>.cu` is compiled by nvcc into its own shared library
with a plain C interface (`build/lib<name>.so`) and loaded with ctypes.
Nothing is built when the package is imported: `load(name)` builds on
the first call, and `build_all()` starts one nvcc per source at once.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
KERNELS = ("gapless", "dp", "affine")

# -fmad=false: no a*b+c contraction, so the float32 log-probabilities
# are rounded after every operation exactly as the plain PyTorch
# versions round them
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}   # name -> nvcc's output (ptxas -v lines)


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _fresh(name: str) -> bool:
    so, src = _lib_path(name), os.path.join(CSRC_DIR, f"{name}.cu")
    return os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src)


def build_all(names=KERNELS) -> dict[str, float]:
    """Compile every stale kernel library, one nvcc process per source,
    all started together. Returns {name: seconds} for those built."""
    todo = [n for n in names if not _fresh(n)]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.time()
    procs = {}
    for n in todo:
        tmp = _lib_path(n) + f".tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{n}.cu")]
        procs[n] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
        )
    secs, errors = {}, []
    for n, (p, tmp) in procs.items():
        out, _ = p.communicate()
        secs[n] = time.time() - t0
        BUILD_LOG[n] = out
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{out}")
        else:
            os.replace(tmp, _lib_path(n))
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {err})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
