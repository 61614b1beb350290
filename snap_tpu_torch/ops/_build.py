"""Build and load the CUDA kernels in csrc/ at first use.

Each `csrc/<name>.cu` is compiled by nvcc into its own shared library
with a plain C interface (`build/lib<name>.so`) and loaded with ctypes.
Nothing is built when the package is imported: a `Kernel` builds and
binds its library on its first call, and `build_all()` starts one nvcc
per source at once. `add_source` registers another source of the same C
interface under a name of its own (say, a kernel as an earlier commit
had it), which `Kernel.using` puts in place of the package's for a
comparison on the same inputs.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
KERNELS = ("gapless", "dp", "affine", "agcigar")

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
_sources: dict[str, str] = {}    # name -> .cu path outside csrc/
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


def add_source(name: str, path: str) -> None:
    """Build library `name` from `path` instead of csrc/<name>.cu."""
    _sources[name] = os.path.abspath(path)


def _src_path(name: str) -> str:
    return _sources.get(name) or os.path.join(CSRC_DIR, f"{name}.cu")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _fresh(name: str) -> bool:
    so, src = _lib_path(name), _src_path(name)
    headers = [os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
               if f.endswith(".cuh")]
    newest = max(os.path.getmtime(f) for f in [src, *headers])
    return os.path.exists(so) and os.path.getmtime(so) >= newest


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
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp, _src_path(n)]
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
            errors.append(f"nvcc failed for {_src_path(n)}:\n{out}")
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


class Kernel:
    """The C launch function `symbol` of library `name`, bound with its
    argument types once, at its first call."""

    def __init__(self, name: str, symbol: str, argtypes):
        self.name, self.symbol, self.argtypes = name, symbol, list(argtypes)
        self._fn = None

    def bind(self, name: str):
        fn = getattr(load(name), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        return fn

    def __call__(self, *args) -> int:
        fn = self._fn
        if fn is None:
            fn = self._fn = self.bind(self.name)
        return fn(*args)

    @contextlib.contextmanager
    def using(self, name: str):
        """Within the block, calls launch library `name`'s function."""
        saved, self._fn = self._fn, self.bind(name)
        try:
            yield
        finally:
            self._fn = saved


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {err})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


# resident blocks per SM of the long-row kernels (csrc/dp.cu and
# csrc/affine.cu kRowBlocksPerSM: 256 threads of at most 128 registers)
LONG_ROW_BLOCKS_PER_SM = 2
# columns of one strip of a long row (kRowCols: 256 threads of 8); a
# wider row runs strip by strip, through 8 words of scratch per block
# and recurrence row
LONG_ROW_STRIP_COLS = 2048


def long_row_blocks(rows: int, device) -> int:
    """Blocks of a long-row launch over `rows` rows: one per row, up to
    the LONG_ROW_BLOCKS_PER_SM that each SM holds at once; each takes
    the next row when it is done."""
    import torch

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(rows, sms * LONG_ROW_BLOCKS_PER_SM))


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
