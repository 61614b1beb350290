"""A configuration's genome and the port's index of it, made once per
checkout and kept under benchmark/.cache.

The genome comes from the configuration's fixed `genome_seed`: uniform
random bases with planted repeats, either the repeat families the
configuration lists (`families`: a consensus of `length` bases planted
`copies` times, each copy with `divergence` of its positions redrawn)
or, where it gives a `repeat_frac` instead, gen_repeat_genome, a frozen
copy of chip_smoke.py's generator (bench.py's `_gen_repeat_genome`
model). The configuration's `n_runs` ([start, length] pairs) are then
set to N, which the index skips and no read is drawn from. The index is built by the port's own `index` command, as
a SNAP user runs `snap index` once and aligns many read sets; its
directory name carries a hash of the port's index sources, so a change
of the index format never loads a stale one.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import shutil
import time

import numpy as np

from .layout import CACHE_DIR

DECODE = np.frombuffer(b"ACGTN", np.uint8)


def gen_repeat_genome(rng, glen: int, repeat_frac: float) -> np.ndarray:
    """Synthetic genome with planted repeats (chip_smoke.py's
    gen_repeat_genome, the model of bench.py's _gen_repeat_genome):
    ~300 bp SINE-like units with 1% divergence, 6 kb LINE-like units,
    and tandem microsatellites, one family of each kind, copies in
    proportion to glen. Frozen here: the draws must not change."""
    seq = rng.integers(0, 4, size=glen).astype(np.uint8)
    budget = int(glen * repeat_frac)
    alu = rng.integers(0, 4, size=300).astype(np.uint8)
    for _ in range(max(1, budget // 2 // 300)):
        p = int(rng.integers(0, glen - 300))
        u = alu.copy()
        d = rng.random(300) < 0.01
        u[d] = rng.integers(0, 4, int(d.sum()))
        seq[p : p + 300] = u
    line = rng.integers(0, 4, size=6000).astype(np.uint8)
    for _ in range(max(1, budget // 2 // 6000)):
        p = int(rng.integers(0, glen - 6000))
        seq[p : p + 6000] = line
    for _ in range(max(1, glen // 20000)):
        unit = rng.integers(0, 4, size=4).astype(np.uint8)
        reps = int(rng.integers(20, 60))
        p = int(rng.integers(0, glen - 4 * reps))
        seq[p : p + 4 * reps] = np.tile(unit, reps)
    return seq


def gen_family_genome(rng, glen: int, families: list[dict]) -> np.ndarray:
    """Uniform random bases with each family's copies planted: a random
    consensus of f["length"] bases, f["copies"] copies each with
    f["divergence"] of its positions redrawn, half of them reverse
    complemented, one copy in each of as many equal slots of the genome
    (in a random order), so no two copies overlap."""
    seq = rng.integers(0, 4, size=glen).astype(np.uint8)
    units = []
    for f in families:
        cons = rng.integers(0, 4, size=f["length"]).astype(np.uint8)
        for _ in range(f["copies"]):
            u = cons.copy()
            d = rng.random(u.size) < f["divergence"]
            u[d] = rng.integers(0, 4, int(d.sum()))
            units.append((3 - u)[::-1] if rng.random() < 0.5 else u)
    slot = glen // len(units)
    for u, k in zip(units, rng.permutation(len(units))):
        p = int(k) * slot + int(rng.integers(0, slot - u.size))
        seq[p : p + u.size] = u
    return seq


def make_genome(config: dict) -> np.ndarray:
    """The configuration's genome as base codes (N = 4)."""
    rng = np.random.default_rng(config["genome_seed"])
    if "families" in config:
        codes = gen_family_genome(rng, config["genome_bp"], config["families"])
    else:
        codes = gen_repeat_genome(rng, config["genome_bp"], config["repeat_frac"])
    for start, length in config.get("n_runs", []):
        codes[start : start + length] = 4
    return codes


def write_fasta(path: str, name: str, codes: np.ndarray, width: int = 100) -> None:
    text = DECODE[codes]
    full = text.shape[0] // width
    lines = np.empty((full, width + 1), np.uint8)
    lines[:, :width] = text[: full * width].reshape(full, width)
    lines[:, width] = ord("\n")
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        f.write(lines.tobytes())
        if text.shape[0] > full * width:
            f.write(text[full * width :].tobytes() + b"\n")


def _digest(parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p if isinstance(p, bytes) else p.encode())
    return h.hexdigest()[:16]


def genome_key(config: dict) -> str:
    g = {k: config.get(k) for k in ("contig", "genome_bp", "repeat_frac", "families",
                                    "n_runs", "genome_seed")}
    with open(os.path.abspath(__file__), "rb") as f:
        src = f.read()
    return _digest([json.dumps(g, sort_keys=True), src])


def index_sources_key() -> str:
    """A hash of the port's index sources (index/*.py, genome.py)."""
    import snap_tpu_torch

    pkg = os.path.dirname(os.path.abspath(snap_tpu_torch.__file__))
    files = sorted(glob.glob(os.path.join(pkg, "index", "*.py"))) + [
        os.path.join(pkg, "genome.py")
    ]
    parts = []
    for p in files:
        with open(p, "rb") as f:
            parts += [os.path.relpath(p, pkg), f.read()]
    return _digest(parts)


def _publish(tmp: str, final: str) -> None:
    """Move a finished directory into place (a run cut short leaves only
    its .tmp directory, which the next run replaces)."""
    if os.path.isdir(final):
        shutil.rmtree(tmp, ignore_errors=True)
        return
    os.replace(tmp, final)


def prepare_genome(config: dict, cache_dir: str = CACHE_DIR) -> tuple[np.ndarray, str]:
    """(base codes, FASTA path) of the configuration's genome, made on
    the first call in a checkout and loaded after."""
    d = os.path.join(cache_dir, "genome", f"{config['name']}-{genome_key(config)}")
    if not os.path.isdir(d):
        tmp = d + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        codes = make_genome(config)
        np.save(os.path.join(tmp, "codes.npy"), codes)
        write_fasta(os.path.join(tmp, "genome.fa"), config["contig"], codes)
        _publish(tmp, d)
    return np.load(os.path.join(d, "codes.npy")), os.path.join(d, "genome.fa")


def prepare_index(config: dict, fasta: str, device, cache_dir: str = CACHE_DIR) -> tuple[str, float]:
    """(index directory, seconds spent building it here: 0 when cached)."""
    d = os.path.join(
        cache_dir, "index",
        f"{config['name']}-{index_sources_key()}-{genome_key(config)}",
    )
    if os.path.isdir(d):
        return d, 0.0
    from snap_tpu_torch import cli

    tmp = d + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.dirname(tmp), exist_ok=True)
    t0 = time.perf_counter()
    if cli.main(["index", fasta, tmp, *config["index_options"]], device=device) != 0:
        raise RuntimeError(f"index build of {config['name']} failed")
    _publish(tmp, d)
    return d, time.perf_counter() - t0
