#!/usr/bin/env python3
"""The kernel launches of chip_smoke's phase-C step and of the first
-rl 256, -rl 400 and 1500 bp batches on the card: recorded once, then
timed per kernel function and against variant builds of the kernel
sources.

    python3 tools/long_launches.py --save .archive/launches     # record, then time
    python3 tools/long_launches.py --load .archive/launches     # time saved launches
    python3 tools/long_launches.py --load DIR --variants block gapless  # and the variants
    python3 tools/long_launches.py --load DIR --baseline .archive/parent
    python3 tools/long_launches.py --load DIR --runs rl256 --kernels affine_extend

Recording builds chip_smoke's genome (25%-repeat, chr21's length, seed
1) and indexes it with the port's `index`, runs the e2e phase's
16384-read phase-C step (align_winners_device, L = 128), draws
chip_smoke's long reads (the same generator, in the same order), and
runs `single` on the first 1024 reads at -rl 256 and at -rl 400 and on
its 256 reads of 1500 bp (chip_smoke's options, -b 64), with the inputs
of every gapless, DP and affine launch of the first batch kept
(chip_smoke's recorded_run); --save writes them as compressed numpy
archives. Timing: for each saved launch, the kernel against its plain
version (bit for bit), its device time (chip_smoke's device_ms:
CUDA-graph replays between CUDA events), the device time of each kernel
function inside the launch (torch.profiler, summed over REPS launches),
the launch's bound; with --baseline, the gapless.cu, dp.cu and
affine.cu found in that directory (an earlier commit's, with the same C
interface), and with --variants, each variant library (the package's
source, or the baseline's, with the text substitutions of VARIANTS
applied, built beside it), checked against the plain versions and
timed on the same launches in turns. Prints one JSON line per kernel
and run (sums over the batch's launches) and the ptxas figures of every
kernel function built. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

RUNS = ("step", "rl256", "rl400", "rl1500")  # chip_smoke's e2e step, LONG_RUNS, 1500 bp
KERNELS = ("gapless_prescreen", "fitting_edit_distance", "affine_extend")
LIBS = ("gapless", "dp", "affine")
REPS = 20
# the block kernel's choice of columns a thread below kMidC (csrc/affine.cu)
AG_ROW_DISPATCH = "".join(f"    SNAP_AG_ROW({c})\n" for c in range(2, 8))
# name -> (kernel library, source, [(text, replacement)]): sources made
# from the package's csrc/<library>.cu ("csrc") or the --baseline
# directory's ("baseline"), each substitution required to match once.
# "mid": the DP's mid-width launches all on one warp a row or all on 128
# threads a row, its one-warp route at 1 and 4 rows a warp and with the
# rows taken in one pass (not longest first), and its few-rows route at
# 256 threads of 2 columns; the affine block rows at 128 threads of up to
# 4 columns (4 and 5 blocks per SM), at 8 columns a thread whatever
# their width, at 4 blocks per SM, without the short passes'
# programmatic dependent launch, and the affine launch with its block
# rows only and with its short passes only.
# "block": the affine's threshold for the block kernel (rows of more
# than kBlockCols columns) at 96 and 160, its mid rows in one class (no
# longest-first split), and the pass instances inlined into the pass
# kernel (as before: they spill), also at 14 resident warps per SM.
# "gapless": the split kernel filling the card at half and twice the
# pairs (kFillPairs), at 4 and 8 windows a thread a chunk, staging 4 and
# 8 words a thread at a time, at 24 and 32 resident warps an SM by launch
# bound, at most 8 threads a pair, a thread's windows strided (g, g + G,
# ...) instead of a run, the shared word packed twice, with 4-byte logq
# loads only, adding +0.0 for the clear bits, and the one-thread kernel
# up to 512 positions (-rl 256, -rl 400).
# "split": the same two for the affine launch of the one-warp xl passes
# (csrc/affine.cu before the mid-width block kernel, given as the
# baseline), the plan kernel in both.
VARIANTS = {
    "mid": {
        "dp_all_warp": ("dp", "csrc", [
            ("constexpr int kFewRowsPerSM = 4;", "constexpr int kFewRowsPerSM = 0;"),
        ]),
        "dp_all_few": ("dp", "csrc", [
            ("constexpr int kFewRowsPerSM = 4;", "constexpr int kFewRowsPerSM = 1 << 20;"),
        ]),
        "dp_one_row_a_warp": ("dp", "csrc", [
            ("constexpr int kMidRowsPerWarp = 2;", "constexpr int kMidRowsPerWarp = 1;"),
        ]),
        "dp_four_rows_a_warp": ("dp", "csrc", [
            ("constexpr int kMidRowsPerWarp = 2;", "constexpr int kMidRowsPerWarp = 4;"),
        ]),
        "dp_one_pass": ("dp", "csrc", [
            ("constexpr int kRowClasses = 4;", "constexpr int kRowClasses = 1;"),
        ]),
        "dp_few256": ("dp", "csrc", [
            ("constexpr int kMidFewThreads = 128;", "constexpr int kMidFewThreads = 256;"),
            ("constexpr int kMidFewC = 4;", "constexpr int kMidFewC = 2;"),
            ("constexpr int kMidFewBlocksPerSM = 6;", "constexpr int kMidFewBlocksPerSM = 4;"),
            ("      SNAP_DP_MID(kMidFewThreads, 3, kMidFewBlocksPerSM)\n", ""),
        ]),
        "affine_p128": ("affine", "csrc", [
            ("constexpr int kMidThreads = 64;", "constexpr int kMidThreads = 128;"),
            ("constexpr int kMidC = 8;", "constexpr int kMidC = 4;"),
            ("constexpr int kMidBlocksPerSM = 6;", "constexpr int kMidBlocksPerSM = 4;"),
        ]),
        "affine_p128_b5": ("affine", "csrc", [
            ("constexpr int kMidThreads = 64;", "constexpr int kMidThreads = 128;"),
            ("constexpr int kMidC = 8;", "constexpr int kMidC = 4;"),
            ("constexpr int kMidBlocksPerSM = 6;", "constexpr int kMidBlocksPerSM = 5;"),
        ]),
        "affine_c8": ("affine", "csrc", [(AG_ROW_DISPATCH, "")]),
        "affine_b4": ("affine", "csrc", [
            ("constexpr int kMidBlocksPerSM = 6;", "constexpr int kMidBlocksPerSM = 4;"),
        ]),
        "affine_no_pdl": ("affine", "csrc", [
            ("  cfg.numAttrs = 1;\n", "  cfg.numAttrs = 0;\n"),
        ]),
        "affine_xl_only": ("affine", "csrc", [
            ("  const cudaError_t err = cudaLaunchKernelEx(&cfg, pass_kernel, a);\n",
             "  const cudaError_t err = cudaSuccess;\n"),
        ]),
        "affine_short_only": ("affine", "csrc", [
            ("  pass_xl_row_kernel<kMidThreads, kMidBlocksPerSM>\n"
             "      <<<(unsigned)min(N, sms * kMidBlocksPerSM), kMidThreads, 0, s>>>(a);\n", ""),
        ]),
    },
    "block": {
        **{f"affine_block{c}": ("affine", "csrc", [
            ("constexpr int kBlockCols = 128;", f"constexpr int kBlockCols = {c};"),
        ]) for c in (96, 160)},
        "affine_one_class": ("affine", "csrc", [
            ("constexpr int kMidSplit = (kBlockCols + kXlCols) / 2;",
             "constexpr int kMidSplit = kXlCols;"),
        ]),
        "affine_pass_inline": ("affine", "csrc", [
            ("__device__ __noinline__ void run_pass(", "__device__ __forceinline__ void run_pass("),
        ]),
        "affine_pass_inline_w14": ("affine", "csrc", [
            ("__device__ __noinline__ void run_pass(", "__device__ __forceinline__ void run_pass("),
            ("constexpr int kPassWarpsPerSM = 16;", "constexpr int kPassWarpsPerSM = 14;"),
        ]),
    },
    "gapless": {
        **{f"gapless_fill{n}k": ("gapless", "csrc", [
            ("constexpr long kFillPairs = 1L << 16;", f"constexpr long kFillPairs = {n}L << 10;"),
        ]) for n in (32, 128)},
        **{f"gapless_win{n}": ("gapless", "csrc", [
            ("constexpr int kWindowsPerThread = 16;", f"constexpr int kWindowsPerThread = {n};"),
        ]) for n in (4, 8)},
        **{f"gapless_stage{n}": ("gapless", "csrc", [
            ("constexpr int kStageLoads = 1;", f"constexpr int kStageLoads = {n};"),
        ]) for n in (4, 8)},
        **{f"gapless_occ{b}": ("gapless", "csrc", [
            ("__launch_bounds__(32 * G) gapless_split_kernel(",
             f"__launch_bounds__(32 * G, {b} / G > 0 ? {b} / G : 1) gapless_split_kernel("),
        ]) for b in (24, 32)},
        "gapless_max8": ("gapless", "csrc", [
            ("constexpr int kMaxSplit = 16;", "constexpr int kMaxSplit = 8;"),
        ]),
        "gapless_strided": ("gapless", "csrc", [
            ("    for (int w = c0 + g * run; w < min(c0 + cn, c0 + (g + 1) * run); ++w) {",
             "    for (int w = c0 + g; w < c0 + cn; w += G) {"),
        ]),
        "gapless_no_keep": ("gapless", "csrc", [
            ("          if (q != kept_q) {", "          if (true) {"),
        ]),
        "gapless_scalar_terms": ("gapless", "csrc", [
            ("            (reinterpret_cast<size_t>(lq + ps) & 15) == 0) {", "            false) {"),
        ]),
        "gapless_add_all": ("gapless", "csrc", [
            ("          if ((wb >> u) & 1u) s = __fadd_rn(s, v[u]);",
             "          s = __fadd_rn(s, (wb >> u) & 1u ? v[u] : 0.0f);"),
        ]),
        "gapless_one_thread512": ("gapless", "csrc", [
            ("constexpr int kOneThreadL = 128;", "constexpr int kOneThreadL = 512;"),
        ]),
    },
}


def record_step(rng, codes: np.ndarray, genome, idx_dir: str, workdir: str) -> dict:
    """kernel -> [(args, kwargs)] of chip_smoke's e2e phase-C step: 16384
    reads of 100 bp drawn as phase_e2e draws them, one
    align_winners_device(adaptive=True, phase_c=True)."""
    import torch

    import chip_smoke as cs
    from snap_tpu_torch.align.pipeline import AlignParams, align_winners_device
    from snap_tpu_torch.index.index import GenomeIndex
    from snap_tpu_torch.io.fastq import read_batches

    contig_start = genome.contigs[0].start
    reads, quals, _, _ = cs.simulate_reads(rng, codes, contig_start, cs.READS, cs.READ_LEN)
    fq = os.path.join(workdir, "reads.fq")
    cs.write_fastq(fq, reads, quals)
    batch = next(read_batches(fq, batch_size=cs.READS, max_len=cs.MAX_LEN))
    idx = GenomeIndex.load(idx_dir, device="cuda")
    dev = torch.device("cuda")
    calls = {name: [] for name in KERNELS}
    with cs.recording(calls):
        align_winners_device(
            idx.device, torch.from_numpy(batch.bases).to(dev),
            torch.from_numpy(batch.quals).to(dev), torch.from_numpy(batch.lengths).to(dev),
            torch.tensor(genome.first_alt_start(), dtype=torch.int64, device=dev),
            AlignParams(seed_len=24, max_probe=idx.max_probe), adaptive=True, phase_c=True)
    return calls


def record(workdir: str, seed: int, glen: int) -> dict:
    """tag -> kernel -> [(args, kwargs)] of the step's and the first
    batch's launches."""
    import chip_smoke as cs
    from snap_tpu_torch.cli import main as cli_main
    from snap_tpu_torch.genome import load_fasta

    rng = np.random.default_rng(seed)  # chip_smoke's phase_e2e
    codes = cs.gen_repeat_genome(rng, glen, 0.25)
    fa = os.path.join(workdir, "ref.fa")
    cs.write_fasta(fa, "chr21sim", codes)
    genome = load_fasta(fa)
    contig_start = genome.contigs[0].start
    idx = os.path.join(workdir, "idx")
    if cli_main(["index", fa, idx, "-s", "24"]) != 0:
        cs.fail("record", "the index command failed")
    out = {"step": record_step(rng, codes, genome, idx, workdir)}
    rng = np.random.default_rng(seed + 3)  # chip_smoke's phase_long
    for read_len, rl, n, _ in (*cs.LONG_RUNS, (cs.XL_LEN, cs.XL_LEN, cs.XL_READS, None)):
        reads, quals, _, _ = cs.simulate_reads(rng, codes, contig_start, n, read_len)
        tag = f"rl{rl}"
        xl = read_len == cs.XL_LEN
        keep = n if xl else 1024
        opts = [*cs.XL_OPTS, "-b", str(cs.XL_BATCH)] if xl else ["-rl", str(rl)]
        fq = os.path.join(workdir, f"{tag}.fq")
        cs.write_fastq(fq, reads[:keep], quals[:keep])
        _, _, first = cs.recorded_run(
            "record", ["single", idx, fq, "-o", os.path.join(workdir, f"{tag}.sam"), *opts], 1)
        out[tag] = {k: first[k] for k in KERNELS}
    return out


def save(calls: dict, directory: str) -> None:
    import torch

    os.makedirs(directory, exist_ok=True)
    for tag, per in calls.items():
        arrays, meta = {}, {}
        for name, launches in per.items():
            meta[name] = []
            for i, (args, kw) in enumerate(launches):
                kinds = []
                for j, a in enumerate(args):
                    if torch.is_tensor(a):
                        arrays[f"{name}_{i}_{j}"] = a.cpu().numpy()
                        kinds.append("tensor")
                    else:
                        kinds.append(a)
                meta[name].append({"args": kinds, "kwargs": kw})
        np.savez_compressed(os.path.join(directory, f"{tag}.npz"), **arrays)
        with open(os.path.join(directory, f"{tag}.json"), "w") as f:
            json.dump(meta, f)


def load(directory: str, device: str = "cuda") -> dict:
    import torch

    out = {}
    for tag in RUNS:
        path = os.path.join(directory, f"{tag}.npz")
        if not os.path.exists(path):
            continue
        arrays = np.load(path)
        with open(os.path.join(directory, f"{tag}.json")) as f:
            meta = json.load(f)
        out[tag] = {
            name: [(tuple(torch.from_numpy(arrays[f"{name}_{i}_{j}"]).to(device)
                          if a == "tensor" else a for j, a in enumerate(m["args"])),
                    m["kwargs"]) for i, m in enumerate(launches)]
            for name, launches in meta.items()
        }
    return out


def build_variants(names: list[str], baseline: str | None) -> dict:
    """Variant name -> (kernel library, library name), sources written to
    the build directory (or found in `baseline`, as <library>_parent)."""
    from snap_tpu_torch.ops import _build

    made = {}
    for lib in LIBS if baseline else ():
        path = os.path.join(baseline, f"{lib}.cu")
        if os.path.exists(path):
            _build.add_source(f"{lib}_parent", path)
            made[f"{lib}_parent"] = (lib, f"{lib}_parent")
    for group in names:
        for vname, (lib, where, subs) in VARIANTS[group].items():
            if where == "baseline" and not baseline:
                raise SystemExit(f"variant {vname} needs --baseline")
            src_dir = _build.CSRC_DIR if where == "csrc" else baseline
            with open(os.path.join(src_dir, f"{lib}.cu")) as f:
                src = f.read()
            for old, new in subs:
                if src.count(old) != 1:
                    raise SystemExit(f"variant {vname}: {old!r} is not in "
                                     f"{src_dir}/{lib}.cu once")
                src = src.replace(old, new)
            os.makedirs(_build.BUILD_DIR, exist_ok=True)
            path = os.path.join(_build.BUILD_DIR, f"{vname}.cu")
            with open(path, "w") as f:
                f.write(src)
            _build.add_source(vname, path)
            made[vname] = (lib, vname)
    return made


def kernel_times(run, reps: int = REPS) -> dict:
    """Device microseconds per call of each kernel function that run()
    launches (torch.profiler over reps calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if us:
            out[e.key] = out.get(e.key, 0.0) + us / reps
    return out


def time_batch(tag: str, per: dict, variants: dict, kernels=KERNELS) -> None:
    import torch

    import chip_smoke as cs

    table = cs.kernel_table()
    for name, launches in per.items():
        if name not in kernels:
            continue
        _, kern, plain, _, launcher = table[name]
        rows = []
        for args, kw in launches:
            run = lambda: kern(*args, **kw)
            got = run()
            ref = plain(*args, **kw)
            torch.cuda.synchronize()
            bad = cs.differing(name, got, ref)
            if bad:
                cs.fail("time", f"{tag} {name}: " + "; ".join(bad))
            mine = [v for v, (lib, _) in variants.items() if lib == launcher.name]

            def with_lib(v):
                def call():
                    with launcher.using(variants[v][1]):
                        return kern(*args, **kw)
                return call

            differs = {v: cs.differing(name, with_lib(v)(), ref) for v in mine}
            torch.cuda.synchronize()
            t = {"kernel": [cs.device_ms(run)]}
            for v in mine:
                t[v] = [cs.device_ms(with_lib(v))]
            for v in reversed(mine):
                t[v].append(cs.device_ms(with_lib(v)))
            t["kernel"].append(cs.device_ms(run))
            nbytes = cs.tensor_bytes(args) + cs.tensor_bytes(got)
            bms, by = cs.bound_ms(nbytes, *cs.work_ops(name, args, got))
            rows.append({
                "shape": cs.shape_of(name, args),
                "plen": np.percentile(args[9 if name == "gapless_prescreen" else 2].cpu().numpy(),
                                      [0, 25, 50, 75, 100]).tolist(),
                "ms": {k: float(np.mean(v)) for k, v in t.items()},
                "functions_us": kernel_times(run),
                "variants_differ": {v: d for v, d in differs.items() if d},
                "bound_ms": bms, "bound_by": by,
            })
        total = {k: sum(r["ms"][k] for r in rows) for k in rows[0]["ms"]} if rows else {}
        funcs = {}
        for r in rows:
            for f, us in r["functions_us"].items():
                funcs[f] = funcs.get(f, 0.0) + us
        bound = sum(r["bound_ms"] for r in rows)
        cs.emit({"tool": "long_launches", "run": tag, "kernel": name,
                 "launches": len(rows), "ms": total,
                 "x_bound": {k: v / bound for k, v in total.items()},
                 "bound_ms": bound, "functions_us": funcs, "per_launch": rows})


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--save", metavar="DIR", help="record the launches and save them here")
    ap.add_argument("--load", metavar="DIR", help="time the launches saved here")
    ap.add_argument("--variants", nargs="*", default=[], choices=sorted(VARIANTS))
    ap.add_argument("--baseline", metavar="DIR",
                    help="also time the gapless.cu, dp.cu and affine.cu found here")
    ap.add_argument("--runs", nargs="*", default=list(RUNS), choices=RUNS,
                    help="time only these batches")
    ap.add_argument("--kernels", nargs="*", default=list(KERNELS), choices=KERNELS,
                    help="time only these kernels")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--genome-len", type=int, default=46_709_983)
    args = ap.parse_args()
    if bool(args.save) == bool(args.load):
        raise SystemExit("give one of --save and --load")

    import torch

    import chip_smoke as cs
    from snap_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        cs.fail("device", "torch.cuda.is_available() is false", 2)
    cs.emit({"tool": "long_launches", "nvidia_smi": cs.nvidia_smi_line(),
             "torch_name": torch.cuda.get_device_name(0)})
    variants = build_variants(args.variants, args.baseline)
    names = (*_build.KERNELS, *variants)
    _build.build_all(names)
    cs.emit({"tool": "long_launches", "ptxas": {
        n: cs.ptxas_functions(_build.BUILD_LOG.get(n, "")) for n in names}})
    if args.save:
        with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke_") as wd:
            calls = record(wd, args.seed, args.genome_len)
        save(calls, args.save)
    else:
        calls = load(args.load)
    for tag, per in calls.items():
        if tag in args.runs:
            time_batch(tag, per, variants, args.kernels)


if __name__ == "__main__":
    main()
