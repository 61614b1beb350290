"""Command-line interface.

Counterpart of snap_tpu.cli: the `index`, `single` and `paired`
commands, their option parsing, the apps commands (`tofastq`, `depth`,
`roc`, `daemon`, `command`; see apps.py), and the comma multi-run. Behavioral reference: SNAP's
CLI surface (CommandProcessor.cpp:41-57, AlignerOptions.cpp usage).
SNAP-style manual flag parsing — SNAP uses `-h` for maxHits, so
argparse's default help is not an option.

The device is a keyword of the Python entry point, main(argv,
device=None, devices=None): the CUDA card unless the caller passes
device="cpu". `devices` is the list a run spreads over (default: every
visible card, or every rank's cards in a torch.distributed group; one
device on the CPU): with more than one, or with -ishards, `single` and
`paired` run on a (data x index) mesh of them (parallel/mesh.py), as
snap_tpu's do over jax.devices(). Neither is a command-line flag, so the
@PG CL: field of the SAM header holds the same arguments as snap_tpu's.
After the stats table a `single` or `paired` run prints its aligner's host branches
(the reads or pairs of each path it took) to stderr.
"""

from __future__ import annotations

import os
import sys
import time

from . import resolve_device
from .align.pipeline import AlignParams
from .align.single import SingleEndAligner
from .constants import DEFAULT_SEED_LEN
from .genome import load_fasta
from .index.index import GenomeIndex


def cmd_index(args: list[str], device=None) -> int:
    if len(args) < 2:
        print("usage: snap-tpu index <input.fa> <output-dir> [-s seedLen]",
              file=sys.stderr)
        return 1
    fa, outdir = args[0], args[1]
    seed_len = DEFAULT_SEED_LEN
    alt_names: set[str] = set()
    non_alt_names: set[str] = set()
    auto_alt = True
    max_alt_contig_size = 0
    alt_liftover = None
    padding = None
    histogram_file = None
    name_terminators = ""
    space_terminates = True
    build_budget_gb = None
    i = 2

    def read_name_file(path: str) -> set[str]:
        with open(path) as f:
            return {ln.strip() for ln in f if ln.strip()}

    while i < len(args):
        a = args[i]
        if a == "-s" and i + 1 < len(args):
            seed_len = int(args[i + 1]); i += 2
        elif a == "-p" and i + 1 < len(args):
            padding = int(args[i + 1]); i += 2
        elif a == "-altContigName" and i + 1 < len(args):
            alt_names.add(args[i + 1]); i += 2
        elif a == "-altContigFile" and i + 1 < len(args):
            alt_names |= read_name_file(args[i + 1]); i += 2
        elif a == "-nonAltContigName" and i + 1 < len(args):
            non_alt_names.add(args[i + 1]); i += 2
        elif a == "-nonAltContigFile" and i + 1 < len(args):
            non_alt_names |= read_name_file(args[i + 1]); i += 2
        elif a == "-maxAltContigSize" and i + 1 < len(args):
            max_alt_contig_size = int(args[i + 1]); i += 2
        elif a == "-AutoAlt-":
            auto_alt = False; i += 1
        elif a == "-altLiftoverFile" and i + 1 < len(args):
            from .genome import parse_alt_file

            alt_liftover = parse_alt_file(args[i + 1]); i += 2
        elif a == "-H" and i + 1 < len(args):
            histogram_file = args[i + 1]; i += 2
        elif a == "-sm" and i + 1 < len(args):
            # small-memory build: external partitioned sort bounded by
            # this many GB (GenomeIndex.cpp:630-753 -sm spill mode)
            build_budget_gb = float(args[i + 1]); i += 2
        elif a == "-t":
            # build threads: the builder is a handful of vectorized
            # numpy passes, not a per-seed loop
            i += 2
        elif a in ("-keysize", "-locationSize", "-h"):
            # reference on-disk knobs; our packed layout derives these
            # from the seed length automatically (see index/build.py)
            i += 2
        elif a == "-bSpace":
            space_terminates = True; i += 1
        elif a == "-bSpace-":
            space_terminates = False; i += 1
        elif a.startswith("-B") and len(a) > 2:
            name_terminators = a[2:]; i += 1
        elif a in ("-exact", "-large", "-hc", "-hc-", "-q", "-qq"):
            i += 1
        else:
            print(f"ignoring unknown index option {a}", file=sys.stderr)
            i += 1
    t0 = time.time()
    print(f"Loading FASTA {fa}...", file=sys.stderr)
    from .constants import DEFAULT_CONTIG_PADDING

    genome = load_fasta(
        fa,
        chromosome_padding=(
            padding if padding is not None else DEFAULT_CONTIG_PADDING
        ),
        alt_names=alt_names or None,
        non_alt_names=non_alt_names or None,
        auto_alt=auto_alt,
        max_alt_contig_size=max_alt_contig_size,
        alt_liftover=alt_liftover,
        name_terminators=name_terminators,
        space_terminates=space_terminates,
    )
    print(f"Building index (seed {seed_len})...", file=sys.stderr)
    if build_budget_gb is not None:
        # -sm: stream the build under the memory budget, saving arrays
        # straight from the memmaps without device placement
        from .errors import write_status
        from .index.build import build_index_chunked, save_index

        arrays = build_index_chunked(
            genome, seed_len, memory_budget_gb=build_budget_gb,
            status=lambda s: write_status(s),
        )
        save_index(arrays, genome, outdir)
        import shutil as _shutil

        tmpd = arrays.get("_tmpdir")
        if tmpd:
            _shutil.rmtree(tmpd, ignore_errors=True)
        n = genome.num_bases
        dt = time.time() - t0
        print(
            f"Index build and save took {dt:.0f}s "
            f"({n / max(dt, 1e-9):,.0f} bases/s)",
            file=sys.stderr,
        )
        return 0
    idx = GenomeIndex.build(genome, seed_len, device=device)
    idx.save(outdir)
    if histogram_file:
        # -H: seed-popularity histogram (GenomeIndex.cpp:55-107 -H):
        # lines of "<nHits> <count of seeds with that many hits>"
        import numpy as _np

        packed = idx._host_arrays["table"][..., 3].reshape(-1)
        n0 = (packed & 0xFFFF).astype(_np.int64)
        n1 = (packed >> 16).astype(_np.int64)
        counts = _np.concatenate([n0[n0 > 0], n1[n1 > 0]])
        vals, freq = _np.unique(counts, return_counts=True)
        with open(histogram_file, "w") as hf:
            for v, c in zip(vals.tolist(), freq.tolist()):
                hf.write(f"{v}\t{c}\n")
    n = genome.num_bases
    dt = time.time() - t0
    print(
        f"Index build and save took {dt:.0f}s ({n / max(dt, 1e-9):,.0f} bases/s)",
        file=sys.stderr,
    )
    return 0


# Loaded indexes cached across runs in one process: the multi-run
# equivalent of g_index (AlignerContext.cpp:56-59,254-288).
_INDEX_CACHE: dict[tuple[str, str], GenomeIndex] = {}


def _load_index_cached(index_dir: str, device=None) -> GenomeIndex:
    key = (os.path.abspath(index_dir), str(resolve_device(device)))
    idx = _INDEX_CACHE.get(key)
    if idx is None:
        print(f"Loading index from directory... {index_dir}", file=sys.stderr)
        idx = GenomeIndex.load(index_dir, device=device)
        _INDEX_CACHE.clear()  # keep at most one index resident (like SNAP)
        _INDEX_CACHE[key] = idx
    else:
        print(f"Index {index_dir} already loaded", file=sys.stderr)
    return idx


def _maybe_mesh(opts: dict, device=None, devices=None):
    """Multi-device routing: when more than one device is given (or
    -ishards asks for index sharding), build the (data x index) mesh.
    Under a launcher's environment (MASTER_ADDR, RANK, WORLD_SIZE) the
    torch.distributed group is initialised once first: nccl on CUDA,
    gloo on the CPU. Returns (mesh | None, n_index) by snap_tpu's rules:
    one device and no -ishards is no mesh, -ishards that does not divide
    the device count falls back to one index shard (so -ishards 2 on one
    device is a 1 x 1 mesh), and -b rounds up to a multiple of n_data."""
    import torch.distributed as dist

    from .parallel.mesh import default_devices, make_mesh

    dev = resolve_device(device)
    if (
        all(os.environ.get(k) for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE"))
        and not dist.is_initialized()
    ):
        dist.init_process_group(backend="nccl" if dev.type == "cuda" else "gloo")
    ranks = None
    if devices is None:
        devices, ranks = default_devices(dev)
    n_devices = len(devices)
    n_index = max(1, opts.get("ishards", 1))
    if n_devices == 1 and n_index == 1:
        return None, 1
    if n_devices % n_index != 0:
        n_index = 1
    n_data = n_devices // n_index
    mesh = make_mesh(n_data, n_index, devices, ranks)
    # device batches split evenly over the data axis
    if opts["batch_size"] % n_data:
        opts["batch_size"] = ((opts["batch_size"] // n_data) + 1) * n_data
    return mesh, n_index


def cmd_single(args: list[str], device=None, devices=None) -> int:
    if len(args) < 2:
        print(
            "usage: snap-tpu single <index-dir> <input.fq> [-o out.sam] "
            "[-d maxDist] [-n numSeeds] [-h maxHits] [-mrl minReadLen] "
            "[-b batchSize] [-rl maxReadLen]",
            file=sys.stderr,
        )
        return 1
    index_dir = args[0]
    # multiple input files round-robin through one run
    # (MultiInputReadSupplier, MultiInputReadSupplier.h:28-83); '-' is stdin
    inputs = []
    i = 1
    while i < len(args) and (args[i] == "-" or not args[i].startswith("-")):
        inputs.append(args[i])
        i += 1
    if not inputs:
        print("single: no input files", file=sys.stderr)
        return 1
    opts = _parse_align_options(args[i:], batch_size=1024)
    from .errors import configure as _configure_errors

    _configure_errors(opts["quiet"], opts["very_quiet"], opts["hdp"])
    index = _load_index_cached(index_dir, device)
    if opts["seed_coverage"] > 0 and "num_seeds" not in opts["overrides"]:
        # -sc: seeds from coverage = readLen * coverage / seedLen
        # (BaseAligner.cpp:2389)
        opts["overrides"]["num_seeds"] = max(
            1, int(opts["max_read_len"] * opts["seed_coverage"]
                   / index.seed_len)
        )
    mesh, n_index = _maybe_mesh(opts, device, devices)
    if mesh is not None:
        index.to_mesh(mesh, n_index)
    params = AlignParams(
        seed_len=index.seed_len,
        max_probe=index.max_probe,
        **opts["overrides"],
    )
    aligner = SingleEndAligner(
        index, params, batch_size=opts["batch_size"],
        max_read_len=opts["max_read_len"], min_read_length=opts["mrl"],
        alt_awareness=opts["alt_awareness"], emit_alt=opts["emit_alt"],
        max_score_gap_to_prefer_non_alt=opts["asg"],
        use_m=opts["use_m"], filter_flags=opts["filter_flags"],
        stop_on_first_hit=opts["stop_on_first"],
        max_secondary_edit=opts["om"], max_secondary=opts["omax"],
        max_secondary_per_contig=opts["mpc"],
        clip_front=opts["clip_front"],
        max_dist_fraction=opts["dp"],
        internal_score_tag=opts["is_tag"],
        read_secondary=opts["read_secondary"],
        attach_times=opts["at"],
        kill_if_too_slow=opts["kts"],
        force_kind=opts["force_kind"],
        force_gzip=opts["force_gzip"],
        mesh=mesh,
        threads=opts["threads"],
        adaptive=opts["adaptive"],
    )

    def run_all(writer):
        stats = None
        for path in inputs:
            stats = aligner.align_file(path, writer)
        return stats

    return _run_with_writer(
        index, "single " + " ".join(args), opts, run_all, aligner,
    )


def cmd_paired(args: list[str], device=None, devices=None) -> int:
    if len(args) < 2:
        print(
            "usage: snap-tpu paired <index-dir> <in1.fq> [in2.fq] [-o out.sam]"
            " [-s min max] [-d maxDist] [-n numSeeds] [-b batchSize]",
            file=sys.stderr,
        )
        return 1
    index_dir, fq1 = args[0], args[1]
    fq2 = None
    i = 2
    if i < len(args) and not args[i].startswith("-"):
        fq2 = args[i]
        i += 1
    opts = _parse_align_options(args[i:])
    # -t is parsed and, as in snap_tpu, only `single` uses it
    from .errors import configure as _configure_errors

    _configure_errors(opts["quiet"], opts["very_quiet"], opts["hdp"])

    from .align.paired_driver import PairedEndAligner
    from .constants import DEFAULT_NUM_SEEDS_PAIRED

    index = _load_index_cached(index_dir, device)
    # -n default differs by command: 25 single / 8 paired
    # (AlignerOptions.cpp:107-117 defaults block)
    opts["overrides"].setdefault("num_seeds", DEFAULT_NUM_SEEDS_PAIRED)
    mesh, n_index = _maybe_mesh(opts, device, devices)
    if mesh is not None:
        index.to_mesh(mesh, n_index)
    params = AlignParams(
        seed_len=index.seed_len,
        max_probe=index.max_probe,
        **opts["overrides"],
    )
    aligner = PairedEndAligner(
        index, params, batch_size=opts["batch_size"],
        max_read_len=opts["max_read_len"], min_read_length=opts["mrl"],
        min_spacing=opts["min_sp"], max_spacing=opts["max_sp"],
        alt_awareness=opts["alt_awareness"], emit_alt=opts["emit_alt"],
        max_score_gap_to_prefer_non_alt=opts["asg"],
        use_m=opts["use_m"], filter_flags=opts["filter_flags"],
        ignore_mismatched_ids=opts["ignore_ids"],
        force_spacing=opts["force_spacing"],
        infer_spacing=opts["infer_spacing"],
        internal_score_tag=opts["is_tag"],
        min_score_realignment=opts["en"],
        min_ag_improvement=opts["eg"],
        flatten_mapq_at_or_below=opts["fmb"],
        read_secondary=opts["read_secondary"],
        max_secondary_edit=opts["om"], max_secondary=opts["omax"],
        max_secondary_per_contig=opts["mpc"],
        enable_hamming=opts["eh"],
        keep_unpaired=opts["ku"],
        attach_times=opts["at"],
        force_kind=opts["force_kind"],
        force_gzip=opts["force_gzip"],
        force_interleaved=opts["interleaved"],
        mesh=mesh,
    )
    return _run_with_writer(
        index, "paired " + " ".join(args), opts,
        lambda writer: aligner.align_files(fq1, fq2, writer), aligner,
    )


def _parse_align_options(rest: list[str], batch_size: int = 512) -> dict:
    """Shared single/paired option parsing (SNAP flag names)."""
    o = {
        "out_path": "-", "overrides": {}, "batch_size": batch_size,
        "threads": 1,
        "max_read_len": 128, "mrl": 50, "sort": False,
        "no_dup": False, "no_index": False, "min_sp": 0, "max_sp": 1000,
        "force_sam": False, "force_bam": False,
        "alt_awareness": True, "emit_alt": False, "asg": 64,
        "use_m": True, "filter_flags": 0, "stop_on_first": False,
        "om": -1, "omax": 0x7FFFFFFF, "mpc": -1, "ignore_ids": False,
        "profile": False, "profile_ag": False, "trace_dir": None,
        "perf_file": None, "read_group": None,
        "force_spacing": False, "infer_spacing": False, "pfc": False,
        "seed_coverage": 0.0, "dp": 0.0, "clip_front": False,
        "clip_back": True, "sort_memory_mb": None, "sort_tmp_dir": None,
        "is_tag": None, "fmb": 3, "en": 3, "eg": 24,
        "read_secondary": False, "at": False, "sam_no_sq": False,
        "eh": True, "ishards": 1, "ku": False, "adaptive": True,
        "quiet": False, "very_quiet": False, "hdp": False, "kts": False,
        "force_kind": None, "force_gzip": False, "interleaved": False,
    }
    # Performance knobs whose concerns don't exist in this design
    # (mmap/prefetch/huge pages/processor binding/write buffers are
    # handled by numpy-mmap, XLA, and the async output path):
    # Knobs whose concerns don't exist in this design (mmap/prefetch/
    # huge pages/processor binding/write buffers are handled by
    # numpy-mmap, XLA, and the async output path). Of the -nX
    # disable-optimization flags (AlignerOptions.h:78-88), -nu
    # (noUkkonen) and -nt (noTruncation) are REAL knobs — the wavefront
    # replays both optimizations — parsed below; the remaining ones
    # (-no ordered evaluation, -ne, -nb banded AG, -ni) name sequential
    # strategies the batched design doesn't perform, so results already
    # match their disabled behavior. -eh toggles Hamming scoring in the
    # single-end fallback; -es is the ALT realignment score gap; -N the
    # fallback seed count — the batched chimeric fallback reuses the
    # pair wavefront's candidates, so these have no separate knob.
    noop_flags = {"-map", "-map-", "-pre", "-pre-", "-hp", "-b-", "-P",
                  "-di", "-lp", "-no", "-ne",
                  "-nb", "-ni", "-B", "-ins-"}
    noop_with_arg = {"-wbs", "-mcp", "-xf", "-es", "-N"}
    i = 0
    while i < len(rest):
        a = rest[i]
        if a == "-o":
            o["out_path"] = rest[i + 1]; i += 2
        elif a == "-so":
            o["sort"] = True; i += 1
        elif a == "-S" and i + 1 < len(rest):
            for ch in rest[i + 1]:
                if ch == "d":
                    o["no_dup"] = True
                elif ch == "i":
                    o["no_index"] = True
            i += 2
        elif a == "-sam":
            o["force_sam"] = True; i += 1
        elif a == "-bam":
            o["force_bam"] = True; i += 1
        elif a == "-s" and i + 2 < len(rest):
            o["min_sp"], o["max_sp"] = int(rest[i + 1]), int(rest[i + 2])
            i += 3
        elif a == "-d":
            o["overrides"]["max_k"] = int(rest[i + 1]); i += 2
        elif a == "-n":
            o["overrides"]["num_seeds"] = int(rest[i + 1]); i += 2
        elif a == "-h":
            o["overrides"]["max_hits"] = int(rest[i + 1]); i += 2
        elif a == "-mrl":
            o["mrl"] = int(rest[i + 1]); i += 2
        elif a == "-b":
            o["batch_size"] = int(rest[i + 1]); i += 2
        elif a == "-rl":
            o["max_read_len"] = int(rest[i + 1]); i += 2
        elif a == "-fs":
            o["force_spacing"] = True; i += 1
        elif a == "-ins":
            o["infer_spacing"] = True; i += 1
        elif a == "-ku":
            # keep reads without RNEXT/PNEXT in the pair matcher
            # instead of quickly dropping them
            # (quicklyDropUnpairedReads, PairedAligner.cpp:311-313)
            o["ku"] = True; i += 1
        elif a == "-pfc":
            o["pfc"] = True; i += 1
        elif a == "-rg":
            # read-group name, keeping the default @RG attributes
            # (AlignerOptions defaultReadGroup)
            from .io.sam import ReadGroup

            rg = o["read_group"] or ReadGroup()
            o["read_group"] = ReadGroup(rg_id=rest[i + 1], attrs=rg.attrs)
            i += 2
        elif a == "-R":
            # full @RG header line, '\t' escapes or literal tabs
            # (AlignerOptions rgLineContents)
            from .io.sam import ReadGroup

            line = rest[i + 1].replace("\\t", "\t")
            fields = line.split("\t")
            if not fields or fields[0] != "@RG":
                print("-R line must start with @RG", file=sys.stderr)
            else:
                rg_id = "FASTQ"
                attrs = []
                for fld in fields[1:]:
                    k, _, v = fld.partition(":")
                    if k == "ID":
                        rg_id = v
                    else:
                        attrs.append((k, v))
                o["read_group"] = ReadGroup(rg_id=rg_id, attrs=tuple(attrs))
            i += 2
        elif a == "-is":
            o["is_tag"] = rest[i + 1]; i += 2
        elif a == "-sm":
            # sort memory budget in GB (AlignerOptions.h:119): beyond it
            # sorted blocks spill to temp files and merge at close
            o["sort_memory_mb"] = int(float(rest[i + 1]) * 1024); i += 2
        elif a == "-sid":
            o["sort_tmp_dir"] = rest[i + 1]; i += 2
        elif a == "-pro":
            o["profile"] = True; i += 1
        elif a == "-proAg":
            # affine-gap usage ratios in the stats table
            # (AlignerContext.cpp:547-549)
            o["profile_ag"] = True; i += 1
        elif a == "-trace":
            # device-profiler trace of the align loop (TPU analogue of
            # the reference's TIME_HISTOGRAM/-pro instrumentation)
            o["trace_dir"] = rest[i + 1]; i += 2
        elif a == "-pf":
            o["perf_file"] = rest[i + 1]; i += 2
        elif a == "-om":
            o["om"] = int(rest[i + 1]); i += 2
        elif a == "-omax":
            o["omax"] = int(rest[i + 1]); i += 2
        elif a == "-mpc":
            o["mpc"] = int(rest[i + 1]); i += 2
        elif a == "-f":
            o["stop_on_first"] = True; i += 1
        elif a == "-I":
            o["ignore_ids"] = True; i += 1
        elif a == "-=":
            o["use_m"] = False; i += 1
        elif a == "-M":
            o["use_m"] = True; i += 1
        elif a == "-x":
            o["overrides"]["explore_popular"] = True; i += 1
        elif a == "-nu":
            # DisabledOptimizations.noUkkonen (AlignerOptions.h:78-88):
            # score every rep regardless of the running score limit
            o["overrides"]["use_ukkonen"] = False; i += 1
        elif a == "-nt":
            # .noTruncation: disable the seed-loop early stop (our
            # adaptive two-phase wavefront) — full-depth every read
            o["adaptive"] = False; i += 1
        elif a == "-D":
            o["overrides"]["extra_search_depth"] = int(rest[i + 1]); i += 2
        elif a == "-F" and i + 1 < len(rest):
            from .options import FILTER_PRESETS

            sel = rest[i + 1]
            if sel in FILTER_PRESETS:
                o["filter_flags"] |= FILTER_PRESETS[sel]
            elif sel == "b":  # paired: both mates must match
                from .options import FILTER_BOTH_MATES_MATCH

                o["filter_flags"] |= FILTER_BOTH_MATES_MATCH
            else:
                print(f"Unknown option type after -F: {sel}", file=sys.stderr)
            i += 2
        elif a == "-E" and i + 1 < len(rest):
            from .options import FILTER_CHARS

            for ch in rest[i + 1]:
                if ch in FILTER_CHARS:
                    o["filter_flags"] |= FILTER_CHARS[ch]
                else:
                    print(
                        f"Unrecognized filter type after -E '{ch}'",
                        file=sys.stderr,
                    )
            i += 2
        elif a == "-A-":
            o["alt_awareness"] = False; i += 1
        elif a == "-ea":
            o["emit_alt"] = True; i += 1
        elif a == "-asg":
            o["asg"] = int(rest[i + 1]); i += 2
        elif a == "-t":
            # -t N: input parser threads (RangeSplitter analogue);
            # ALIGNMENT parallelism is the device mesh
            o["threads"] = max(1, int(rest[i + 1])); i += 2
        elif a == "-sc":
            o["seed_coverage"] = float(rest[i + 1]); i += 2
        elif a == "-dp":
            o["dp"] = float(rest[i + 1]); i += 2
        elif a == "-i":
            o["overrides"]["max_k_indels"] = int(rest[i + 1]); i += 2
        elif a == "-G-":
            o["overrides"]["use_affine_gap"] = False; i += 1
        elif a == "-gm":
            o["overrides"]["ag_match"] = int(rest[i + 1]); i += 2
        elif a == "-gs":
            o["overrides"]["ag_sub"] = int(rest[i + 1]); i += 2
        elif a == "-go":
            o["overrides"]["ag_open"] = int(rest[i + 1]); i += 2
        elif a == "-ge":
            o["overrides"]["ag_extend"] = int(rest[i + 1]); i += 2
        elif a == "-g5":
            o["overrides"]["ag_b5"] = int(rest[i + 1]); i += 2
        elif a == "-g3":
            o["overrides"]["ag_b3"] = int(rest[i + 1]); i += 2
        elif a == "-ms":
            o["overrides"]["min_weight"] = int(rest[i + 1]); i += 2
        elif a == "-fmb":
            o["fmb"] = int(rest[i + 1]); i += 2
        elif a == "-en":
            o["en"] = int(rest[i + 1]); i += 2
        elif a == "-eg":
            o["eg"] = int(rest[i + 1]); i += 2
        elif a == "-sa":
            o["read_secondary"] = True; i += 1
        elif a == "-ishards":
            o["ishards"] = int(rest[i + 1]); i += 2
        elif a == "-eh":
            o["eh"] = True; i += 1
        elif a == "-eh-":
            o["eh"] = False; i += 1
        elif a == "-at":
            o["at"] = True; i += 1
        elif a == "-samNoSQ":
            o["sam_no_sq"] = True; i += 1
        elif a == "-q":
            o["quiet"] = True; i += 1
        elif a == "-qq":
            o["very_quiet"] = True; i += 1
        elif a == "-hdp":
            o["hdp"] = True; i += 1
        elif a == "-kts":
            o["kts"] = True; i += 1
        elif a == "-fastq":
            o["force_kind"] = "fastq"; i += 1
        elif a == "-compressedFastq":
            o["force_kind"] = "fastq"; o["force_gzip"] = True; i += 1
        elif a == "-pairedFastq":
            o["force_kind"] = "fastq"; i += 1
        elif a == "-pairedInterleavedFastq":
            o["force_kind"] = "fastq"; o["interleaved"] = True; i += 1
        elif a == "-pairedCompressedInterleavedFastq":
            o["force_kind"] = "fastq"; o["force_gzip"] = True
            o["interleaved"] = True; i += 1
        elif a.startswith("-C") and len(a) == 4 and set(a[2:]) <= {"+", "-"}:
            # -C<front><back> with '+' = clip low-quality bases from that
            # end, '-' = don't; default back only, -C-+
            # (AlignerOptions.cpp:988-1010)
            o["clip_front"] = a[2] == "+"
            o["clip_back"] = a[3] == "+"
            o["overrides"]["clip_back"] = a[3] == "+"
            i += 1
        elif a in noop_flags:
            i += 1
        elif a in noop_with_arg:
            i += 2
        else:
            print(f"ignoring unknown option {a}", file=sys.stderr)
            i += 1
    return o


def _run_with_writer(index, command_line: str, opts: dict, run, aligner) -> int:
    from .io.output import OutputWriter

    out_path = opts["out_path"]
    bam = opts["force_bam"] or (
        out_path.endswith(".bam") and not opts["force_sam"]
    )
    if out_path == "-":
        out = sys.stdout.buffer
    else:
        # double-buffered async writes so record emission overlaps disk
        # latency (the BufferedAsyncWriter analogue, BufferedAsync.h:40-66)
        from .io.bufferedasync import BufferedAsyncWriter

        out = BufferedAsyncWriter(open(out_path, "wb"))
    try:
        writer = OutputWriter(
            out=out,
            genome=index.genome_meta,
            command_line=command_line,
            read_group=opts["read_group"],
            preserve_fastq_comments=opts["pfc"],
            sort_memory_mb=opts["sort_memory_mb"],
            sort_tmp_dir=opts["sort_tmp_dir"],
            bam=bam,
            sam_no_sq=opts["sam_no_sq"],
            sort=opts["sort"],
            mark_duplicates=(opts["sort"] and not opts["no_dup"]),
            build_bai=(bam and opts["sort"] and not opts["no_index"]),
            bai_path=(out_path + ".bai") if out_path != "-" else None,
        )
        print("Aligning.", file=sys.stderr)
        trace_dir = opts.get("trace_dir")
        prof = None
        if trace_dir:
            # -trace: a torch.profiler trace of the align loop (host ops
            # and, on the card, its kernels), written as a Chrome trace
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if index.torch_device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
        try:
            stats = run(writer)
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
                os.makedirs(trace_dir, exist_ok=True)
                path = os.path.join(trace_dir, "trace.json")
                prof.export_chrome_trace(path)
                print(f"Wrote device trace to {path}", file=sys.stderr)
        writer.close()
        from .stats import reduce_across_hosts

        reduce_across_hosts(stats)
        stats.profile = opts["profile"]
        stats.profile_ag = opts["profile_ag"]
        stats.print_table()
        print("Host branches: " + ", ".join(
            f"{k}={v}" for k, v in sorted(aligner.branches.items())
        ), file=sys.stderr)
        if opts["perf_file"]:
            from .constants import DEFAULT_MAX_DIST, DEFAULT_MAX_HITS

            stats.write_perf_file(
                opts["perf_file"],
                opts["overrides"].get("max_hits", DEFAULT_MAX_HITS),
                opts["overrides"].get("max_k", DEFAULT_MAX_DIST),
            )
    finally:
        if out_path != "-":
            out.close()
            out.out.close()
    return 0


def run_one_command(argv: list[str], device=None, devices=None) -> int:
    """Dispatch one top-level command (also the daemon's entry point) on
    `device` (the card by default), spreading `single` and `paired` over
    `devices` (see _maybe_mesh)."""
    if not argv:
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "index":
        return cmd_index(rest, device)
    if cmd == "single":
        return cmd_single(rest, device, devices)
    if cmd == "paired":
        return cmd_paired(rest, device, devices)
    from . import apps

    if cmd == "tofastq":
        return apps.cmd_tofastq(rest)
    if cmd == "depth":
        return apps.cmd_depth(rest, device)
    if cmd == "roc":
        return apps.cmd_roc(rest)
    if cmd == "daemon":
        return apps.cmd_daemon(rest, device, devices)
    if cmd == "command":
        return apps.cmd_command(rest)
    print(f"unknown command {cmd}", file=sys.stderr)
    return 1


def main(argv: list[str] | None = None, device=None, devices=None) -> int:
    """Run the command line `argv` on `device`: the CUDA card unless the
    caller passes device="cpu" (raises when CUDA is asked for but
    absent). `devices` lists the devices `single` and `paired` spread
    over (default: every visible card; one device on the CPU)."""
    argv = argv if argv is not None else sys.argv[1:]
    device = resolve_device(device)
    print("Welcome to snap-tpu (PyTorch port), a SNAP-capability aligner.",
          file=sys.stderr)
    if not argv:
        print(
            "usage: snap-tpu {index,single,paired,tofastq,roc,daemon,"
            "command} ... [ , <next command> ...]",
            file=sys.stderr,
        )
        return 1
    # comma-separated multi-run syntax (CommandProcessor.cpp:69-85): the
    # loaded index stays cached between runs.
    runs: list[list[str]] = [[]]
    for a in argv:
        if a == ",":
            runs.append([])
        else:
            runs[-1].append(a)
    code = 0
    for run in runs:
        if not run:
            continue
        code = run_one_command(run, device, devices)
        if code != 0:
            return code
    return code


if __name__ == "__main__":
    sys.exit(main())
