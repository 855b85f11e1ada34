"""Top-level assembler CLI — the spades.py equivalent, on PyTorch.

Mirrors SPAdes' outer orchestration (`src/projects/spades/pipeline/
spades.py:616-725` and `options_parser.py`): library options, assembly
modes, K auto-selection, multi-K iteration with contig feed-forward, `--test`
smoke contract, `--continue` / `--restart-from`, output directory layout
(contigs.fasta, scaffolds.fasta, assembly_graph_with_scaffolds.gfa, per-K
dirs, spades.log, params.txt).  The whole pipeline runs in-process against
the device (`--device`, the CUDA card unless `--device cpu` is given), and
per-K state is checkpointed through the stage manager.

    python -m spades_tpu_torch.pipeline.main -1 r1.fq -2 r2.fq -o out

Every assembly mode runs: isolate, multicell, `--sc`, `--sewage`, `--meta`,
`--plasmid`, `--metaplasmid`, `--metaviral`, `--rna` (with `--ss fr|rf` and
`--fl-rna`), `--rnaviral`, `--bio` and `--corona` (with `--custom-hmms`),
with read error correction (BayesHammer by default, IonHammer under
`--iontorrent`; `--only-assembler` skips it, `--only-error-correction` stops
after it; rna, corona and sewage skip it), with or without repeat resolution,
careful mode (`--careful`, `--mismatch-correction`), long reads (`--pacbio`,
`--nanopore`, `--sanger`), a GFA start (`--assembly-graph`) and
`--series-analysis`, and `--read-cov-threshold` (the reads' median k-mer
coverage on the device, `tools/read_filter.py`).

A multi-process run starts one process per card, each with the same
arguments and its own rank:

    python -m spades_tpu_torch.pipeline.main ... --num-processes N
        --process-id I --coordinator host:port [--dist-backend gloo]

(or the SPADES_NUM_PROCESSES / SPADES_PROCESS_ID / SPADES_COORDINATOR
environment).  Each process joins the group before any device use, runs the
whole assembly on the whole input and holds the same state; the counting,
mapping, prefilter and vote share their reads out across the group
(`parallel/`).  Only rank 0 writes the output directory: the other ranks
write into a private temporary directory, removed at their end.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

from .. import __version__, resolve_device

MODES = ("isolate", "multicell", "meta", "rna", "plasmid", "metaplasmid", "sc", "metaviral", "rnaviral", "corona", "bio", "sewage")


def test_dataset_dir() -> str:
    """SPAdes' bundled E. coli 1K test set (`--test`), in a SPAdes source
    tree at `src/projects/spades/test_dataset`; the tree is
    `SPADES_SOURCE_DIR`, else the working directory."""
    return os.path.join(os.environ.get("SPADES_SOURCE_DIR", ""), "src", "projects", "spades",
                        "test_dataset")

# numbered library options (options_parser.py:198-320: --pe<#>-1 .. --s<#>),
# up to 9 libraries per kind with per-library orientation suffixes
_NUMBERED_RE = None


def _numbered_re():
    global _NUMBERED_RE
    if _NUMBERED_RE is None:
        import re

        _NUMBERED_RE = re.compile(
            r"^--(pe|mp|hqmp)([1-9])-(1|2|12|s|m|fr|rf|ff)$|^--s([1-9])$"
        )
    return _NUMBERED_RE


def extract_numbered_libs(argv: list[str]):
    """Split numbered library options out of argv.

    Returns (remaining_argv, libs) with libs = {(kind, num): {slot: [files],
    "orientation": str}}.  Mirrors SPAdes' per-library option family
    (`--pe1-1 a.fq --pe1-2 b.fq --pe1-fr --mp2-12 c.fq --s3 d.fq ...`)."""
    rx = _numbered_re()
    rest: list[str] = []
    libs: dict = {}
    i = 0
    while i < len(argv):
        m = rx.match(argv[i])
        if not m:
            rest.append(argv[i])
            i += 1
            continue
        if m.group(4):                      # --s<#>
            key = ("single", int(m.group(4)))
            slot = "s"
        else:
            key = (m.group(1), int(m.group(2)))
            slot = m.group(3)
        lib = libs.setdefault(key, {"orientation": ""})
        if slot in ("fr", "rf", "ff"):
            lib["orientation"] = slot
            i += 1
            continue
        if i + 1 >= len(argv):
            raise SystemExit(f"error: {argv[i]} requires a file argument")
        lib.setdefault(slot, []).append(argv[i + 1])
        i += 2
    return rest, libs


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spades_tpu_torch",
        description="de Bruijn graph assembler on PyTorch and CUDA (SPAdes capability surface)",
    )
    inp = p.add_argument_group("input")
    inp.add_argument("-1", dest="pe1", action="append", default=[], help="left paired-end reads")
    inp.add_argument("-2", dest="pe2", action="append", default=[], help="right paired-end reads")
    inp.add_argument("--12", dest="interlaced", action="append", default=[], help="interlaced paired reads")
    inp.add_argument("-s", dest="single", action="append", default=[], help="unpaired reads")
    inp.add_argument("--mp-1", dest="mp1", action="append", default=[], help="left mate-pair reads (RF)")
    inp.add_argument("--mp-2", dest="mp2", action="append", default=[], help="right mate-pair reads (RF)")
    inp.add_argument("--hqmp-1", dest="hqmp1", action="append", default=[], help="left high-quality mate-pair reads")
    inp.add_argument("--hqmp-2", dest="hqmp2", action="append", default=[], help="right high-quality mate-pair reads")
    inp.add_argument("--merged", action="append", default=[], help="merged overlapping paired reads")
    inp.add_argument("--pacbio", action="append", default=[], help="PacBio CLR reads")
    inp.add_argument("--nanopore", action="append", default=[], help="Oxford Nanopore reads")
    inp.add_argument("--sanger", action="append", default=[], help="Sanger reads (treated as accurate long reads)")
    inp.add_argument("--fl-rna", dest="fl_rna", action="append", default=[],
                     help="full-length transcripts (rna mode: trusted transcript paths)")
    inp.add_argument("--trusted-contigs", action="append", default=[], help="trusted contigs")
    inp.add_argument("--untrusted-contigs", action="append", default=[], help="untrusted contigs")
    inp.add_argument("--dataset", help="dataset description in YAML (needs PyYAML)")
    inp.add_argument("--assembly-graph", dest="assembly_graph", default=None,
                     help="start from an existing assembly graph (GFA) instead of constructing one")
    inp.add_argument("--custom-hmms", action="append", default=[], help="profile HMM file(s) for domain-guided modes (bio/corona)")
    inp.add_argument("--iontorrent", action="store_true", help="IonTorrent data: homopolymer-space error correction (ionhammer)")
    inp.add_argument("--test", action="store_true", help="run on SPAdes' bundled E. coli 1K dataset and check the result")

    out = p.add_argument_group("output")
    out.add_argument("-o", dest="output_dir", help="output directory (required unless --test)")

    modes = p.add_argument_group("modes")
    for m in MODES:
        if m != "multicell":          # the default, with no flag of its own
            modes.add_argument(f"--{m}", action="store_true", help=f"{m} mode")
    modes.add_argument("--careful", action="store_true", help="careful mode (mismatch correction)")
    modes.add_argument("--ss", choices=("fr", "rf"), default=None,
                       help="strand-specific RNA protocol orientation (rna mode)")
    modes.add_argument("--series-analysis", default=None, metavar="YAML",
                       help="multi-sample coverage series analysis config (meta mode)")
    modes.add_argument("--only-assembler", action="store_true", help="skip read error correction")
    modes.add_argument("--only-error-correction", action="store_true")

    adv = p.add_argument_group("advanced")
    adv.add_argument("-k", dest="k_list", help="comma-separated odd k values or 'auto'", default="auto")
    adv.add_argument("-t", "--threads", type=int, default=16, help="accepted for parity")
    adv.add_argument("-m", "--memory", type=int, default=250, help="accepted for parity (GB)")
    adv.add_argument("--cov-cutoff", default="off", help="'off', 'auto' or float: (k+1)-mer count cutoff")
    adv.add_argument("--phred-offset", type=int, default=None, help="accepted for parity")
    adv.add_argument("--checkpoints", default="last", choices=("none", "last", "all"))
    adv.add_argument("--continue", dest="cont", action="store_true", help="resume from the last checkpoint")
    adv.add_argument("--profile", action="store_true",
                     help="capture a torch.profiler Chrome trace of the run (output/profile/)")
    adv.add_argument("--restart-from", help="restart from stage id (k<K>:<stage> or 'last')")
    adv.add_argument("--device", default="cuda",
                     help="torch device of the device work: 'cuda' (default; raises without "
                          "a card) or 'cpu'")
    adv.add_argument("--disable-gzip-output", action="store_true")
    adv.add_argument("--time-tracing", action="store_true", help="write a Chrome-trace spades_time_trace.json (TimeTracerRAII analog)")
    adv.add_argument("--grid-engine", default=None, choices=("slurm", "save_yaml"), help="emit a batch-system submission script instead of executor choice")
    adv.add_argument("--grid-queue", default=None, help="batch queue/partition for --grid-engine")
    adv.add_argument("--grid-time", default=None, help="wall-time limit for --grid-engine")
    adv.add_argument("--grid-nnodes", type=int, default=1, help="node count for --grid-engine")
    adv.add_argument("--grid-extra", default=None, help="extra scheduler directives for --grid-engine")
    adv.add_argument("--coordinator", default=None,
                     help="multi-process run: rank 0's address host:port (torch.distributed)")
    adv.add_argument("--num-processes", type=int,
                     default=int(os.environ.get("SPADES_NUM_PROCESSES", "1")),
                     help="multi-process run: total process count, one per card "
                          "(default: SPADES_NUM_PROCESSES, else 1)")
    adv.add_argument("--process-id", type=int, default=None,
                     help="multi-process run: this process's rank")
    adv.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                     help="multi-process run: collective backend (default: nccl on cuda, "
                          "gloo on the cpu; gloo lets several ranks share one card)")
    adv.add_argument("--tmp-dir", default=None, help="directory for temporary files")
    adv.add_argument("--config-file", default=None,
                     help="user config overlay (YAML or section.key value lines) "
                          "applied over the mode defaults — the .info overlay "
                          "surface of SPAdes (config_struct.cpp)")
    adv.add_argument("--disable-rr", action="store_true",
                     help="skip repeat resolution: output simplified graph edges as contigs")
    adv.add_argument("--stop-after", default=None, metavar="CP",
                     help="stop after checkpoint: 'ec', 'as', or 'k<K>'")
    adv.add_argument("--gfa11", action="store_true",
                     help="write assembly_graph_with_scaffolds.gfa as GFA v1.1 (no jump links)")
    adv.add_argument("--save-gp", action="store_true",
                     help="save the full graph pack at every stage (checkpoints=all)")
    adv.add_argument("--mismatch-correction", dest="mismatch_correction", action="store_true",
                     help="run post-assembly mismatch correction (implied by --careful)")
    adv.add_argument("--read-cov-threshold", type=float, default=None, metavar="C",
                     help="drop reads whose median k-mer coverage is below C")
    adv.add_argument("--read-buffer-size", type=int, default=None, help="accepted for parity (reads are streamed in device-sized batches regardless)")
    adv.add_argument("--large-genome", action="store_true", help="accepted for parity")
    adv.add_argument("--configs-dir", default=None, help="accepted for parity (per-mode configs are dataclasses here)")
    adv.add_argument("--debug", action="store_true", help="verbose (DEBUG) logging")
    adv.add_argument("--no-clear-after", action="store_true", help="keep per-K intermediate files (they are kept by default; accepted for parity)")
    adv.add_argument("--only-generate-config", action="store_true",
                     help="write run_spades.yaml/run_spades.sh and exit without assembling")
    adv.add_argument("--hidden-cov-cutoff", dest="hidden_cov_cutoff", default=None, help=argparse.SUPPRESS)
    adv.add_argument("-v", "--version", action="version", version=f"spades_tpu_torch {__version__}")
    return p


def detect_mode(args) -> str:
    for m in ("meta", "rna", "plasmid", "metaplasmid", "sc", "metaviral", "rnaviral", "corona", "bio", "sewage", "isolate"):
        if getattr(args, m, False):
            return m
    return "multicell"


def setup_logging(output_dir: str) -> None:
    os.makedirs(output_dir, exist_ok=True)
    handlers = [
        logging.StreamHandler(),
        logging.FileHandler(os.path.join(output_dir, "spades.log")),
    ]
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
        handlers=handlers,
        force=True,
    )


def _start_profiler(device):
    """torch.profiler over the CPU and, on the card, CUDA activities."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts, record_shapes=False)
    prof.start()
    return prof


def _log_launches(log) -> None:
    """Log how often this run launched each hand kernel (none on the CPU)."""
    from ..ops import cuda_kernels as CK
    from ..ops.coverage_em import coverage_em

    log.info("kernel launches: canonical_windows=%d coverage_em=%d",
             CK.canonical_window_keys.launches, coverage_em.launches)


def main(argv=None) -> int:
    raw_argv = list(argv if argv is not None else sys.argv[1:])
    clean_argv, numbered = extract_numbered_libs(raw_argv)
    args = build_parser().parse_args(clean_argv)

    if args.test:
        args.pe1 = [os.path.join(test_dataset_dir(), "ecoli_1K_1.fq.gz")]
        args.pe2 = [os.path.join(test_dataset_dir(), "ecoli_1K_2.fq.gz")]
        if not args.output_dir:
            args.output_dir = "spades_test"
    if not args.output_dir:
        print("error: the output directory (-o) is required", file=sys.stderr)
        return 64  # InvalidInputFormat family (support.py:39-59)
    if not (args.pe1 or args.single or args.interlaced or args.mp1
            or args.merged or args.dataset or args.assembly_graph or numbered):
        print("error: no input reads specified", file=sys.stderr)
        return 64
    mode = detect_mode(args)
    device = resolve_device(args.device)
    private = _join_run(args, device) if args.num_processes > 1 else None
    try:
        return _assemble(args, argv, raw_argv, numbered, mode, device)
    finally:
        if args.num_processes > 1:
            import shutil

            import torch.distributed as dist

            if private is not None:
                shutil.rmtree(private, ignore_errors=True)
            dist.destroy_process_group()


def _join_run(args, device):
    """Join the process group of a multi-process run before any device use
    (the spades-hpc MPI_Init point, `main_mpi.cpp:73`).  Every rank but 0
    gets a private temporary output directory (holding a copy of the real
    one when it restarts from a checkpoint); returns it, or None on rank 0."""
    import tempfile

    import torch.distributed as dist

    from ..parallel.distributed import init_distributed

    init_distributed(args.coordinator, args.num_processes, args.process_id,
                     backend=args.dist_backend, device=device)
    rank = dist.get_rank()
    if rank == 0:
        return None
    private = tempfile.mkdtemp(prefix=f"spades_rank{rank}_")
    if (args.cont or args.restart_from) and os.path.isdir(args.output_dir):
        import shutil

        shutil.copytree(args.output_dir, private, dirs_exist_ok=True)
    args.output_dir = private
    return private


def _assemble(args, argv, raw_argv, numbered, mode, device) -> int:
    if args.tmp_dir:
        import tempfile

        os.makedirs(args.tmp_dir, exist_ok=True)
        tempfile.tempdir = args.tmp_dir

    setup_logging(args.output_dir)
    log = logging.getLogger("spades_tpu_torch")
    if args.debug:
        logging.getLogger().setLevel(logging.DEBUG)
    from ..utils import timetracer

    if args.time_tracing or args.profile:
        timetracer.enable(profile=args.profile)
    prof = _start_profiler(device) if args.profile else None
    # the trace files are written on every exit path, early returns and
    # errors included
    try:
        with timetracer.span("spades"):
            return _run_job(args, argv, raw_argv, numbered, mode, device, log)
    finally:
        if args.time_tracing:
            tpath = os.path.join(args.output_dir, "spades_time_trace.json")
            timetracer.write(tpath)
            log.info("time trace -> %s", tpath)
        timetracer.disable()
        if prof is not None:
            prof.stop()
            pdir = os.path.join(args.output_dir, "profile")
            os.makedirs(pdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(pdir, "trace.json"))
            log.info("torch profiler trace -> %s", pdir)


def _run_job(args, argv, raw_argv, numbered, mode, device, log) -> int:
    from ..utils.timetracer import enabled, span

    log.info("spades_tpu_torch %s, mode=%s, device=%s, output=%s",
             __version__, mode, device, args.output_dir)

    with open(os.path.join(args.output_dir, "params.txt"), "w") as fh:
        fh.write(" ".join(raw_argv) + "\n")
        fh.write(f"mode={mode}\n")

    from ..io.fastx import read_fastx
    from ..io.libraries import DataSet, SequencingLibrary, load_dataset_yaml
    from ..pipeline.run import run_assembly

    # --- load libraries (library.hpp / DataSet model) --------------------
    def _parsed(sp, seqs):
        if enabled():
            sp.set(reads=len(seqs), bases=sum(map(len, seqs)))

    def _seqs(path):
        with span("cli.parse") as sp:
            seqs = [r.seq for r in read_fastx(path)]
            _parsed(sp, seqs)
        return seqs

    def _seqs_quals(path):
        seqs, quals = [], []
        with span("cli.parse") as sp:
            for r in read_fastx(path):
                seqs.append(r.seq)
                quals.append(r.qual or "")
            _parsed(sp, seqs)
        return seqs, quals

    dataset = DataSet()
    if args.dataset:
        dataset = load_dataset_yaml(args.dataset)
    for p1, p2 in zip(args.pe1, args.pe2):
        (r1, q1), (r2, q2) = _seqs_quals(p1), _seqs_quals(p2)
        if len(r1) != len(r2):
            log.error("paired files %s / %s length mismatch", p1, p2)
            return 64
        dataset.libraries.append(SequencingLibrary(
            type="paired-end", left=r1, right=r2, left_quals=q1, right_quals=q2))
    for p in args.interlaced:
        rs, qs = _seqs_quals(p)
        dataset.libraries.append(
            SequencingLibrary(type="paired-end", left=rs[0::2], right=rs[1::2],
                              left_quals=qs[0::2], right_quals=qs[1::2])
        )
    for p1, p2 in zip(args.mp1, args.mp2):
        dataset.libraries.append(
            SequencingLibrary(type="mate-pairs", left=_seqs(p1), right=_seqs(p2))
        )
    for p1, p2 in zip(args.hqmp1, args.hqmp2):
        dataset.libraries.append(
            SequencingLibrary(type="hq-mate-pairs", left=_seqs(p1), right=_seqs(p2))
        )
    for p in args.single + args.merged:
        rs, qs = _seqs_quals(p)
        dataset.libraries.append(SequencingLibrary(type="single", left=rs, left_quals=qs))
    _KIND2TYPE = {"pe": "paired-end", "mp": "mate-pairs", "hqmp": "hq-mate-pairs",
                  "single": "single"}
    for (kind, num) in sorted(numbered):
        spec = numbered[(kind, num)]
        lt = _KIND2TYPE[kind]
        lib = SequencingLibrary(type=lt, orientation=spec.get("orientation", ""))
        for f in spec.get("1", []):
            rs, qs = _seqs_quals(f)
            lib.left += rs
            lib.left_quals += qs
        for f in spec.get("2", []):
            rs, qs = _seqs_quals(f)
            lib.right += rs
            lib.right_quals += qs
        for f in spec.get("12", []):
            rs, qs = _seqs_quals(f)
            lib.left += rs[0::2]
            lib.left_quals += qs[0::2]
            lib.right += rs[1::2]
            lib.right_quals += qs[1::2]
        for f in spec.get("s", []) + spec.get("m", []):
            if lt == "single":
                rs, qs = _seqs_quals(f)
                lib.left += rs
                lib.left_quals += qs
            else:
                # unpaired/merged reads of a paired library become a single lib
                rs, qs = _seqs_quals(f)
                dataset.libraries.append(
                    SequencingLibrary(type="single", left=rs, left_quals=qs))
        if lib.is_paired and len(lib.left) != len(lib.right):
            log.error("numbered library %s%d: mate count mismatch", kind, num)
            return 64
        if lib.left or lib.right:
            dataset.libraries.append(lib)
    for p in args.pacbio:
        dataset.libraries.append(SequencingLibrary(type="pacbio", left=_seqs(p)))
    for p in args.nanopore:
        dataset.libraries.append(SequencingLibrary(type="nanopore", left=_seqs(p)))
    for p in args.sanger:
        dataset.libraries.append(SequencingLibrary(type="sanger", left=_seqs(p)))
    for p in args.fl_rna:
        dataset.libraries.append(SequencingLibrary(type="fl-rna", left=_seqs(p)))
    for p in args.trusted_contigs:
        dataset.libraries.append(SequencingLibrary(type="trusted-contigs", left=_seqs(p)))
    for p in args.untrusted_contigs:
        dataset.libraries.append(SequencingLibrary(type="untrusted-contigs", left=_seqs(p)))

    reads = dataset.all_short_reads()
    paired_libs = dataset.paired()
    long_reads = dataset.long_reads()
    trusted = dataset.contigs()
    if not reads and not args.assembly_graph:
        log.error("no reads parsed")
        return 64

    # --- error correction (BayesHammer stage; error_correction_stage.py) -
    # Runs by default as in SPAdes; skipped for --only-assembler and for
    # modes that disable it (rna/corona run without hammer upstream).
    if not args.only_assembler and mode not in ("rna", "corona", "sewage"):
        from ..hammer import HammerConfig, correct_reads
        from ..hammer.hammer import HammerStats
        from ..io.fastx import write_fasta

        flat: list[str] = []
        flat_quals: list[str] = []
        spans = []  # (lib, n_left, n_right) in order
        for lib in dataset.libraries:
            if lib.is_paired:
                spans.append((lib, len(lib.left), len(lib.right)))
                flat += lib.left + lib.right
                flat_quals += (lib.left_quals or [""] * len(lib.left))
                flat_quals += (lib.right_quals or [""] * len(lib.right))
            elif lib.type == "single":
                spans.append((lib, len(lib.left), 0))
                flat += lib.left
                flat_quals += (lib.left_quals or [""] * len(lib.left))
        with span("error_correction", reads=len(flat)):
            if args.iontorrent:
                from ..hammer.ionhammer import correct_ion_reads

                corrected, changed = correct_ion_reads(flat)
                st = HammerStats(reads_total=len(flat), bases_changed=changed,
                                 reads_changed=sum(a != b for a, b in zip(corrected, flat)))
            else:
                corrected, st = correct_reads(flat, HammerConfig(), quals=flat_quals,
                                              device=device)
        log.info(
            "error correction: %d/%d reads changed, %d bases",
            st.reads_changed, st.reads_total, st.bases_changed,
        )
        off = 0
        for lib, nl, nr in spans:
            lib.left = corrected[off : off + nl]
            lib.right = corrected[off + nl : off + nl + nr]
            off += nl + nr
        reads = dataset.all_short_reads()
        paired_libs = dataset.paired()
        cdir = os.path.join(args.output_dir, "corrected")
        with span("cli.ec_write", reads=len(corrected)):
            os.makedirs(cdir, exist_ok=True)
            for li, lib in enumerate(dataset.paired()):
                write_fasta(os.path.join(cdir, f"lib{li + 1}_1.cor.fasta"),
                            [(f"read{i+1}/1", r) for i, r in enumerate(lib.left)])
                write_fasta(os.path.join(cdir, f"lib{li + 1}_2.cor.fasta"),
                            [(f"read{i+1}/2", r) for i, r in enumerate(lib.right)])
            singles = dataset.singles()
            if singles:
                write_fasta(os.path.join(cdir, "unpaired.cor.fasta"),
                            [(f"read{i+1}", r) for i, r in enumerate(singles)])
        if args.only_error_correction or args.stop_after == "ec":
            _log_launches(log)
            log.info("======= spades_tpu_torch finished (error correction only). "
                     "Results in %s", cdir)
            return 0
    elif args.only_error_correction:
        log.error("--only-error-correction with --only-assembler or a no-EC mode")
        return 64

    # --- k selection ----------------------------------------------------
    rl = int(np.median([len(r) for r in reads]))
    if args.k_list == "auto":
        from .assembler import default_k_ladder

        k_list = [k for k in default_k_ladder(rl) if k < rl]
    else:
        k_list = [int(x) for x in args.k_list.split(",")]
        bad = [k for k in k_list if k % 2 == 0 or k >= 128]
        if bad:
            log.error("k values must be odd and < 128: %s", bad)
            return 65
    if args.stop_after and args.stop_after.startswith("k"):
        stop_k = int(args.stop_after[1:])
        if stop_k in k_list:
            k_list = k_list[: k_list.index(stop_k) + 1]
            log.info("--stop-after %s: k ladder truncated", args.stop_after)
    log.info("read length=%d, k ladder=%s", rl, k_list)

    if args.read_cov_threshold:
        # read_cov_threshold (options_parser.py): drop reads whose median
        # k-mer coverage is below the threshold before assembly; as in the
        # JAX package, only `reads` are filtered and `paired_libs` go on whole
        from ..ops.count import count_sequences
        from ..tools.read_filter import read_median_coverage

        fk = min(21, k_list[0])
        kc = count_sequences(reads, fk, device=device)
        med = read_median_coverage(reads, fk, kc, device=device)
        keep = med >= args.read_cov_threshold
        log.info("read coverage filter: %d/%d reads kept (threshold %.1f)",
                 int(keep.sum()), len(reads), args.read_cov_threshold)
        reads = [r for r, k_ in zip(reads, keep) if k_]

    cov_cutoff = 0
    cut_src = args.hidden_cov_cutoff or args.cov_cutoff
    if cut_src not in ("off", "auto"):
        cov_cutoff = int(float(cut_src))

    hmm_profiles = []
    for hf in args.custom_hmms:
        from ..hmm import read_hmm

        hmm_profiles += read_hmm(hf)
    if hmm_profiles:
        log.info("loaded %d HMM profiles", len(hmm_profiles))

    # executor artifacts: run_spades.yaml / run_spades.sh (+ sbatch script)
    from .executors import dump_sh, dump_slurm, dump_yaml, pipeline_description

    user_argv = list(argv if argv is not None else sys.argv[1:])
    cmds = pipeline_description(
        k_list, mode, args.careful, bool(long_reads), bool(hmm_profiles)
    )
    dump_yaml(os.path.join(args.output_dir, "run_spades.yaml"), cmds)
    dump_sh(os.path.join(args.output_dir, "run_spades.sh"), user_argv)
    if args.grid_engine == "slurm":
        sub = os.path.join(args.output_dir, "submit_spades.sh")
        dump_slurm(sub, user_argv, threads=args.threads, memory_gb=args.memory,
                   partition=args.grid_queue,
                   time_limit=args.grid_time or "24:00:00",
                   nnodes=args.grid_nnodes, extra=args.grid_extra)
        log.info("SLURM submission script -> %s (submit with sbatch)", sub)

    if args.only_generate_config:
        log.info("======= config generated (run_spades.yaml/run_spades.sh); exiting")
        return 0

    overlay = None
    if getattr(args, "config_file", None):
        from .config_overlay import load_overlay

        overlay = load_overlay(args.config_file)
        log.info("loaded config overlay from %s (%d sections)",
                 args.config_file, len(overlay))
    restart = "last" if args.cont else args.restart_from
    if args.save_gp:
        args.checkpoints = "all"
    result = run_assembly(
        reads=reads,
        k_list=k_list,
        output_dir=args.output_dir,
        mode=mode,
        read_length=rl,
        paired_libs=paired_libs,
        long_reads=long_reads,
        trusted_contigs=trusted,
        min_count=max(cov_cutoff, 1),
        checkpoints=args.checkpoints,
        restart_from=restart,
        careful=args.careful,
        hmm_profiles=hmm_profiles,
        ss=args.ss,
        series_analysis=args.series_analysis,
        assembly_graph=args.assembly_graph,
        disable_rr=args.disable_rr,
        mismatch_correction=(args.careful or args.mismatch_correction)
        if args.stop_after != "as" else False,
        gfa_version="1.1" if args.gfa11 else "1.2",
        config_overlay=overlay,
        device=device,
    )

    # --- --test oracle (check_test_script.py:58-76) ---------------------
    if args.test:
        contigs = result.contigs
        ok = len(contigs) == 1 and len(contigs[0].seq) == 1000
        if ok:
            log.info("========= TEST PASSED CORRECTLY")
        else:
            log.error(
                "TEST FAILED: got %d contigs, lengths %s",
                len(contigs), [len(c.seq) for c in contigs],
            )
            return 1
    _log_launches(log)
    if args.num_processes > 1:
        from ..parallel.distributed import EXCHANGED

        log.info("collectives: %d bytes sent in %d", EXCHANGED["bytes"],
                 EXCHANGED["collectives"])
    log.info("======= spades_tpu_torch finished. Results in %s", args.output_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
