#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`spades_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

1. Toolchain and card: CUDA, nvcc, triton, the native host library, and the
   build of the port's CUDA kernel from `spades_tpu_torch/csrc/`.
2. Every kernel against its plain PyTorch version on the card, on random
   reads at every k from 13 to 128 and at every shape the main path gives
   it, with and without the strand plane; tolerance 0 (the work is integer),
   with CUDA-event times beside the memory bound.
3. Graph construction at isolate scale: a synthetic 5 Mb genome with planted
   repeats, 150 bp FR pairs at 15x, through the `gbuilder` CLI at k=55.  The
   result is checked by invariants, and a subset against the port's CPU path.
4. Read mapping on that k=55 graph: `MappingEngine.map_store` over every
   read of one `ReadStore` (device-built edge index, search, vote) and the tip
   prefilter `hit_filter_store`, checked against the sequence pool, the host
   index build and the port's CPU path, with the time of each part.
5. Read error correction of the same isolate (`hammer.correct_reads`, the
   default path's first step) at full width, with PHRED qualities drawn from
   the seed (lower on the planted substitutions): the time of each step,
   the kernel's launches from its two callers (21-mer counting, the window
   maps), the CUDA-event time of every batch of the quality sum and the
   vote, the peak device memory, and the planted substitutions fixed and
   the bases wrongly changed, from the reads before their errors.
6. Assembly of the corrected reads in careful mode: `run_assembly(k_list=
   [21, 33, 55], careful=True)`, reads to mismatch-corrected,
   repeat-resolved contigs and scaffolds (MismatchCorrection and
   PairInfoCount map every read onto the simplified k=55 graph,
   DistanceEstimation, RepeatResolution).  Graph invariants after every
   stage, the native library, the k=55 counts against a direct count of the
   corrected reads, the insert-size estimate and the mapped share of the
   pairs, the device index of the simplified k=55 graph (its upper row
   tiers) against the host build, contigs and broken scaffolds against the
   genome, the output files.
7. Error correction, gap closing, careful mode and repeat resolution, card
   against CPU: a 300 kb genome whose pairs are thinned at planted positions
   so that k=55 tips overlap by 10 to 45 bases, with qualities as in 5, is
   corrected with its qualities and without them, and the reads corrected
   without them (as the CLI's FASTQ parser keeps no qualities) are
   assembled at k=55 (`careful=True`), on the card and on the CPU; gaps
   must close and the two results (corrected reads, statistics, cluster
   labels, quality sums bit for bit, the graph after MismatchCorrection, raw
   and clustered pair indices, paths, contigs, scaffolds) must be equal.  Each device program of error correction and
   careful mode (window maps, quality sum, expansion, vote, vote scatter) is
   held against its plain numpy version on the card, and timed.
8. The CLI's default path: the gap dataset as FASTQ with its qualities
   through `python -m spades_tpu_torch.pipeline.main -k 55 --careful` on the
   card, in a subprocess; its corrected reads, contigs and scaffolds must
   equal phase 7's card run.
9. metaSPAdes at full width: a mock community of four random genomes (2.0,
   1.5, 1.0 and 0.5 Mb at 60, 25, 12 and 6x, the two largest sharing a 5 kb
   segment), raw 150 bp FR pairs, through `run_assembly([21, 33, 55],
   mode="meta")`: both repeat-resolution passes (the second maps every read
   again onto the first's device index), SecondPhaseSetup's trusted paths,
   the stage times, the kernel's launches by caller and by stage, peak
   device memory, and the contigs of 1 kb or more laid onto the genomes.
10. Long reads: phase 7's gap set (its raw pairs) with 8x of noisy 10 kb
   reads through `run_assembly([55], long_reads=)`, and through the CLI's
   `--nanopore`, whose contigs must equal the library call's.
11. The other modes at K = 55: a 100 kb chromosome at 40x with circular
   plasmids of 5, 12 and 30 kb at 3, 5 and 8 times its depth in `plasmid`,
   `metaplasmid`, `metaviral`, `sc` and `sewage` mode; and the gap set
   from phase 7's GFA (`assembly_graph=`, then the CLI's
   `--assembly-graph`).
12. The card against the CPU: a worker process (`--cpu-worker`), started
   after phase 7, makes the small runs of phases 9 to 11 (the community cut
   to 300 kb, the hybrid run, every mode, the GFA start) on the CPU while
   the card works; every file each wrote must equal the card's.
13. Every shape phases 3 to 19 gave the kernel that phase 2 did not hold
   yet, against the plain version and timed (run last).
14. rnaSPAdes at full width: a synthetic stranded (dUTP) transcriptome of
   2,000 genes (400 with a second isoform, 33 convergent pairs overlapping
   at their 3' ends, poly-A tails, log-normal expression) as 500,000 pairs
   of 100 bp through `run_assembly(mode="rna", ss="rf")` over the CLI's K
   choice: the early A/T clipper and SSEdgeSplit at every K, the stage
   times, the kernel's launches, peak device memory, and transcripts.fasta
   laid onto the true transcripts (genes recovered, isoforms told apart,
   convergent pairs kept apart, poly-A left).
15. The other modes of the last slice at K = 55, card against CPU: a
   190-transcript copy of 14's set in rna mode with `ss="fr"` and with
   `ss="rf"` plus full-length transcripts, `rnaspades --ss rf --fl-rna`
   (equal to that library call), `rnaviralspades` (error correction on),
   `coronaspades --custom-hmms` on a 30 kb coronavirus-like genome with
   nested subgenomic RNAs at about 1,000x and 200 kb of host transcripts
   (three amino profiles of 120, 200 and 300 states), `--bio --custom-hmms`
   on a 300 kb genome at 40x, and series analysis of phase 9's 300 kb
   community in three samples; every profile's best hit must spell its
   gene, and a second CPU worker, started with the first, makes every run
   on the CPU: every file must be equal.  The CLI's `--read-cov-threshold 3`
   runs on the gap set's raw pairs among these CLI runs.
16. The standalone tools, in this process through their `main(argv)` with
   `--device cuda`: `kmercount` at k = 55 (its unique count must equal the
   k-mers of phase 3's graph) and at k = 21, `kmer_estimating` at k = 55
   (HyperLogLog, within 5 % of that count) and `read_filter -k 21 -c 2` on
   the whole isolate, the last with 2,000 pairs of a random contaminant at
   0.3x after it (at least 99 % of the genome's pairs kept, 90 % of the
   contaminant's dropped); then, each against the same run on the CPU (a
   third CPU worker, started before phase 14, or the slice-7 worker over its
   own phase 15 outputs): kmercount, the HLL registers and read_filter on
   phase 3's subset, `gmapper` on phase 7's k=55 graph with its reads, and
   the host tools `gsimplifier`, `gfa_split`, `gchecker`,
   `convert_bin_to_fasta`, `corrector` (with reads, and with `--sam` from
   `mappings_to_sam`), `spaligner` (phase 10's long reads), `pathracer` (the
   first corona profile on the corona run's graph) and `mts` (the series
   run's contigs and samples); every file and printed line must be equal.
17. The last single-device tools, their CLI runs in a process of their own
   on the card during phase 14: `binspreader` on phase 9's K = 55 graph with
   a seed binning of its segments of 2,500 nt or more and all of phase 9's
   pairs (`--bin-dist --reads-split`, majority_length and max_likelihood
   `--multi`; the share of shorter segments given the bin of the genome they
   lie in), `splitter` on phase 6's K = 55 graph with 1,000,000 linked reads
   of the isolate (`BX:Z:` barcodes, molecules of about 40 kb, 10 per
   barcode; `--mapping-k 31`), `sewage` on a 30 kb reference with a tree of
   2,000 lineages by 3,000 mutation columns and 500,000 reads of five
   lineages (the mixture's lineages first, and lineages.csv equal to the JAX
   package's on the same inputs), `cds_subgraphs` with 100 slices of 1-3 kb
   of the community's genomes and 5 random queries (each subgraph holds the
   edge its query maps to), a scripted `online_vis` session; in this
   process `fill_positions` of the isolate onto phase 6's graph (every edge
   of 1 kb or more placed, every non-repeat one covered whole) and
   `count_batch_device(_tiled)` on 65,536 of its reads (tiles merged equal
   the untiled count and `count_reads`, the card equal to the plain path);
   a fourth CPU worker makes the same tool runs on a cut set (phase 9's
   300 kb copy, the gap set with 60,000 linked reads and its positions,
   50,000 of the wastewater reads): every file and printed line equal, the
   abundances within 1e-9.
18. Multi-GPU on torch.distributed, in a process of its own started before
   phase 14 (the sharded paths of `spades_tpu_torch/parallel/`): (a) NCCL
   at world size 1 on the card, the isolate of phase 3 at full size: the
   sharded count of its (k+1)-mers and `construct_graph` under the group,
   each equal to phase 3's single-device result (SHA-256 of the arrays), and
   the group `map_reads_sharded` / `position_votes_sharded` /
   `hit_filter_store` of 65,536 pairs equal to the single-device calls;
   (b) two ranks on the one card under gloo (NCCL refuses two ranks on one
   card), each in its own process: the same count and graph checks; then
   `dryrun_multigpu(2, "cuda", "gloo")`, `dryrun_multihost` with two
   processes, and `python -m spades_tpu_torch.pipeline.main -k 55 --careful
   --num-processes 2` on phase 8's FASTQ as two rank processes, whose
   corrected reads, contigs and scaffolds must equal phase 8's byte for
   byte while rank 1 writes nothing.  Per-rank wall times, bytes sent and
   B1 launches per rank are printed.
19. The user paths no other phase takes, a card process and a CPU worker
   started before phase 14: (a) phase 3's isolate with a mate-pair library of
   its genome (RF, insert 3,000 +- 300, 5x) through `run_assembly([21, 33,
   55], paired_libs=[PE, MP], min_count=2)` (the two-pass structure count at
   K = 33 and 55, the mate pairs to the scaffold graph; contigs laid onto the
   genome, scaffolds' N50 at least the contigs'); (b) the CLI on the card and
   on the CPU, every file equal: `--iontorrent -k 21,33,55` on the gap set
   with homopolymer-length errors, and the gap set with a 3 kb RF mate-pair
   library at 10x and `--cov-cutoff 2 -k 21,33,55`; (c) on the gap set's
   K = 55 graph after Simplification, card against CPU: `map_store` with the
   kmer-mapper on reads of which at least 1 % stay unmapped on the device (the
   host residue pass must recover some), and MismatchCorrection's string path
   (`correct_mismatches(g, reads)`) restoring bases planted into the graph.

20. The coverage EM kernel (`csrc/coverage_em.cu`, one launch per coverage
   fit) on the histograms the main path gave it: every fit of phases 5, 6
   and 9 (error correction, the isolate's K ladder, meta's) is made again on
   the card, twice (bit for bit equal, and equal to the main path's fit),
   with the plain PyTorch version and on the host (scipy): isolate and error
   correction fits with every integer field equal to both, the mean within
   1e-3 and the sd within 1e-2 (relative); meta's with `trusted_bound`, the
   one field its stages read, equal (its fit may end in another basin, as
   the host's own does under a 1-ulp change of the objective).  The
   kernel's launches are counted per driven path (one per fit on the card)
   and timed with CUDA events beside the plain version, the host EM and the
   kernel's float64 bound (run after 9).

Where the card's files must equal the CPU's, a checkpoint's state.json is
compared as JSON with its coverage fit's mean within 1e-2 (relative), every
other field exact: the card's fit differs from the host's in its float
fields (`FIT_MEAN_RTOL`).

Every earlier line is one JSON record (or the card's `nvidia-smi` line); the
last line is {"ok": true, "device": {...}}.  Without a CUDA card, without the
package beside this script, or when any phase fails, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_KS = (13, 22, 33, 56, 128)     # timed on random reads
SWEEP_KS = range(13, 129)             # checked on random reads


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# 1. toolchain and card
# ---------------------------------------------------------------------------

def phase_toolchain(dev) -> dict:
    import torch

    from spades_tpu_torch import native
    from spades_tpu_torch.ops import cuda_kernels as CK

    rec = {"phase": "toolchain", "torch": torch.__version__,
           "torch_cuda": torch.version.cuda, "device": str(dev)}
    try:
        import triton

        rec["triton"] = triton.__version__
    except ImportError as e:
        rec["triton"] = f"not importable: {e}"
    rec["ninja"] = shutil.which("ninja")
    try:        # the port writes run_spades.yaml without it; --dataset needs it
        import yaml

        rec["yaml"] = yaml.__version__
    except ImportError as e:
        rec["yaml"] = f"not importable: {e}"
    t0 = time.perf_counter()
    rec["native_loaded"] = native.lib() is not None
    rec["native_build_s"] = time.perf_counter() - t0
    if rec["native_loaded"]:
        # the Makefile falls back to a single-threaded build without OpenMP
        with open(native._SO, "rb") as fh:
            rec["native_openmp"] = b"GOMP_parallel" in fh.read()
    else:
        rec["native_build_log"] = native.build_log[-1500:]
    if dev.type == "cuda":
        rec["nvcc"] = subprocess.run(
            [CK._nvcc(), "--version"], capture_output=True, text=True, timeout=60,
            check=True,
        ).stdout.strip().splitlines()[-1]
        t0 = time.perf_counter()
        CK.build()
        rec["kernel_build_s"] = time.perf_counter() - t0
        rec["ptxas"] = [ln.split(":", 1)[1].strip() for ln in CK.build_log.splitlines()
                        if "registers" in ln]
        rec["card"] = nvidia_smi_line()
    return rec


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_kernels(dev, main_shapes=None, rand_R: int = 2048, rand_L: int = 200) -> dict:
    """The canonical-windows kernel against its plain version, exactly, with
    and without the strand plane: every k on small random batches (ragged
    lengths, N, odd shapes, rows that start off a 16-byte line), then with
    times at several k and at every shape the main path gives it."""
    import torch

    from spades_tpu_torch.ops import cuda_kernels as CK
    from spades_tpu_torch.tools import kernel_shapes as KS

    def compare(name, args, L, k, strand):
        ref = CK.canonical_window_keys_plain(*args, L, k, strand=strand)
        got = CK.canonical_window_keys(*args, L, k, strand=strand)
        sync(dev)
        err = KS.max_abs_err(got, ref)
        check(err == 0, f"{name}: kernel differs from its plain version (max abs err {err})")
        return err

    n_swept = 0
    for k in SWEEP_KS:
        R, L = (517, 200) if k % 2 else (512, 203)
        pc, pn, ln, L = KS.random_packed(k, R, L, k)
        args = [torch.from_numpy(a).to(dev) for a in (pc, pn, ln)]
        for strand in (False, True):
            compare(f"sweep k={k}", args, L, k, strand)
            compare(f"sweep k={k}, offset rows", [t[3:] for t in args], L, k, strand)
            n_swept += 2

    cases = [(f"random k={k}", rand_R, rand_L, k, strand, None, 0.03, 10)
             for k in KERNEL_KS for strand in (False, True)]
    cases += [(*shape, 0.0, 20) for shape in (main_shapes or KS.MAIN_SHAPES)]
    shapes = []
    for i, (name, R, L, k, strand, read_len, n_rate, iters) in enumerate(cases):
        pc, pn, ln, L = KS.random_packed(1000 + i, R, L, k, read_len, n_rate)
        args = [torch.from_numpy(a).to(dev) for a in (pc, pn, ln)]
        err = compare(name, args, L, k, strand)
        ms = KS.time_ms(lambda: CK.canonical_window_keys(*args, L, k, strand=strand), dev, iters)
        plain_ms = KS.time_ms(
            lambda: CK.canonical_window_keys_plain(*args, L, k, strand=strand),
            dev, max(1, iters // 5))
        bound_ms, bound_by = KS.canonical_windows_bound(R, L, k, strand)
        shapes.append({"shape": name, "R": R, "L": L, "k": k, "strand": strand,
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by})
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return {"phase": "kernels", "tolerance": 0, "swept_k": [SWEEP_KS[0], SWEEP_KS[-1]],
            "swept_cases": n_swept, "shapes": shapes}


# ---------------------------------------------------------------------------
# 3. the main path at isolate scale
# ---------------------------------------------------------------------------

GRAPH_FIELDS = ("e_start", "e_end", "e_conj", "e_off", "e_len", "e_cov",
                "alive", "seq_pool", "v_conj")


def digest(*arrays) -> str:
    """SHA-256 of arrays' dtypes, shapes and bytes."""
    import numpy as np

    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def construction_digests(p1, graph) -> dict:
    return {"p1": digest(p1.words, p1.counts),
            "graph": {f: digest(getattr(graph, f)) for f in GRAPH_FIELDS}}


def graph_checks(name: str, g) -> None:
    import numpy as np

    E = g.e_start.shape[0]
    check(E > 0, f"{name}: empty graph")
    check(np.array_equal(g.e_conj[g.e_conj], np.arange(E)),
          f"{name}: edge conjugation is not an involution")
    check(np.array_equal(g.v_conj[g.v_conj], np.arange(g.v_conj.shape[0])),
          f"{name}: vertex conjugation is not an involution")


def phase_main_path(dev, workdir: str, genome_size: int, coverage: int,
                    subset_pairs: int, seed: int, rl: int = 150):
    import numpy as np
    import torch

    from spades_tpu_torch.core.reads import ReadStore
    from spades_tpu_torch.io.fastx import read_sequences
    from spades_tpu_torch.ops import cuda_kernels as CK
    from spades_tpu_torch.pipeline.construction import construct_graph
    from spades_tpu_torch.tools import gbuilder, synthetic

    wall = {}
    t0 = time.perf_counter()
    genome, r1, r2, c1, c2 = synthetic.make_e2e_dataset(genome_size, coverage, rl, 0.003,
                                                        seed, truth=True)
    wall["make_data_s"] = time.perf_counter() - t0
    n_pairs = r1.shape[0]
    n_reads = 2 * n_pairs
    paths = [os.path.join(workdir, "r1.fq"), os.path.join(workdir, "r2.fq")]
    t0 = time.perf_counter()
    synthetic.write_fastq(paths[0], r1, 1)
    synthetic.write_fastq(paths[1], r2, 2)
    wall["write_fastq_s"] = time.perf_counter() - t0

    # -- the main path: launch counts from 0, read right after ---------------
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    CK.canonical_window_keys.launches = 0
    out = os.path.join(workdir, "gbuilder")
    t0 = time.perf_counter()
    res_g = gbuilder.run([*paths, "-k", "55", "--unitigs", "-w", out,
                          "--device", dev.type])
    sync(dev)
    wall["gbuilder_k55_s"] = time.perf_counter() - t0
    launches = {"gbuilder_k55": CK.canonical_window_keys.launches}

    t0 = time.perf_counter()
    reads = list(read_sequences(paths))
    wall["read_fastq_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    store = ReadStore.build(reads)
    wall["read_store_build_s"] = time.perf_counter() - t0
    main_launches = CK.canonical_window_keys.launches
    peak_gib = (torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda"
                else None)

    # -- invariants of the full-size result ---------------------------------
    for name, n in launches.items():   # a CPU rehearsal launches no kernel
        check(n > 0 or dev.type == "cpu",
              f"{name}: the canonical-windows kernel was not launched")
    check(res_g.p1_counts.total == n_reads * (rl - 55),
          "gbuilder k=55: counted windows != reads x (150 - k)")
    graph_checks("gbuilder_k55", res_g.graph)
    n_seg = len(res_g.graph.canonical_edge_ids())
    with open(os.path.join(out, "assembly_graph_with_scaffolds.gfa")) as fh:
        gfa_s = sum(1 for ln in fh if ln.startswith("S\t"))
    with open(os.path.join(out, "unitigs.fasta")) as fh:
        n_unitigs = sum(1 for ln in fh if ln.startswith(">"))
    check(gfa_s == n_seg, f"GFA has {gfa_s} segments, the graph {n_seg} edge pairs")
    check(n_unitigs == n_seg, f"unitigs.fasta has {n_unitigs} records, not {n_seg}")

    # -- the card against the port's CPU path on a subset --------------------
    sub = min(subset_pairs, n_pairs)
    sub_seqs = reads[:sub] + reads[n_pairs : n_pairs + sub]   # r1 reads, then r2
    del reads
    t0 = time.perf_counter()
    got = construct_graph(sub_seqs, 55, device=dev)
    sync(dev)
    wall["subset_device_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = construct_graph(sub_seqs, 55, device="cpu")
    wall["subset_cpu_s"] = time.perf_counter() - t0
    check(np.array_equal(got.p1_counts.words, ref.p1_counts.words)
          and np.array_equal(got.p1_counts.counts, ref.p1_counts.counts),
          "subset: device and CPU (k+1)-mer counts differ")
    for f in GRAPH_FIELDS:
        check(np.array_equal(getattr(got.graph, f), getattr(ref.graph, f)),
              f"subset: device and CPU graphs differ in {f}")

    # the subset as FASTQ, for phase 16's tools
    subset = [os.path.join(workdir, "sub_1.fq"), os.path.join(workdir, "sub_2.fq")]
    synthetic.write_fastq(subset[0], r1[:sub], 1)
    synthetic.write_fastq(subset[1], r2[:sub], 2)

    rec = {
        "phase": "main_path",
        "card": nvidia_smi_line() if dev.type == "cuda" else "cpu",
        "dataset": {"genome_nt": genome_size, "coverage": coverage, "read_len": rl,
                    "pairs": n_pairs, "error_rate": 0.003, "seed": seed},
        "wall_s": wall,
        "timings": {"gbuilder_k55": res_g.timings},
        "launches": launches,
        "unique_p1": {"gbuilder_k55": res_g.p1_counts.num_unique},
        "unique_k": {"gbuilder_k55": res_g.index.num_kmers},
        "edges": {"gbuilder_k55": int(res_g.graph.e_start.shape[0])},
        "gfa_segments": gfa_s,
        "subset_pairs": sub,
        "subset_edges": int(got.graph.e_start.shape[0]),
        "peak_device_gib": peak_gib,
    }
    isolate = {"paths": paths, "subset": subset, "pairs": int(n_pairs), "subset_pairs": sub,
               "unique_k55": res_g.index.num_kmers, "genome": genome,
               "batch": r1[:65536].copy(),          # phase 17's tiled count
               "digests": construction_digests(res_g.p1_counts, res_g.graph)}   # phase 18
    return rec, main_launches, {"store": store, "graph": res_g.graph, "n_pairs": n_pairs,
                                "genome": genome, "r1": r1, "r2": r2, "c1": c1, "c2": c2,
                                "isolate": isolate}


# ---------------------------------------------------------------------------
# 4. read mapping on the k=55 graph
# ---------------------------------------------------------------------------

def spelled_windows(g, k: int, codes, edge: int, start: int) -> int:
    """How many k-windows of a read (uint8 codes, N as 4) spell oriented
    `edge` at offset `start + j`: counted from the sequence pool alone."""
    import numpy as np

    n = len(codes)
    seq = g.edge_codes(edge)
    pos = start + np.arange(n)
    inside = (pos >= 0) & (pos < len(seq))
    same = np.zeros(n, bool)
    same[inside] = seq[pos[inside]] == codes[inside]
    run = np.concatenate([[0], np.cumsum(same)])
    return int((run[k:] - run[:-k] == k).sum())


def phase_mapping(dev, state, subset_pairs: int, seed: int, n_tips: int = 10_000,
                  n_sample: int = 1_000):
    import numpy as np
    import torch

    from spades_tpu_torch.alignment.mapper import MappingEngine, build_edge_index
    from spades_tpu_torch.core import kmers as K
    from spades_tpu_torch.core.reads import subset_store
    from spades_tpu_torch.ops import cuda_kernels as CK
    from spades_tpu_torch.ops.count import _lexsort_rows
    from spades_tpu_torch.ops.extension import canonicalize
    from spades_tpu_torch.parallel import sharded_mapping as SM
    from spades_tpu_torch.tools.kernel_shapes import time_ms

    store, g, n_pairs = state["store"], state["graph"], state["n_pairs"]
    k = g.k
    rng = np.random.default_rng(seed)
    wall = {}
    # a table of k-mers drawn from the graph, as the gap closer's tip table
    pool_pos = np.sort(rng.choice(len(g.seq_pool) - k, 4 * n_tips, replace=False))
    e_of = np.searchsorted(g.e_off, pool_pos, side="right") - 1
    pool_pos = pool_pos[pool_pos + k <= g.e_off[e_of] + g.e_len[e_of]][:n_tips]
    tips = canonicalize(K.pack(np.lib.stride_tricks.sliding_window_view(
        g.seq_pool, k)[pool_pos]), k)[0]
    tips = np.unique(tips[_lexsort_rows(tips)], axis=0)

    # -- the mapping path: launch counts from 0, read right after ------------
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    CK.canonical_window_keys.launches = 0
    engine = MappingEngine(g, device=dev)
    t0 = time.perf_counter()
    prep = engine._device_index()
    sync(dev)
    index_tm = engine.index_timings
    wall["index_build_s"] = time.perf_counter() - t0
    index_peak_gib = (torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda"
                      else None)
    launches = {"index_build": CK.canonical_window_keys.launches}
    t0 = time.perf_counter()
    edge, start, votes = engine.map_store(store)
    sync(dev)
    wall["map_store_s"] = time.perf_counter() - t0
    launches["map_store"] = CK.canonical_window_keys.launches - launches["index_build"]
    before = CK.canonical_window_keys.launches
    t0 = time.perf_counter()
    hits = SM.hit_filter_store(store, tips, k, device=dev)
    sync(dev)
    wall["hit_filter_s"] = time.perf_counter() - t0
    launches["hit_filter"] = CK.canonical_window_keys.launches - before
    map_launches = CK.canonical_window_keys.launches
    peak_gib = (torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda"
                else None)
    check(index_tm.get("index_rows", 0) > 0,
          "the edge index was not built on the device (SPADES_DEVICE_INDEX_POOL)")
    for name, n in launches.items():   # a CPU rehearsal launches no kernel
        check(n > 0 or dev.type == "cpu",
              f"{name}: the canonical-windows kernel was not launched")

    # -- one chunk again, part by part: queue, then pull ----------------------
    ch = store.chunks[0]
    sub = int(os.environ.get("SPADES_MAP_SUBCHUNK", 131072))
    pc, pn, ln = ch.device(dev)
    t0 = time.perf_counter()
    futs = [SM.map_packed_async(prep, k, pc[a : a + sub], pn[a : a + sub], ln[a : a + sub], ch.L)
            for a in range(0, pc.shape[0], sub)]
    wall["chunk_queue_s"] = time.perf_counter() - t0      # returns before the device is done
    sync(dev)
    wall["chunk_compute_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pulled = [tuple(t.cpu().numpy() for t in f) for f in futs]
    wall["chunk_pull_s"] = time.perf_counter() - t0
    check(np.array_equal(np.concatenate([p[0] for p in pulled])[: ch.n], edge[: ch.n]),
          "a second pass over the first chunk mapped differently")
    del futs, pulled
    # the parts of one sub-slice: kernel with strand, search, whole core, prefilter
    a = (pc[:sub].contiguous(), pn[:sub].contiguous(), ln[:sub].contiguous())
    tw = torch.from_numpy(np.ascontiguousarray(K.words_to_keys(tips).T)).to(dev)
    keys, valid, rrc = CK.canonical_window_keys(*a, ch.L, k, strand=True)
    part_ms = {
        "reads": int(a[0].shape[0]), "windows": int(keys.shape[1]),
        "index_rows": int(prep[0].shape[1]),
        "kernel_strand_ms": time_ms(
            lambda: CK.canonical_window_keys(*a, ch.L, k, strand=True), dev, 5),
        "search_ms": time_ms(lambda: SM.device_searchsorted_rows(prep[0], keys), dev, 3),
        "core_ms": time_ms(lambda: SM._map_shard_core(keys, valid, rrc, *prep, k=k), dev, 3),
        "hit_body_ms": time_ms(lambda: SM._hit_shard_body(*a, tw, k=k, L=ch.L), dev, 3),
    }
    part_ms["vote_ms"] = part_ms["core_ms"] - part_ms["search_ms"]
    del keys, valid, rrc, tw

    # -- checks ---------------------------------------------------------------
    lengths = np.concatenate([c.lengths[: c.n] for c in store.chunks])
    has_n = np.concatenate([c.pn[: c.n].any(axis=1) for c in store.chunks])
    eligible = (lengths >= k) & ~has_n
    mapped_share = float((edge[eligible] >= 0).mean())
    check(mapped_share >= 0.99,
          f"only {mapped_share:.4f} of the N-free reads of length >= k mapped")
    check(not (edge[lengths < k] >= 0).any(), "a read shorter than k mapped")
    sample = rng.choice(np.flatnonzero(edge >= 0), min(n_sample, int((edge >= 0).sum())),
                        replace=False)
    seqs = MappingEngine._gather_sequences(store, np.sort(sample))
    for i, codes in zip(np.sort(sample), seqs):
        n_spelled = spelled_windows(g, k, codes, int(edge[i]), int(start[i]))
        check(n_spelled >= votes[i] > 0,
              f"read {i}: {votes[i]} votes for edge {edge[i]} at {start[i]}, but only "
              f"{n_spelled} of its windows spell that edge there")

    # the device-built index against the host build, row for row
    t0 = time.perf_counter()
    host_index = build_edge_index(g, k)
    wall["host_index_build_s"] = time.perf_counter() - t0
    check_index_against_host(f"k={k} graph", prep, host_index, k)

    # the card against the port's CPU path on the first pairs
    sub_n = min(subset_pairs, n_pairs)
    idx = np.concatenate([np.arange(sub_n), n_pairs + np.arange(sub_n)])
    small = subset_store(store, idx)
    t0 = time.perf_counter()
    ce, cs, cv = MappingEngine(g, index=host_index, device="cpu").map_store(
        small, force_device=True)           # the torch path, on CPU tensors
    wall["subset_cpu_map_s"] = time.perf_counter() - t0
    check(np.array_equal(ce, edge[idx]) and np.array_equal(cs, start[idx])
          and np.array_equal(cv, votes[idx]),
          "subset: device and CPU mappings differ")
    t0 = time.perf_counter()
    cpu_hits = SM.hit_filter_store(small, tips, k, device="cpu")
    wall["subset_cpu_hit_filter_s"] = time.perf_counter() - t0
    check(np.array_equal(cpu_hits, hits[idx]), "subset: device and CPU prefilter hits differ")

    rec = {
        "phase": "mapping",
        "card": nvidia_smi_line() if dev.type == "cuda" else "cpu",
        "k": k, "reads": int(store.n), "eligible_reads": int(eligible.sum()),
        "mapped_share_of_eligible": mapped_share,
        "mapped_reads": int((edge >= 0).sum()),
        "mean_votes": float(votes[edge >= 0].mean()),
        "sample_checked": int(len(sample)),
        "tip_table_rows": int(tips.shape[0]), "prefilter_hits": int(hits.sum()),
        "wall_s": wall, "index_build": index_tm, "sub_slice_ms": part_ms,
        "launches": launches, "subset_pairs": sub_n,
        "index_build_peak_device_gib": index_peak_gib, "peak_device_gib": peak_gib,
    }
    return rec, map_launches


# ---------------------------------------------------------------------------
# 5. read error correction of the isolate at full width
# ---------------------------------------------------------------------------

def as_strings(letters) -> list:
    """(n, rl) uint8 ASCII rows -> strings."""
    import numpy as np

    rl = letters.shape[1]
    return np.ascontiguousarray(letters).view(f"S{rl}").ravel().astype(f"U{rl}").tolist()


def read_strings(codes) -> list:
    """(n, rl) uint8 base codes -> strings."""
    import numpy as np

    return as_strings(np.frombuffer(b"ACGT", np.uint8)[codes])


def as_codes(seqs, rl: int):
    """Strings of length rl -> (n, rl) uint8 codes, N as 4."""
    import numpy as np

    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    return lut[np.frombuffer("".join(seqs).encode(), np.uint8).reshape(-1, rl)]


def per_batch(ms) -> dict:
    """Summary of per-batch CUDA-event milliseconds."""
    if not ms:
        return {"batches": 0}
    return {"batches": len(ms), "mean_ms": sum(ms) / len(ms), "max_ms": max(ms),
            "total_ms": sum(ms)}


def correction_quality(fixed, reads, clean) -> dict:
    """Planted substitutions (reads against the reads before their errors)
    that correction fixed, left, or changed to another wrong base, and the
    right bases it changed."""
    planted = reads != clean
    return {"planted": int(planted.sum()),
            "fixed": int((planted & (fixed == clean)).sum()),
            "left": int((planted & (fixed == reads)).sum()),
            "miscalled": int((planted & (fixed != clean) & (fixed != reads)).sum()),
            "wrongly_changed": int((~planted & (fixed != clean)).sum()),
            "reads_touched": int((fixed != reads).any(axis=1).sum())}


def phase_error_correction(dev, state, seed: int, rl: int = 150):
    import numpy as np
    import torch

    from spades_tpu_torch.hammer import correct_reads
    from spades_tpu_torch.ops import cuda_kernels as CK
    from spades_tpu_torch.tools import synthetic

    wall = {}
    t0 = time.perf_counter()
    r1, r2, c1, c2 = state["r1"], state["r2"], state["c1"], state["c2"]
    q = [synthetic.error_qualities(r, c, seed + 11 + i) for i, (r, c) in
         enumerate(((r1, c1), (r2, c2)))]
    seqs = read_strings(r1) + read_strings(r2)
    quals = as_strings(q[0]) + as_strings(q[1])
    wall["make_strings_s"] = time.perf_counter() - t0

    # -- the error-correction path: launch counts from 0, read right after ---
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    CK.canonical_window_keys.launches = 0
    shapes = CK.canonical_window_keys.launch_shapes = collections.Counter()
    tm = {}
    t0 = time.perf_counter()
    out, st = correct_reads(seqs, quals=quals, device=dev, record=tm)
    sync(dev)
    wall["correct_reads_s"] = time.perf_counter() - t0
    launches = CK.canonical_window_keys.launches
    CK.canonical_window_keys.launch_shapes = None
    peak_gib = (torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda"
                else None)
    by_caller = collections.Counter()
    for (_R, _L, k, strand), n in shapes.items():
        by_caller[f"{'window_maps' if strand else 'count'} k={k}"] += n

    # -- checks ---------------------------------------------------------------
    n = r1.shape[0]
    fixed = as_codes(out, rl)
    reads, clean = np.concatenate([r1, r2]), np.concatenate([c1, c2])
    quality = correction_quality(fixed, reads, clean)
    check(len(out) == 2 * n and st.reads_total == 2 * n, "error correction lost reads")
    check(dev.type == "cpu" or (by_caller.get("count k=21", 0) > 0
                                and by_caller.get("window_maps k=21", 0) > 0),
          f"error correction: the kernel was not launched by both callers: {dict(by_caller)}")
    check(st.bases_changed == int((fixed != reads).sum()),
          "error correction: its statistics do not count the bases it changed")
    check(quality["fixed"] >= 0.8 * quality["planted"],
          f"error correction fixed {quality['fixed']} of {quality['planted']} planted "
          f"substitutions, under 80 %")
    check(quality["wrongly_changed"] <= 0.1 * quality["fixed"],
          f"error correction changed {quality['wrongly_changed']} right bases")
    steps = {k: v for k, v in tm.items() if k.endswith("_s")}
    rec = {
        "phase": "error_correction",
        "card": nvidia_smi_line() if dev.type == "cuda" else "cpu",
        "reads": 2 * n, "quality_draw": {"right": [20, 40], "planted": [2, 12]},
        "wall_s": wall, "steps_s": steps,
        # CUDA-event time of the quality sum and the vote against the pass
        "quality_and_vote_share": (sum(tm.get("quality_ms", [])) + sum(tm.get("vote_ms", [])))
        / 1e3 / max(wall["correct_reads_s"], 1e-9),
        "quality_sum_per_batch": per_batch(tm.get("quality_ms", [])),
        "vote_per_batch": per_batch(tm.get("vote_ms", [])),
        "stats": dataclasses.asdict(st), "correction": quality,
        "launches": launches, "launches_by_caller": dict(sorted(by_caller.items())),
        "peak_device_gib": peak_gib,
    }
    c1f, c2f = fixed[:n], fixed[n:]
    return rec, launches, shapes, (c1f, c2f)


# ---------------------------------------------------------------------------
# 6. assembly of the corrected isolate in careful mode
# ---------------------------------------------------------------------------

STAGE_IDS = ("construction", "ec_threshold_finder", "raw_simplification",
             "gap_closer_early", "simplification", "gap_closer_late", "contig_output")
RR_STAGE_IDS = ("pair_info_count", "distance_estimation", "repeat_resolving")


def stage_ids(k_list) -> list:
    """(k, stage id) of every stage `run_assembly(careful=True)` runs:
    mismatch correction and repeat resolution come before ContigOutput, at
    the last K only."""
    out = []
    for k in k_list:
        ids = list(STAGE_IDS)
        if k == k_list[-1]:
            ids[-1:-1] = ["mismatch_correction", *RR_STAGE_IDS]
        out += [(k, s) for s in ids]
    return out
OUTPUT_FILES = ("contigs.fasta", "scaffolds.fasta", "assembly_graph_with_scaffolds.gfa",
                "assembly_graph.fastg", "contigs.paths", "scaffolds.paths")


@contextlib.contextmanager
def after_every_stage(hook):
    """Call hook(stage, ctx) after each stage of every `StageManager` run."""
    from spades_tpu_torch.pipeline import spades_stages as S

    classes = (S.Construction, S.GenomicInfoFiller, S.RawSimplification, S.GapClosing,
               S.Simplification, S.MismatchCorrection, S.PairInfoCount,
               S.DistanceEstimation, S.RepeatResolution, S.SecondPhaseSetup,
               S.HybridAligning, S.ChromosomeRemoval, S.MetaplasmidExtraction,
               S.LoadGraph, S.ContigOutput, S.SSEdgeSplit, S.SeriesAnalysis,
               S.DomainAnalysis)
    saved = [(cls, cls.run) for cls in classes]

    def hooked(run):
        def run_then_hook(self, ctx):
            run(self, ctx)
            hook(self, ctx)
        return run_then_hook

    for cls, run in saved:
        cls.run = hooked(run)
    try:
        yield
    finally:
        for cls, run in saved:
            cls.run = run


def launches_by_caller(shapes) -> dict:
    """Launch counts of a path by what launched them, told apart by shape:
    (k+1)-mer counting runs at even k without the strand plane; at odd k
    without it, the prefilter runs over chunks of 150-base reads and the
    gap closer's count of its tip regions over rows of 456 bases or more;
    the index build and the mapper ask for the strand plane (index rows are
    256, 2,048 or 8,192 bases wide, read chunks are not)."""
    out = collections.Counter()
    for (_R, L, k, strand), n in shapes.items():
        if strand:
            who = "index_build" if L in (256, 2048, 8192) else "map_store"
        elif k % 2 == 0:
            who = "count"
        else:       # the prefilter over read chunks, or the count of the tip regions
            who = "hit_filter" if L < 256 else "tip_region_count"
        out[f"{who} k={k}"] += n
    return dict(sorted(out.items()))


def assembly_stats(contigs) -> dict:
    lens = sorted((len(c.seq) for c in contigs), reverse=True)
    total = sum(lens)
    acc, n50 = 0, 0
    for n in lens:
        acc += n
        if acc * 2 >= total:
            n50 = n
            break
    return {"contigs": len(lens), "total": total, "n50": n50,
            "longest": lens[0] if lens else 0}


def substitutions_against(seqs, genomes, anchor: int = 32, stride: int = 200,
                          with_spans: bool = False) -> list:
    """For each sequence, (the fewest substitutions that lay it onto one of
    `genomes` (uint8 codes) on either strand, the indices of the genomes that
    need that few), or (None, set()) where no anchor hits; `with_spans` adds
    a third item, the set of (genome, reverse strand, start on that strand)
    of those placements.  Anchors
    (`anchor`-mers every `stride` bases, anchor <= 32) are looked up in a
    sorted table of the genomes' k-mers, and each placement they give is
    compared in full: reads that carry substitutions only leave a contig that
    is right a few surviving ones, and one that joins two places differs in
    most bases past the joint."""
    import numpy as np

    def keys_of(codes):
        n = len(codes) - anchor + 1
        keys = np.zeros(max(n, 0), np.uint64)
        for j in range(anchor):
            keys = (keys << np.uint64(2)) | codes[j : j + n].astype(np.uint64)
        return keys

    strands, keys, where = [], [], []
    for gi, g in enumerate(genomes):
        for s in (g, (3 - g)[::-1].copy()):
            kk = keys_of(s)
            keys.append(kk)
            where.append(np.stack([np.full(len(kk), len(strands)), np.arange(len(kk))], 1))
            strands.append((gi, s))
    keys = np.concatenate(keys)
    where = np.concatenate(where)
    order = np.argsort(keys, kind="stable")
    keys, where = keys[order], where[order]
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    out = []
    for seq in seqs:
        c = lut[np.frombuffer(seq.encode(), np.uint8)]
        tried, best, hits, spans = set(), None, set(), set()
        for off in range(0, len(c) - anchor + 1, stride):
            win = c[off : off + anchor]
            if (win > 3).any():
                continue
            key = keys_of(win)[0]
            lo, hi = np.searchsorted(keys, key), np.searchsorted(keys, key, side="right")
            for si, pos in where[lo:hi]:
                start = int(pos) - off
                gi, s = strands[si]
                if (si, start) in tried or start < 0 or start + len(c) > len(s):
                    continue
                tried.add((si, start))
                d = int((s[start : start + len(c)] != c).sum())
                if best is None or d < best:
                    best, hits, spans = d, {gi}, {(gi, bool(si % 2), start)}
                elif d == best:
                    hits.add(gi)
                    spans.add((gi, bool(si % 2), start))
        out.append((best, hits, spans) if with_spans else (best, hits))
    return out


def repeat_joints(seq: str, strands, flank: int = 60):
    """Where `seq` joins pieces that each lie exactly in one of `strands`
    (the genome and its reverse complement), every joint right after `flank`
    bases that occur at least twice there: inside a copy of a repeat, where
    greedy path extension may cross to another copy's flank when the repeat
    is longer than the insert.  Returns the joints' positions, or None when a
    piece lies nowhere or a joint is not at a repeat."""
    cuts, a = [], 0
    while True:
        lo, hi = a, len(seq)           # longest seq[a:m] that lies in a strand
        while lo < hi:
            m = (lo + hi + 1) // 2
            if any(seq[a:m] in g for g in strands):
                lo = m
            else:
                hi = m - 1
        if lo == len(seq):
            return cuts
        if lo - a < flank or sum(g.count(seq[lo - flank : lo]) for g in strands) < 2:
            return None
        cuts.append(lo)
        a = lo


def lay_onto_genome(what: str, records, genome, rng, n_sample: int = 200):
    """Up to n_sample (name, sequence) records of 1 kb or more, drawn with
    `rng`, each laid onto `genome` (uint8 codes) with at most a few
    substitutions, or else cut into exact pieces of the genome that join
    inside repeats (`repeat_joints`); fails on any other.  Returns the
    number of such records and what the sample showed."""
    import numpy as np

    acgt = np.frombuffer(b"ACGT", np.uint8)
    fwd = acgt[genome].tobytes().decode()
    rev = acgt[(3 - genome)[::-1]].tobytes().decode()
    long_ = [(name, seq) for name, seq in records if len(seq) >= 1000]
    picks = rng.choice(len(long_), min(n_sample, len(long_)), replace=False)
    placed = substitutions_against([long_[i][1] for i in picks], [genome])
    subs = {long_[i][0]: d if d is not None and d <= max(2, 0.003 * len(long_[i][1]))
            else None for i, (d, _g) in zip(picks, placed)}
    joined = {long_[i][0]: repeat_joints(long_[i][1], (fwd, rev)) for i in picks
              if subs[long_[i][0]] is None}
    wrong = [name for name, cuts in joined.items() if cuts is None]
    check(not wrong, f"{len(wrong)} of {len(picks)} sampled {what} of 1 kb or more lie "
                     f"nowhere in the genome or its reverse complement, not even as "
                     f"pieces joined at repeats: {wrong[:5]}")
    placed = {n: d for n, d in subs.items() if d is not None}
    return len(long_), {"checked": len(subs), "exact": sum(d == 0 for d in placed.values()),
                        "most_substitutions": max(placed.values(), default=None),
                        "joined_at_repeats": len(joined),
                        "joints": sum(len(c) for c in joined.values()),
                        "joined_lengths": sorted(len(seq) for n, seq in long_ if n in joined)}


def check_index_against_host(name, prep, host_index, k) -> None:
    """A device-built index (`MappingEngine._device_index`) equals the host's
    `build_edge_index` of the same graph, row for row."""
    import numpy as np

    from spades_tpu_torch.core import kmers as K

    check(np.array_equal(K.keys_to_words(prep[0].T.contiguous().cpu().numpy(),
                                         K.kmer_words(k)), host_index.kmers),
          f"{name}: device-built index k-mers differ from build_edge_index")
    for col, dev_col, host_col in (("edge", prep[1], host_index.edge),
                                   ("offset", prep[2], host_index.offset),
                                   ("strand", prep[3], host_index.strand)):
        check(np.array_equal(dev_col.cpu().numpy(), host_col),
              f"{name}: device-built index {col} differs from build_edge_index")


def phase_assembly(dev, workdir: str, state, seed: int, corrected, k_list=(21, 33, 55),
                   rl: int = 150, n_sample: int = 200, total_tolerance: float = 0.02,
                   insert_mean: int = 400):
    import numpy as np
    import torch

    from spades_tpu_torch import native
    from spades_tpu_torch.alignment import mapper as MR
    from spades_tpu_torch.alignment.mapper import MappingEngine, build_edge_index
    from spades_tpu_torch.io.contigs import extract_contigs
    from spades_tpu_torch.io.gfa import read_gfa
    from spades_tpu_torch.ops import cuda_kernels as CK
    from spades_tpu_torch.ops.count import count_sequences
    from spades_tpu_torch.pipeline import spades_stages as S
    from spades_tpu_torch.pipeline import stages as ST
    from spades_tpu_torch.pipeline.run import run_assembly

    check(native.lib() is not None,
          "the native library did not load: simplification would take the numpy loop")
    genome, (r1, r2) = state["genome"], corrected
    k_last = k_list[-1]
    lefts, rights = list(r1), list(r2)
    per_stage = {}
    simplified = {}
    # the (k+1)-mers of the corrected reads through the ReadBatch path, for the
    # construction at k=55 (which counts them through the ReadStore path)
    t0 = time.perf_counter()
    p1_k55 = count_sequences(lefts + rights, 56, device=dev)
    simplified["direct_count_k56_s"] = time.perf_counter() - t0

    def hook(stage, ctx):
        t_hook = time.perf_counter()
        g = ctx.graph
        g.check_invariants()
        graph_checks(f"k={ctx.k} {stage.id}", g)
        row = per_stage[f"k={ctx.k} {stage.id}"] = {
            "edge_pairs": int(len(g.canonical_edge_ids())),
            "launches": CK.canonical_window_keys.launches,     # running total
        }
        if stage.id == "construction" and ctx.k == 55:
            # prev-K contigs only add zero-count structure rows: the
            # read-counted rows are exactly the ReadBatch path's table
            p1, ref = ctx.p1_counts, p1_k55
            nz = p1.counts > 0
            check(np.array_equal(p1.words[nz], ref.words)
                  and np.array_equal(p1.counts[nz], ref.counts),
                  "k=55: the ReadStore and ReadBatch paths counted differently")
            simplified["structure_rows_k55"] = int((~nz).sum())
        if stage.id == "gap_closer_late" and ctx.k == k_last and ctx._me is not None:
            # the closer's own engine on the simplified graph, where it mapped
            simplified["index_in_run"] = dict(ctx._me.index_timings)
        # this check's own seconds, which `STAGE_TIMES` counts into the stage
        row["check_s"] = time.perf_counter() - t_hook

    # -- the assembly path: launch counts from 0, read right after -----------
    ST.STAGE_TIMES.clear()
    S.CONSTRUCT_PHASES.clear()
    S.GAP_CLOSER_STATS.clear()
    S.RR_STATS.clear()
    S.MISMATCH_STATS.clear()
    MR.RESIDUE_STATS.clear()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    CK.canonical_window_keys.launches = 0
    CK.canonical_window_keys.launch_shapes = collections.Counter()
    out = os.path.join(workdir, "assembly")
    t0 = time.perf_counter()
    with after_every_stage(hook):
        res = run_assembly(lefts + rights, list(k_list), out, paired_libs=[(lefts, rights)],
                           read_length=rl, device=dev, checkpoints="none", careful=True)
    sync(dev)
    wall_s = time.perf_counter() - t0
    launches = CK.canonical_window_keys.launches
    shapes = CK.canonical_window_keys.launch_shapes
    CK.canonical_window_keys.launch_shapes = None
    peak_gib = (torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda"
                else None)

    # -- the index of the simplified graph: built on the device, it must use the
    # upper row tiers and equal the host build (PairInfoCount mapped every read
    # onto it in the run) ------------------------------------------------------
    engine = MappingEngine(res.graph, device=dev)
    t0 = time.perf_counter()
    engine._device_index()
    sync(dev)
    simplified["index_build_s"] = time.perf_counter() - t0
    simplified["index"] = dict(engine.index_timings)
    t0 = time.perf_counter()
    check_index_against_host(f"k={k_last} simplified graph", engine._device_index(),
                             build_edge_index(res.graph, k_last), k_last)
    simplified["host_index_check_s"] = time.perf_counter() - t0
    engine.release()

    # -- checks ---------------------------------------------------------------
    check(launches > 0 or dev.type == "cpu",
          "assembly: the canonical-windows kernel was not launched")
    check([(k, s) for k, s, _ in ST.STAGE_TIMES] == stage_ids(k_list),
          f"assembly: the stages that ran are {[(k, s) for k, s, _ in ST.STAGE_TIMES]}")
    check(len(per_stage) == len(stage_ids(k_list)), "assembly: a stage was not checked")
    check([k for k, _n in S.MISMATCH_STATS] == [k_last],
          f"assembly: mismatch correction ran at {S.MISMATCH_STATS}, not once at k={k_last}")
    rr = {s: st for _k, s, st in S.RR_STATS}
    check(list(rr) == list(RR_STAGE_IDS) and len(S.RR_STATS) == 3,
          f"assembly: repeat-resolution records {[s for _, s, _ in S.RR_STATS]}")
    pic = rr["pair_info_count"]
    check(abs(pic["is_median"] - insert_mean) <= 30,
          f"insert-size median {pic['is_median']}, not within 30 of {insert_mean}")
    check(pic["mapped_both"] >= 0.97 * pic["pairs"],
          f"only {pic['mapped_both']} of {pic['pairs']} pairs map with both mates")
    check(rr["distance_estimation"]["improved_entries"] > 0, "the paired index is empty")
    check(rr["repeat_resolving"]["paths"] > 0 and len(res.scaffolds) > 0,
          "repeat resolution made no path")
    tier_rows = simplified.get("index", {}).get("tier_rows", {})
    check(simplified.get("index", {}).get("index_rows", 0) > 0,
          "the index of the simplified graph was not built on the device")
    for tier in (2048, 8192):
        check(tier_rows.get(tier, 0) > 0,
              f"the {tier}-base index tier got no row on the simplified k={k_last} graph")
    stats = assembly_stats(res.contigs)
    before_rr = assembly_stats(extract_contigs(res.graph))   # the graph's edges as contigs
    check(abs(stats["total"] - len(genome)) <= total_tolerance * len(genome),
          f"contigs total {stats['total']} nt, not within {total_tolerance:.0%} of the "
          f"genome's {len(genome)}")
    rng = np.random.default_rng(seed)
    n_long, contig_check = lay_onto_genome("contigs", [(c.name, c.seq) for c in res.contigs],
                                           genome, rng, n_sample)
    check(n_long > 0, "assembly: no contig of 1 kb or more")
    broken_path = os.path.join(out, "misc", "broken_scaffolds.fasta")
    broken = {"file": os.path.exists(broken_path), "pieces_1kb": 0}
    if broken["file"]:
        from spades_tpu_torch.io.fastx import read_fastx

        broken["pieces_1kb"], broken["check"] = lay_onto_genome(
            "broken scaffolds", [(r.name, r.seq) for r in read_fastx(broken_path)], genome,
            rng, n_sample)
    n_gapped = sum(1 for sc in res.scaffolds if "N" in sc.seq)
    for sub in ("", f"K{k_last}"):
        for name in OUTPUT_FILES:
            path = os.path.join(out, sub, name)
            check(os.path.exists(path) and os.path.getsize(path) > 0, f"{path} is missing")
    parsed = read_gfa(os.path.join(out, "assembly_graph_with_scaffolds.gfa"))
    check(len(parsed.segments) == len(res.graph.canonical_edge_ids()),
          "read_gfa: the segments read back are not the graph's edge pairs")
    check(len(parsed.paths) == len(res.scaffolds),
          "read_gfa: the paths read back are not the scaffolds")

    rec = {
        "phase": "assembly",
        "card": nvidia_smi_line() if dev.type == "cuda" else "cpu",
        "input": "the corrected reads of phase 5", "careful": True,
        "k_list": list(k_list), "reads": int(2 * r1.shape[0]), "wall_s": wall_s,
        "mismatch_correction_fixed": [n for _k, n in S.MISMATCH_STATS],
        "stage_times": {f"k={k} {s}": t for k, s, t in ST.STAGE_TIMES},
        "construction": {f"k={k}": tm for k, tm in S.CONSTRUCT_PHASES},
        "gap_closer": {f"k={k} {s}": st for k, s, st in S.GAP_CLOSER_STATS},
        "repeat_resolution": rr,
        "residue_pass": list(MR.RESIDUE_STATS),
        "per_stage": per_stage,
        "simplified_graph": simplified,
        "launches": launches,
        "launches_by_caller": launches_by_caller(shapes),
        "peak_device_gib": peak_gib,
        "contig_stats": stats, "contig_stats_before_rr": before_rr,
        "scaffold_stats": assembly_stats(res.scaffolds), "scaffolds_with_n": n_gapped,
        "broken_scaffolds": broken, "contigs_1kb": n_long, "contigs_check": contig_check,
        "gfa_segments": len(parsed.segments),
    }
    return rec, launches, shapes


# ---------------------------------------------------------------------------
# 7. error correction, gap closing, careful mode and repeat resolution, card
#    against CPU; the device programs against their plain versions
# ---------------------------------------------------------------------------

RR_SAVES = (("pair_info_count", "raw_pairs_0.npz"), ("distance_estimation", "paired_index.npz"),
            ("distance_estimation", "scaffold_index.npz"))
RR_FILES = ("contigs.fasta", "scaffolds.fasta", "contigs.paths", "scaffolds.paths")


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


# the card's coverage fit (graph/coverage_model.py:fit_coverage_model) differs
# from the host's in its float fields, and a checkpoint keeps its mean: in the
# last digits, or where the EM's stopping round hangs on them further (phase
# 19's mate-pair run at K = 33: 1.96e-3 relative, the integer fields equal;
# scipy orders tied vertices otherwise than the kernel's stable sort)
FIT_MEAN_RTOL = 1e-2


def same_output(a: str, b: str) -> bool:
    """The two files are equal; a checkpoint's state.json as JSON, its
    coverage fit's `estimated_mean` within FIT_MEAN_RTOL, the rest exact."""
    if os.path.basename(a) != "state.json":
        return read_bytes(a) == read_bytes(b)
    with open(a) as fa, open(b) as fb:
        sa, sb = json.load(fa), json.load(fb)
    ga, gb = sa.pop("genomic_info", {}), sb.pop("genomic_info", {})
    ma, mb = ga.pop("estimated_mean", 0.0), gb.pop("estimated_mean", 0.0)
    return sa == sb and ga == gb and abs(ma - mb) <= FIT_MEAN_RTOL * abs(mb)


def phase_programs(dev, seqs, quals, graph, k: int, batch: int = 8192,
                   vote_reads: int = 65536) -> dict:
    """Each device program of error correction and careful mode against its
    plain numpy version on the same inputs, on the card, at the batch shapes
    the main path gives it, tolerance 0 (integer work, and float32 sums
    taken in the plain version's order), with the time of each: CUDA events
    for the device program, the host clock for the plain version."""
    import numpy as np
    import torch

    from spades_tpu_torch.alignment.mapper import build_edge_index
    from spades_tpu_torch.core import kmers as K
    from spades_tpu_torch.core.reads import ReadBatch
    from spades_tpu_torch.hammer import bayes as B
    from spades_tpu_torch.hammer import hammer as H
    from spades_tpu_torch.hammer.clustering import cluster_kmers
    from spades_tpu_torch.ops.count import count_sequences, unpack_batch_device
    from spades_tpu_torch.parallel import sharded_mapping as SM
    from spades_tpu_torch.tools.kernel_shapes import time_ms

    def host_ms(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3

    rec = {}
    vote_seqs = seqs[:vote_reads]
    clean = [s.upper().replace("N", "A") for s in seqs]
    kc = count_sequences(clean, 21, device=dev)
    # two batches of the main path's shape against the whole table
    seqs, quals, clean = seqs[: 2 * batch], quals[: 2 * batch], clean[: 2 * batch]
    maps = H.build_window_maps(seqs, kc.words, 21, batch, device=dev)
    plain, plain_ms = host_ms(lambda: H.build_window_maps_plain(seqs, kc.words, 21, batch))
    err = 0
    for (_b, _n, i, pr, rc), (_pb, _pn, pi, pp, prc) in zip(maps, plain):
        pr = pr.cpu().numpy()
        err += int((pr != pp).sum() + (i.cpu().numpy()[pr] != pi[pp]).sum()
                   + (rc.cpu().numpy()[pr] != prc[pp]).sum())
    check(err == 0, f"window maps: card and plain version differ in {err} places")
    rec["window_maps"] = {"batches": len(maps), "max_abs_err": err,
                          "ms": time_ms(lambda: H.build_window_maps(seqs, kc.words, 21, batch,
                                                                    device=dev), dev, 2),
                          "plain_ms": plain_ms}

    kq = B.accumulate_quality(kc, clean, quals, 21, maps=maps)
    kq_plain, plain_ms = host_ms(lambda: B.accumulate_quality_plain(kc, quals, 21, plain))
    diff = int((kq.pos_log_err.view(np.uint32) != kq_plain.pos_log_err.view(np.uint32)).sum())
    check(diff == 0, f"quality sum: card and plain version differ in {diff} float32 bits")
    rec["quality_sum"] = {"batches": len(maps), "max_abs_err": diff,
                          "ms": time_ms(lambda: B.accumulate_quality(kc, clean, quals, 21,
                                                                     maps=maps), dev, 2),
                          "plain_ms": plain_ms}

    solid0 = kc.counts >= 10
    got, rounds = B.expand_solid(kc, solid0, clean, 21, 8, maps=maps)
    (ref, rref), plain_ms = host_ms(lambda: B.expand_solid_plain(solid0, 21, plain, 8))
    diff = int((got != ref).sum()) + abs(rounds - rref)
    check(diff == 0, f"solid-set expansion: card and plain version differ ({diff})")
    rec["expand_solid"] = {"rounds": rounds, "max_abs_err": diff,
                           "ms": time_ms(lambda: B.expand_solid(kc, solid0, clean, 21, 8,
                                                                maps=maps), dev, 2),
                           "plain_ms": plain_ms}

    labels = cluster_kmers(kc.words, 21)
    centers, _tot = H._cluster_centers(kc.words, kc.counts, labels)
    center_idx = centers[labels]
    good_k = kc.counts[center_idx] >= 3
    b, _n, idx, present, use_rc = maps[0]
    ccodes = K.unpack(kc.words, 21)
    safe = torch.where(idx >= 0, idx, 0).to(torch.int64)
    cidx = torch.from_numpy(center_idx).to(dev)[safe]
    good = present & torch.from_numpy(good_k).to(dev)[safe]
    args = (torch.from_numpy(b.codes).to(dev), torch.from_numpy(ccodes).to(dev), cidx, use_rc,
            good, 21, 0.5)
    out, win = H._vote_correct_batch(*args)
    oriented = ccodes[cidx.cpu().numpy()]
    oriented = np.where(use_rc.cpu().numpy()[..., None], 3 - oriented[:, :, ::-1],
                        oriented).astype(np.uint8)
    (pout, pwin), plain_ms = host_ms(lambda: H._vote_correct_batch_plain(
        b.codes, oriented, good.cpu().numpy(), 21, 0.5))
    diff = int((out.cpu().numpy() != pout).sum() + (win.cpu().numpy() != pwin).sum())
    check(diff == 0, f"vote: card and plain version differ in {diff} places")
    rec["vote"] = {"reads": int(b.codes.shape[0]), "L": int(b.codes.shape[1]),
                   "max_abs_err": diff, "ms": time_ms(lambda: H._vote_correct_batch(*args),
                                                      dev, 5),
                   "plain_ms": plain_ms, "changed": int((pout != b.codes).sum())}

    # the vote scatter of careful mode, on the graph the assembly polished
    index = build_edge_index(graph, k)
    prep = SM.prepare_index_device(index, graph, dev)
    rb = ReadBatch.from_sequences(vote_seqs)
    pc, pn, lengths, L = rb.packed()
    pc, pn, lengths = (torch.from_numpy(np.asarray(a)).to(dev) for a in (pc, pn, lengths))
    e_off = torch.from_numpy(np.ascontiguousarray(graph.e_off, np.int32)).to(dev)
    pool = len(graph.seq_pool)
    votes = SM._votes_shard_body(pc, pn, lengths, *prep, e_off, k=k, L=L, pool_len=pool)
    edge, start, _v = SM._map_shard_body(pc, pn, lengths, *prep, k=k, L=L)
    codes, n_mask = unpack_batch_device(pc, pn, L)
    pv, plain_ms = host_ms(lambda: SM.votes_plain(
        codes.cpu().numpy(), n_mask.cpu().numpy(), lengths.cpu().numpy(), edge.cpu().numpy(),
        start.cpu().numpy(), graph.e_len, graph.e_off, pool))
    diff = int((votes.cpu().numpy() != pv).sum())
    check(diff == 0 and pv.sum() > 0, f"vote scatter: card and plain version differ in {diff}")
    rec["vote_scatter"] = {"reads": int(pc.shape[0]), "L": int(L), "pool": pool,
                           "max_abs_err": diff,
                           "ms": time_ms(lambda: SM._votes_shard_body(
                               pc, pn, lengths, *prep, e_off, k=k, L=L, pool_len=pool), dev, 5),
                           "map_ms": time_ms(lambda: SM._map_shard_body(
                               pc, pn, lengths, *prep, k=k, L=L), dev, 5),
                           "plain_ms": plain_ms, "votes": int(pv.sum())}
    return rec


# the gap set's depth: cut from 40x to 30x so that the script with phase 17
# ends its last phase by 1,150 s (at 40x: 1,159.1 s on an H100 at 700 W)
GAP_COVERAGE = 30


def phase_gap(dev, workdir: str, seed: int, genome_size: int = 300_000,
              coverage: int = GAP_COVERAGE,
              n_gaps: int = 30, k: int = 55, rl: int = 150):
    import numpy as np
    import torch

    from spades_tpu_torch.alignment import mapper as MR
    from spades_tpu_torch.hammer import correct_reads
    from spades_tpu_torch.ops import cuda_kernels as CK
    from spades_tpu_torch.pipeline import spades_stages as S
    from spades_tpu_torch.pipeline.run import run_assembly
    from spades_tpu_torch.tools import synthetic

    genome, r1, r2, gaps, c1, c2 = synthetic.make_gapped_dataset(
        genome_size, coverage, rl, 0.003, seed + 1, n_gaps, truth=True)
    q1, q2 = (synthetic.error_qualities(r, c, seed + 21 + i)
              for i, (r, c) in enumerate(((r1, c1), (r2, c2))))
    seqs, quals = read_strings(r1) + read_strings(r2), as_strings(q1) + as_strings(q2)
    n = r1.shape[0]
    results = {}
    shapes_ec, shapes = collections.Counter(), collections.Counter()
    launches = 0
    wall = {}
    for where in (dev, torch.device("cpu")):
        if where.type in results:        # a CPU rehearsal: one run is both
            continue
        S.GAP_CLOSER_STATS.clear()
        S.RR_STATS.clear()
        S.MISMATCH_STATS.clear()
        MR.RESIDUE_STATS.clear()
        out = os.path.join(workdir, f"gap_{where.type}")
        if where == dev:
            # -- the gap path: launch counts from 0, read right after ---------
            CK.canonical_window_keys.launches = 0
            CK.canonical_window_keys.launch_shapes = shapes_ec
        # with the qualities (the quality-aware path), then without them: the
        # CLI reads FASTQ with the native parser, which keeps no qualities (as
        # the JAX package's), so the assembly and the CLI take the count-only
        # path's reads
        tm = {}
        t0 = time.perf_counter()
        with_q = correct_reads(seqs, quals=quals, device=where, record=tm)
        sync(where)
        wall[f"{where.type}_correct_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fixed, st = correct_reads(seqs, device=where)
        sync(where)
        wall[f"{where.type}_correct_count_only_s"] = time.perf_counter() - t0
        if where == dev:
            CK.canonical_window_keys.launch_shapes = shapes
        lefts, rights = fixed[:n], fixed[n:]
        t0 = time.perf_counter()
        res = run_assembly(lefts + rights, [k], out, paired_libs=[(lefts, rights)],
                           read_length=rl, device=where, checkpoints="all", careful=True)
        sync(where)
        wall[f"{where.type}_assembly_s"] = time.perf_counter() - t0
        if where == dev:
            launches = CK.canonical_window_keys.launches
            CK.canonical_window_keys.launch_shapes = None
        saves = {f"{st_}/{f}": np.load(os.path.join(out, f"K{k}", "saves", st_, f))
                 for st_, f in RR_SAVES + (("mismatch_correction", "graph.npz"),)}
        files = {f: read_bytes(os.path.join(out, f)) for f in RR_FILES}
        results[where.type] = (res, files, [(s, dict(st_)) for _, s, st_ in S.GAP_CLOSER_STATS],
                               saves, {s: dict(st_) for _, s, st_ in S.RR_STATS}, out,
                               (with_q, (fixed, st), tm, list(S.MISMATCH_STATS)),
                               list(MR.RESIDUE_STATS))

    got = results[dev.type]
    ref = results["cpu"]
    closed = sum(st_["closed"] for _, st_ in got[2])
    (with_q, (fixed, st), tm, mm), (rwith_q, rcount, rtm, rmm) = got[6], ref[6]
    check(launches > 0 or dev.type == "cpu",
          "gap phase: the canonical-windows kernel was not launched")
    check(with_q == rwith_q and (fixed, st) == rcount,
          "gap phase: device and CPU corrected the reads differently")
    check(np.array_equal(tm["labels"], rtm["labels"]),
          "gap phase: device and CPU cluster labels differ")
    check(tm["pos_log_err"].view(np.uint32).tobytes() == rtm["pos_log_err"].view(np.uint32).tobytes(),
          "gap phase: device and CPU quality sums differ in their float32 bits")
    check(mm == rmm and len(mm) == 1, f"gap phase: mismatch correction {mm} against {rmm}")
    check(closed > 0, "gap phase: the gap closer closed no gap")
    check([(s, st_["candidates"], st_["closed"]) for s, st_ in got[2]]
          == [(s, st_["candidates"], st_["closed"]) for s, st_ in ref[2]],
          "gap phase: candidates or closed gaps differ between the device and the CPU")
    for f in GRAPH_FIELDS:
        check(np.array_equal(getattr(got[0].graph, f), getattr(ref[0].graph, f)),
              f"gap phase: device and CPU graphs differ in {f}")
    for name, z in got[3].items():
        for col in z.files:
            check(z[col].dtype == ref[3][name][col].dtype
                  and np.array_equal(z[col], ref[3][name][col]),
                  f"gap phase: device and CPU {name} differ in {col}")
    for name, data in got[1].items():
        check(data == ref[1][name], f"gap phase: device and CPU {name} differ")
    check(len(got[0].scaffolds) > 0, "gap phase: repeat resolution made no scaffold")
    got[0].graph.check_invariants()
    quality = {name: correction_quality(as_codes(out_, rl), np.concatenate([r1, r2]),
                                        np.concatenate([c1, c2]))
               for name, out_ in (("with_qualities", with_q[0]), ("count_only", fixed))}
    t0 = time.perf_counter()
    programs = phase_programs(dev, seqs, quals, got[0].graph, k)
    wall["programs_s"] = time.perf_counter() - t0

    ec_callers = collections.Counter()
    for (_R, _L, kk, strand), cnt in shapes_ec.items():
        ec_callers[f"{'hammer window_maps' if strand else 'hammer count'} k={kk}"] += cnt
    rec = {
        "phase": "gap_closing",
        "card": nvidia_smi_line() if dev.type == "cuda" else "cpu",
        "dataset": {"genome_nt": genome_size, "coverage": coverage, "read_len": rl,
                    "pairs": int(n), "planted_gaps": int(len(gaps)),
                    "overlaps": [int(gaps[:, 1].min()), int(gaps[:, 1].max())],
                    "seed": seed + 1},
        "k": k, "careful": True, "wall_s": wall, "closed": closed,
        "error_correction": {"stats": {"with_qualities": dataclasses.asdict(with_q[1]),
                                       "count_only": dataclasses.asdict(st)},
                             "correction": quality,
                             "steps_s": {kk: v for kk, v in tm.items() if kk.endswith("_s")}},
        "mismatch_correction_fixed": [c for _k, c in mm],
        "gap_closer": {s: st_ for s, st_ in got[2]},
        "repeat_resolution": got[4],
        "residue_pass": got[7],
        "index_entries": {name: int(z["e1"].shape[0]) for name, z in got[3].items()
                          if "e1" in z.files},
        "contig_stats": assembly_stats(got[0].contigs),
        "scaffold_stats": assembly_stats(got[0].scaffolds),
        "device_programs": programs,
        "launches": launches,
        "launches_by_caller": {**dict(sorted(ec_callers.items())), **launches_by_caller(shapes)},
    }
    shapes.update(shapes_ec)
    return rec, launches, shapes, {"r1": r1, "r2": r2, "q1": q1, "q2": q2, "k": k,
                                   "out": got[5], "fixed": fixed, "genome": genome}


# ---------------------------------------------------------------------------
# 8. the CLI in a subprocess, against the library call
# ---------------------------------------------------------------------------

def phase_cli(dev, workdir: str, gap_state, timeout_s: int = 900):
    """`python -m spades_tpu_torch.pipeline.main -k 55 --careful` (the
    default path: error correction first) on the gap dataset written as
    FASTQ with its qualities: its corrected reads, contigs and scaffolds must
    equal the in-process run's.  The CLI logs how often it launched the
    kernel (a process of its own counts from 0)."""
    import re

    from spades_tpu_torch.io.fastx import read_fastx
    from spades_tpu_torch.tools import synthetic

    paths = [os.path.join(workdir, "cli_1.fq"), os.path.join(workdir, "cli_2.fq")]
    synthetic.write_fastq(paths[0], gap_state["r1"], 1, gap_state["q1"])
    synthetic.write_fastq(paths[1], gap_state["r2"], 2, gap_state["q2"])
    out = os.path.join(workdir, "cli")
    cmd = [sys.executable, "-m", "spades_tpu_torch.pipeline.main", "-1", paths[0],
           "-2", paths[1], "-k", str(gap_state["k"]), "--careful", "-o", out]
    if dev.type == "cpu":
        cmd += ["--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True, text=True,
                          timeout=timeout_s)
    wall_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"the CLI exited with {proc.returncode}: {proc.stderr[-2000:]}")
    n = gap_state["r1"].shape[0]
    for mate, want in ((1, gap_state["fixed"][:n]), (2, gap_state["fixed"][n:])):
        got = [r.seq for r in read_fastx(os.path.join(out, "corrected", f"lib1_{mate}.cor.fasta"))]
        check(got == want, f"CLI: its corrected reads of mate {mate} differ from the "
                           f"library call's")
    for name in ("contigs.fasta", "scaffolds.fasta"):
        check(read_bytes(os.path.join(out, name))
              == read_bytes(os.path.join(gap_state["out"], name)),
              f"CLI: {name} differs from the library call's")
    with open(os.path.join(out, "spades.log")) as fh:
        log_text = fh.read()
    found = re.findall(r"kernel launches: canonical_windows=(\d+)", log_text)
    check(len(found) == 1, "CLI: its log does not say how often it launched the kernel")
    check("Mismatch Correction" in log_text, "CLI: careful mode did not run")
    launches = int(found[0])
    check(launches > 0 or dev.type == "cpu", "CLI: the canonical-windows kernel was not launched")
    em_found = re.findall(r"kernel launches: canonical_windows=\d+ coverage_em=(\d+)", log_text)
    check(len(em_found) == 1, "CLI: its log does not say how often it launched the coverage EM")
    em_launches = int(em_found[0])
    check(em_launches > 0 or dev.type == "cpu", "CLI: the coverage EM kernel was not launched")
    with open(os.path.join(out, "run_spades.yaml")) as fh:
        yaml_lines = fh.read().count("\n")
    gap_state["cli_fastq"], gap_state["cli_out"] = paths, out     # phase 18's CLI run
    return {"phase": "cli", "card": nvidia_smi_line() if dev.type == "cuda" else "cpu",
            "command": " ".join(os.path.relpath(c, workdir) if c.startswith(workdir) else c
                                for c in cmd[1:]),
            "wall_s": wall_s,
            "launches": launches, "coverage_em_launches": em_launches,
            "run_spades_yaml_lines": yaml_lines,
            "residue_pass": residue_lines(log_text)}, launches


def residue_lines(log_text: str) -> list:
    """The `map_store` lines of a run's log (`alignment/mapper.py`): per
    mapping pass given a kmer-mapper, its reads, where they mapped, and what
    the kmer-mapper residue pass re-ran and recovered."""
    import re

    return [{"reads": int(n), "on": on, "unmapped": int(u), "rerun": int(r),
             "recovered": int(c)}
            for n, on, u, r, c in re.findall(
                r"map_store: (\d+) reads on the (\w+), (\d+) unmapped there; kmer-mapper "
                r"residue pass re-ran (\d+), recovered (\d+)", log_text)]


# ---------------------------------------------------------------------------
# 9-12. metaSPAdes, long reads, the other modes, and their CPU runs
# ---------------------------------------------------------------------------

# the mock community of phase 9: four genomes (nt) at four depths, the two
# largest sharing one 5 kb segment (at lower depths the checks fail: halved,
# raw-read contigs of the shallow genomes carry more substitutions than the
# placement check allows; the deepest alone at 30x, its contigs join the
# second genome's at the shared segment)
META_SIZES = (2_000_000, 1_500_000, 1_000_000, 500_000)
META_COVERAGES = (60, 25, 12, 6)
META_RR_IDS = ("pair_info_count_preliminary", "distance_estimation_preliminary",
               "repeat_resolving_preliminary", "second_phase_setup", *RR_STAGE_IDS)
MODES = ("plasmid", "metaplasmid", "metaviral", "sc", "sewage")
# the card-against-CPU sets of phases 9-11 are small: below these device
# thresholds their mapping would take the host path on both sides, so both
# take the device path (the card's kernels, the CPU's plain versions)
SMALL_SET_ENV = {"SPADES_DEVICE_MAP_READS": "1", "SPADES_DEVICE_INDEX_POOL": "1"}
SMALL_SIZES = {"meta_total": 300_000, "gap_genome": 300_000, "gap_count": 30,
               "chromosome": 100_000, "plasmids": [5_000, 12_000, 30_000]}
GFA_NAME = "assembly_graph_with_scaffolds.gfa"


@contextlib.contextmanager
def environment(values: dict):
    """Set environment variables for the duration of the block."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def hybrid_long_reads(genome, seed: int) -> list:
    """Long reads of the gap set's genome: 8x of 10 +- 2 kb reads with 10 %
    errors (4 % substitutions, 3 % insertions, 3 % deletions)."""
    from spades_tpu_torch.tools import synthetic

    return synthetic.sample_long_reads(genome, 8, 10_000, 2_000, 0.04, 0.03, 0.03, seed + 5)


def small_runs(seed: int, sizes: dict, gfa=None):
    """The runs that phases 9-11 make on the card and the CPU worker makes on
    the CPU, from the seed alone: (name, k_list, reads, run_assembly keyword
    arguments, extra) for the 300 kb community in meta mode, the gap set
    with long reads, the gap set from `gfa` (phase 7's graph), and the
    plasmid set in each of `MODES`."""
    from spades_tpu_torch.tools import synthetic

    rl = 150
    scaled = [s * sizes["meta_total"] // sum(META_SIZES) for s in META_SIZES]
    _g, r1, r2, _o = synthetic.make_community(scaled, META_COVERAGES, rl, 0.003, seed + 4)
    lefts, rights = list(r1), list(r2)
    yield ("meta", [21, 33, 55], lefts + rights,
           dict(mode="meta", paired_libs=[(lefts, rights)], read_length=rl), {"genomes": scaled})
    genome, r1, r2, _gaps = synthetic.make_gapped_dataset(
        sizes["gap_genome"], GAP_COVERAGE, rl, 0.003, seed + 1, sizes["gap_count"])
    lefts, rights = read_strings(r1), read_strings(r2)
    longs = hybrid_long_reads(genome, seed)
    yield ("hybrid", [55], lefts + rights,
           dict(paired_libs=[(lefts, rights)], read_length=rl, long_reads=longs),
           {"long_reads": len(longs), "long_read_nt": sum(map(len, longs))})
    if gfa:
        yield ("assembly_graph", [55], lefts + rights,
               dict(paired_libs=[(lefts, rights)], read_length=rl, assembly_graph=gfa), {})
    chrom, plas, r1, r2 = synthetic.make_plasmid_dataset(
        sizes["chromosome"], 40, sizes["plasmids"], (3, 5, 8), rl, 0.003, seed + 6)
    lefts, rights = list(r1), list(r2)
    for mode in MODES:
        yield (mode, [55], lefts + rights,
               dict(mode=mode, paired_libs=[(lefts, rights)], read_length=rl),
               {"chromosome": chrom, "plasmids": plas})


def run_small(name, k_list, reads, kw, out, where) -> dict:
    """One run of `small_runs` on `where`, with its trails."""
    from spades_tpu_torch.pipeline import spades_stages as S
    from spades_tpu_torch.pipeline import stages as ST
    from spades_tpu_torch.pipeline.run import run_assembly

    for trail in (ST.STAGE_TIMES, S.GAP_CLOSER_STATS, S.RR_STATS, S.MODE_STATS):
        trail.clear()
    t0 = time.perf_counter()
    with environment(SMALL_SET_ENV):
        res = run_assembly(reads, list(k_list), out, device=where, checkpoints="none", **kw)
    sync(where)
    return {"wall_s": time.perf_counter() - t0, "contigs": len(res.contigs),
            "stages": [[k, s] for k, s, _ in ST.STAGE_TIMES],
            "gap_closer": [[k, s, st["candidates"], st["closed"]]
                           for k, s, st in S.GAP_CLOSER_STATS],
            "rr": [[k, s, {kk: v for kk, v in st.items() if not kk.endswith("_s")
                           and kk != "index_timings"}] for k, s, st in S.RR_STATS],
            "modes": [[k, s, {kk: v for kk, v in st.items() if not kk.endswith("_s")}]
                      for k, s, st in S.MODE_STATS],
            "stage_times": [[k, s, t] for k, s, t in ST.STAGE_TIMES]}


def cpu_worker(workdir: str, seed: int, sizes: dict, gfa) -> int:
    """The CPU side of phases 9-11 (`--cpu-worker`): every run of
    `small_runs` on the CPU into `workdir/<name>`, its trails into
    `workdir/<name>.json`."""
    import torch

    torch.set_num_threads(4)          # the card's phases share the host
    for name, k_list, reads, kw, _extra in small_runs(seed, sizes, gfa):
        rec = run_small(name, k_list, reads, kw, os.path.join(workdir, name),
                        torch.device("cpu"))
        with open(os.path.join(workdir, f"{name}.json"), "w") as fh:
            json.dump(rec, fh)
    return 0


def start_cpu_worker(workdir: str, seed: int, sizes: dict, gfa):
    out = os.path.join(workdir, "cpu_side")
    os.makedirs(out)
    log = open(os.path.join(workdir, "cpu_worker.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-worker", out, "--seed", str(seed),
         "--sizes", json.dumps(sizes), "--gfa", gfa or ""],
        cwd=HERE, stdout=log, stderr=subprocess.STDOUT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    return proc, out, log


def files_under(root: str) -> set:
    return {os.path.relpath(os.path.join(d, n), root)
            for d, _dirs, names in os.walk(root) for n in names}


def stage_launches_hook(per_stage: dict):
    """A hook for `after_every_stage`: graph invariants after each stage,
    and the kernel's launches the stage made."""
    from spades_tpu_torch.ops import cuda_kernels as CK

    last = [CK.canonical_window_keys.launches]

    def hook(stage, ctx):
        g = ctx.graph
        g.check_invariants()
        graph_checks(f"k={ctx.k} {stage.id}", g)
        n = CK.canonical_window_keys.launches
        per_stage[f"k={ctx.k} {stage.id}"] = n - last[0]
        last[0] = n
    return hook


def phase_meta(dev, workdir: str, seed: int, small_sizes: dict, sizes=META_SIZES,
               coverages=META_COVERAGES, k_list=(21, 33, 55), rl: int = 150):
    """metaSPAdes at full width: the mock community's raw reads through
    `run_assembly(mode="meta")` (`--only-assembler`): counting at every K,
    the gap closers, the preliminary PairInfoCount, DistanceEstimation and
    RepeatResolution, SecondPhaseSetup (the preliminary contigs aligned as
    trusted paths), then the main pass mapping every read again."""
    import numpy as np
    import torch

    from spades_tpu_torch.graph import simplify as SIMP
    from spades_tpu_torch.ops import cuda_kernels as CK
    from spades_tpu_torch.pipeline import spades_stages as S
    from spades_tpu_torch.pipeline import stages as ST
    from spades_tpu_torch.pipeline.run import run_assembly
    from spades_tpu_torch.tools import synthetic

    wall = {}
    t0 = time.perf_counter()
    genomes, r1, r2, origin = synthetic.make_community(sizes, coverages, rl, 0.003, seed + 3)
    wall["make_data_s"] = time.perf_counter() - t0
    lefts, rights = list(r1), list(r2)
    per_stage = {}
    for trail in (ST.STAGE_TIMES, S.CONSTRUCT_PHASES, S.GAP_CLOSER_STATS, S.RR_STATS,
                  S.MODE_STATS):
        trail.clear()
    # -- the meta path: launch counts from 0, read right after ----------------
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    CK.canonical_window_keys.launches = 0
    shapes = CK.canonical_window_keys.launch_shapes = collections.Counter()
    SIMP.ENGINE_RUNS.update(native=0, numpy=0)
    out = os.path.join(workdir, "meta")
    t0 = time.perf_counter()
    with after_every_stage(stage_launches_hook(per_stage)):
        res = run_assembly(lefts + rights, list(k_list), out, mode="meta",
                           paired_libs=[(lefts, rights)], read_length=rl, device=dev,
                           checkpoints="none")
    sync(dev)
    wall["run_assembly_s"] = time.perf_counter() - t0
    launches = CK.canonical_window_keys.launches
    CK.canonical_window_keys.launch_shapes = None
    engines = dict(SIMP.ENGINE_RUNS)
    # meta's relative-coverage flanking takes Simplification off the native
    # engine onto the numpy loop (`graph/simplify.py:simplify`); the raw
    # pass, without it, stays native
    check(engines == {"native": len(k_list), "numpy": len(k_list)},
          f"meta: simplification ran {engines}, not the numpy loop once per K")
    peak_gib = (torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda"
                else None)

    k_last = k_list[-1]
    ran = [(k, s) for k, s, _ in ST.STAGE_TIMES]
    want = [(k, s) for k, s in stage_ids(k_list) if s != "mismatch_correction"
            and s not in RR_STAGE_IDS]
    want[-1:-1] = [(k_last, s) for s in META_RR_IDS]
    check(ran == want, f"meta: the stages that ran are {ran}")
    first_pe = os.path.join(out, f"K{k_last}", "first_pe_contigs.fasta")
    check(os.path.exists(first_pe) and os.path.getsize(first_pe) > 0,
          "meta: first_pe_contigs.fasta is missing or empty")
    rr = {s: st for _k, s, st in S.RR_STATS}
    check(list(rr) == [s for s in META_RR_IDS if s != "second_phase_setup"],
          f"meta: repeat-resolution records {list(rr)}")
    pre, main = rr["pair_info_count_preliminary"], rr["pair_info_count"]
    for key in ("pairs", "mapped_left", "mapped_right", "mapped_both", "raw_entries"):
        check(pre[key] == main[key], f"meta: the two PairInfoCount passes differ in {key}")
    check(main["index_timings"] == pre["index_timings"],
          "meta: the second PairInfoCount built a second device index")
    check(launches > 0 or dev.type == "cpu", "meta: the canonical-windows kernel was not launched")
    for sid in ("pair_info_count_preliminary", "pair_info_count"):
        check(per_stage[f"k={k_last} {sid}"] > 0 or dev.type == "cpu",
              f"meta: {sid} mapped the reads without the kernel")
    [(_k, _s, setup)] = [m for m in S.MODE_STATS if m[1] == "second_phase_setup"]
    check(setup["trusted_paths"] > 0, "meta: SecondPhaseSetup stored no trusted path")
    for name in OUTPUT_FILES[:4]:
        path = os.path.join(out, name)
        check(os.path.exists(path) and os.path.getsize(path) > 0, f"{path} is missing")

    # -- contigs against the genomes -------------------------------------------
    # (raw reads, no error correction: a contig of the shallow genomes may keep
    # a few substitutions, and one may join two genomes at their shared segment)
    t0 = time.perf_counter()
    long_ = [c.seq for c in res.contigs if len(c.seq) >= 1000]
    placed = substitutions_against(long_, genomes)
    wall["placement_s"] = time.perf_counter() - t0
    near = [d is not None and d <= max(3, 0.003 * len(s)) for s, (d, _g) in zip(long_, placed)]
    per_genome = []
    for gi, g in enumerate(genomes):
        got = [len(s) for s, (d, gs), ok in zip(long_, placed, near) if ok and gi in gs]
        per_genome.append({"genome_nt": len(g), "coverage": coverages[gi],
                           "pairs": int((origin == gi).sum()), "contigs_1kb": len(got),
                           "contig_nt": sum(got), "longest": max(got, default=0),
                           "exact": sum(1 for d, gs in placed if d == 0 and gs == {gi})})
    exact_one = sum(d == 0 and len(gs) == 1 for d, gs in placed)
    exact_shared = sum(d == 0 and len(gs) > 1 for d, gs in placed)
    # the rest must be exact pieces joined inside a repeat: the shared segment,
    # which no insert spans (greedy extension crosses it, as for the isolate)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    texts = [acgt[s].tobytes().decode() for g in genomes for s in (g, (3 - g)[::-1])]
    t0 = time.perf_counter()
    joined = {i: repeat_joints(long_[i], texts) for i, ok in enumerate(near) if not ok}
    wall["joint_check_s"] = time.perf_counter() - t0
    unexplained = sorted(len(long_[i]) for i, cuts in joined.items() if cuts is None)
    check(long_ and len(unexplained) <= max(2, 0.01 * len(long_)),
          f"meta: {len(unexplained)} of {len(long_)} contigs of 1 kb or more lie in no genome "
          f"within a few substitutions, nor as exact pieces joined at repeats: "
          f"{unexplained[-5:]}")
    check(per_genome[0]["contigs_1kb"] > 0, "meta: the deepest genome has no contig of 1 kb")

    trails = {"stage_times": {f"k={k} {s}": t for k, s, t in ST.STAGE_TIMES},
              "construction": {f"k={k}": tm for k, tm in S.CONSTRUCT_PHASES},
              "gap_closer": {f"k={k} {s}": st for k, s, st in S.GAP_CLOSER_STATS}}

    # -- the small community on the card, for the CPU worker's run --------------
    small = next(small_runs(seed, small_sizes))
    CK.canonical_window_keys.launches = 0
    small_rec = run_small(*small[:4], os.path.join(workdir, "card_side", "meta"), dev)
    small_launches = CK.canonical_window_keys.launches
    check(small_launches > 0 or dev.type == "cpu",
          "meta, 300 kb copy: the canonical-windows kernel was not launched")
    rec = {
        "phase": "meta",
        "card": nvidia_smi_line() if dev.type == "cuda" else "cpu",
        "dataset": {"genomes_nt": list(sizes), "coverages": list(coverages), "shared_nt": 5000,
                    "read_len": rl, "pairs": int(len(lefts)), "error_rate": 0.003,
                    "insert": [400, 30], "seed": seed + 3},
        "k_list": list(k_list), "wall_s": wall, **trails,
        "repeat_resolution": rr,
        "second_phase_setup": setup,
        "launches": launches,
        "launches_by_caller": launches_by_caller(shapes),
        "launches_by_stage": {s: n for s, n in per_stage.items() if n},
        "simplify_engine_runs": engines,
        "peak_device_gib": peak_gib,
        "contig_stats": assembly_stats(res.contigs),
        "contigs_1kb": len(long_), "exact_in_one_genome": exact_one,
        "exact_in_two_genomes": exact_shared,
        "with_substitutions": sum(near) - exact_one - exact_shared,
        "joined_at_repeats": sorted(len(long_[i]) for i, c in joined.items() if c),
        "unexplained": unexplained, "per_genome": per_genome,
        "small_card_run": {"genomes_nt": small[4]["genomes"], "wall_s": small_rec["wall_s"],
                           "launches": small_launches, "contigs": small_rec["contigs"]},
    }
    community = {"genomes": genomes, "r1": r1, "r2": r2}      # phase 17's binspreader
    return rec, {"meta": launches, "meta_small": small_launches}, shapes, small_rec, community


def run_cli(dev, workdir: str, name: str, args: list, timeout_s: int = 600,
            entry: str = "main", threads: int | None = None):
    """`python -m spades_tpu_torch.pipeline.<entry>` (the CLI or a mode
    wrapper) in a subprocess with the small sets' device thresholds, and
    with `threads` host threads (OpenMP and torch) where given; returns
    (output dir, wall s, launches, log)."""
    import re

    out = os.path.join(workdir, name)
    cmd = [sys.executable, "-m", f"spades_tpu_torch.pipeline.{entry}", *args, "-o", out]
    if dev.type == "cpu":
        cmd += ["--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""),
               **SMALL_SET_ENV)
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True, text=True,
                          timeout=timeout_s)
    wall_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"{name}: the CLI exited with {proc.returncode}: "
                                f"{proc.stderr[-2000:]}")
    with open(os.path.join(out, "spades.log")) as fh:
        log_text = fh.read()
    found = re.findall(r"kernel launches: canonical_windows=(\d+)", log_text)
    check(len(found) == 1, f"{name}: its log does not say how often it launched the kernel")
    launches = int(found[0])
    check(launches > 0 or dev.type == "cpu", f"{name}: the kernel was not launched")
    return out, wall_s, launches, log_text


def phase_hybrid(dev, workdir: str, seed: int, small_sizes: dict, gap_closed: int, gap_state):
    """Long reads: the gap set (phase 7's genome and pairs, not corrected)
    with 8x of noisy 10 kb reads through `run_assembly([55], long_reads=)`
    on the card (the CPU worker makes the same run), and once through the
    CLI's `--nanopore`."""
    from spades_tpu_torch.ops import cuda_kernels as CK

    name, k_list, reads, kw, extra = next(r for r in small_runs(seed, small_sizes)
                                          if r[0] == "hybrid")
    CK.canonical_window_keys.launches = 0
    shapes = CK.canonical_window_keys.launch_shapes = collections.Counter()
    card_dir = os.path.join(workdir, "card_side", "hybrid")
    rec_run = run_small(name, k_list, reads, kw, card_dir, dev)
    launches = CK.canonical_window_keys.launches
    CK.canonical_window_keys.launch_shapes = None
    check(launches > 0 or dev.type == "cpu", "hybrid: the kernel was not launched")
    [(_k, _s, hyb)] = [m for m in rec_run["modes"] if m[1] == "hybrid_aligning"]
    check(hyb["aligned"] > 0.9 * hyb["reads"], f"hybrid: only {hyb['aligned']} of "
                                               f"{hyb['reads']} long reads aligned")
    check(hyb["paths"] > 0, "hybrid: no long-read path was stored")
    paired_closed = sum(row[3] for row in rec_run["gap_closer"])

    lr_path = os.path.join(workdir, "long_reads.fasta")
    from spades_tpu_torch.tools import synthetic

    synthetic.write_fasta(lr_path, kw["long_reads"])
    fq = [os.path.join(workdir, "cli_raw_1.fq"), os.path.join(workdir, "cli_raw_2.fq")]
    synthetic.write_fastq(fq[0], gap_state["r1"], 1)
    synthetic.write_fastq(fq[1], gap_state["r2"], 2)
    out, cli_s, cli_launches, log_text = run_cli(
        dev, workdir, "cli_nanopore",
        ["-1", fq[0], "-2", fq[1], "--nanopore", lr_path, "-k", "55", "--only-assembler"])
    check("hybrid aligning:" in log_text, "CLI --nanopore: HybridAligning did not run")
    for fname in ("contigs.fasta", "scaffolds.fasta"):
        check(read_bytes(os.path.join(out, fname)) == read_bytes(os.path.join(card_dir, fname)),
              f"CLI --nanopore: {fname} differs from the library call's")
    rec = {
        "phase": "hybrid",
        "card": nvidia_smi_line() if dev.type == "cuda" else "cpu",
        "dataset": {"genome_nt": small_sizes["gap_genome"], "planted_gaps":
                    small_sizes["gap_count"], "pairs": len(reads) // 2, **extra,
                    "long_read_errors": {"substitution": 0.04, "insertion": 0.03,
                                         "deletion": 0.03}},
        "wall_s": rec_run["wall_s"], "stage_times": rec_run["stage_times"],
        "hybrid_aligning": hyb,
        "closed": {"paired_reads": paired_closed, "long_reads": hyb["closed"],
                   "total": paired_closed + hyb["closed"],
                   "phase_7_corrected_careful": gap_closed},
        "launches": launches, "launches_by_caller": launches_by_caller(shapes),
        "cli": {"wall_s": cli_s, "launches": cli_launches},
    }
    return rec, {"hybrid": launches, "cli_nanopore": cli_launches}, shapes, rec_run


def phase_modes(dev, workdir: str, seed: int, small_sizes: dict, gap_state):
    """The plasmid set in `plasmid`, `metaplasmid`, `metaviral`, `sc` and
    `sewage` mode, and the gap set from phase 7's GFA
    (`run_assembly(assembly_graph=)`, then the CLI's `--assembly-graph`), on
    the card at K = 55 (the CPU worker makes the same runs)."""
    import numpy as np

    from spades_tpu_torch.io.fastx import read_fastx
    from spades_tpu_torch.ops import cuda_kernels as CK

    gfa = os.path.join(gap_state["out"], GFA_NAME)
    shapes = CK.canonical_window_keys.launch_shapes = collections.Counter()
    recs, report, launches = {}, {}, {}
    for name, k_list, reads, kw, extra in small_runs(seed, small_sizes, gfa):
        if name not in MODES + ("assembly_graph",):
            continue
        card_dir = os.path.join(workdir, "card_side", name)
        CK.canonical_window_keys.launches = 0
        recs[name] = r = run_small(name, k_list, reads, kw, card_dir, dev)
        launches[f"modes_{name}"] = CK.canonical_window_keys.launches
        check(launches[f"modes_{name}"] > 0 or dev.type == "cpu",
              f"{name}: the kernel was not launched")
        stats = {s: st for _k, s, st in r["modes"]}
        row = report[name] = {"wall_s": r["wall_s"], "contigs": r["contigs"],
                              "stage_times": r["stage_times"]}
        if name in ("plasmid", "metaplasmid", "metaviral"):
            row["chromosome_removal"] = stats["chromosome_removal"]
            check(stats["chromosome_removal"]["removed"] > 0,
                  f"{name}: no chromosomal edge was removed")
        if name == "plasmid":
            seqs = [rr.seq for rr in read_fastx(os.path.join(card_dir, "contigs.fasta"))]
            plas = extra["plasmids"]
            circ = [np.concatenate([p, p]) for p in plas]      # contigs may cross the origin
            where = substitutions_against(seqs, circ + [extra["chromosome"]])
            row["kept"] = [{"nt": len(s), "substitutions": d, "in": sorted(gs)}
                           for s, (d, gs) in zip(seqs, where)]
            check(any(d == 0 and max(gs) < len(plas) for d, gs in where if gs),
                  "plasmid: no kept contig lies in a plasmid")
        if name in ("metaplasmid", "metaviral"):
            row["metaplasmid_extraction"] = stats["metaplasmid_extraction"]
            comps = sorted(f for f in files_under(card_dir) if "components" in f)
            row["component_files"] = comps
            check(comps, f"{name}: no components*.fasta was written")
        if name == "assembly_graph":
            row["load_graph"] = stats["load_graph"]
            check(r["stages"][0] == [55, "load_graph"], "assembly_graph: LoadGraph did not run")
    CK.canonical_window_keys.launch_shapes = None
    out, cli_s, cli_launches, log_text = run_cli(
        dev, workdir, "cli_assembly_graph",
        ["-1", os.path.join(workdir, "cli_raw_1.fq"), "-2", os.path.join(workdir, "cli_raw_2.fq"),
         "--assembly-graph", gfa, "-k", "55", "--only-assembler"])
    check("Load Graph" in log_text, "CLI --assembly-graph: LoadGraph did not run")
    for fname in ("contigs.fasta", "scaffolds.fasta", GFA_NAME):
        a, b = os.path.join(out, fname), os.path.join(workdir, "card_side", "assembly_graph",
                                                      fname)
        check(read_bytes(a) == read_bytes(b),
              f"CLI --assembly-graph: {fname} differs from the library call's")
    rec = {"phase": "modes", "card": nvidia_smi_line() if dev.type == "cuda" else "cpu",
           "dataset": {"chromosome_nt": small_sizes["chromosome"], "coverage": 40,
                       "plasmids_nt": small_sizes["plasmids"], "plasmid_multiples": [3, 5, 8],
                       "k": 55},
           "runs": report, "launches": launches, "launches_by_caller": launches_by_caller(shapes),
           "cli_assembly_graph": {"wall_s": cli_s, "launches": cli_launches}}
    return rec, {**launches, "cli_assembly_graph": cli_launches}, shapes, recs


def phase_card_against_cpu(workdir: str, card_recs: dict, worker, timeout_s: int = 900):
    """Wait for the CPU worker, then hold every card run of phases 9-11 to
    its CPU run: every output file, and the trails (stages, gap closer,
    repeat resolution, mode stages)."""
    proc, cpu_dir, log = worker
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=timeout_s)
    finally:
        log.close()
    waited = time.perf_counter() - t0
    if rc != 0:
        with open(os.path.join(workdir, "cpu_worker.log")) as fh:
            tail = fh.read()[-3000:]
        raise SmokeFailure(f"the CPU worker exited with {rc}: {tail}")
    runs = {}
    for name, card in card_recs.items():
        with open(os.path.join(cpu_dir, f"{name}.json")) as fh:
            cpu = json.load(fh)
        a, b = os.path.join(workdir, "card_side", name), os.path.join(cpu_dir, name)
        names = files_under(a)
        check(names == files_under(b), f"{name}: the card and the CPU wrote different files: "
                                       f"{sorted(names ^ files_under(b))[:10]}")
        for rel in sorted(names):
            check(same_output(os.path.join(a, rel), os.path.join(b, rel)),
                  f"{name}: the card's and the CPU's {rel} differ")
        for key in ("contigs", "stages", "gap_closer", "rr", "modes"):
            check(json.loads(json.dumps(card[key])) == cpu[key],
                  f"{name}: the card's and the CPU's {key} differ")
        runs[name] = {"files": len(names), "card_s": card["wall_s"], "cpu_s": cpu["wall_s"]}
    return {"phase": "card_against_cpu", "tolerance": 0, "runs": runs,
            "waited_for_cpu_s": waited}


# ---------------------------------------------------------------------------
# 14-15. rnaSPAdes at full width; the other modes of the last slice, card
# against CPU
# ---------------------------------------------------------------------------

# phase 14's transcriptome and the sets of phase 15 (card and CPU worker)
RNA_SIZES = {"genes": 2000, "pairs": 500_000, "small_genes": 160, "small_pairs": 51_200,
             "corona_nt": 30_000, "corona_cov": 1000, "host_nt": 200_000,
             "bio_nt": 300_000, "bio_cov": 40, "series_total": 300_000}
# the three samples of the series set: per-genome coverages of phase 9's
# community at three time points
SERIES_COVERAGES = ((60, 25, 12, 6), (6, 60, 25, 12), (12, 6, 60, 25))
CORONA_PROFILES = (1, 2, 3)          # the ORFs of 120, 200 and 300 codons
SLICE7_K = [55]
NOT_COMPARED = {"spades.log", "params.txt", "run_spades.sh"}


def transcript_checks(records, data, rl: int, min_cov: float = 5.0,
                      min_len: int = 200) -> dict:
    """Lay the transcripts.fasta records of `min_len` nt or more onto the true
    transcripts (either strand) and report: records exact or within a few
    substitutions, genes
    above `min_cov` x whose primary transcript one record covers over 90 % of
    its length, isoform pairs whose two transcripts are each so covered, the
    convergent pairs no record fuses across their shared 3' end, and records
    that still end in 15 or more A/T."""
    import numpy as np

    short = sum(1 for s in records if len(s) < min_len)
    records = [s for s in records if len(s) >= min_len]
    tx = data["transcripts"]
    tails = data["tail"]
    bodies = [t[: len(t) - int(n)] for t, n in zip(tx, tails)]
    placed = substitutions_against(records, tx, with_spans=True)
    exact = sum(1 for d, _g, _s in placed if d == 0)
    close = sum(1 for d, _g, _s in placed if d is not None and 0 < d <= 5)
    cover = np.zeros(len(tx), np.int64)         # longest record inside each transcript
    for seq, (d, _g, spans) in zip(records, placed):
        if d is not None and d <= 5:
            for gi, _rc, _start in spans:
                cover[gi] = max(cover[gi], len(seq))
    body_len = np.array([len(b) for b in bodies], np.int64)
    covered = cover >= 0.9 * body_len
    depth = data["fragments"] * 2 * rl / np.array([len(t) for t in tx])
    first = {}
    for i, g in enumerate(data["gene"]):
        first.setdefault(int(g), i)
    deep = [i for i in first.values() if depth[i] > min_cov]
    iso = data["isoform_pairs"]
    # a fused record: laid onto a convergent locus (first body, then the
    # second body reverse-complemented past the overlap) across the overlap
    loci, spans = [], []
    for a, b, ov in data["convergent"]:
        la = len(bodies[a])
        loci.append(np.concatenate([bodies[a], (3 - bodies[b][: len(bodies[b]) - ov])[::-1]]))
        spans.append((la - ov, la))
    fused = set()
    for seq, (d, _g, sp) in zip(records, substitutions_against(records, loci, with_spans=True)
                                if loci else []):
        if d is None or d > 5:
            continue
        for li, rc, start in sp:
            lo, hi = spans[li]
            L = len(loci[li])
            s0 = L - start - len(seq) if rc else start
            if s0 < lo - 50 and s0 + len(seq) > hi + 50:
                fused.add(li)
    polya = sum(1 for s in records if s.endswith("A" * 15) or s.startswith("T" * 15)
                or s.endswith("T" * 15) or s.startswith("A" * 15))
    return {"records_under_min_len": short, "min_len": min_len,
            "records": len(records), "records_exact": exact, "records_within_5_subs": close,
            "records_not_laid": sum(1 for d, _g, _s in placed if d is None or d > 5),
            "genes_above_min_cov": len(deep), "min_cov": min_cov,
            "genes_recovered_90pct": int(sum(covered[i] for i in deep)),
            "isoform_pairs": len(iso),
            "isoform_pairs_told_apart": int(sum(covered[a] and covered[b] for a, b in iso)),
            "convergent_pairs": len(loci), "convergent_pairs_separated": len(loci) - len(fused),
            "records_ending_in_15_at": polya}


def phase_rna(dev, workdir: str, seed: int, sizes: dict, rl: int = 100):
    """rnaSPAdes at full width: a stranded (dUTP) transcriptome library
    through `run_assembly(k_list, mode="rna", ss="rf")` with the CLI's K
    choice for its read length: the early A/T clipper at every K, SSEdgeSplit
    (two device mapping passes) at every K, repeat resolution, and
    transcripts.fasta laid onto the true transcripts."""
    import numpy as np
    import torch

    from spades_tpu_torch.io.fastx import read_fastx
    from spades_tpu_torch.ops import cuda_kernels as CK
    from spades_tpu_torch.pipeline import spades_stages as S
    from spades_tpu_torch.pipeline import stages as ST
    from spades_tpu_torch.pipeline.assembler import default_k_ladder
    from spades_tpu_torch.pipeline.run import run_assembly
    from spades_tpu_torch.tools import synthetic

    wall = {}
    t0 = time.perf_counter()
    data = synthetic.make_transcriptome(sizes["genes"], sizes["pairs"], seed + 5, rl=rl)
    wall["make_data_s"] = time.perf_counter() - t0
    lefts, rights = list(data["r1"]), list(data["r2"])
    k_list = [k for k in default_k_ladder(rl) if k < rl]       # pipeline/main.py's auto choice
    for trail in (ST.STAGE_TIMES, S.CONSTRUCT_PHASES, S.GAP_CLOSER_STATS, S.RR_STATS,
                  S.MODE_STATS):
        trail.clear()
    per_stage = {}
    shapes = CK.canonical_window_keys.launch_shapes = collections.Counter()
    CK.canonical_window_keys.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = os.path.join(workdir, "rna")
    last = [0]

    def count_launches(stage, ctx):
        n = CK.canonical_window_keys.launches
        per_stage[f"k={ctx.k} {stage.id}"] = n - last[0]
        last[0] = n

    t0 = time.perf_counter()
    with after_every_stage(count_launches):
        res = run_assembly(lefts + rights, k_list, out, mode="rna", ss="rf",
                           paired_libs=[(lefts, rights)], read_length=rl, device=dev,
                           checkpoints="none")
    sync(dev)
    wall["run_assembly_s"] = time.perf_counter() - t0
    launches = CK.canonical_window_keys.launches
    CK.canonical_window_keys.launch_shapes = None
    check(launches > 0 or dev.type == "cpu", "rna: the canonical-windows kernel was not launched")
    res.graph.check_invariants()
    graph_checks("rna, last K", res.graph)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if dev.type == "cuda" else None
    stages = [s for _k, s, _t in ST.STAGE_TIMES]
    check(stages.count("ss_edge_split") == len(k_list), "rna: SSEdgeSplit did not run at every K")
    clip = {f"k={k}": tm.get("early_clip_s") for k, tm in S.CONSTRUCT_PHASES}
    check(all(v is not None for v in clip.values()), "rna: the early A/T clipper did not run")
    ss = [dict(st, k=k) for k, sid, st in S.MODE_STATS if sid == "ss_edge_split"]
    pic = [dict(st, k=k) for k, sid, st in S.RR_STATS if sid == "pair_info_count"]
    check(pic and pic[-1]["mapped_both"] > 0.5 * pic[-1]["pairs"],
          "rna: PairInfoCount mapped too few pairs")
    t0 = time.perf_counter()
    records = [r.seq for r in read_fastx(os.path.join(out, "transcripts.fasta"))]
    truth = transcript_checks(records, data, rl)
    wall["truth_s"] = time.perf_counter() - t0
    check(truth["records_exact"] + truth["records_within_5_subs"] > 0.7 * truth["records"],
          f"rna: most transcripts.fasta records lie in no transcript: {truth}")
    check(truth["genes_recovered_90pct"] > 0.5 * truth["genes_above_min_cov"],
          f"rna: too few expressed genes recovered: {truth}")
    for name in ("transcripts.fasta", "contigs.fasta", "scaffolds.fasta", GFA_NAME):
        check(os.path.getsize(os.path.join(out, name)) > 0, f"rna: {name} is empty")
    rec = {
        "phase": "rna", "card": nvidia_smi_line() if dev.type == "cuda" else "cpu",
        "dataset": {"genes": sizes["genes"], "transcripts": len(data["transcripts"]),
                    "transcript_nt": int(sum(map(len, data["transcripts"]))),
                    "isoform_pairs": len(data["isoform_pairs"]),
                    "convergent_pairs": len(data["convergent"]), "pairs": len(lefts),
                    "read_length": rl, "protocol": "dUTP, --ss rf", "insert": [250, 25],
                    "substitutions": 0.003, "expression_sigma": 1.5, "seed": seed + 5},
        "k_list": k_list, "wall": wall, "stage_times": [list(t) for t in ST.STAGE_TIMES],
        "early_clip_s": clip,
        "construction": {f"k={k}": tm for k, tm in S.CONSTRUCT_PHASES},
        "ss_edge_split": ss, "pair_info_count": pic,
        "contigs": assembly_stats(res.contigs), "truth": truth,
        "launches": launches, "launches_by_caller": launches_by_caller(shapes),
        "launches_by_stage": per_stage, "peak_device_gib": peak,
    }
    return rec, {"rna": launches}, shapes


def _slice7_inputs(workdir: str, seed: int, sizes: dict) -> dict:
    """Write phase 15's inputs under `workdir` (the same bytes on the card's
    side and the CPU worker's, from the seed): the small transcriptome as
    FASTQ and arrays with two full-length transcripts, the corona sample and
    its three amino profiles, the bio genome with its two, and the series
    samples with their k-mer profiles' config, and the gap set's raw pairs."""
    from spades_tpu_torch.hmm.io import hmm_from_consensus, write_hmm
    from spades_tpu_torch.tools import synthetic

    os.makedirs(workdir, exist_ok=True)
    rna = synthetic.make_transcriptome(sizes["small_genes"], sizes["small_pairs"], seed + 5)
    fl = [read_strings(rna["transcripts"][i][None, :])[0] for i in (0, 3)]
    files = {"rna": rna, "fl": fl, "fl_path": os.path.join(workdir, "fl.fasta"), "sizes": sizes}
    synthetic.write_fasta(files["fl_path"], fl)
    for mate, key in ((1, "r1"), (2, "r2")):
        files[f"rna_{mate}"] = os.path.join(workdir, f"rna_{mate}.fq")
        synthetic.write_fastq(files[f"rna_{mate}"], rna[key], mate)
    cor = synthetic.make_corona_dataset(seed + 6, genome_nt=sizes["corona_nt"],
                                        coverage=sizes["corona_cov"], host_nt=sizes["host_nt"])
    files["corona"] = cor
    files["corona_hmms"] = []
    for i in CORONA_PROFILES:
        path = os.path.join(workdir, f"corona_orf{i}.hmm")
        write_hmm(path, hmm_from_consensus(cor["peptides"][i], f"orf{i}", alphabet="amino"))
        files["corona_hmms"].append(path)
    bio = synthetic.make_domain_genome(sizes["bio_nt"], (150, 250), sizes["bio_cov"], seed + 7)
    files["bio"] = bio
    files["bio_hmms"] = []
    for i, pep in enumerate(bio["peptides"]):
        path = os.path.join(workdir, f"bio_dom{i}.hmm")
        write_hmm(path, hmm_from_consensus(pep, f"dom{i}", alphabet="amino"))
        files["bio_hmms"].append(path)
    for name, d in (("corona", cor), ("bio", bio)):
        for mate, key in ((1, "r1"), (2, "r2")):
            files[f"{name}_{mate}"] = os.path.join(workdir, f"{name}_{mate}.fq")
            synthetic.write_fastq(files[f"{name}_{mate}"], d[key], mate)
    scaled = [s * sizes["series_total"] // sum(META_SIZES) for s in META_SIZES]
    files["series"] = synthetic.make_series(scaled, SERIES_COVERAGES, 150, 0.003, seed + 8)
    # phase 7's gap set (its raw pairs), for the CLI's --read-cov-threshold
    _g, r1, r2, _gaps = synthetic.make_gapped_dataset(
        sizes["gap_genome"], GAP_COVERAGE, 150, 0.003, seed + 1, sizes["gap_count"])
    for mate, reads in ((1, r1), (2, r2)):
        files[f"gap_{mate}"] = os.path.join(workdir, f"gap_{mate}.fq")
        synthetic.write_fastq(files[f"gap_{mate}"], reads, mate)
    return files


def _custom_hmms(paths) -> list:
    return [a for p in paths for a in ("--custom-hmms", p)]


def slice7_cli_runs(workdir: str, files: dict, where, threads: int | None = None):
    """Phase 15's CLI runs on `where` over `files` (`_slice7_inputs`), one
    after another, each in a process of its own (with `threads` host
    threads) that counts its launches: (name, record) with the output
    directory, wall time, launches and log."""
    k = ["-k", ",".join(map(str, SLICE7_K))]
    cli = (
        ("cli_rnaspades", "rnaspades", ["-1", files["rna_1"], "-2", files["rna_2"], "--ss", "rf",
                                        "--fl-rna", files["fl_path"], "--only-assembler", *k]),
        ("rnaviral", "rnaviralspades", ["-1", files["rna_1"], "-2", files["rna_2"], *k]),
        ("corona", "coronaspades", ["-1", files["corona_1"], "-2", files["corona_2"],
                                    *_custom_hmms(files["corona_hmms"]), *k]),
        ("bio", "main", ["-1", files["bio_1"], "-2", files["bio_2"], "--bio",
                         *_custom_hmms(files["bio_hmms"]), "--only-assembler", *k]),
        ("cli_read_cov", "main", ["-1", files["gap_1"], "-2", files["gap_2"],
                                  "--read-cov-threshold", "3", "--only-assembler", *k]),
    )
    for name, entry, args in cli:
        out, wall_s, launches, log_text = run_cli(where, workdir, name, args, entry=entry,
                                                  threads=threads)
        yield name, {"out": out, "wall_s": wall_s, "launches": launches, "log": log_text}


def start_slice7_cli(workdir: str, files: dict, where):
    """Phase 15's CLI runs in a thread (their processes beside phase 14's
    run, on the same card); `finish` joins it and returns {name: record},
    raising what a run raised."""
    import threading

    done, failed = {}, []

    def body():
        try:
            # two host threads each, beside phase 14's run
            done.update(slice7_cli_runs(workdir, files, where, threads=2))
        except BaseException as exc:  # noqa: BLE001 -- re-raised by finish()
            failed.append(exc)

    thread = threading.Thread(target=body, name="slice7-cli")
    thread.start()

    def finish():
        thread.join()
        if failed:
            raise failed[0]
        return done
    return finish


def slice7_lib_runs(workdir: str, files: dict, where):
    """Phase 15's library runs on `where` over `files`, one after another,
    each with its own launch count: (name, record) with the output
    directory, wall time and launches.  The CPU worker makes the same runs."""
    import numpy as np

    from spades_tpu_torch.mts.multiplicity import profiles_from_read_sets
    from spades_tpu_torch.ops import cuda_kernels as CK

    rna = files["rna"]
    lefts, rights = list(rna["r1"]), list(rna["r2"])
    rna_kw = dict(paired_libs=[(lefts, rights)], read_length=100, mode="rna")
    lib = (
        ("rna_small", dict(rna_kw, ss="fr")),
        ("rna_small_rf", dict(rna_kw, ss="rf", trusted_contigs=files["fl"])),
    )
    for name, kw in lib:
        CK.canonical_window_keys.launches = 0
        r = run_small(name, SLICE7_K, lefts + rights, kw, os.path.join(workdir, name), where)
        r.update(out=os.path.join(workdir, name), launches=CK.canonical_window_keys.launches)
        yield name, r
    # series analysis: k-mer profiles of the three samples, counted on `where`
    CK.canonical_window_keys.launches = 0
    genomes, samples = files["series"]
    t0 = time.perf_counter()
    prof = profiles_from_read_sets([list(a) + list(b) for a, b in samples], SLICE7_K[-1],
                                   min_samples=1, min_mult=2, device=where)
    profile_s = time.perf_counter() - t0
    out = os.path.join(workdir, "series")
    os.makedirs(out)
    mult = os.path.join(workdir, "series_profiles.npz")
    prof.save(mult)
    cfg = os.path.join(workdir, "series.yaml")
    with open(cfg, "w") as fh:
        fh.write(f"k: {SLICE7_K[-1]}\nsample_cnt: {len(samples)}\nkmer_mult: {mult}\n"
                 f"min_len: 500\nfrag_size: 2000\n"
                 + "".join(f"{key}: {os.path.join(out, 'dumps', name)}\n"
                           for key, name in (("edges_sqn", "edges.fasta"),
                                             ("edges_mpl", "edges.mpl"),
                                             ("edge_fragments_mpl", "edge_fragments.mpl"))))
    os.makedirs(os.path.join(out, "dumps"))
    sl = [np.concatenate([a for a, _b in samples]), np.concatenate([b for _a, b in samples])]
    r = run_small("series", SLICE7_K, list(sl[0]) + list(sl[1]),
                  dict(mode="meta", paired_libs=[(list(sl[0]), list(sl[1]))], read_length=150,
                       series_analysis=cfg), os.path.join(out, "run"), where)
    r.update(out=out, launches=CK.canonical_window_keys.launches, profile_s=profile_s,
             profiles={"kmers": prof.num_kmers, "samples": prof.num_samples})
    yield "series", r


def slice7_worker(workdir: str, seed: int, sizes: dict) -> int:
    """The CPU side of phase 15 (`--cpu-worker ... --runs slice7`)."""
    import torch

    torch.set_num_threads(2)          # beside the card's phases and the first worker
    files = _slice7_inputs(os.path.join(workdir, "inputs"), seed, sizes)
    cpu = torch.device("cpu")
    for name, r in (*slice7_lib_runs(workdir, files, cpu), *slice7_cli_runs(workdir, files, cpu)):
        r.pop("log", None)
        with open(os.path.join(workdir, f"{name}.json"), "w") as fh:
            json.dump({k: v for k, v in r.items() if k != "out"}, fh)
    slice7_tool_runs(workdir, files, cpu)      # phase 16's pathracer and mts
    return 0


def start_slice7_worker(workdir: str, seed: int, sizes: dict):
    out = os.path.join(workdir, "cpu_side_slice7")
    os.makedirs(out)
    log = open(os.path.join(workdir, "cpu_worker_slice7.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-worker", out, "--runs", "slice7",
         "--seed", str(seed), "--sizes", json.dumps(sizes)],
        cwd=HERE, stdout=log, stderr=subprocess.STDOUT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    return proc, out, log


def best_hits(path: str) -> dict:
    """domain_hits.tsv -> {profile: (edge path, seq_len)} of its best hit."""
    best = {}
    with open(path) as fh:
        for line in fh.read().splitlines()[1:]:
            name, _score, edges, seq_len = line.split("\t")
            best.setdefault(name, ([int(e) for e in edges.split(",")], int(seq_len)))
    return best


def hits_spell_their_genes(out: str, k: int, genes: dict) -> dict:
    """Each profile's best hit in `out`'s domain_hits.tsv, spelled along its
    edge path in the run's last graph (its checkpoint), holds the profile's
    gene but for the start and stop codons; returns the hits' lengths."""
    from spades_tpu_torch.core import dna
    from spades_tpu_torch.graph.serialize import load_graph
    from spades_tpu_torch.hmm.align import _spell

    kdir = os.path.join(out, f"K{k}")
    g = load_graph(os.path.join(kdir, "saves", "contig_output", "graph.npz"))
    best = best_hits(os.path.join(kdir, "domain_hits.tsv"))
    report = {}
    for name, orf in genes.items():
        check(name in best, f"{out}: profile {name} has no hit")
        path, seq_len = best[name]
        s = _spell(g, path)
        body = dna.decode(orf[3:-3])
        check(body in s or dna.revcomp_str(body) in s,
              f"{os.path.basename(out)}: the best hit of {name} does not spell its gene")
        report[name] = {"edges": len(path), "seq_len": seq_len, "gene_nt": len(orf)}
    return report


def phase_other_modes(dev, workdir: str, card_dir: str, files: dict, cli, worker):
    """Phase 15: the small transcriptome in rna mode (ss fr and rf, the second
    with full-length transcripts), `rnaspades --ss rf --fl-rna` against that
    library call, `rnaviralspades` (error correction on), `coronaspades
    --custom-hmms` on a 30 kb coronavirus-like sample with host transcripts,
    `--bio --custom-hmms` on a 300 kb genome, and series analysis of a
    three-sample community; then every file of each run against the CPU
    worker's.  `files` are `_slice7_inputs` under `card_dir`; `cli` finishes
    the CLI runs, started before phase 14 (`start_slice7_cli`)."""
    import numpy as np

    from spades_tpu_torch.ops import cuda_kernels as CK

    shapes = CK.canonical_window_keys.launch_shapes = collections.Counter()
    runs = dict(slice7_lib_runs(card_dir, files, dev))
    CK.canonical_window_keys.launch_shapes = None
    runs.update(cli())
    launches = {}
    for name, r in runs.items():
        launches[name] = r["launches"]
        check(r["launches"] > 0 or dev.type == "cpu", f"{name}: the kernel was not launched")
    report = {name: {"wall_s": r["wall_s"], "launches": r["launches"]}
              for name, r in runs.items()}
    # the CLI's rnaspades is the library call with the transcripts as trusted contigs
    for fname in ("transcripts.fasta", "contigs.fasta", "scaffolds.fasta", GFA_NAME,
                  "contigs.paths"):
        check(read_bytes(os.path.join(runs["cli_rnaspades"]["out"], fname))
              == read_bytes(os.path.join(runs["rna_small_rf"]["out"], fname)),
              f"rnaspades --fl-rna: {fname} differs from the library call's")
    check("SS Edge Splitting" in runs["cli_rnaspades"]["log"], "rnaspades: no SSEdgeSplit")
    check(os.path.isdir(os.path.join(runs["rnaviral"]["out"], "corrected")),
          "rnaviralspades: error correction did not run")
    cor = files["corona"]
    report["corona"]["hits"] = hits_spell_their_genes(
        runs["corona"]["out"], SLICE7_K[-1],
        {f"orf{i}": cor["genome"][cor["orfs"][i][0] : cor["orfs"][i][1]] for i in CORONA_PROFILES})
    report["bio"]["hits"] = hits_spell_their_genes(
        runs["bio"]["out"], SLICE7_K[-1],
        {f"dom{i}": orf for i, orf in enumerate(files["bio"]["orfs"])})
    dp = {}
    for name in ("corona", "bio"):
        found = [ln for ln in runs[name]["log"].splitlines() if "== done Domain Analysis" in ln]
        check(len(found) == 1, f"{name}: DomainAnalysis did not run once")
        dp[name] = found[0].rsplit("(", 1)[-1].rstrip(")")
    report["domain_analysis_s"] = dp
    # the CLI's --read-cov-threshold on the gap set (its files are compared below)
    found = [ln for ln in runs["cli_read_cov"]["log"].splitlines()
             if "read coverage filter: " in ln]
    check(len(found) == 1, "--read-cov-threshold: the CLI did not log the reads it kept")
    kept, total = (int(x) for x in
                   found[0].split("read coverage filter: ", 1)[1].split()[0].split("/"))
    check(0 < kept <= total == read_bytes(files["gap_1"]).count(b"\n") // 2,
          f"--read-cov-threshold: kept {kept} of {total} reads")
    report["cli_read_cov"]["reads_kept"] = [kept, total]
    report["series"]["profiles"] = runs["series"]["profiles"]
    report["series"]["profile_s"] = runs["series"]["profile_s"]
    # every file against the CPU worker's
    proc, cpu_dir, log = worker
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=900)
    finally:
        log.close()
    waited = time.perf_counter() - t0
    if rc != 0:
        with open(os.path.join(workdir, "cpu_worker_slice7.log")) as fh:
            raise SmokeFailure(f"the slice-7 CPU worker exited with {rc}: {fh.read()[-3000:]}")
    compared = {}
    for name, r in runs.items():
        a, b = r["out"], os.path.join(cpu_dir, name)
        names = {n for n in files_under(a)
                 if os.path.basename(n) not in NOT_COMPARED | {"checkpoint.json"}}
        other = {n for n in files_under(b)
                 if os.path.basename(n) not in NOT_COMPARED | {"checkpoint.json"}}
        check(names == other, f"{name}: the card and the CPU wrote different files: "
                              f"{sorted(names ^ other)[:10]}")
        for rel in sorted(names):
            check(same_output(os.path.join(a, rel), os.path.join(b, rel)),
                  f"{name}: the card's and the CPU's {rel} differ")
        with open(os.path.join(cpu_dir, f"{name}.json")) as fh:
            cpu = json.load(fh)
        for key in ("contigs", "stages", "gap_closer", "rr", "modes", "profiles"):
            if key in r:
                check(json.loads(json.dumps(r[key])) == cpu[key],
                      f"{name}: the card's and the CPU's {key} differ")
        compared[name] = {"files": len(names), "card_s": r["wall_s"], "cpu_s": cpu["wall_s"]}
    a = np.load(os.path.join(card_dir, "series_profiles.npz"))
    b = np.load(os.path.join(cpu_dir, "series_profiles.npz"))
    check(all(np.array_equal(a[f], b[f]) for f in ("k", "words", "mpl")),
          "series: the card's and the CPU's k-mer profiles differ")
    rec = {"phase": "other_modes", "card": nvidia_smi_line() if dev.type == "cuda" else "cpu",
           "k_list": SLICE7_K,
           "dataset": {"rna_small": {"genes": files["sizes"]["small_genes"],
                                     "transcripts": len(files["rna"]["transcripts"]),
                                     "pairs": files["sizes"]["small_pairs"]},
                       "corona": {"genome_nt": files["sizes"]["corona_nt"],
                                  "orfs": len(cor["orfs"]),
                                  "profile_states": [len(cor["peptides"][i])
                                                     for i in CORONA_PROFILES],
                                  "pairs": int(cor["r1"].shape[0]),
                                  "host_nt": int(sum(map(len, cor["host"])))},
                       "bio": {"genome_nt": files["sizes"]["bio_nt"],
                               "coverage": files["sizes"]["bio_cov"],
                               "profile_states": [len(p) for p in files["bio"]["peptides"]]},
                       "series": {"samples": len(SERIES_COVERAGES),
                                  "coverages": SERIES_COVERAGES,
                                  "community_nt": files["sizes"]["series_total"]}},
           "runs": report, "card_against_cpu": compared, "waited_for_cpu_s": waited,
           "tolerance": 0, "launches_by_caller": launches_by_caller(shapes)}
    return rec, launches, shapes


# ---------------------------------------------------------------------------
# 16. the standalone tools
# ---------------------------------------------------------------------------

# read_filter's contaminant: 2,000 pairs (0.3x) of a random 2 Mb genome.  At
# 0.6x (1 Mb) a pair's larger median passes 2 in 11-14 % of pairs (the port
# on the CPU, six seeds): two other reads over half of a read are common.
CONTAMINANT_NT = 2_000_000
CONTAMINANT_COV = 0.3
# the tools of the twin runs that launch the kernel on the card
DEVICE_TWINS = ("kmercount_subset", "registers_subset", "read_filter_subset", "gmapper",
                "sam_map")


def _concat(out: str, *paths) -> str:
    with open(out, "wb") as fo:
        for p in paths:
            with open(p, "rb") as fi:
                shutil.copyfileobj(fi, fo)
    return out


def tools_inputs(workdir: str, seed: int, isolate: dict, gap_state: dict) -> dict:
    """Phase 16's input files, written before phase 14 so that the tools'
    CPU worker can run beside it: the isolate's first pairs (phase 3's
    subset), read_filter's inputs (the isolate's pairs, or the subset, with
    2,000 contaminant pairs after them), the gap set's genome, k=55 GFA,
    contigs, raw FASTQ and long reads (phases 7 and 10), and `convert_reads`
    chunks of the subset.  Returns their paths."""
    import numpy as np

    from spades_tpu_torch.io.binary_reads import convert_reads
    from spades_tpu_torch.io.fastx import read_sequences
    from spades_tpu_torch.tools import synthetic

    d = os.path.join(workdir, "tools_in")
    os.makedirs(d)
    rng = np.random.default_rng(seed + 9)
    contaminant = rng.integers(0, 4, CONTAMINANT_NT).astype(np.uint8)
    c1, c2 = synthetic._fr_pairs(rng, contaminant, CONTAMINANT_COV, 150, 0.003, 400, 30)
    inp = {"dir": d, "pairs": isolate["pairs"], "subset_pairs": isolate["subset_pairs"],
           "contaminant_pairs": int(c1.shape[0])}
    for mate, reads in ((1, c1), (2, c2)):
        cont = os.path.join(d, f"contaminant_{mate}.fq")
        synthetic.write_fastq(cont, reads, mate, prefix="c")
        inp[f"isolate_{mate}"] = isolate["paths"][mate - 1]
        inp[f"sub_{mate}"] = isolate["subset"][mate - 1]
        inp[f"rf_{mate}"] = _concat(os.path.join(d, f"rf_{mate}.fq"),
                                    isolate["paths"][mate - 1], cont)
        inp[f"rf_sub_{mate}"] = _concat(os.path.join(d, f"rf_sub_{mate}.fq"),
                                        isolate["subset"][mate - 1], cont)
    inp["gap_genome"] = os.path.join(d, "gap_genome.fasta")
    synthetic.write_fasta(inp["gap_genome"], read_strings(gap_state["genome"][None, :]))
    inp["gap_gfa"] = os.path.join(gap_state["out"], GFA_NAME)
    inp["gap_contigs"] = os.path.join(gap_state["out"], "contigs.fasta")
    inp["gap_1"], inp["gap_2"] = (os.path.join(workdir, f"cli_raw_{m}.fq") for m in (1, 2))
    inp["long_reads"] = os.path.join(workdir, "long_reads.fasta")
    inp["bin_dir"] = os.path.join(d, "bin_reads")
    convert_reads(inp["bin_dir"], list(read_sequences(isolate["subset"])), chunks=8)
    return inp


def _tool(name: str, main, argv: list, out: str, runs: dict, where, counted: bool):
    """One tool's `main(argv + [-w out])` in this process with its printed
    lines captured (the script's own standard output carries JSON only); its
    wall time, printed text (the output directory masked) and, when
    `counted`, the kernel's launches go into `runs[name]`."""
    import io

    from spades_tpu_torch.ops import cuda_kernels as CK

    os.makedirs(os.path.dirname(out), exist_ok=True)
    CK.canonical_window_keys.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv + ["-w", out, "--device", where.type])
    sync(where)
    wall = time.perf_counter() - t0
    check(rc == 0, f"{name}: the tool returned {rc}")
    runs[name] = {"wall_s": wall, "printed": buf.getvalue().replace(out, "<out>")}
    if counted:
        runs[name]["launches"] = CK.canonical_window_keys.launches
    return buf.getvalue()


def tool_twin_runs(out: str, inp: dict, where) -> dict:
    """The tool runs that both sides make, into `out/<name>`: kmercount,
    the HLL registers and read_filter on the subset, and gmapper, gsimplifier,
    gfa_split, gchecker, convert_bin_to_fasta, corrector (with the reads, and
    with `--sam` from `mappings_to_sam` of the reads mapped on `where`) and
    spaligner on the gap set.  Returns {name: record}."""
    import numpy as np

    from spades_tpu_torch.alignment.mapper import build_edge_index, map_read_batch
    from spades_tpu_torch.core.reads import batch_iter
    from spades_tpu_torch.graph.from_gfa import graph_from_gfa
    from spades_tpu_torch.io.fastx import read_fastx, read_sequences
    from spades_tpu_torch.io.gfa import read_gfa
    from spades_tpu_torch.io.sam import mappings_to_sam
    from spades_tpu_torch.ops import cuda_kernels as CK
    from spades_tpu_torch.ops.hll import kmer_registers
    from spades_tpu_torch.tools import (convert_bin_to_fasta, corrector, gchecker, gfa_split,
                                        gmapper, gsimplifier, kmercount, read_filter, spaligner)

    runs = {}
    sub = [inp["sub_1"], inp["sub_2"]]
    # the subset's one batch is below the host-counting threshold: lowered,
    # as for the small sets, so that both sides count on the device path
    with environment({"SPADES_HOST_COUNT_WINDOWS": "1"}):
        _tool("kmercount_subset", kmercount.main, [*sub, "-k", "55", "--counts"],
              os.path.join(out, "kmercount_subset"), runs, where, True)
    CK.canonical_window_keys.launches = 0
    t0 = time.perf_counter()
    regs = kmer_registers(batch_iter(read_sequences(sub)), 55, device=where)
    os.makedirs(os.path.join(out, "registers_subset"))
    np.save(os.path.join(out, "registers_subset", "registers.npy"), regs)
    runs["registers_subset"] = {"wall_s": time.perf_counter() - t0, "printed": "",
                                "launches": CK.canonical_window_keys.launches}
    rf = os.path.join(out, "read_filter_subset")
    _tool("read_filter_subset", read_filter.main,
          ["-1", inp["rf_sub_1"], "-2", inp["rf_sub_2"], "-k", "21", "-c", "2", "-o", rf],
          rf, runs, where, True)
    with environment(SMALL_SET_ENV):
        _tool("gmapper", gmapper.main, [inp["gap_gfa"], inp["gap_1"], "-k", "55"],
              os.path.join(out, "gmapper"), runs, where, True)
    _tool("gsimplifier", gsimplifier.main, [inp["gap_gfa"], "-k", "55", "--read-length", "150"],
          os.path.join(out, "gsimplifier"), runs, where, False)
    _tool("gfa_split", gfa_split.main, [inp["gap_gfa"]], os.path.join(out, "gfa_split"),
          runs, where, False)
    _tool("gchecker", gchecker.main, [inp["gap_contigs"], inp["gap_genome"]],
          os.path.join(out, "gchecker"), runs, where, False)
    _tool("convert_bin_to_fasta", convert_bin_to_fasta.main, [inp["bin_dir"]],
          os.path.join(out, "convert_bin_to_fasta"), runs, where, False)
    _tool("corrector_reads", corrector.main,
          [inp["gap_contigs"], inp["gap_1"], inp["gap_2"], "-k", "21"],
          os.path.join(out, "corrector_reads"), runs, where, False)
    # the SAM path: the gap graph's edges as contigs, the mates of the first
    # reads mapped onto it on `where` and written as SAM
    sam_dir = os.path.join(out, "sam_map")
    os.makedirs(sam_dir)
    g = graph_from_gfa(read_gfa(inp["gap_gfa"]), 55)
    edges = os.path.join(sam_dir, "edges.fasta")
    with open(edges, "w") as fh:
        for e in g.canonical_edge_ids():
            fh.write(f">{int(e)}\n{g.edge_seq(int(e))}\n")
    recs = list(read_fastx(inp["gap_1"]))[:20_000]
    CK.canonical_window_keys.launches = 0
    t0 = time.perf_counter()
    with environment(SMALL_SET_ENV):
        mappings = map_read_batch(build_edge_index(g), g, [r.seq for r in recs], device=where)
    sam = os.path.join(sam_dir, "reads.sam")
    n = mappings_to_sam(sam, g, [r.name for r in recs], [r.seq for r in recs], mappings)
    runs["sam_map"] = {"wall_s": time.perf_counter() - t0, "printed": f"{n} mapped",
                       "launches": CK.canonical_window_keys.launches}
    _tool("corrector_sam", corrector.main, [edges, "--sam", sam],
          os.path.join(out, "corrector_sam"), runs, where, False)
    _tool("spaligner", spaligner.main, [inp["gap_gfa"], inp["long_reads"], "-k", "55",
                                        "-d", "nanopore"],
          os.path.join(out, "spaligner"), runs, where, False)
    return runs


def slice7_tool_runs(workdir: str, files: dict, where) -> dict:
    """pathracer with the first corona profile on the graph of the corona run,
    and mts on the series run's contigs with its three samples, both over
    phase 15's outputs under `workdir`, into `workdir/tools/<name>`."""
    from spades_tpu_torch.tools import mts, pathracer, synthetic

    out = os.path.join(workdir, "tools")
    runs = {}
    _tool("pathracer", pathracer.main,
          [files["corona_hmms"][0], os.path.join(workdir, "corona", GFA_NAME), "-k", "55"],
          os.path.join(out, "pathracer"), runs, where, False)
    samples = []
    for i, (a, b) in enumerate(files["series"][1]):
        samples.append(os.path.join(out, f"series_sample{i + 1}.fasta"))
        synthetic.write_fasta(samples[-1], read_strings(a) + read_strings(b))
    _tool("mts", mts.main, [os.path.join(workdir, "series", "run", "contigs.fasta"), *samples,
                            "-k", "55", "--min-mult", "2"],
          os.path.join(out, "mts"), runs, where, True)
    for p in samples:
        os.unlink(p)
    return runs


def tools_worker(workdir: str, inp: dict) -> int:
    """The CPU side of phase 16 (`--cpu-worker ... --runs tools`)."""
    import torch

    torch.set_num_threads(2)          # beside phase 14 and the slice-7 worker
    runs = tool_twin_runs(workdir, inp, torch.device("cpu"))
    with open(os.path.join(workdir, "runs.json"), "w") as fh:
        json.dump(runs, fh)
    return 0


def start_tools_worker(workdir: str, inp: dict):
    out = os.path.join(workdir, "cpu_side_tools")
    os.makedirs(out)
    log = open(os.path.join(workdir, "cpu_worker_tools.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-worker", out, "--runs", "tools",
         "--sizes", json.dumps(inp)],
        cwd=HERE, stdout=log, stderr=subprocess.STDOUT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    return proc, out, log


def same_trees(name: str, a: str, b: str) -> int:
    """Every file under `a` equals the file of that name under `b`."""
    names, other = files_under(a), files_under(b)
    check(names == other, f"{name}: the card and the CPU wrote different files: "
                          f"{sorted(names ^ other)[:10]}")
    for rel in sorted(names):
        check(same_output(os.path.join(a, rel), os.path.join(b, rel)),
              f"{name}: the card's and the CPU's {rel} differ")
    return len(names)


def phase_tools(dev, workdir: str, inp: dict, isolate: dict, worker, card7: str, files7: dict,
                cpu7: str):
    """Phase 16: the standalone tools on the card.  kmercount at k = 55 and
    21, kmer_estimating at k = 55 and read_filter at k = 21 on the whole
    isolate (with the contaminant); the twin runs of `tool_twin_runs` and
    `slice7_tool_runs`, each file against the CPU's (the tools' worker, and
    the slice-7 worker's runs over its own phase 15 outputs)."""
    import numpy as np

    from spades_tpu_torch.ops import cuda_kernels as CK
    from spades_tpu_torch.tools import kmer_estimating, kmercount, read_filter

    shapes = CK.canonical_window_keys.launch_shapes = collections.Counter()
    out = os.path.join(workdir, "card_side_tools")
    full = {}
    iso = [inp["isolate_1"], inp["isolate_2"]]
    for k in (55, 21):
        _tool(f"kmercount_k{k}", kmercount.main, [*iso, "-k", str(k), "--counts"],
              os.path.join(out, f"kmercount_k{k}"), full, dev, True)
    est_text = _tool("kmer_estimating", kmer_estimating.main, [*iso, "-k", "55"],
                     os.path.join(out, "kmer_estimating"), full, dev, True)
    rf = os.path.join(out, "read_filter")
    _tool("read_filter", read_filter.main,
          ["-1", inp["rf_1"], "-2", inp["rf_2"], "-k", "21", "-c", "2", "-o", rf],
          rf, full, dev, True)
    twins = tool_twin_runs(os.path.join(out, "twins"), inp, dev)
    twins.update(slice7_tool_runs(card7, files7, dev))
    CK.canonical_window_keys.launch_shapes = None
    t_card = time.perf_counter()

    # -- the whole isolate --------------------------------------------------
    unique = {}
    for k in (55, 21):
        words = os.path.getsize(os.path.join(out, f"kmercount_k{k}", "final_kmers"))
        unique[k] = words // (8 * ((2 * k + 63) // 64))
        printed = int(full[f"kmercount_k{k}"]["printed"].split()[0])
        check(printed == unique[k], f"kmercount k={k}: printed {printed}, wrote {unique[k]}")
    check(unique[55] == isolate["unique_k55"],
          f"kmercount k=55: {unique[55]} unique k-mers, phase 3's graph holds "
          f"{isolate['unique_k55']}")
    est = int(est_text.rsplit(":", 1)[1])
    hll_err = abs(est - unique[55]) / unique[55]
    check(hll_err < 0.05, f"kmer_estimating: {est} is {hll_err:.4f} off the exact {unique[55]}")
    kept = {"p": 0, "c": 0}
    with open(os.path.join(rf, "filtered_1.fasta")) as fh:
        for line in fh:
            if line[0] == ">":
                kept[line[1]] += 1
    genome_kept = kept["p"] / inp["pairs"]
    cont_dropped = 1 - kept["c"] / inp["contaminant_pairs"]
    check(genome_kept >= 0.99, f"read_filter kept {genome_kept:.4f} of the genome's pairs")
    check(cont_dropped >= 0.90,
          f"read_filter dropped {cont_dropped:.4f} of the contaminant's pairs")

    # -- the twin runs against the CPU's ------------------------------------
    proc, cpu_dir, log = worker
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=900)
    finally:
        log.close()
    waited = time.perf_counter() - t0
    if rc != 0:
        with open(os.path.join(workdir, "cpu_worker_tools.log")) as fh:
            raise SmokeFailure(f"the tools' CPU worker exited with {rc}: {fh.read()[-3000:]}")
    with open(os.path.join(cpu_dir, "runs.json")) as fh:
        cpu_runs = json.load(fh)
    compared = {}
    for name, r in twins.items():
        if name in ("pathracer", "mts"):
            a, b = os.path.join(card7, "tools", name), os.path.join(cpu7, "tools", name)
        else:
            a, b = os.path.join(out, "twins", name), os.path.join(cpu_dir, name)
            check(r["printed"] == cpu_runs[name]["printed"],
                  f"{name}: the card's and the CPU's printed lines differ")
        compared[name] = {"files": same_trees(name, a, b), "card_s": r["wall_s"]}
        if name in cpu_runs:
            compared[name]["cpu_s"] = cpu_runs[name]["wall_s"]
    for name in (*DEVICE_TWINS, "mts"):
        check(twins[name]["launches"] > 0 or dev.type == "cpu",
              f"{name}: the kernel was not launched")
    check(json.loads(twins["gchecker"]["printed"])["n_contigs"] > 0,
          "gchecker: no contig of 500 nt or more")
    check(twins["pathracer"]["printed"].splitlines()[-1].split()[0] != "0",
          "pathracer: the corona profile has no hit")
    launches = {**{name: r["launches"] for name, r in full.items()},
                "gmapper": twins["gmapper"]["launches"], "mts": twins["mts"]["launches"],
                "corrector_sam_map": twins["sam_map"]["launches"]}
    for name, n in launches.items():
        check(n > 0 or dev.type == "cpu", f"{name}: the kernel was not launched")
    rec = {
        "phase": "tools", "card": nvidia_smi_line() if dev.type == "cuda" else "cpu",
        "dataset": {"isolate_pairs": inp["pairs"], "subset_pairs": inp["subset_pairs"],
                    "contaminant": {"genome_nt": CONTAMINANT_NT, "coverage": CONTAMINANT_COV,
                                    "pairs": inp["contaminant_pairs"]}},
        "wall_s": {**{name: r["wall_s"] for name, r in full.items()},
                   **{name: r["wall_s"] for name, r in twins.items()},
                   "card_side": sum(r["wall_s"] for r in (*full.values(), *twins.values())),
                   "checks_s": time.perf_counter() - t_card, "waited_for_cpu_s": waited},
        "unique_kmers": {"k55": unique[55], "k21": unique[21]},
        "kmer_estimating": {"estimate": est, "relative_error": hll_err},
        "read_filter": {"genome_pairs_kept": genome_kept, "contaminant_pairs_dropped":
                        cont_dropped, "printed": full["read_filter"]["printed"].strip()},
        "gchecker": json.loads(twins["gchecker"]["printed"]),
        "printed": {name: twins[name]["printed"].strip().splitlines()[-1]
                    for name in ("gmapper", "gsimplifier", "corrector_reads", "corrector_sam",
                                 "spaligner", "pathracer", "mts")},
        "card_against_cpu": compared, "tolerance": 0,
        "launches": launches,
        "launch_shapes": {f"{R}x{L} k={k}{' strand' if strand else ''}": n
                          for (R, L, k, strand), n in sorted(shapes.items())},
    }
    return rec, launches, shapes


# ---------------------------------------------------------------------------
# 17. BinSPreader, SPlitteR, wastewater lineages, cds_subgraphs, online_vis,
#     edge positions and the tiled count
# ---------------------------------------------------------------------------

# MetaBAT2's default minimum contig length: the seed binning bins segments of
# this length or more, as users bin contigs before BinSPreader refines them
MIN_BIN_NT = 2_500
# a wastewater sample: a SARS-CoV-2-sized reference, a lineage tree of the
# order of the usher barcode files, 150 bp reads of five lineages
SEWAGE = {"genome_nt": 30_000, "lineages": 2_000, "columns": 3_000, "reads": 500_000,
          "twin_reads": 50_000, "weights": [0.40, 0.25, 0.15, 0.12, 0.08]}
# linked reads of the isolate (10x Chromium / TELL-Seq shape): 30x of 150 bp
LINKED = {"reads": 1_000_000, "twin_reads": 60_000, "molecule_nt": 40_000,
          "molecules_per_barcode": 10}
CDS_ORFS, CDS_RANDOM = 100, 5
# the wastewater check, from the JAX package's `estimate_abundances` on the
# same inputs on the CPU (`python -m tests.test_torch_sewage 42`): the mixture's three
# largest lineages come first in its order, its five lie among the top six
# and hold 0.70 of the abundance (the tree's ancestors take the rest); its
# lineages.csv (40 lineages, 4 decimals) has this SHA-256, and the port's
# must equal it
SEWAGE_TOP_IN_ORDER, SEWAGE_TOP_ALL, SEWAGE_TRUE_SHARE = 3, 6, 0.6
SEWAGE_REFERENCE_SHA256 = {
    42: "e8ff0364dd2f15f5e06f801c233a4f08e6280d6986809030d863c5b170bf17b2"}
VIS_SESSION = "stats\ncontigs 20\nedge {e}\nseq {e} 60\nin {v_in}\nout {v_out}\ndraw {dot}\n" \
              "frobnicate\nedge not-a-number\nexit\n"


def _strings(codes_list) -> list:
    """uint8 code arrays -> strings."""
    import numpy as np

    acgt = np.frombuffer(b"ACGT", np.uint8)
    return [acgt[c].tobytes().decode() for c in codes_list]


def seed_binning(gfa: str, genomes, where, k: int = 55):
    """Bins of the segments of `gfa`: each segment of MIN_BIN_NT or more goes
    to the genome that holds most of its k-mers (`fill_positions` of the
    segment onto the genomes as a k-mer graph, on `where`), and each shorter
    one that lies whole in one genome (every window maps there as one
    sequence) has that genome as its truth.  Returns (seed {name: bin},
    truth {name: bin})."""
    import numpy as np

    from spades_tpu_torch.alignment.mapper import MappingEngine
    from spades_tpu_torch.graph.graph import CondensedGraph
    from spades_tpu_torch.graph.positions import fill_positions
    from spades_tpu_torch.io.gfa import read_gfa

    segs = read_gfa(gfa).segments
    gen = CondensedGraph.from_sequences(_strings(genomes), k)
    hits = {}
    pos = fill_positions(gen, {n: s for n, s in segs.items() if len(s) >= MIN_BIN_NT},
                         device=where)
    for e, ps in pos.by_edge.items():
        for p in ps:
            hits.setdefault(p.name, np.zeros(len(genomes)))[e // 2] += p.ref_end - p.ref_start - k + 1
    seed = {n: f"bin{int(np.argmax(h))}" for n, h in sorted(hits.items())}
    short = sorted(n for n, s in segs.items() if k <= len(s) < MIN_BIN_NT)
    edge, _start, votes = MappingEngine(gen, device=where).map_sequences([segs[n] for n in short])
    truth = {n: f"bin{int(e) // 2}" for n, e, v in zip(short, edge, votes)
             if e >= 0 and v == len(segs[n]) - k + 1}
    return seed, truth


def _write_tsv(path: str, rows: dict) -> str:
    with open(path, "w") as fh:
        fh.writelines(f"{n}\t{b}\n" for n, b in rows.items())
    return path


def tools17_set(d: str, seed: int, where, gfa: str, genomes, pairs, isolate_gfa: str,
                isolate_genome, linked_reads: int, sewage_reads) -> dict:
    """One set of phase 17's inputs under `d`: the metagenome's pairs as
    FASTQ, its seed binning, ORFs of its genomes and random queries for
    cds_subgraphs and a scripted online_vis session (over `gfa`); linked
    reads of `isolate_genome` (over `isolate_gfa`); the wastewater reads
    (`sewage_reads`, uint8 codes).  Returns the paths and truths."""
    import numpy as np

    from spades_tpu_torch.graph.from_gfa import graph_from_gfa
    from spades_tpu_torch.io.gfa import read_gfa
    from spades_tpu_torch.tools import synthetic

    os.makedirs(d, exist_ok=True)
    s = {"dir": d, "gfa": gfa, "isolate_gfa": isolate_gfa}
    for mate, reads in ((1, pairs[0]), (2, pairs[1])):
        s[f"meta_{mate}"] = os.path.join(d, f"meta_{mate}.fq")
        synthetic.write_fastq(s[f"meta_{mate}"], reads, mate)
    seed_bins, truth = seed_binning(gfa, genomes, where)
    s["bins"] = _write_tsv(os.path.join(d, "seed_bins.tsv"), seed_bins)
    s["short_truth"] = truth
    s["seeded"] = len(seed_bins)
    rng = np.random.default_rng(seed + 14)
    queries = []
    for i in range(CDS_ORFS):
        gi = int(rng.integers(0, len(genomes)))
        n = int(rng.integers(1_000, 3_001))
        a = int(rng.integers(0, len(genomes[gi]) - n))
        queries.append((f"orf{i}", genomes[gi][a : a + n]))
    queries += [(f"random{i}", rng.integers(0, 4, int(rng.integers(1_000, 3_001))).astype(np.uint8))
                for i in range(CDS_RANDOM)]
    s["cds"] = os.path.join(d, "cds.fasta")
    with open(s["cds"], "w") as fh:
        fh.writelines(f">{n}\n{q}\n" for n, q in zip([n for n, _ in queries],
                                                     _strings([q for _, q in queries])))
    g = graph_from_gfa(read_gfa(gfa), 55)
    e = max((int(x) for x in g.canonical_edge_ids()), key=lambda x: (int(g.e_len[x]), -x))
    s["vis"] = os.path.join(d, "vis_session.txt")
    s["dot"] = os.path.join(d, "vis.dot")
    with open(s["vis"], "w") as fh:
        fh.write(VIS_SESSION.format(e=e, v_in=int(g.e_end[e]), v_out=int(g.e_start[e]),
                                    dot=s["dot"]))
    reads, barcode = synthetic.make_linked_reads(
        isolate_genome, linked_reads, seed + 10, molecule_nt=LINKED["molecule_nt"],
        molecules_per_barcode=LINKED["molecules_per_barcode"])
    s["linked"] = os.path.join(d, "linked.fq")
    synthetic.write_fastq(s["linked"], reads, 1, prefix="l",
                          comments=[f"BX:Z:{b}-1" for b in barcode.tolist()])
    s["sewage_reads"] = os.path.join(d, "sewage_reads.fq")
    synthetic.write_fastq(s["sewage_reads"], sewage_reads, 1, prefix="s")
    return s


def tools17_inputs(workdir: str, seed: int, where, isolate: dict, community: dict,
                   gap_state: dict, small_meta: str, small_sizes: dict) -> dict:
    """Phase 17's shared inputs, written before phase 14: the wastewater
    reference and barcode CSV (both sides use the whole matrix), the
    metagenome's and the isolate's data for the card's process, and the cut
    set of the twin runs (phase 9's 300 kb copy, the gap set, 50,000
    wastewater reads), the same bytes for the card and the CPU."""
    import numpy as np

    from spades_tpu_torch.tools import synthetic

    d = os.path.join(workdir, "tools17_in")
    os.makedirs(d)
    inp = {"dir": d, "seed": seed, "device": where.type}
    ref, cols, member = synthetic.make_lineage_barcodes(
        SEWAGE["genome_nt"], SEWAGE["lineages"], SEWAGE["columns"], seed + 11)
    lins = sorted(np.random.default_rng(seed + 12).choice(
        np.arange(SEWAGE["lineages"] // 2, SEWAGE["lineages"]), 5, replace=False).tolist())
    reads = synthetic.lineage_mixture_reads(ref, cols, member, lins, SEWAGE["weights"],
                                            SEWAGE["reads"], seed + 13)
    inp["mixture"] = {f"lin{i}": w for i, w in zip(lins, SEWAGE["weights"])}
    inp["sewage_ref"] = os.path.join(d, "sewage_ref.fasta")
    synthetic.write_fasta(inp["sewage_ref"], _strings([ref]))
    inp["barcodes"] = os.path.join(d, "barcodes.csv")
    synthetic.write_barcodes_csv(inp["barcodes"], cols, member)
    # the card's process writes the full set from these arrays
    inp["full_arrays"] = os.path.join(d, "full_arrays.npz")
    np.savez(inp["full_arrays"], isolate=isolate["genome"], sewage=reads,
             r1=community["r1"], r2=community["r2"],
             **{f"genome{i}": g for i, g in enumerate(community["genomes"])})
    # the tiled count's batch: its plain path runs in the CPU worker
    inp["count_batch"] = os.path.join(d, "count_batch.npy")
    np.save(inp["count_batch"], isolate["batch"])
    inp["meta_gfa"] = os.path.join(workdir, "meta", GFA_NAME)
    inp["isolate_gfa"] = os.path.join(workdir, "assembly", GFA_NAME)
    # the twin set: phase 9's 300 kb copy, the gap set, the first wastewater reads
    scaled = [s * small_sizes["meta_total"] // sum(META_SIZES) for s in META_SIZES]
    small_g, s1, s2, _o = synthetic.make_community(scaled, META_COVERAGES, 150, 0.003, seed + 4)
    inp["twin"] = tools17_set(os.path.join(d, "twin"), seed, where,
                              os.path.join(small_meta, GFA_NAME), small_g, (s1, s2),
                              os.path.join(gap_state["out"], GFA_NAME), gap_state["genome"],
                              LINKED["twin_reads"], reads[: SEWAGE["twin_reads"]])
    inp["twin"]["genome"] = os.path.join(d, "twin", "gap_genome.fasta")
    synthetic.write_fasta(inp["twin"]["genome"], _strings([gap_state["genome"]]))
    return inp


def _tool17_runs(out: str, s: dict, inp: dict, where, suffix: str = "") -> dict:
    """binspreader (majority_length, then max_likelihood --multi), splitter,
    sewage, cds_subgraphs and online_vis over one set `s`, into `out/<name>`;
    with the wastewater abundances at full precision."""
    import io

    from spades_tpu_torch.io.fastx import read_fastx, read_sequences
    from spades_tpu_torch.sewage import estimate_abundances, read_barcodes_csv
    from spades_tpu_torch.tools import binspreader, cds_subgraphs, online_vis, sewage, splitter

    runs = {}
    mates = ["-1", s["meta_1"], "-2", s["meta_2"]]
    _tool("binspreader" + suffix, binspreader.main,
          [s["gfa"], s["bins"], "-k", "55", *mates, "--bin-dist", "--reads-split"],
          os.path.join(out, "binspreader" + suffix), runs, where, True)
    _tool("binspreader_ml" + suffix, binspreader.main,
          [s["gfa"], s["bins"], "-k", "55", *mates, "--bin-dist", "--reads-split",
           "--assignment", "max_likelihood", "--multi"],
          os.path.join(out, "binspreader_ml" + suffix), runs, where, True)
    _tool("splitter" + suffix, splitter.main,
          [s["isolate_gfa"], s["linked"], "-k", "55", "--mapping-k", "31"],
          os.path.join(out, "splitter" + suffix), runs, where, True)
    _tool("sewage" + suffix, sewage.main, [inp["sewage_ref"], inp["barcodes"], s["sewage_reads"]],
          os.path.join(out, "sewage" + suffix), runs, where, True)
    if suffix:          # the abundances at full precision, held within 1e-9
        ref = next(iter(read_fastx(inp["sewage_ref"]))).seq
        runs["abundances"] = estimate_abundances(
            ref, list(read_sequences([s["sewage_reads"]])), read_barcodes_csv(inp["barcodes"]),
            device=where)
    _tool("cds_subgraphs" + suffix, cds_subgraphs.main, [s["gfa"], s["cds"], "-k", "55"],
          os.path.join(out, "cds_subgraphs" + suffix), runs, where, True)
    from spades_tpu_torch.graph.from_gfa import graph_from_gfa
    from spades_tpu_torch.io.gfa import read_gfa

    t0 = time.perf_counter()
    buf = io.StringIO()
    with open(s["vis"]) as fh:
        online_vis.repl(graph_from_gfa(read_gfa(s["gfa"]), 55), out=buf, inp=fh)
    os.makedirs(os.path.join(out, "online_vis" + suffix))
    shutil.move(s["dot"], os.path.join(out, "online_vis" + suffix, "vis.dot"))
    runs["online_vis" + suffix] = {"wall_s": time.perf_counter() - t0,
                                   "printed": buf.getvalue().replace(s["dot"], "<dot>")}
    return runs


def _positions_json(path: str, pos) -> str:
    with open(path, "w") as fh:
        json.dump({str(e): [str(p) for p in ps] for e, ps in pos.by_edge.items()}, fh)
    return path


def tools17_twin_runs(out: str, inp: dict, where) -> dict:
    """The runs both sides make on the twin set, and the gap set's positions."""
    from spades_tpu_torch.graph.from_gfa import graph_from_gfa
    from spades_tpu_torch.graph.positions import fill_positions
    from spades_tpu_torch.io.fastx import read_fastx
    from spades_tpu_torch.io.gfa import read_gfa

    s = inp["twin"]
    runs = _tool17_runs(out, s, inp, where, suffix="_twin")
    t0 = time.perf_counter()
    g = graph_from_gfa(read_gfa(s["isolate_gfa"]), 55)
    genome = next(iter(read_fastx(s["genome"]))).seq
    os.makedirs(os.path.join(out, "positions_twin"))
    _positions_json(os.path.join(out, "positions_twin", "positions.json"),
                    fill_positions(g, {"genome": genome}, device=where))
    runs["positions_twin"] = {"wall_s": time.perf_counter() - t0, "printed": ""}
    return runs


def tools17_card(workdir: str, inp: dict) -> int:
    """The card's side of phase 17's tool runs (`--runs tools17_card`), in a
    process of its own beside phase 14: the full set's inputs, then every
    tool on it and on the twin set on the card, each counting its launches;
    the kernel shapes of all of them."""
    import numpy as np
    import torch

    from spades_tpu_torch.ops import cuda_kernels as CK

    torch.set_num_threads(2)          # beside phase 14 and the CPU workers
    dev = torch.device(inp["device"])        # "cpu" in a rehearsal
    t0 = time.perf_counter()
    arr = np.load(inp["full_arrays"])
    genomes = [arr[f"genome{i}"] for i in range(len(META_SIZES))]
    full = tools17_set(os.path.join(inp["dir"], "full"), inp["seed"], dev, inp["meta_gfa"],
                       genomes, (arr["r1"], arr["r2"]), inp["isolate_gfa"], arr["isolate"],
                       LINKED["reads"], arr["sewage"])
    del arr
    inputs_s = time.perf_counter() - t0
    shapes = CK.canonical_window_keys.launch_shapes = collections.Counter()
    runs = _tool17_runs(os.path.join(workdir, "full"), full, inp, dev)
    runs.update(tools17_twin_runs(os.path.join(workdir, "twins"), inp, dev))
    rec = {"runs": runs, "inputs_s": inputs_s, "full": full,
           "shapes": [[*key, n] for key, n in shapes.items()]}
    with open(os.path.join(workdir, "runs.json"), "w") as fh:
        json.dump(rec, fh)
    return 0


def count_batch_packed(path: str, dev):
    """Phase 17's count batch (reads of uint8 codes) padded to 256, packed
    on `dev`: (pc, pn, lengths, L) and its reads as strings."""
    import numpy as np
    import torch

    from spades_tpu_torch.core.reads import ReadBatch

    reads = _strings(np.load(path))
    pc, pn, ln, L = ReadBatch.from_sequences(reads, pad_len_to=256).packed()
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (pc, pn, ln)], L, reads


def tools17_worker(workdir: str, inp: dict) -> int:
    """The CPU side of phase 17 (`--runs tools17`): the twin runs, and the
    plain path of the tiled count on its batch."""
    import numpy as np
    import torch

    from spades_tpu_torch.ops import count as C

    torch.set_num_threads(2)          # beside phase 14 and the other workers
    runs = tools17_twin_runs(workdir, inp, torch.device("cpu"))
    args, L, _reads = count_batch_packed(inp["count_batch"], torch.device("cpu"))
    outs = (*C.count_batch_device(*args, L, 55), *C.count_batch_device_tiled(*args, L, 55, 512))
    np.savez(os.path.join(workdir, "count_plain.npz"), *[o.numpy() for o in outs])
    with open(os.path.join(workdir, "runs.json"), "w") as fh:
        json.dump(runs, fh)
    return 0


def start_tools17(workdir: str, inp: dict, side: str):
    """Start phase 17's card process (`side` "card": on `inp["device"]`) or
    its CPU worker (`side` "cpu")."""
    out = os.path.join(workdir, f"{side}_side_tools17")
    os.makedirs(out)
    log = open(os.path.join(workdir, f"tools17_{side}.log"), "w")
    env = dict(os.environ, **({"CUDA_VISIBLE_DEVICES": ""} if side == "cpu" else {}))
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-worker", out, "--runs",
         "tools17" if side == "cpu" else "tools17_card", "--sizes", json.dumps(inp)],
        cwd=HERE, stdout=log, stderr=subprocess.STDOUT, env=env)
    return proc, out, log


def _wait(name: str, worker, workdir: str, timeout_s: int = 900):
    proc, out, log = worker
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=timeout_s)
    finally:
        log.close()
    if rc != 0:
        with open(log.name) as fh:
            raise SmokeFailure(f"{name} process exited with {rc}: {fh.read()[-3000:]}")
    with open(os.path.join(out, "runs.json")) as fh:
        return json.load(fh), out, time.perf_counter() - t0


def _adjacent(pos, a: int, b: int, conj, k: int) -> bool | None:
    """Do oriented edges a then b follow each other in the genome (one
    interval of each, b starting k - 1... k bases before a ends)?  None when
    either has no interval."""
    def spans(e):
        c = min(e, int(conj[e]))
        flip = c != e
        return [(p.ref_start, p.ref_end, p.strand ^ flip) for p in pos.positions_of(c)]
    sa, sb = spans(a), spans(b)
    if not sa or not sb:
        return None
    return any((st_a == st_b == 0 and bs == ae - k) or (st_a == st_b == 1 and be == as_ + k)
               for as_, ae, st_a in sa for bs, be, st_b in sb)


def phase_tools17(dev, workdir: str, inp: dict, isolate: dict, card, worker):
    """Phase 17: edge positions of the isolate's K = 55 graph and the tiled
    count on the card in this process; the tool runs of the card's process
    (started before phase 14) checked, and its twin runs held against the
    CPU worker's."""
    import numpy as np
    import torch

    from spades_tpu_torch.alignment.mapper import MappingEngine
    from spades_tpu_torch.core import dna
    from spades_tpu_torch.core.reads import ReadBatch
    from spades_tpu_torch.graph.from_gfa import graph_from_gfa
    from spades_tpu_torch.graph.positions import fill_positions
    from spades_tpu_torch.io.fastx import read_fastx
    from spades_tpu_torch.io.gfa import read_gfa
    from spades_tpu_torch.ops import count as C
    from spades_tpu_torch.ops import cuda_kernels as CK
    from spades_tpu_torch.tools import kernel_shapes as KS

    launches, wall = {}, {}
    shapes = CK.canonical_window_keys.launch_shapes = collections.Counter()
    # -- edge positions: the launch count from 0, read right after -------------
    g = graph_from_gfa(read_gfa(inp["isolate_gfa"]), 55)
    genome = _strings([isolate["genome"]])[0]
    CK.canonical_window_keys.launches = 0
    t0 = time.perf_counter()
    pos = fill_positions(g, {"genome": genome}, device=dev)
    sync(dev)
    wall["positions_s"] = time.perf_counter() - t0
    launches["positions"] = CK.canonical_window_keys.launches
    # an edge's first or last window belongs to the edge beside it when both
    # hold that junction k-mer (the index keeps one copy): it shows as a
    # one-window interval there, and the edge's own interval stops a base short
    placed = {"edges_1kb": 0, "non_repeat": 0, "covered_whole": 0, "repeat": 0}
    for e in g.canonical_edge_ids():
        e = int(e)
        if g.e_len[e] < 1_000 or not g.alive[e]:
            continue
        placed["edges_1kb"] += 1
        ps = pos.positions_of(e)
        check(ps, f"positions: edge {e} of {int(g.e_len[e])} nt has no interval")
        for p in ps:          # an interval of exact k-mer hits spells the genome
            seq = genome[p.ref_start : p.ref_end]
            check(g.edge_seq(e)[p.edge_start : p.edge_end]
                  == (seq if p.strand == 0 else dna.revcomp_str(seq)),
                  f"positions: edge {e}'s interval {p} does not spell the genome")
        runs = [p for p in ps if p.ref_end - p.ref_start > 55]
        if len(runs) > 1:
            placed["repeat"] += 1
            continue
        placed["non_repeat"] += 1
        placed["covered_whole"] += bool(runs and runs[0].edge_start <= 1
                                        and runs[0].edge_end >= g.e_len[e] - 1)
    check(placed["covered_whole"] >= 0.95 * placed["non_repeat"] > 0, f"positions: {placed}")

    # -- the tiled count: 65,536 reads of the isolate, padded to 256, k = 55 --
    t0 = time.perf_counter()
    args, L, reads = count_batch_packed(inp["count_batch"], dev)
    CK.canonical_window_keys.launches = 0
    got = C.count_batch_device(*args, L, 55)
    tiles = C.count_batch_device_tiled(*args, L, 55, tile=512)
    sync(dev)
    launches["count_tiled"] = CK.canonical_window_keys.launches
    CK.canonical_window_keys.launch_shapes = None

    def runs_of(words, starts, nv):
        w, st, n = words.cpu().numpy(), starts.cpu().numpy(), int(nv)
        idx = np.flatnonzero(st[:n])
        return C.KmerCounts(55, w[idx].astype(np.uint32),
                            np.diff(np.append(idx, n)).astype(np.int64))

    whole = runs_of(*got)
    # each tile's run (its starts among its valid rows), pulled at once
    w, st, nv = (x.cpu().numpy() for x in tiles)
    T, tile = st.shape
    first = np.flatnonzero(st & (np.arange(tile)[None, :] < nv[:, None]))
    t_of = first // tile
    end = np.append(first[1:], 0)
    last = np.append(t_of[1:] != t_of[:-1], True)
    end[last] = t_of[last] * tile + nv[t_of[last]]
    bounds = np.searchsorted(t_of, np.arange(1, T))
    merged = C.merge_counts([C.KmerCounts(55, a, b) for a, b in zip(
        np.split(w.reshape(-1, w.shape[-1])[first].astype(np.uint32), bounds),
        np.split((end - first).astype(np.int64), bounds))])
    direct = C.count_reads([ReadBatch.from_sequences(reads, pad_len_to=256)], 55, device=dev)
    for name, other in (("merged tiles", merged), ("count_reads", direct)):
        check(np.array_equal(other.words, whole.words)
              and np.array_equal(other.counts, whole.counts),
              f"count: the {name} differ from the untiled count")
    count_ms = {"untiled": KS.time_ms(lambda: C.count_batch_device(*args, L, 55), dev, 10),
                "tiled": KS.time_ms(lambda: C.count_batch_device_tiled(*args, L, 55, 512),
                                    dev, 10)}
    wall["count_s"] = time.perf_counter() - t0

    # -- the card's tool runs ------------------------------------------------
    rec_card, card_dir, waited_card = _wait("phase 17's card", card, workdir)
    runs, full = rec_card["runs"], rec_card["full"]
    for name in ("binspreader", "binspreader_ml", "splitter", "sewage", "cds_subgraphs"):
        check(runs[name]["launches"] > 0 or dev.type == "cpu",
              f"{name}: the kernel was not launched")
        launches[name] = runs[name]["launches"]
    for name in ("positions", "count_tiled"):
        check(launches[name] > 0 or dev.type == "cpu", f"{name}: the kernel was not launched")
    for R, L_, k, strand, n in rec_card["shapes"]:
        shapes[(R, L_, k, bool(strand))] += n
    bins = {}
    for name in ("binspreader", "binspreader_ml"):
        with open(os.path.join(card_dir, "full", name, "binning.tsv")) as fh:
            got_bins = {}
            for line in fh:
                n, b = line.rstrip("\n").split("\t")
                got_bins.setdefault(n, set()).add(b)
        truth = full["short_truth"]
        right = sum(1 for n, b in truth.items() if got_bins.get(n) == {b})
        holds = sum(1 for n, b in truth.items() if b in got_bins.get(n, ()))
        bins[name] = {"short_in_one_genome": len(truth), "given_its_bin_alone": right,
                      "share": right / max(len(truth), 1), "share_holding_its_bin":
                      holds / max(len(truth), 1), "segments_binned": len(got_bins),
                      "seeded": full["seeded"],
                      "printed": runs[name]["printed"].strip().splitlines()[-1]}
    check(bins["binspreader"]["share"] > 0.5, f"binspreader: {bins['binspreader']}")
    # splitter: the vertex states and the resolved pairs laid onto the genome
    states, pairs = collections.Counter(), {"resolved": 0, "adjacent": 0, "not_adjacent": 0,
                                            "unplaced": 0}
    with open(os.path.join(card_dir, "full", "splitter", "vertex_results.tsv")) as fh:
        next(fh)
        for line in fh:
            f = line.rstrip("\n").split("\t")
            states[f[5]] += 1
            for pair in filter(None, f[9].split(",")):
                a, b = map(int, pair.split("#"))
                pairs["resolved"] += 1
                adj = _adjacent(pos, a, b, g.e_conj, 55)
                pairs["unplaced" if adj is None else "adjacent" if adj else "not_adjacent"] += 1
    # a random genome's repeats longer than k are edges between vertices of
    # in- or out-degree 1, so few complex vertices (in and out >= 2) exist;
    # the barcode index must hold the clouds all the same
    entries = int(runs["splitter"]["printed"].split("barcode index: ")[1].split()[0])
    check(entries > 0, "splitter: the barcode index is empty")
    # the wastewater sample against the mixture, as the JAX package gives it
    import hashlib

    csv = read_bytes(os.path.join(card_dir, "full", "sewage", "lineages.csv"))
    rows = [ln.split(",") for ln in csv.decode().splitlines()[1:]]
    lineages = [n for n, _a in rows]
    abund = {n: float(a) for n, a in rows}
    sha = hashlib.sha256(csv).hexdigest()
    if inp["seed"] in SEWAGE_REFERENCE_SHA256:
        check(sha == SEWAGE_REFERENCE_SHA256[inp["seed"]],
              f"sewage: lineages.csv is not the JAX package's ({len(rows)} lineages, "
              f"sha256 {sha})")
    mix = inp["mixture"]
    order = sorted(mix, key=lambda n: -mix[n])
    true_share = sum(abund.get(n, 0.0) for n in mix) / max(sum(abund.values()), 1e-12)
    check(lineages[:SEWAGE_TOP_IN_ORDER] == order[:SEWAGE_TOP_IN_ORDER]
          and set(mix) <= set(lineages[:SEWAGE_TOP_ALL]) and true_share >= SEWAGE_TRUE_SHARE,
          f"sewage: {lineages[:8]} against the mixture {order} (share {true_share:.3f})")
    # cds_subgraphs: each ORF's subgraph holds the edge it maps to
    gm = graph_from_gfa(read_gfa(inp["meta_gfa"]), 55)
    names = [r.name for r in read_fastx(full["cds"])]
    edges = MappingEngine(gm, device=dev).map_sequences(
        [r.seq for r in read_fastx(full["cds"])])[0]
    printed = runs["cds_subgraphs"]["printed"]
    for n, e in zip(names, edges.tolist()):
        if n.startswith("random"):
            check(f"{n}: no graph hit" in printed, f"cds_subgraphs: {n} hit the graph")
            continue
        check(e >= 0, f"cds_subgraphs: {n} maps nowhere")
        seq = gm.edge_seq(min(e, int(gm.e_conj[e])))
        with open(os.path.join(card_dir, "full", "cds_subgraphs", f"{n}.gfa")) as fh:
            check(any(ln.split("\t")[2] == seq for ln in fh if ln.startswith("S\t")),
                  f"cds_subgraphs: {n}'s subgraph lacks the edge it maps to")
    vis = runs["online_vis"]["printed"]
    check("segments" in vis and "unknown command 'frobnicate'" in vis and "error:" in vis
          and os.path.getsize(os.path.join(card_dir, "full", "online_vis", "vis.dot")) > 0,
          "online_vis: the session's transcript is wrong")

    # -- the twin runs against the CPU's -------------------------------------
    cpu_runs, cpu_dir, waited_cpu = _wait("phase 17's CPU", worker, workdir)
    compared = {}
    for name, r in runs.items():
        if not name.endswith("_twin"):
            continue
        check(r["printed"] == cpu_runs[name]["printed"],
              f"{name}: the card's and the CPU's printed lines differ")
        compared[name] = {"files": same_trees(name, os.path.join(card_dir, "twins", name),
                                              os.path.join(cpu_dir, name)),
                          "card_s": r["wall_s"], "cpu_s": cpu_runs[name]["wall_s"]}
    # the tiled count: the card's output against the plain path's (the worker's)
    with np.load(os.path.join(cpu_dir, "count_plain.npz")) as plain:
        for i, out in enumerate((*got, *tiles)):
            check(np.array_equal(out.cpu().numpy(), plain[f"arr_{i}"]),
                  f"count: output {i} of the card differs from the plain path's")
    a, b = runs["abundances"], cpu_runs["abundances"]
    check([n for n, _ in a] == [n for n, _ in b]
          and max((abs(x - y) for (_, x), (_, y) in zip(a, b)), default=0.0) <= 1e-9,
          "sewage: the card's and the CPU's abundances differ by more than 1e-9")
    rec = {
        "phase": "tools17", "card": nvidia_smi_line() if dev.type == "cuda" else "cpu",
        "dataset": {"sewage": SEWAGE, "mixture": mix, "linked": LINKED,
                    "cds": {"orfs": CDS_ORFS, "random": CDS_RANDOM}},
        "wall_s": {**wall, **{n: r["wall_s"] for n, r in runs.items() if n != "abundances"},
                   "card_inputs_s": rec_card["inputs_s"], "waited_for_card_s": waited_card,
                   "waited_for_cpu_s": waited_cpu},
        "positions": placed, "count_ms": count_ms,
        "count": {"windows": int(got[0].shape[0]), "unique": int(whole.num_unique),
                  "tiles": int(tiles[0].shape[0])},
        "binspreader": bins, "splitter": {"states": dict(states), "pairs": pairs,
                                          "index_entries": entries,
                                          "printed": runs["splitter"]["printed"].strip()},
        "sewage": {"top": list(zip(lineages[:10], [abund[n] for n in lineages[:10]])),
                   "mixture_share": true_share, "lineages": len(lineages),
                   "lineages_csv_sha256": sha},
        "card_against_cpu": compared, "tolerance": {"files": 0, "abundances": 1e-9},
        "launches": launches,
        "launch_shapes": {f"{R}x{L_} k={k}{' strand' if st else ''}": n
                          for (R, L_, k, st), n in sorted(shapes.items())},
    }
    return rec, launches, shapes


# ---------------------------------------------------------------------------
# 13. the shapes the paths gave the kernel that phase 2 did not hold
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# 18. multi-GPU on torch.distributed
# ---------------------------------------------------------------------------

SHARDED_SUBSET_PAIRS = 65_536       # the pairs of (a)'s group mapping, votes and hits


def sharded_construction(dev, inp: dict, group):
    """Phase 3's isolate under `group`: the sharded count of its 56-mers
    (each rank its share of every chunk) and `construct_graph` at k = 55,
    each checked against phase 3's digests.  Returns (record, store, graph,
    reads); the record's launches count both runs."""
    from spades_tpu_torch.core.reads import ReadStore
    from spades_tpu_torch.io.fastx import read_sequences
    from spades_tpu_torch.ops import cuda_kernels as CK
    from spades_tpu_torch.parallel.distributed import EXCHANGED, rank_and_size
    from spades_tpu_torch.parallel.sharded_count import count_kmers_sharded
    from spades_tpu_torch.pipeline.construction import construct_graph

    rank, world = rank_and_size(group)
    name = f"rank {rank} of {world}"
    wall = {}
    t0 = time.perf_counter()
    reads = list(read_sequences(inp["paths"]))
    store = ReadStore.build(reads)
    wall["inputs_s"] = time.perf_counter() - t0
    CK.canonical_window_keys.launches = 0
    sent0 = EXCHANGED["bytes"]
    t0 = time.perf_counter()
    kc = count_kmers_sharded(store.chunks, 56, group=group, device=dev, share=True)
    sync(dev)
    wall["count_s"] = time.perf_counter() - t0
    count_bytes = EXCHANGED["bytes"] - sent0
    check(digest(kc.words, kc.counts) == inp["digests"]["p1"],
          f"{name}: the sharded count differs from phase 3's")
    t0 = time.perf_counter()
    res = construct_graph(reads, 55, read_store=store, device=dev, group=group)
    sync(dev)
    wall["construct_graph_s"] = time.perf_counter() - t0
    got = construction_digests(res.p1_counts, res.graph)
    check(got["p1"] == inp["digests"]["p1"],
          f"{name}: construct_graph's counts differ from phase 3's")
    for f, want in inp["digests"]["graph"].items():
        check(got["graph"][f] == want, f"{name}: construct_graph's {f} differs from phase 3's")
    rec = {"rank": rank, "world": world, "wall_s": wall, "unique_p1": kc.num_unique,
           "count_bytes_sent": count_bytes,
           "construct_bytes_sent": res.timings["exchanged_bytes"],
           "construct_timings": res.timings,
           "launches": CK.canonical_window_keys.launches}
    return rec, store, res.graph, reads


def sharded_mapping_checks(dev, group, graph, reads, n_pairs: int, sub_pairs: int) -> dict:
    """Group map / votes / hits of `sub_pairs` pairs on the graph against
    the same calls on one device; returns times and the launches of the
    group calls."""
    import types

    import numpy as np

    from spades_tpu_torch.core import kmers as K
    from spades_tpu_torch.core.reads import ReadBatch, ReadStore
    from spades_tpu_torch.ops import cuda_kernels as CK
    from spades_tpu_torch.parallel import sharded_mapping as SM

    sub_pairs = min(sub_pairs, n_pairs)
    sub = reads[:sub_pairs] + reads[n_pairs : n_pairs + sub_pairs]
    store = ReadStore.build(sub)
    batch = ReadBatch.from_sequences(sub)
    prep = SM.build_index_device(graph, 55, dev)
    k55 = types.SimpleNamespace(k=55)
    tips = K.keys_to_words(prep[0][:, ::97].T.contiguous().cpu().numpy(), K.kmer_words(55))
    calls = {
        "map_reads_sharded": lambda g: SM.map_reads_sharded(k55, graph, batch, dev, prep=prep,
                                                            group=g),
        "position_votes_sharded": lambda g: SM.position_votes_sharded(
            k55, graph, store=store, prep=prep, device=dev, group=g),
        "hit_filter_store": lambda g: SM.hit_filter_store(store, tips, 55, device=dev, group=g),
    }
    single = {name: fn(None) for name, fn in calls.items()}     # one device (world size 1)
    rec = {"pairs": sub_pairs, "wall_s": {}}
    CK.canonical_window_keys.launches = 0
    for name, fn in calls.items():
        t0 = time.perf_counter()
        got = fn(group)
        sync(dev)
        rec["wall_s"][name] = time.perf_counter() - t0
        want = single[name]
        same = (all(np.array_equal(a, b) for a, b in zip(got, want)) if isinstance(got, tuple)
                else np.array_equal(got, want))
        check(same, f"(a): the group {name} differs from the single-device call")
    rec["mapped"] = int((single["map_reads_sharded"][0] >= 0).sum())
    rec["hits"] = int(single["hit_filter_store"].sum())
    rec["launches"] = CK.canonical_window_keys.launches
    return rec


SHARDED_DE_ROWS = 2_000_000        # raw pair rows of (a)'s distance clustering


def sharded_de_check(dev, group, n: int = SHARDED_DE_ROWS) -> dict:
    """`estimate_simple_sharded` of a seeded raw pair table under `group`
    on the card against the port's CPU result: e1 and e2 equal, dist and
    weight within rtol 1e-5 (CUDA's `index_add_` sums float32 in another
    order).  Returns times and sizes."""
    import numpy as np

    from spades_tpu_torch.paired.paired_info import PairedIndex
    from spades_tpu_torch.parallel.sharded_de import estimate_simple_sharded

    rng = np.random.default_rng(18)
    e1, e2 = rng.integers(0, 20_000, n), rng.integers(0, 20_000, n)
    # half the rows in 500 heavy groups of about 2,000 rows, each one cluster
    e1[: n // 2], e2[: n // 2] = rng.integers(0, 500, n // 2), 0
    d = rng.integers(0, 1_000, n)
    o = np.lexsort((d, e2, e1))
    pi = PairedIndex(e1[o], e2[o], d[o], (rng.integers(1, 50, n) / 7.0)[o])
    t0 = time.perf_counter()
    got = estimate_simple_sharded(pi, group=group, device=dev)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = estimate_simple_sharded(pi, device="cpu")
    cpu_wall = time.perf_counter() - t0
    check(np.array_equal(got.e1, ref.e1) and np.array_equal(got.e2, ref.e2),
          "(a): the group distance clusters differ from the CPU's")
    check(np.allclose(got.dist, ref.dist, rtol=1e-5, atol=0)
          and np.allclose(got.weight, ref.weight, rtol=1e-5, atol=0),
          "(a): the group distance estimates differ from the CPU's beyond rtol 1e-5")
    return {"rows": n, "clusters": int(ref.e1.size), "wall_s": wall, "cpu_wall_s": cpu_wall,
            "max_rel_dist": float(np.max(np.abs(got.dist - ref.dist)
                                         / np.maximum(np.abs(ref.dist), 1e-30))),
            "max_rel_weight": float(np.max(np.abs(got.weight - ref.weight) / ref.weight))}


def sharded_rank(workdir: str, inp: dict) -> int:
    """One rank of (b) (`--runs sharded_rank`): gloo on the card, beside
    the other rank in a process of its own."""
    import torch
    import torch.distributed as dist

    from spades_tpu_torch.ops import cuda_kernels as CK
    from spades_tpu_torch.parallel.distributed import init_distributed

    torch.set_num_threads(2)
    dev = torch.device(inp["device"])
    init_distributed(f"localhost:{inp['port']}", 2, inp["rank"], backend="gloo", device=dev)
    shapes = CK.canonical_window_keys.launch_shapes = collections.Counter()
    t0 = time.perf_counter()
    rec, *_ = sharded_construction(dev, inp, dist.group.WORLD)
    rec["rank_wall_s"] = time.perf_counter() - t0
    rec["shapes"] = [[*key, n] for key, n in shapes.items()]
    dist.destroy_process_group()
    with open(os.path.join(workdir, "runs.json"), "w") as fh:
        json.dump(rec, fh)
    return 0


def _run_ranks(cmds, outs, env, timeout_s: float):
    """Start one process per command; returns each one's wall seconds
    (until it exited) and its stderr.  Raises unless every one exits 0."""
    t0 = time.perf_counter()
    procs = []
    for cmd, out in zip(cmds, outs):
        with open(out + ".out", "w") as fo, open(out + ".err", "w") as fe:
            procs.append(subprocess.Popen(cmd, cwd=HERE, env=env, stdout=fo, stderr=fe))
    walls = [None] * len(procs)
    try:
        while any(w is None for w in walls):
            check(time.perf_counter() - t0 < timeout_s, "phase 18: a rank ran past its time")
            for i, p in enumerate(procs):
                if walls[i] is None and p.poll() is not None:
                    walls[i] = time.perf_counter() - t0
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    errs = []
    for p, out in zip(procs, outs):
        with open(out + ".err") as fh:
            errs.append(fh.read())
        check(p.returncode == 0, f"phase 18: {' '.join(p.args[1:4])} exited with "
                                 f"{p.returncode}: {errs[-1][-3000:]}")
    return walls, errs


def sharded_cli(dev, workdir: str, inp: dict) -> dict:
    """`python -m spades_tpu_torch.pipeline.main -k 55 --careful
    --num-processes 2` on phase 8's FASTQ, two gloo ranks on the card, rank 1
    given an output directory of its own: rank 0's corrected reads, contigs
    and scaffolds must equal phase 8's, and rank 1's directory must not
    exist."""
    import re

    from spades_tpu_torch.parallel.dryrun import free_port

    outs = [os.path.join(workdir, "cli_np2"), os.path.join(workdir, "cli_np2_rank1")]
    cmd = [sys.executable, "-m", "spades_tpu_torch.pipeline.main", "-1", inp["cli_fastq"][0],
           "-2", inp["cli_fastq"][1], "-k", str(inp["cli_k"]), "--careful",
           "--num-processes", "2", "--coordinator", f"localhost:{free_port()}",
           "--dist-backend", "gloo"] + (["--device", "cpu"] if dev.type == "cpu" else [])
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    walls, errs = _run_ranks([cmd + ["--process-id", str(r), "-o", outs[r]] for r in range(2)],
                             [os.path.join(workdir, f"cli_np2_r{r}") for r in range(2)], env,
                             900)
    check(not os.path.exists(outs[1]), "phase 18: rank 1 of the CLI wrote its output directory")
    for name in ("corrected/lib1_1.cor.fasta", "corrected/lib1_2.cor.fasta", "contigs.fasta",
                 "scaffolds.fasta"):
        check(read_bytes(os.path.join(outs[0], name))
              == read_bytes(os.path.join(inp["cli_out"], name)),
              f"phase 18: the two-rank CLI's {name} differs from phase 8's")
    launches, per_k, sent = [], [], []
    for r, err in enumerate(errs):
        found = re.findall(r"kernel launches: canonical_windows=(\d+)", err)
        check(len(found) == 1, f"phase 18: CLI rank {r} does not say how often it launched B1")
        launches.append(int(found[0]))
        per_k.append({int(k): int(b) for k, b in
                      re.findall(r"k=(\d+): \d+ unique \(k\+1\)-mers.*'exchanged_bytes': (\d+)",
                                 err)})
        total = re.findall(r"collectives: (\d+) bytes sent in (\d+)", err)
        check(len(total) == 1, f"phase 18: CLI rank {r} does not say what it sent")
        sent.append([int(x) for x in total[0]])
    return {"wall_s": walls, "launches": launches, "construction_bytes_sent_per_k": per_k,
            "bytes_sent_and_collectives": sent}


def sharded_card(workdir: str, inp: dict) -> int:
    """Phase 18's process (`--runs sharded`), started before phase 14: (a)
    NCCL at world size 1, then (b) two gloo ranks on the card, the dry runs
    and the two-rank CLI.  In a CPU rehearsal (a) is gloo."""
    import torch
    import torch.distributed as dist

    from spades_tpu_torch.ops import cuda_kernels as CK
    from spades_tpu_torch.parallel.distributed import start_group
    from spades_tpu_torch.parallel.dryrun import dryrun_multigpu, dryrun_multihost, free_port

    torch.set_num_threads(2)          # beside phase 14 and the workers
    dev = torch.device(inp["device"])
    rec = {"card": nvidia_smi_line() if dev.type == "cuda" else "cpu"}
    shapes = CK.canonical_window_keys.launch_shapes = collections.Counter()
    # (a) NCCL at world size 1: the collectives launch on the card
    t0 = time.perf_counter()
    backend = "nccl" if dev.type == "cuda" else "gloo"
    start_group(f"localhost:{free_port()}", 1, 0, backend, dev)
    check(dist.get_backend() == backend, f"(a): the group's backend is not {backend}")
    a, _store, graph, reads = sharded_construction(dev, inp, dist.group.WORLD)
    a["backend"] = backend
    a["mapping"] = sharded_mapping_checks(dev, dist.group.WORLD, graph, reads, inp["pairs"],
                                          SHARDED_SUBSET_PAIRS)
    a["distance_clusters"] = sharded_de_check(dev, dist.group.WORLD)
    dist.destroy_process_group()
    a["phase_wall_s"] = time.perf_counter() - t0
    rec["nccl1"] = a
    del _store, graph, reads
    CK.canonical_window_keys.launch_shapes = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # (b) two ranks on the one card under gloo, each in its own process
    t0 = time.perf_counter()
    port = free_port()
    outs = [os.path.join(workdir, f"gloo2_r{r}") for r in range(2)]
    for out in outs:
        os.makedirs(out)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    walls, _errs = _run_ranks(
        [[sys.executable, os.path.abspath(__file__), "--cpu-worker", outs[r], "--runs",
          "sharded_rank", "--sizes", json.dumps(dict(inp, rank=r, port=port))]
         for r in range(2)], outs, env, 900)
    rec["gloo2"] = []
    for r, out in enumerate(outs):
        with open(os.path.join(out, "runs.json")) as fh:
            rec["gloo2"].append(dict(json.load(fh), process_wall_s=walls[r]))
    rec["gloo2_wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["dryrun_multigpu"] = dict(dryrun_multigpu(2, dev.type, "gloo"),
                                  wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    out = dryrun_multihost(2, dev.type, "gloo")
    rec["dryrun_multihost"] = {"line": out.strip().splitlines()[-1],
                               "wall_s": time.perf_counter() - t0}
    rec["cli_np2"] = sharded_cli(dev, workdir, inp)
    rec["shapes"] = [[*key, n] for key, n in shapes.items()]
    with open(os.path.join(workdir, "runs.json"), "w") as fh:
        json.dump(rec, fh)
    return 0


def start_sharded(workdir: str, isolate: dict, gap_state: dict, dev):
    """Start phase 18's process (before phase 14)."""
    out = os.path.join(workdir, "sharded")
    os.makedirs(out)
    inp = {"device": dev.type, "paths": isolate["paths"], "pairs": isolate["pairs"],
           "digests": isolate["digests"], "cli_fastq": gap_state["cli_fastq"],
           "cli_k": gap_state["k"], "cli_out": gap_state["cli_out"]}
    log = open(os.path.join(workdir, "sharded.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-worker", out, "--runs", "sharded",
         "--sizes", json.dumps(inp)],
        cwd=HERE, stdout=log, stderr=subprocess.STDOUT)
    return proc, out, log


def phase_sharded(dev, workdir: str, worker):
    """Phase 18: wait for its process and report; every check ran there."""
    rec, _out, wait_s = _wait("phase 18's", worker, workdir)
    launches = {"sharded_nccl1": rec["nccl1"]["launches"] + rec["nccl1"]["mapping"]["launches"],
                "sharded_gloo2_r0": rec["gloo2"][0]["launches"],
                "sharded_gloo2_r1": rec["gloo2"][1]["launches"],
                "cli_np2": sum(rec["cli_np2"]["launches"])}
    for name, n in launches.items():
        check(n > 0 or dev.type == "cpu", f"phase 18: {name} launched no kernel")
    shapes = collections.Counter()
    for row in rec.pop("shapes") + [row for g in rec["gloo2"] for row in g.pop("shapes")]:
        shapes[tuple(row[:4])] += row[4]
    return (dict(phase="multi_gpu", waited_s=wait_s, **rec), launches, shapes)


# ---------------------------------------------------------------------------
# 19. the user paths no other phase takes: a mate-pair library with
#     --cov-cutoff over several K, --iontorrent, the kmer-mapper residue pass
#     and MismatchCorrection's string path
# ---------------------------------------------------------------------------

# (a)'s mate pairs over the isolate: RF, insert normal(3,000, 300), 150 bp at
# 5x (83,333 pairs), 0.3 % substitutions
ISOLATE_MP = {"coverage": 5, "insert": (3000, 300), "error_rate": 0.003}
GAP_MP_COVERAGE = 10              # (b)'s mate pairs over the gap genome: the same library
P19_K = (21, 33, 55)
HOMOPOLYMER_RATE = 0.01           # (b)'s share of runs of 3 or more bases made longer or shorter
ARM_READS = 5_000                 # (c)'s most reads drawn from removed bulge arms
PLANTED_MISMATCHES = 200          # (c)'s substitutions planted into the graph


def homopolymer_errors(codes, rate: float, seed: int):
    """(n, rl) uint8 reads as strings, with `rate` of their runs of 3 or more
    equal bases lengthened or shortened by one (IonTorrent's usual error),
    drawn from `seed`.  Returns (reads, runs changed)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n, rl = codes.shape
    first = np.ones((n, rl), bool)
    first[:, 1:] = codes[:, 1:] != codes[:, :-1]
    rows, cols = np.nonzero(first)                   # run starts, row-major
    ends = np.full(rows.size, rl)
    same = rows[1:] == rows[:-1]
    ends[:-1][same] = cols[1:][same]
    pick = ((ends - cols) >= 3) & (rng.random(rows.size) < rate)
    grow = rng.random(rows.size) < 0.5
    reads = read_strings(codes)
    # right to left, so that an edit leaves the positions of earlier runs alone
    for i in np.flatnonzero(pick)[::-1]:
        r, c, s = rows[i], cols[i], reads[rows[i]]
        reads[r] = s[:c] + s[c] + s[c:] if grow[i] else s[:c] + s[c + 1:]
    return reads, int(pick.sum())


def write_reads(path: str, seqs, mate: int, prefix: str) -> str:
    """Reads of any length as FASTQ, quality I throughout."""
    with open(path, "w") as fh:
        fh.writelines(f"@{prefix}{i}/{mate}\n{s}\n+\n{'I' * len(s)}\n"
                      for i, s in enumerate(seqs))
    return path


def p19_inputs(workdir: str, seed: int, dev, gap_state: dict, genome_size: int,
               coverage: int) -> dict:
    """Phase 19's inputs, written before phase 14: (b)'s IonTorrent reads
    (the gap set's raw pairs with homopolymer errors) and its mate pairs over
    the gap genome, the gap set's FASTQ (phase 8's) for (b) and (c), and what
    the card's process needs to make (a)'s isolate from the seed."""
    from spades_tpu_torch.tools import synthetic

    d = os.path.join(workdir, "p19_inputs")
    os.makedirs(d)
    files, runs_changed = {}, []
    for mate in (1, 2):
        reads, n = homopolymer_errors(gap_state[f"r{mate}"], HOMOPOLYMER_RATE, seed + 30 + mate)
        files[f"ion_{mate}"] = write_reads(os.path.join(d, f"ion_{mate}.fq"), reads, mate,
                                            "ion")
        runs_changed.append(n)
    m1, m2 = synthetic.make_mate_pairs(gap_state["genome"], GAP_MP_COVERAGE, 150,
                                       ISOLATE_MP["error_rate"], seed + 33,
                                       *ISOLATE_MP["insert"])
    for mate, r in ((1, m1), (2, m2)):
        files[f"mp_{mate}"] = os.path.join(d, f"mp_{mate}.fq")
        synthetic.write_fastq(files[f"mp_{mate}"], r, mate, prefix="mp")
    files["pe_1"], files["pe_2"] = gap_state["cli_fastq"]
    return {"device": dev.type, "seed": seed, "genome_size": genome_size,
            "coverage": coverage, "files": files, "k": gap_state["k"],
            "homopolymer_runs_changed": runs_changed, "gap_mate_pairs": int(m1.shape[0])}


def p19_cli_runs(workdir: str, files: dict, where):
    """(b)'s two CLI runs on `where`, one after the other, each in a process
    of its own with two host threads: (name, record)."""
    k = ["-k", ",".join(map(str, P19_K))]
    cli = (("cli_iontorrent", ["-1", files["ion_1"], "-2", files["ion_2"], "--iontorrent",
                               *k]),
           ("cli_mate_pairs", ["-1", files["pe_1"], "-2", files["pe_2"], "--mp-1",
                               files["mp_1"], "--mp-2", files["mp_2"], "--cov-cutoff", "2", *k]))
    for name, args in cli:
        out, wall_s, launches, log_text = run_cli(where, workdir, name, args, threads=2)
        yield name, {"out": out, "wall_s": wall_s, "launches": launches,
                     "residue_pass": residue_lines(log_text)}


def mate_pairs_cov_cutoff(dev, workdir: str, inp: dict, k_list=P19_K, rl: int = 150):
    """(a): phase 3's isolate (FR pairs) and a mate-pair library of the same
    genome through `run_assembly(k_list, paired_libs=[PE, MP], min_count=2)`:
    the two-pass structure count at every K after the first, the mate pairs
    through PairInfoCount and DistanceEstimation to the scaffold graph, the
    contigs laid onto the genome, the scaffolds' N50 at least the contigs'."""
    import numpy as np
    import torch

    from spades_tpu_torch.alignment import mapper as MR
    from spades_tpu_torch.graph import simplify as SIMP
    from spades_tpu_torch.io.libraries import SequencingLibrary
    from spades_tpu_torch.ops import cuda_kernels as CK
    from spades_tpu_torch.pipeline import spades_stages as S
    from spades_tpu_torch.pipeline import stages as ST
    from spades_tpu_torch.pipeline.run import run_assembly
    from spades_tpu_torch.tools import synthetic

    wall = {}
    t0 = time.perf_counter()
    genome, r1, r2 = synthetic.make_e2e_dataset(inp["genome_size"], inp["coverage"], rl,
                                                0.003, inp["seed"])
    m1, m2 = synthetic.make_mate_pairs(genome, ISOLATE_MP["coverage"], rl,
                                       ISOLATE_MP["error_rate"], inp["seed"] + 31,
                                       *ISOLATE_MP["insert"])
    lefts, rights, mp_l, mp_r = (read_strings(r) for r in (r1, r2, m1, m2))
    libs = [SequencingLibrary(type="paired-end", left=lefts, right=rights),
            SequencingLibrary(type="mate-pairs", left=mp_l, right=mp_r)]
    wall["make_data_s"] = time.perf_counter() - t0
    for trail in (ST.STAGE_TIMES, S.CONSTRUCT_PHASES, S.GAP_CLOSER_STATS, S.RR_STATS,
                  MR.RESIDUE_STATS):
        trail.clear()
    SIMP.ENGINE_RUNS.update(native=0, numpy=0)
    # -- the path: launch counts from 0, read right after ---------------------
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    CK.canonical_window_keys.launches = 0
    out = os.path.join(workdir, "mate_pairs")
    t0 = time.perf_counter()
    res = run_assembly(lefts + rights + mp_l + mp_r, list(k_list), out, paired_libs=libs,
                       read_length=rl, min_count=2, device=dev, checkpoints="none")
    sync(dev)
    wall["run_assembly_s"] = time.perf_counter() - t0
    launches = CK.canonical_window_keys.launches
    peak_gib = (torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda"
                else None)

    check(launches > 0 or dev.type == "cpu", "(a): the canonical-windows kernel was not launched")
    two_pass = [k for k, tm in S.CONSTRUCT_PHASES if "extra_count_s" in tm]
    check(two_pass == list(k_list[1:]),
          f"(a): the two-pass structure count ran at K = {two_pass}, not {list(k_list[1:])}")
    pic = [st for _k, s, st in S.RR_STATS if s == "pair_info_count"]
    check([st["lib_type"] for st in pic] == ["paired-end", "mate-pairs"],
          f"(a): PairInfoCount mapped {[st['lib_type'] for st in pic]}")
    mp_median = pic[1]["is_median"]
    check(abs(mp_median - ISOLATE_MP["insert"][0]) <= 150,
          f"(a): the mate pairs' insert-size median {mp_median}, not within 150 of "
          f"{ISOLATE_MP['insert'][0]}")
    [de] = [st for _k, s, st in S.RR_STATS if s == "distance_estimation"]
    check(de["mp_entries"] > 0, "(a): the mate-pair library left no clustered entry")
    [rr] = [st for _k, s, st in S.RR_STATS if s == "repeat_resolving"]
    check(rr["scaffold_graph_links"] is not None,
          "(a): repeat resolution built no mate-pair scaffold graph")
    contigs, scaffolds = assembly_stats(res.contigs), assembly_stats(res.scaffolds)
    check(scaffolds["n50"] >= contigs["n50"],
          f"(a): the scaffolds' N50 {scaffolds['n50']} is below the contigs' {contigs['n50']}")
    t0 = time.perf_counter()
    n_long, placed = lay_onto_genome("contigs", [(c.name, c.seq) for c in res.contigs],
                                     genome, np.random.default_rng(inp["seed"]))
    wall["placement_s"] = time.perf_counter() - t0
    check(n_long > 0, "(a): no contig of 1 kb or more")
    return {"dataset": {"genome_nt": inp["genome_size"], "coverage": inp["coverage"],
                        "pairs": int(r1.shape[0]), "mate_pairs": int(m1.shape[0]),
                        "mate_pair_library": dict(ISOLATE_MP, orientation="rf"),
                        "seed": inp["seed"]},
            "k_list": list(k_list), "min_count": 2, "wall_s": wall,
            "stage_times": {f"k={k} {s}": t for k, s, t in ST.STAGE_TIMES},
            "construction": {f"k={k}": tm for k, tm in S.CONSTRUCT_PHASES},
            "repeat_resolution": [[k, s, {kk: v for kk, v in st.items()
                                          if kk != "index_timings"}]
                                  for k, s, st in S.RR_STATS],
            "residue_pass": list(MR.RESIDUE_STATS),
            "simplify_engine_runs": dict(SIMP.ENGINE_RUNS),
            "launches": launches, "peak_device_gib": peak_gib,
            "contig_stats": contigs, "scaffold_stats": scaffolds,
            "contigs_1kb": n_long, "contigs_check": placed}


def after_simplification(reads, k: int, out: str, dev, rl: int = 150):
    """The graph after Simplification at `k` and its kmer-mapper, from
    `run_assembly([k])` of the FR pairs `reads` (lefts + rights) on `dev`.
    (A checkpoint would not do: a kmer-mapper loaded from one counts no
    rows, `KmerMapper.size`, so no mapping pass would apply it.)"""
    import copy

    n = len(reads) // 2
    got = {}

    def keep(stage, ctx):
        if stage.id == "simplification":
            got["graph"], got["kmer_mapper"] = copy.deepcopy((ctx.graph, ctx.kmer_mapper))

    from spades_tpu_torch.pipeline.run import run_assembly

    with after_every_stage(keep):
        run_assembly(reads, [k], out, paired_libs=[(reads[:n], reads[n:])], read_length=rl,
                     disable_rr=True, device=dev, checkpoints="none")
    return got["graph"], got["kmer_mapper"]


def residue_and_string_paths(dev, workdir: str, inp: dict, rl: int = 150):
    """(c): the gap set's graph after Simplification at K = 55 and its
    kmer-mapper (`run_assembly([55])` on the card), then on the card and on
    the port's CPU path: `MappingEngine.map_store`
    with the kmer-mapper over the gap set's reads and reads of removed bulge
    arms (the kmer-mapper's source k-mers), so that at least 1 % stay
    unmapped on the device and the host residue pass must run and recover
    reads; and `correct_mismatches(g, reads)` (the string path, mapping on
    the device) on that graph with substitutions planted into it.  Returns
    (record, launches of each, shapes)."""
    import copy

    import numpy as np

    from spades_tpu_torch.alignment import mapper as MR
    from spades_tpu_torch.alignment.mismatch import correct_mismatches
    from spades_tpu_torch.core import kmers as K
    from spades_tpu_torch.core.reads import ReadStore
    from spades_tpu_torch.graph.serialize import save_kmer_mapper
    from spades_tpu_torch.io.fastx import read_fastx
    from spades_tpu_torch.ops import cuda_kernels as CK

    k = inp["k"]
    wall = {}
    reads = [r.seq for m in (1, 2) for r in read_fastx(inp["files"][f"pe_{m}"])]
    t0 = time.perf_counter()
    graph, km = after_simplification(reads, k, os.path.join(workdir, "gap_graph"), dev, rl)
    sync(dev)
    wall["assembly_s"] = time.perf_counter() - t0
    check(km.size > 0, "(c): Simplification left an empty kmer-mapper")
    km_path = os.path.join(workdir, "kmer_mapper.npz")
    save_kmer_mapper(km_path, km)
    src = np.load(km_path)["src"]         # the removed arms' k-mers
    rng = np.random.default_rng(inp["seed"] + 34)
    arms = src[np.sort(rng.choice(src.shape[0], min(ARM_READS, src.shape[0]), replace=False))]
    arm_reads = read_strings(K.unpack(arms, k))
    store = ReadStore.build(reads + arm_reads)
    shapes = CK.canonical_window_keys.launch_shapes = collections.Counter()
    launches, got = {}, {}
    for where in (dev, "cpu"):
        key = "card" if where is dev else "cpu"
        MR.RESIDUE_STATS.clear()
        CK.canonical_window_keys.launches = 0
        t0 = time.perf_counter()
        g, km_ = copy.deepcopy((graph, km))
        mapped = MR.MappingEngine(g, device=where).map_store(store, kmer_mapper=km_,
                                                             force_device=True)
        sync(dev)
        wall[f"map_store_{key}_s"] = time.perf_counter() - t0
        got[key] = (mapped, list(MR.RESIDUE_STATS))
        if where is dev:
            launches["residue_pass"] = CK.canonical_window_keys.launches
    check(all(np.array_equal(a, b) for a, b in zip(got["card"][0], got["cpu"][0])),
          "(c): the card's and the CPU's map_store with the kmer-mapper differ")
    check(got["card"][1] == got["cpu"][1],
          f"(c): residue passes {got['card'][1]} on the card, {got['cpu'][1]} on the CPU")
    [residue] = got["card"][1]
    check(residue["device"] and residue["unmapped"] >= store.n // 100,
          f"(c): {residue['unmapped']} of {store.n} reads unmapped on the device, under 1 %")
    check(residue["rerun"] == residue["unmapped"] and residue["recovered"] > 0,
          f"(c): the residue pass re-ran {residue['rerun']} reads and recovered "
          f"{residue['recovered']}")

    # -- the string path, with substitutions planted inside long edges --------
    g0 = graph
    ids = [int(e) for e in g0.canonical_edge_ids() if g0.e_len[e] >= 1000]
    check(bool(ids), "(c): the gap graph has no edge of 1 kb or more")
    planted = {}            # pool position -> (its conjugate's position, the right base)
    for e in rng.choice(ids, PLANTED_MISMATCHES):
        p = int(rng.integers(k, g0.e_len[e] - k))
        planted[int(g0.e_off[e] + p)] = (int(g0.e_off[g0.e_conj[e]] + g0.e_len[e] - 1 - p),
                                         int(g0.seq_pool[g0.e_off[e] + p]))
    fixed = {}
    for where in (dev, "cpu"):
        key = "card" if where is dev else "cpu"
        g = copy.deepcopy(graph)
        for pos, (conj_pos, base) in planted.items():
            g.seq_pool[pos] = (base + 1) & 3
            g.seq_pool[conj_pos] = 3 - g.seq_pool[pos]
        CK.canonical_window_keys.launches = 0
        t0 = time.perf_counter()
        with environment({"SPADES_DEVICE_MAP_READS": "1"}):    # map on the device
            n = correct_mismatches(g, reads, device=where)
        sync(dev)
        wall[f"correct_mismatches_{key}_s"] = time.perf_counter() - t0
        fixed[key] = (n, g)
        if where is dev:
            launches["mismatch_strings"] = CK.canonical_window_keys.launches
    CK.canonical_window_keys.launch_shapes = None
    (n_card, g_card), (n_cpu, g_cpu) = fixed["card"], fixed["cpu"]
    check(n_card == n_cpu and np.array_equal(g_card.seq_pool, g_cpu.seq_pool),
          f"(c): the string path fixed {n_card} bases on the card and {n_cpu} on the CPU, "
          f"or the graphs differ")
    restored = sum(int(g_card.seq_pool[p]) == b for p, (_c, b) in planted.items())
    check(restored == len(planted),
          f"(c): the string path restored {restored} of {len(planted)} planted bases")
    for name, n in launches.items():
        check(n > 0 or dev.type == "cpu", f"(c): {name} launched no kernel")
    return {"reads": store.n, "arm_reads": len(arm_reads), "kmer_mapper_rows": int(src.shape[0]),
            "residue_pass": residue, "planted": len(planted), "fixed": n_card,
            "restored": restored, "wall_s": wall}, launches, shapes


def p19_card(workdir: str, inp: dict) -> int:
    """Phase 19's card process (`--runs p19_card`), started before phase 14:
    (a), (b)'s CLI runs on the card, then (c)."""
    import torch

    from spades_tpu_torch.ops import cuda_kernels as CK

    torch.set_num_threads(2)          # beside phase 14 and the workers
    dev = torch.device(inp["device"])
    rec = {"card": nvidia_smi_line() if dev.type == "cuda" else "cpu"}
    shapes = CK.canonical_window_keys.launch_shapes = collections.Counter()
    t0 = time.perf_counter()
    rec["mate_pairs_cov_cutoff"] = mate_pairs_cov_cutoff(dev, workdir, inp)
    rec["mate_pairs_cov_cutoff"]["phase_wall_s"] = time.perf_counter() - t0
    CK.canonical_window_keys.launch_shapes = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec["cli"] = dict(p19_cli_runs(workdir, inp["files"], dev))
    t0 = time.perf_counter()
    rec["device_paths"], rec["device_path_launches"], shapes_c = residue_and_string_paths(
        dev, workdir, inp)
    rec["device_paths"]["phase_wall_s"] = time.perf_counter() - t0
    shapes.update(shapes_c)
    rec["shapes"] = [[*key, n] for key, n in shapes.items()]
    with open(os.path.join(workdir, "runs.json"), "w") as fh:
        json.dump(rec, fh)
    return 0


def p19_worker(workdir: str, inp: dict) -> int:
    """Phase 19's CPU worker (`--runs p19`): (b)'s CLI runs on the CPU."""
    import torch

    runs = dict(p19_cli_runs(workdir, inp["files"], torch.device("cpu")))
    with open(os.path.join(workdir, "runs.json"), "w") as fh:
        json.dump(runs, fh)
    return 0


def start_p19(workdir: str, inp: dict, side: str):
    """Start phase 19's card process (`side` "card": on `inp["device"]`) or
    its CPU worker (`side` "cpu")."""
    out = os.path.join(workdir, f"{side}_side_p19")
    os.makedirs(out)
    log = open(os.path.join(workdir, f"p19_{side}.log"), "w")
    env = dict(os.environ, **({"CUDA_VISIBLE_DEVICES": ""} if side == "cpu" else {}))
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-worker", out, "--runs",
         "p19" if side == "cpu" else "p19_card", "--sizes", json.dumps(inp)],
        cwd=HERE, stdout=log, stderr=subprocess.STDOUT, env=env)
    return proc, out, log


def phase_user_paths(dev, workdir: str, inp: dict, card, worker):
    """Phase 19: wait for its card process and its CPU worker ((a) and (c)
    were checked in the card's process); every file of (b)'s CLI runs must
    be equal on the card and the CPU, and their logs must show the path."""
    import re

    rec, _card_dir, waited_card = _wait("phase 19's card", card, workdir)
    cpu, _cpu_dir, waited_cpu = _wait("phase 19's CPU", worker, workdir)
    launches = {"mate_pairs_cov_cutoff": rec["mate_pairs_cov_cutoff"]["launches"],
                **{name: r["launches"] for name, r in rec["cli"].items()},
                **rec.pop("device_path_launches")}
    for name, n in launches.items():
        check(n > 0 or dev.type == "cpu", f"phase 19: {name} launched no kernel")
    skip = NOT_COMPARED | {"checkpoint.json"}
    for name, r in rec["cli"].items():
        a, b = r["out"], cpu[name]["out"]
        names = {n for n in files_under(a) if os.path.basename(n) not in skip}
        other = {n for n in files_under(b) if os.path.basename(n) not in skip}
        check(names == other, f"{name}: the card and the CPU wrote different files: "
                              f"{sorted(names ^ other)[:10]}")
        for rel in sorted(names):
            check(same_output(os.path.join(a, rel), os.path.join(b, rel)),
                  f"{name}: the card's and the CPU's {rel} differ")
        check(r["residue_pass"] == cpu[name]["residue_pass"],
              f"{name}: the card's and the CPU's mapping passes differ")
        r.update(files=len(names), cpu_s=cpu[name]["wall_s"])
        with open(os.path.join(a, "spades.log")) as fh:
            log_text = fh.read()
        if name == "cli_iontorrent":
            changed = re.findall(r"error correction: (\d+)/(\d+) reads changed", log_text)
            check(len(changed) == 1 and int(changed[0][0]) > 0,
                  "cli_iontorrent: IonHammer changed no read")
            r["reads_changed"] = [int(x) for x in changed[0]]
        else:
            two_pass = [int(k) for k in re.findall(r"k=(\d+): \d+ unique \(k\+1\)-mers.*"
                                                   r"'extra_count_s'", log_text)]
            check(two_pass == list(P19_K[1:]),
                  f"cli_mate_pairs: the two-pass structure count ran at K = {two_pass}")
            check("mate-pair scaffold graph:" in log_text,
                  "cli_mate_pairs: no mate-pair scaffold graph was built")
    shapes = collections.Counter()
    for row in rec.pop("shapes"):
        shapes[tuple(row[:4])] += row[4]
    return ({"phase": "user_paths", "waited_card_s": waited_card, "waited_cpu_s": waited_cpu,
             "inputs": {kk: v for kk, v in inp.items() if kk != "files"}, **rec},
            launches, shapes)


def user_paths_alone(dev, seed: int, genome_size: int = 5_000_000, coverage: int = 15,
                     gap_genome: int = 300_000, gap_count: int = 30) -> dict:
    """Phase 19 alone (`--phase19`, a rehearsal): the gap set made as phase 7
    makes it and written as phase 8 writes it, then phase 19's two
    processes; returns its record with the launches by path."""
    from spades_tpu_torch.tools import synthetic

    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="spades_torch_p19_")
    card = worker = None
    try:
        genome, r1, r2, _gaps, c1, c2 = synthetic.make_gapped_dataset(
            gap_genome, GAP_COVERAGE, 150, 0.003, seed + 1, gap_count, truth=True)
        paths = [os.path.join(workdir, f"cli_{m}.fq") for m in (1, 2)]
        for i, (r, c) in enumerate(((r1, c1), (r2, c2))):
            synthetic.write_fastq(paths[i], r, i + 1,
                                  synthetic.error_qualities(r, c, seed + 21 + i))
        gap_state = {"r1": r1, "r2": r2, "genome": genome, "k": 55, "cli_fastq": paths}
        inp = p19_inputs(workdir, seed, dev, gap_state, genome_size, coverage)
        card, worker = start_p19(workdir, inp, "card"), start_p19(workdir, inp, "cpu")
        rec, launches, _shapes = phase_user_paths(dev, workdir, inp, card, worker)
    finally:
        for w in (card, worker):
            if w is not None:
                if w[0].poll() is None:
                    w[0].kill()
                    w[0].wait()
                w[2].close()
        shutil.rmtree(workdir, ignore_errors=True)
    return dict(rec, launches_by_path=launches, total_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# 20. the coverage EM kernel on the main path's histograms
# ---------------------------------------------------------------------------

EM_HELD_PATHS = ("error_correction", "assembly", "meta")
EM_INTS = ("ec_bound", "trusted_bound", "genome_size", "converged")


@contextlib.contextmanager
def em_path(dev, fits: list, launches: dict, path: str):
    """Within, every coverage fit that GenomicInfoFiller or error correction
    makes is appended to `fits` (its path, the histogram of its
    multiplicities, its device and its GenomicInfo), and the EM kernel's
    launches, counted from 0, are `launches[path]`: one per fit on the
    card."""
    import numpy as np

    from spades_tpu_torch.hammer import hammer as H
    from spades_tpu_torch.ops import coverage_em as E
    from spades_tpu_torch.pipeline import spades_stages as S

    real = S.fit_coverage_model          # graph/coverage_model.py's, in both modules
    mine = []

    def fit(m, *args, **kw):
        info = real(m, *args, **kw)
        dev_of = kw.get("device")
        mine.append({"path": path, "hist": np.bincount(np.asarray(m).astype(np.int64)),
                     "on_card": dev_of is not None and str(dev_of).startswith("cuda"),
                     "info": info})
        return info

    S.fit_coverage_model = H.fit_coverage_model = fit
    E.coverage_em.launches = 0
    try:
        yield
    finally:
        S.fit_coverage_model = H.fit_coverage_model = real
    launches[path] = E.coverage_em.launches
    on_card = sum(f["on_card"] for f in mine)
    check(launches[path] == on_card,
          f"{path}: {launches[path]} coverage EM launches for {on_card} fits on the card")
    check(on_card > 0 or dev.type == "cpu", f"{path}: no coverage fit ran on the card")
    fits.extend(mine)


def _em_inputs(counts):
    """The host fit of `counts`, the arguments of its EM and the EM's
    seconds."""
    from spades_tpu_torch.graph import coverage_model as cm

    seen = {}
    host_em = cm._em_host

    def spy(*args):
        seen["args"] = args
        t0 = time.perf_counter()
        res = host_em(*args)
        seen["s"] = time.perf_counter() - t0
        return res
    cm._em_host = spy
    try:
        info = cm.fit_coverage_model(counts)
    finally:
        cm._em_host = host_em
    return info, seen["args"], seen["s"]


def _fit_from(counts, em_result):
    """fit_coverage_model of `counts` with its EM's result given."""
    from spades_tpu_torch.graph import coverage_model as cm

    host_em = cm._em_host
    cm._em_host = lambda *_a: em_result
    try:
        return cm.fit_coverage_model(counts)
    finally:
        cm._em_host = host_em


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else abs(a - b)


def phase_coverage_em(dev, fits: list) -> dict:
    """Every fit on the card of EM_HELD_PATHS made again: the kernel twice
    (bit for bit equal, the GenomicInfo equal to the main path's), against
    the plain version and the host's scipy EM, with times and the bound."""
    import dataclasses

    import numpy as np
    import torch

    from spades_tpu_torch.ops import coverage_em as E
    from spades_tpu_torch.tools import kernel_shapes as KS

    rows, failures = [], []
    for f in fits:
        if not f["on_card"] or f["path"] not in EM_HELD_PATHS:
            continue
        counts = np.repeat(np.arange(len(f["hist"])), f["hist"])
        host, (good_cov, x0, p0, total), host_s = _em_inputs(counts)
        cov = torch.from_numpy(np.ascontiguousarray(good_cov))
        on_card = cov.to(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        first = E.coverage_em(on_card, x0, p0, total)
        end.record()
        sync(dev)
        ms = start.elapsed_time(end)
        second = E.coverage_em(on_card, x0, p0, total)
        t0 = time.perf_counter()
        plain = E.coverage_em(cov, x0, p0, total)
        plain_ms = (time.perf_counter() - t0) * 1e3
        card, via_plain = _fit_from(counts, first), _fit_from(counts, plain)
        nonempty = int((good_cov > 0).sum())
        row = {"path": f["path"], "bins": len(good_cov), "nonempty_bins": nonempty,
               "rounds": first[2], "evals": first[3], "plain_rounds": plain[2],
               "plain_evals": plain[3], "ms": ms, "us_per_eval": ms * 1e3 / max(first[3], 1),
               "plain_ms": plain_ms, "host_ms": host_s * 1e3,
               "bound_ms": KS.coverage_em_bound(nonempty, first[3]),
               "repeat_equal": (first[0].tobytes() == second[0].tobytes()
                                and first[1:] == second[1:]),
               "main_path_equal": dataclasses.asdict(card) == dataclasses.asdict(f["info"]),
               "card": [getattr(card, n) for n in EM_INTS],
               "host": [getattr(host, n) for n in EM_INTS],
               "plain": [getattr(via_plain, n) for n in EM_INTS],
               "mean_rel_host": _rel(card.estimated_mean, host.estimated_mean),
               "mean_rel_plain": _rel(card.estimated_mean, via_plain.estimated_mean),
               "sd_rel_host": _rel(card.estimated_sd, host.estimated_sd),
               "sd_rel_plain": _rel(card.estimated_sd, via_plain.estimated_sd)}
        rows.append(row)
        what = f"coverage EM, {f['path']} fit {len(rows)}"
        if not row["repeat_equal"]:
            failures.append(f"{what}: two launches differ")
        if not row["main_path_equal"]:
            failures.append(f"{what}: the main path's fit differs from the kernel's")
        if f["path"] == "meta":       # meta's stages read trusted_bound alone
            if not card.trusted_bound == host.trusted_bound == via_plain.trusted_bound:
                failures.append(f"{what}: trusted_bound {row['card']} / {row['host']} / "
                                f"{row['plain']} (card / host / plain)")
        else:
            if not row["card"] == row["host"] == row["plain"]:
                failures.append(f"{what}: integer fields {row['card']} / {row['host']} / "
                                f"{row['plain']} (card / host / plain)")
            if max(row["mean_rel_host"], row["mean_rel_plain"]) > 1e-3:
                failures.append(f"{what}: mean off by {row['mean_rel_host']:.3g} / "
                                f"{row['mean_rel_plain']:.3g} (host / plain)")
            if max(row["sd_rel_host"], row["sd_rel_plain"]) > 1e-2:
                failures.append(f"{what}: sd off by {row['sd_rel_host']:.3g} / "
                                f"{row['sd_rel_plain']:.3g} (host / plain)")
    check(rows or dev.type == "cpu", "coverage EM: no fit on the card to hold")
    rec = {"phase": "coverage_em", "fits": rows, "failures": failures}
    if failures:
        emit(rec)
    check(not failures, "; ".join(failures))
    return rec


def phase_observed_shapes(dev, observed, held, max_groups: int = 64) -> dict:
    """`observed` counts launches by (R, L, k, strand).  For every (L, k,
    strand) among them, its largest R is checked against the plain version
    and timed, unless `held` (the shapes of phase 2) has that very shape."""
    import torch

    from spades_tpu_torch.ops import cuda_kernels as CK
    from spades_tpu_torch.tools import kernel_shapes as KS

    groups = {}
    for (R, L, k, strand), n in observed.items():
        g = groups.setdefault((L, k, strand), {"R": 0, "launches": 0, "distinct_R": 0})
        g["R"] = max(g["R"], R)
        g["launches"] += n
        g["distinct_R"] += 1
    held = {(R, L, k, strand) for _name, R, L, k, strand, _len in held}
    todo = sorted((key for key, g in groups.items() if (g["R"], *key) not in held),
                  key=lambda key: -groups[key]["launches"])
    check(len(todo) <= max_groups,
          f"{len(todo)} kernel shape groups to check, more than {max_groups}")
    shapes = []
    for i, (L, k, strand) in enumerate(todo):
        g = groups[(L, k, strand)]
        R = g["R"]
        pc, pn, ln, L = KS.random_packed(5000 + i, R, L, k, None, 0.0)
        args = [torch.from_numpy(a).to(dev) for a in (pc, pn, ln)]
        ref = CK.canonical_window_keys_plain(*args, L, k, strand=strand)
        got = CK.canonical_window_keys(*args, L, k, strand=strand)
        sync(dev)
        err = KS.max_abs_err(got, ref)
        check(err == 0, f"observed shape {R}x{L} k={k}: kernel differs from its plain "
                        f"version (max abs err {err})")
        del ref, got
        ms = KS.time_ms(lambda: CK.canonical_window_keys(*args, L, k, strand=strand), dev, 10)
        plain_ms = KS.time_ms(
            lambda: CK.canonical_window_keys_plain(*args, L, k, strand=strand), dev, 2)
        bound_ms, bound_by = KS.canonical_windows_bound(R, L, k, strand)
        shapes.append({"R": R, "L": L, "k": k, "strand": strand, "launches": g["launches"],
                       "distinct_R": g["distinct_R"], "max_abs_err": err, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by})
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return {"phase": "observed_shapes", "tolerance": 0,
            "groups_seen": len(groups), "groups_held_before": len(groups) - len(todo),
            "shapes": shapes}


def kernels_line(kernel_rec: dict, observed_rec: dict, launches: dict, em_rec: dict,
                 em_launches: dict) -> dict:
    """The per-kernel summary: launches by driven path, times at the k=56
    ReadStore chunk (else the last main-path shape without the strand plane),
    the largest error over every shape held against the plain version; for
    the coverage EM, times at the held fit with the most evaluations."""
    shapes = kernel_rec["shapes"]
    top = next((s for s in shapes if s["shape"] == "ReadStore chunk k=56"),
               [s for s in shapes if not s["strand"]][-1])
    return {"kernels": [{
        "name": "canonical_windows",
        "route": "cuda",
        "source": "spades_tpu_torch/csrc/canonical_windows.cu",
        "replaces": "spades_tpu/ops/pallas_kernels.py:40",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max(s["max_abs_err"] for s in shapes + observed_rec["shapes"]),
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": None,
        "at": top["shape"],
    }, coverage_em_line(em_rec, em_launches)]}


def coverage_em_line(em_rec: dict, em_launches: dict) -> dict:
    fits = em_rec["fits"]
    top = max(fits, key=lambda r: r["evals"]) if fits else {}
    return {
        "name": "coverage_em",
        "route": "cuda",
        "source": "spades_tpu_torch/csrc/coverage_em.cu",
        "replaces": None,          # the JAX package fits on the host
        "launches": sum(em_launches.values()),
        "launches_by_path": em_launches,
        "fits_held": len(fits),
        "max_mean_rel_err": max((max(r["mean_rel_host"], r["mean_rel_plain"]) for r in fits
                                 if r["path"] != "meta"), default=None),
        **{key: top.get(key) for key in ("ms", "plain_ms", "host_ms", "bound_ms",
                                         "us_per_eval", "evals", "nonempty_bins")},
        "bound_by": "float64 operations",
        "library_ms": None,
        "at": f"{top['path']}, {top['nonempty_bins']} bins" if fits else None,
    }


def run(dev, genome_size: int, coverage: int, subset_pairs: int, seed: int,
        main_shapes=None, rand_R: int = 2048, gap_genome: int = 300_000,
        gap_count: int = 30, total_tolerance: float = 0.02, meta_sizes=META_SIZES,
        small_sizes=None, rna_sizes=None):
    """All phases on `dev` (20 after 9, 16 after 15, 17 after 16, 18 after 17,
    19 after 18, 13 last);
    returns the kernels line.
    Raises on any failure.
    total_tolerance: how far the contigs' total may be from the genome size
    (a rehearsal on a small genome, most of it planted repeats, needs more);
    meta_sizes, small_sizes: the genomes of phase 9 and the sets of phases 9
    to 11's card-against-CPU runs (`SMALL_SIZES`); rna_sizes: phase 14's
    transcriptome and phase 15's sets (`RNA_SIZES`)."""
    from spades_tpu_torch.ops import cuda_kernels as CK
    from spades_tpu_torch.tools import kernel_shapes as KS

    small_sizes = dict(SMALL_SIZES, **(small_sizes or {}), gap_genome=gap_genome,
                       gap_count=gap_count)
    rna_sizes = dict(RNA_SIZES, **(rna_sizes or {}), gap_genome=gap_genome, gap_count=gap_count)
    t0 = time.perf_counter()
    emit(phase_toolchain(dev))
    kern = phase_kernels(dev, main_shapes, rand_R=rand_R)
    emit(kern)
    observed = collections.Counter()
    launches = {}
    em_fits, em_launches = [], {}
    workdir = tempfile.mkdtemp(prefix="spades_torch_smoke_")
    worker = worker7 = worker16 = worker17 = card17 = cli7 = sharded = card19 = worker19 = None
    try:
        # the CPU side of phase 15 (about 800 s of CPU work) runs from here
        # on, in a process of its own
        worker7 = start_slice7_worker(workdir, seed, rna_sizes)
        CK.canonical_window_keys.launch_shapes = observed
        rec, launches["construction"], state = phase_main_path(
            dev, workdir, genome_size, coverage, subset_pairs, seed)
        isolate = state.pop("isolate")
        rec["total_s"] = time.perf_counter() - t0
        emit(rec)
        rec, launches["mapping"] = phase_mapping(dev, state, subset_pairs, seed)
        CK.canonical_window_keys.launch_shapes = None
        rec["total_s"] = time.perf_counter() - t0
        emit(rec)
        del state["store"], state["graph"]
        with em_path(dev, em_fits, em_launches, "error_correction"):
            rec, launches["error_correction"], shapes, corrected = phase_error_correction(
                dev, state, seed)
        observed.update(shapes)
        rec["total_s"] = time.perf_counter() - t0
        emit(rec)
        with em_path(dev, em_fits, em_launches, "assembly"):
            rec, launches["assembly"], shapes = phase_assembly(
                dev, workdir, state, seed, corrected, total_tolerance=total_tolerance)
        del corrected
        observed.update(shapes)
        rec["total_s"] = time.perf_counter() - t0
        emit(rec)
        del state
        with em_path(dev, em_fits, em_launches, "gap_closing"):
            rec, launches["gap_closing"], shapes, gap_state = phase_gap(
                dev, workdir, seed, gap_genome, n_gaps=gap_count)
        observed.update(shapes)
        rec["total_s"] = time.perf_counter() - t0
        emit(rec)
        gap_closed = rec["closed"]
        # the CPU side of phases 9 to 11 runs meanwhile, in a process of its own
        worker = start_cpu_worker(workdir, seed, small_sizes,
                                  os.path.join(gap_state["out"], GFA_NAME))
        rec, launches["cli"] = phase_cli(dev, workdir, gap_state)
        em_launches["cli"] = rec["coverage_em_launches"]
        rec["total_s"] = time.perf_counter() - t0
        emit(rec)
        card_runs = {}
        with em_path(dev, em_fits, em_launches, "meta"):
            rec, counts, shapes, card_runs["meta"], community = phase_meta(
                dev, workdir, seed, small_sizes, sizes=meta_sizes)
        launches.update(counts)
        observed.update(shapes)
        rec["total_s"] = time.perf_counter() - t0
        emit(rec)
        em_rec = phase_coverage_em(dev, em_fits)
        em_rec["total_s"] = time.perf_counter() - t0
        emit(em_rec)
        with em_path(dev, em_fits, em_launches, "hybrid"):
            rec, counts, shapes, card_runs["hybrid"] = phase_hybrid(
                dev, workdir, seed, small_sizes, gap_closed, gap_state)
        launches.update(counts)
        observed.update(shapes)
        rec["total_s"] = time.perf_counter() - t0
        emit(rec)
        with em_path(dev, em_fits, em_launches, "modes"):
            rec, counts, shapes, runs = phase_modes(dev, workdir, seed, small_sizes, gap_state)
        launches.update(counts)
        card_runs.update(runs)
        observed.update(shapes)
        rec["total_s"] = time.perf_counter() - t0
        emit(rec)
        rec = phase_card_against_cpu(workdir, card_runs, worker)
        rec["total_s"] = time.perf_counter() - t0
        emit(rec)
        # phase 16's CPU side runs during phase 14, in a process of its own
        tools_in = tools_inputs(workdir, seed, isolate, gap_state)
        worker16 = start_tools_worker(workdir, tools_in)
        # phase 17's tool runs go on during phase 14 too: the card's in a
        # process of its own, the CPU's twins in a fourth worker
        t17 = time.perf_counter()
        inp17 = tools17_inputs(workdir, seed, dev, isolate, community, gap_state,
                               os.path.join(workdir, "card_side", "meta"), small_sizes)
        del community
        card17 = start_tools17(workdir, inp17, "card")
        worker17 = start_tools17(workdir, inp17, "cpu")
        inputs17_s = time.perf_counter() - t17
        # phase 15's CLI runs go on in processes of their own during phase 14
        card7 = os.path.join(workdir, "card_side_slice7")
        files7 = _slice7_inputs(os.path.join(card7, "inputs"), seed, rna_sizes)
        cli7 = start_slice7_cli(card7, files7, dev)
        # phase 18's ranks go on during phase 14 too, in processes of their own
        sharded = start_sharded(workdir, isolate, gap_state, dev)
        # and phase 19's card process and CPU worker
        inp19 = p19_inputs(workdir, seed, dev, gap_state, genome_size, coverage)
        card19 = start_p19(workdir, inp19, "card")
        worker19 = start_p19(workdir, inp19, "cpu")
        with em_path(dev, em_fits, em_launches, "rna"):
            rec, counts, shapes = phase_rna(dev, workdir, seed, rna_sizes)
        launches.update(counts)
        observed.update(shapes)
        rec["total_s"] = time.perf_counter() - t0
        emit(rec)
        rec, counts, shapes = phase_other_modes(dev, workdir, card7, files7, cli7, worker7)
        launches.update(counts)
        observed.update(shapes)
        rec["total_s"] = time.perf_counter() - t0
        emit(rec)
        rec, counts, shapes = phase_tools(dev, workdir, tools_in, isolate, worker16, card7,
                                          files7, worker7[1])
        launches.update(counts)
        observed.update(shapes)
        rec["total_s"] = time.perf_counter() - t0
        emit(rec)
        rec, counts, shapes = phase_tools17(dev, workdir, inp17, isolate, card17, worker17)
        rec["wall_s"]["inputs_before_phase_14_s"] = inputs17_s
        launches.update(counts)
        observed.update(shapes)
        rec["total_s"] = time.perf_counter() - t0
        emit(rec)
        rec, counts, shapes = phase_sharded(dev, workdir, sharded)
        launches.update(counts)
        observed.update(shapes)
        rec["total_s"] = time.perf_counter() - t0
        emit(rec)
        rec, counts, shapes = phase_user_paths(dev, workdir, inp19, card19, worker19)
        launches.update(counts)
        observed.update(shapes)
        rec["total_s"] = time.perf_counter() - t0
        emit(rec)
    finally:
        CK.canonical_window_keys.launch_shapes = None
        if cli7 is not None:          # its processes end before the script does
            with contextlib.suppress(BaseException):
                cli7()
        for w in (worker, worker7, worker16, worker17, card17, sharded, card19, worker19):
            if w is not None:
                if w[0].poll() is None:
                    w[0].kill()
                    w[0].wait()
                w[2].close()
        shutil.rmtree(workdir, ignore_errors=True)
    seen = phase_observed_shapes(dev, observed, main_shapes or KS.MAIN_SHAPES)
    seen["total_s"] = time.perf_counter() - t0
    emit(seen)
    return kernels_line(kern, seen, launches, em_rec, em_launches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=42, help="seed of the synthetic data")
    ap.add_argument("--cpu-worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--sizes", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--gfa", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--runs", default="modes", help=argparse.SUPPRESS)
    ap.add_argument("--phase19", action="store_true",
                    help="run phase 19 alone at full size (a rehearsal; prints its record)")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "spades_tpu_torch")):
        print("chip_smoke: the spades_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    if args.cpu_worker:          # a process of phases 9-11 or 15-19, started by `run`
        sys.path.insert(0, HERE)
        if args.runs == "slice7":
            return slice7_worker(args.cpu_worker, args.seed, json.loads(args.sizes))
        if args.runs == "tools":
            return tools_worker(args.cpu_worker, json.loads(args.sizes))
        if args.runs in ("sharded", "sharded_rank"):
            work = sharded_card if args.runs == "sharded" else sharded_rank
            return work(args.cpu_worker, json.loads(args.sizes))
        if args.runs in ("tools17", "tools17_card"):
            work = tools17_worker if args.runs == "tools17" else tools17_card
            return work(args.cpu_worker, json.loads(args.sizes))
        if args.runs in ("p19", "p19_card"):
            work = p19_worker if args.runs == "p19" else p19_card
            return work(args.cpu_worker, json.loads(args.sizes))
        return cpu_worker(args.cpu_worker, args.seed, json.loads(args.sizes), args.gfa or None)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 3
    sys.path.insert(0, HERE)
    dev = torch.device("cuda", 0)
    if args.phase19:
        emit(user_paths_alone(dev, args.seed))
        print(nvidia_smi_line(), flush=True)
        return 0
    # a bacterial isolate: 5 Mb at 15x (cut from 40x for the time limit once
    # phases 14-15 came), and the first 20,000 pairs for the
    # comparison with the CPU path
    kernels = run(dev, genome_size=5_000_000, coverage=15, subset_pairs=20_000,
                  seed=args.seed)
    print(nvidia_smi_line(), flush=True)
    emit(kernels)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
