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
   repeats, 150 bp FR pairs at 40x, through the `gbuilder` CLI at k=55.  The
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
9. Every shape phases 3 to 8 gave the kernel that phase 2 did not hold yet,
   against the plain version and timed.

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

    rec = {
        "phase": "main_path",
        "card": nvidia_smi_line() if dev.type == "cuda" else "cpu",
        "dataset": {"genome_nt": genome_size, "coverage": coverage, "read_len": rl,
                    "pairs": n_pairs, "error_rate": 0.003, "seed": seed},
        "wall_s": wall,
        "timings": {"gbuilder_k55": res_g.timings},
        "launches": launches,
        "unique_p1": {"gbuilder_k55": res_g.p1_counts.num_unique},
        "edges": {"gbuilder_k55": int(res_g.graph.e_start.shape[0])},
        "gfa_segments": gfa_s,
        "subset_pairs": sub,
        "subset_edges": int(got.graph.e_start.shape[0]),
        "peak_device_gib": peak_gib,
    }
    return rec, main_launches, {"store": store, "graph": res_g.graph, "n_pairs": n_pairs,
                                "genome": genome, "r1": r1, "r2": r2, "c1": c1, "c2": c2}


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
               S.DistanceEstimation, S.RepeatResolution, S.ContigOutput)
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


def substitutions_against(seq: str, strands, err: float, anchor: int = 32,
                          stride: int = 200):
    """Fewest substitutions that lay `seq` onto one of `strands` (the genome
    and its reverse complement), or None when no placement needs at most
    max(2, err * len(seq)): the reads carry substitutions only, so a contig
    that is right differs from the genome by a few surviving ones, and one
    that joins two places differs in most bases past the joint."""
    import numpy as np

    if any(seq in g for g in strands):
        return 0
    a = np.frombuffer(seq.encode(), np.uint8)
    best = None
    for g in strands:
        garr = np.frombuffer(g.encode(), np.uint8)
        for off in range(0, len(seq) - anchor + 1, stride):
            at = g.find(seq[off : off + anchor])
            while at >= 0:
                lo = at - off
                if lo >= 0 and lo + len(seq) <= len(g):
                    d = int((garr[lo : lo + len(seq)] != a).sum())
                    best = d if best is None else min(best, d)
                at = g.find(seq[off : off + anchor], at + 1)
    return best if best is not None and best <= max(2, err * len(seq)) else None


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
    acgt = np.frombuffer(b"ACGT", np.uint8)
    fwd = acgt[genome].tobytes().decode()
    rev = acgt[(3 - genome)[::-1]].tobytes().decode()
    rng = np.random.default_rng(seed)

    def sample_in_genome(what, records):
        """Up to n_sample records of 1 kb or more, each laid onto the genome
        with at most a few substitutions, or else cut into exact pieces of the
        genome that join inside repeats (`repeat_joints`)."""
        long_ = [(name, seq) for name, seq in records if len(seq) >= 1000]
        picks = rng.choice(len(long_), min(n_sample, len(long_)), replace=False)
        subs = {long_[i][0]: substitutions_against(long_[i][1], (fwd, rev), 0.003)
                for i in picks}
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

    n_long, contig_check = sample_in_genome("contigs", [(c.name, c.seq) for c in res.contigs])
    check(n_long > 0, "assembly: no contig of 1 kb or more")
    broken_path = os.path.join(out, "misc", "broken_scaffolds.fasta")
    broken = {"file": os.path.exists(broken_path), "pieces_1kb": 0}
    if broken["file"]:
        from spades_tpu_torch.io.fastx import read_fastx

        broken["pieces_1kb"], broken["check"] = sample_in_genome(
            "broken scaffolds", [(r.name, r.seq) for r in read_fastx(broken_path)])
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


def phase_gap(dev, workdir: str, seed: int, genome_size: int = 300_000, coverage: int = 40,
              n_gaps: int = 30, k: int = 55, rl: int = 150):
    import numpy as np
    import torch

    from spades_tpu_torch.hammer import correct_reads
    from spades_tpu_torch.ops import cuda_kernels as CK
    from spades_tpu_torch.pipeline import spades_stages as S
    from spades_tpu_torch.pipeline.run import run_assembly
    from spades_tpu_torch.tools import synthetic

    _genome, r1, r2, gaps, c1, c2 = synthetic.make_gapped_dataset(
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
                               (with_q, (fixed, st), tm, list(S.MISMATCH_STATS)))

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
                                   "out": got[5], "fixed": fixed}


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
    with open(os.path.join(out, "run_spades.yaml")) as fh:
        yaml_lines = fh.read().count("\n")
    return {"phase": "cli", "card": nvidia_smi_line() if dev.type == "cuda" else "cpu",
            "command": " ".join(os.path.relpath(c, workdir) if c.startswith(workdir) else c
                                for c in cmd[1:]),
            "wall_s": wall_s,
            "launches": launches, "run_spades_yaml_lines": yaml_lines}, launches


# ---------------------------------------------------------------------------
# 9. the shapes the paths gave the kernel that phase 2 did not hold
# ---------------------------------------------------------------------------

def phase_observed_shapes(dev, observed, held, max_groups: int = 40) -> dict:
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


def kernels_line(kernel_rec: dict, observed_rec: dict, launches: dict) -> dict:
    """The per-kernel summary: launches by driven path, times at the k=56
    ReadStore chunk (else the last main-path shape without the strand plane),
    the largest error over every shape held against the plain version."""
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
    }]}


def run(dev, genome_size: int, coverage: int, subset_pairs: int, seed: int,
        main_shapes=None, rand_R: int = 2048, gap_genome: int = 300_000,
        gap_count: int = 30, total_tolerance: float = 0.02):
    """All phases on `dev`; returns the kernels line.  Raises on any failure.
    total_tolerance: how far the contigs' total may be from the genome size
    (a rehearsal on a small genome, most of it planted repeats, needs more)."""
    from spades_tpu_torch.ops import cuda_kernels as CK
    from spades_tpu_torch.tools import kernel_shapes as KS

    t0 = time.perf_counter()
    emit(phase_toolchain(dev))
    kern = phase_kernels(dev, main_shapes, rand_R=rand_R)
    emit(kern)
    observed = collections.Counter()
    workdir = tempfile.mkdtemp(prefix="spades_torch_smoke_")
    try:
        CK.canonical_window_keys.launch_shapes = observed
        rec, main_launches, state = phase_main_path(dev, workdir, genome_size, coverage,
                                                    subset_pairs, seed)
        rec["total_s"] = time.perf_counter() - t0
        emit(rec)
        rec, map_launches = phase_mapping(dev, state, subset_pairs, seed)
        CK.canonical_window_keys.launch_shapes = None
        rec["total_s"] = time.perf_counter() - t0
        emit(rec)
        del state["store"], state["graph"]
        rec, ec_launches, shapes, corrected = phase_error_correction(dev, state, seed)
        observed.update(shapes)
        rec["total_s"] = time.perf_counter() - t0
        emit(rec)
        rec, asm_launches, shapes = phase_assembly(dev, workdir, state, seed, corrected,
                                                   total_tolerance=total_tolerance)
        del corrected
        observed.update(shapes)
        rec["total_s"] = time.perf_counter() - t0
        emit(rec)
        del state
        rec, gap_launches, shapes, gap_state = phase_gap(dev, workdir, seed, gap_genome,
                                                         n_gaps=gap_count)
        observed.update(shapes)
        rec["total_s"] = time.perf_counter() - t0
        emit(rec)
        rec, cli_launches = phase_cli(dev, workdir, gap_state)
        rec["total_s"] = time.perf_counter() - t0
        emit(rec)
    finally:
        CK.canonical_window_keys.launch_shapes = None
        shutil.rmtree(workdir, ignore_errors=True)
    seen = phase_observed_shapes(dev, observed, main_shapes or KS.MAIN_SHAPES)
    seen["total_s"] = time.perf_counter() - t0
    emit(seen)
    return kernels_line(kern, seen, {"construction": main_launches, "mapping": map_launches,
                                     "error_correction": ec_launches,
                                     "assembly": asm_launches, "gap_closing": gap_launches,
                                     "cli": cli_launches})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=42, help="seed of the synthetic isolate")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "spades_tpu_torch")):
        print("chip_smoke: the spades_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 3
    sys.path.insert(0, HERE)
    dev = torch.device("cuda", 0)
    # a bacterial isolate: 5 Mb at 40x, and the first 20,000 pairs for the
    # comparison with the CPU path
    kernels = run(dev, genome_size=5_000_000, coverage=40, subset_pairs=20_000,
                  seed=args.seed)
    print(nvidia_smi_line(), flush=True)
    emit(kernels)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
