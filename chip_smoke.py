#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`spades_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

1. Toolchain and card: CUDA, nvcc, triton, the native host library, and the
   build of the port's CUDA kernel from `spades_tpu_torch/csrc/`.
2. Every kernel against its plain PyTorch version on the card, on random
   reads at every k from 13 to 128 and at every shape the main path gives
   it, with and without the strand plane; tolerance 0 (the work is integer),
   with CUDA-event times beside the memory bound.
3. The main path at isolate scale: a synthetic 5 Mb genome with planted
   repeats, 150 bp FR pairs at 40x.  The `gbuilder` CLI at k=55, then
   `construct_graph` over one `ReadStore` at k=21 and at k=55 with the k=21
   unitigs as structure (the K feed-forward of a multi-K run).  The result
   is checked by invariants, and a subset against the port's CPU path.
4. Read mapping on that k=55 graph: `MappingEngine.map_store` over every
   read of the store (device-built edge index, search, vote) and the tip
   prefilter `hit_filter_store`, checked against the sequence pool, the host
   index build and the port's CPU path, with the time of each part.

Every earlier line is one JSON record (or the card's `nvidia-smi` line); the
last line is {"ok": true, "device": {...}}.  Without a CUDA card, without the
package beside this script, or when any phase fails, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
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
    from spades_tpu_torch.io.contigs import extract_contigs
    from spades_tpu_torch.io.fastx import read_sequences
    from spades_tpu_torch.ops import cuda_kernels as CK
    from spades_tpu_torch.pipeline.construction import construct_graph
    from spades_tpu_torch.tools import gbuilder, synthetic

    wall = {}
    t0 = time.perf_counter()
    _genome, r1, r2 = synthetic.make_e2e_dataset(genome_size, coverage, rl, 0.003, seed)
    wall["make_data_s"] = time.perf_counter() - t0
    n_pairs = r1.shape[0]
    n_reads = 2 * n_pairs
    paths = [os.path.join(workdir, "r1.fq"), os.path.join(workdir, "r2.fq")]
    t0 = time.perf_counter()
    synthetic.write_fastq(paths[0], r1, 1)
    synthetic.write_fastq(paths[1], r2, 2)
    wall["write_fastq_s"] = time.perf_counter() - t0
    del r1, r2

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
    before = CK.canonical_window_keys.launches
    t0 = time.perf_counter()
    res21 = construct_graph(None, 21, read_store=store, device=dev)
    sync(dev)
    wall["store_k21_s"] = time.perf_counter() - t0
    launches["store_k21"] = CK.canonical_window_keys.launches - before
    t0 = time.perf_counter()
    unitigs21 = [c.seq for c in extract_contigs(res21.graph)]
    wall["k21_unitigs_s"] = time.perf_counter() - t0
    before = CK.canonical_window_keys.launches
    t0 = time.perf_counter()
    res55 = construct_graph(None, 55, read_store=store, extra_sequences=unitigs21,
                            device=dev)
    sync(dev)
    wall["store_k55_s"] = time.perf_counter() - t0
    launches["store_k55"] = CK.canonical_window_keys.launches - before
    main_launches = CK.canonical_window_keys.launches
    peak_gib = (torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda"
                else None)

    # -- invariants of the full-size result ---------------------------------
    for name, n in launches.items():   # a CPU rehearsal launches no kernel
        check(n > 0 or dev.type == "cpu",
              f"{name}: the canonical-windows kernel was not launched")
    check(res_g.p1_counts.total == n_reads * (rl - 55),
          "gbuilder k=55: counted windows != reads x (150 - k)")
    check(res21.p1_counts.total == n_reads * (rl - 21),
          "store k=21: counted windows != reads x (150 - k)")
    check(res55.p1_counts.total == n_reads * (rl - 55),
          "store k=55: counted windows != reads x (150 - k)")
    # the k=21 unitigs only add zero-count structure rows: the read-counted
    # rows are exactly the gbuilder (ReadBatch path) table
    p55 = res55.p1_counts
    nz = p55.counts > 0
    check(np.array_equal(p55.words[nz], res_g.p1_counts.words)
          and np.array_equal(p55.counts[nz], res_g.p1_counts.counts),
          "k=55: ReadStore and ReadBatch (gbuilder) paths counted differently")
    for name, res in (("gbuilder_k55", res_g), ("store_k21", res21), ("store_k55", res55)):
        graph_checks(name, res.graph)
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
        "timings": {"gbuilder_k55": res_g.timings, "store_k21": res21.timings,
                    "store_k55": res55.timings},
        "launches": launches,
        "unique_p1": {"gbuilder_k55": res_g.p1_counts.num_unique,
                      "store_k21": res21.p1_counts.num_unique,
                      "store_k55": p55.num_unique},
        "structure_rows_k55": int((~nz).sum()),
        "edges": {"gbuilder_k55": int(res_g.graph.e_start.shape[0]),
                  "store_k21": int(res21.graph.e_start.shape[0]),
                  "store_k55": int(res55.graph.e_start.shape[0])},
        "gfa_segments": gfa_s,
        "subset_pairs": sub,
        "subset_edges": int(got.graph.e_start.shape[0]),
        "peak_device_gib": peak_gib,
    }
    return rec, main_launches, {"store": store, "graph": res55.graph, "n_pairs": n_pairs}


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
    W = K.kmer_words(k)
    check(np.array_equal(K.keys_to_words(prep[0].T.contiguous().cpu().numpy(), W),
                         host_index.kmers),
          "device-built index: k-mers differ from build_edge_index")
    for name, dev_col, host_col in (("edge", prep[1], host_index.edge),
                                    ("offset", prep[2], host_index.offset),
                                    ("strand", prep[3], host_index.strand)):
        check(np.array_equal(dev_col.cpu().numpy(), host_col),
              f"device-built index: {name} differs from build_edge_index")

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


def kernels_line(kernel_rec: dict, launches: dict) -> dict:
    """The per-kernel summary: launches summed over the driven paths, times
    at the largest main-path shape (the last one without the strand plane)."""
    shapes = kernel_rec["shapes"]
    top = [s for s in shapes if not s["strand"]][-1]
    return {"kernels": [{
        "name": "canonical_windows",
        "route": "cuda",
        "source": "spades_tpu_torch/csrc/canonical_windows.cu",
        "replaces": "spades_tpu/ops/pallas_kernels.py:40",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": None,
        "at": top["shape"],
    }]}


def run(dev, genome_size: int, coverage: int, subset_pairs: int, seed: int,
        main_shapes=None, rand_R: int = 2048):
    """All phases on `dev`; returns the kernels line.  Raises on any failure."""
    t0 = time.perf_counter()
    emit(phase_toolchain(dev))
    kern = phase_kernels(dev, main_shapes, rand_R=rand_R)
    emit(kern)
    workdir = tempfile.mkdtemp(prefix="spades_torch_smoke_")
    try:
        rec, main_launches, state = phase_main_path(dev, workdir, genome_size, coverage,
                                                    subset_pairs, seed)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    rec["total_s"] = time.perf_counter() - t0
    emit(rec)
    rec, map_launches = phase_mapping(dev, state, subset_pairs, seed)
    rec["total_s"] = time.perf_counter() - t0
    emit(rec)
    return kernels_line(kern, {"construction": main_launches, "mapping": map_launches})


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
    # a bacterial isolate: 5 Mb at 40x, and the first 50,000 pairs for the
    # comparison with the CPU path
    kernels = run(dev, genome_size=5_000_000, coverage=40, subset_pairs=50_000,
                  seed=args.seed)
    print(nvidia_smi_line(), flush=True)
    emit(kernels)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
