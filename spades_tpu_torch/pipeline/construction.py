"""Construction stage: reads -> counted (k+1)-mers -> extension index -> graph.

Mirrors SPAdes' Construction composite stage
(`src/common/stages/construction.cpp:439-453`: KMerCounting of (k+1)-mers ->
ExtensionIndexBuilder -> GraphCondenser -> coverage fill) as a function
pipeline over the counting engine, on one device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from .. import resolve_device
from ..core.reads import batch_iter, chop_sequences
from ..graph.graph import CondensedGraph
from ..ops import condense as _condense
from ..ops import count as _count
from ..ops import extension as _ext


@dataclass
class ConstructionResult:
    graph: CondensedGraph
    p1_counts: _count.KmerCounts       # canonical (k+1)-mer counts
    index: _ext.ExtensionIndex
    # Per-phase wall seconds: count_reads' keys (device_s, device_first_s,
    # pull_s, merge_s, host_s, n_batches) plus extra_count_s (two-pass
    # structure counting), filter_s, ext_build_s and condense_s.
    timings: dict = field(default_factory=dict)


def construct_graph(
    sequences,
    k: int,
    min_count: int = 1,
    batch_size: int = 65536,
    early_tip_clip: bool = False,
    early_tc_length_bound: int | None = None,
    early_at_clip: bool = False,
    read_length: int | None = None,
    extra_sequences=None,
    read_store=None,
    device=None,
) -> ConstructionResult:
    """Build the condensed de Bruijn graph at odd k from a sequence list.

    min_count: drop (k+1)-mers with multiplicity < min_count before the
    graph build.  extra_sequences: prev-K / trusted contigs, which add graph
    structure but no coverage.  read_store: a `ReadStore` of the same reads,
    packed once for the whole run; when given, `sequences` is not read.
    device: where counting runs (None: the CUDA card; see `resolve_device`).

    early_tip_clip / early_at_clip (the pre-condensation clippers of SPAdes'
    construction.cpp:446-450) are not ported yet and raise
    NotImplementedError; early_tc_length_bound and read_length only
    parameterize them.
    """
    if k % 2 == 0:
        raise ValueError("k must be odd")
    if early_tip_clip or early_at_clip:
        raise NotImplementedError("early tip / A-T clipping is not ported yet (ROADMAP A13e)")
    dev = resolve_device(device)
    tm: dict = {}
    k1 = k + 1
    # prev-K contigs join the same device merge with zeroed counts: one fused
    # table replaces a separate count + host merge + lookup.  A coverage
    # filter must see read counts only, so min_count > 1 takes two passes.
    fused_structure = bool(extra_sequences) and min_count == 1
    structure = None
    if fused_structure:
        structure = batch_iter(chop_sequences(extra_sequences, k1), batch_size=batch_size)
    if read_store is not None:
        batches = read_store.chunks
    else:
        batches = batch_iter(chop_sequences(sequences, k1), batch_size=batch_size)
    p1 = _count.count_reads(batches, k1, timings=tm, structure_batches=structure,
                            device=dev)
    if min_count > 1:
        t0 = time.perf_counter()
        keep = p1.counts >= min_count
        p1 = _count.KmerCounts(k=p1.k, words=p1.words[keep], counts=p1.counts[keep])
        tm["filter_s"] = time.perf_counter() - t0
    if extra_sequences and not fused_structure:
        # structure rows absent from the read counts carry coverage 0
        # (SPAdes keeps contig streams apart "for not counting it in
        # coverage", stages/construction.cpp:110,233)
        t0 = time.perf_counter()
        p_extra = _count.count_sequences(extra_sequences, k1, batch_size=batch_size,
                                         device=dev)
        structure = _count.merge_counts([p1, p_extra])
        cov = np.zeros(structure.num_unique, np.int64)
        rows = _count.searchsorted_rows(structure.words, p1.words)
        cov[rows] = p1.counts
        p1 = _count.KmerCounts(k=p1.k, words=structure.words, counts=cov)
        tm["extra_count_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = _ext.build_extension_index(p1)
    tm["ext_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = _condense.condense(index, p1, device=dev)
    tm["condense_s"] = time.perf_counter() - t0
    return ConstructionResult(graph=graph, p1_counts=p1, index=index, timings=tm)
