"""Construction stage: reads -> counted (k+1)-mers -> extension index -> graph.

Mirrors SPAdes' Construction composite stage
(`src/common/stages/construction.cpp:439-453`: KMerCounting of (k+1)-mers ->
ExtensionIndexBuilder -> GraphCondenser -> coverage fill) as a function
pipeline over the counting engine, on one device or, under a process group,
with the sharded count of `parallel/sharded_count.py` (ConstructionMPI's
split of the reads, `hpcspades/mpi/stages/construction_mpi.cpp`).  On a
CUDA card the extension index and the condensation run on the card too.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import native, resolve_device
from ..core.reads import batch_iter, chop_sequences
from ..graph.graph import CondensedGraph
from ..ops import condense as _condense
from ..ops import count as _count
from ..ops import early_clip as _early
from ..ops import extension as _ext
from ..parallel.distributed import EXCHANGED, resolve_group
from ..utils import timetracer
from ..utils.timetracer import span


@dataclass
class ConstructionResult:
    graph: CondensedGraph
    p1_counts: _count.KmerCounts       # canonical (k+1)-mer counts
    # the extension index: a host ExtensionIndex, or the device index until
    # `index` is first read
    _index: _ext.ExtensionIndex | _ext.DeviceExtensionIndex
    # Per-phase wall seconds: count_reads' keys (device_s, device_first_s,
    # pull_s, merge_s, host_s, n_batches) plus extra_count_s (two-pass
    # structure counting), filter_s, ext_build_s, early_clip_s (when a
    # clipper ran) and condense_s; ext_device is 1 where the index was
    # built on the card, else 0.
    timings: dict = field(default_factory=dict)

    @property
    def index(self) -> _ext.ExtensionIndex:
        """The extension index on the host (a device index is pulled here,
        at the first read)."""
        if isinstance(self._index, _ext.DeviceExtensionIndex):
            self._index = self._index.to_host()
        return self._index


def _count_sharded(batches, k1: int, group, dev, tm: dict) -> _count.KmerCounts:
    """The (k+1)-mer count across the group: each rank's share of every
    batch goes through the sharded counter (one exchange per batch, one
    gather at the end)."""
    from ..parallel.sharded_count import count_kmers_sharded

    sent0 = EXCHANGED["bytes"]
    with span(".count_sharded", into=tm, key="sharded_count_s"):
        p1 = count_kmers_sharded(batches, k1, group, dev, share=True, timings=tm)
    tm["exchanged_bytes"] = EXCHANGED["bytes"] - sent0
    return p1


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
    group=None,
) -> ConstructionResult:
    """Build the condensed de Bruijn graph at odd k from a sequence list.

    min_count: drop (k+1)-mers with multiplicity < min_count before the
    graph build.  extra_sequences: prev-K / trusted contigs, which add graph
    structure but no coverage.  read_store: a `ReadStore` of the same reads,
    packed once for the whole run; when given, `sequences` is not read.
    device: where counting and the extension index build run (None: the
    CUDA card; see `resolve_device`).  On a CUDA card the table's key planes
    go to the card once and the extension index
    (`build_extension_index_device`) and the condensation (`condense_device`)
    run there, handing only the graph back; on the CPU the native host index
    (`build_extension_index`) and `stbr_condense` run, or without the native
    library the same torch pair on CPU tensors.  The condensation follows
    the index (`condense`): `timings["ext_device"]` is 1 where the index was
    built on the card, and the spans' `path` says which pair ran.

    early_tip_clip / early_at_clip: run the pre-condensation clippers on the
    extension index (SPAdes' construction.cpp:446-450: the EarlyATClipper
    for RNA pipelines, the EarlyTipClipper when the gap closer is off); the
    tip length bound defaults to read_length - k (construction.cpp:297-300).
    Both counting branches meet before the index build, so the clippers see
    the same masks either way; their time is `timings["early_clip_s"]`.
    They edit a host index, so a device index is pulled before them.

    group: the process group the count runs across (None: the default group
    of a multi-process run, else one device).  Under a group each rank
    counts its `process_read_slice` of every batch with `count_kmers_sharded`
    and every rank gets the whole table (`timings["exchanged_bytes"]` is
    what this rank sent); prev-K contigs then take the two-pass path, as in
    the JAX package with several devices.  Every later step runs whole on
    every rank.
    """
    if k % 2 == 0:
        raise ValueError("k must be odd")
    dev = resolve_device(device)
    grp = resolve_group(group)
    tm: dict = {}
    k1 = k + 1
    # prev-K contigs join the same device merge with zeroed counts: one fused
    # table replaces a separate count + host merge + lookup.  A coverage
    # filter must see read counts only, so min_count > 1 takes two passes.
    fused_structure = bool(extra_sequences) and min_count == 1 and grp is None
    structure = None
    if fused_structure:
        structure = batch_iter(chop_sequences(extra_sequences, k1), batch_size=batch_size)
    if read_store is not None:
        batches = read_store.chunks
    else:
        batches = batch_iter(chop_sequences(sequences, k1), batch_size=batch_size)
    if grp is None:
        p1 = _count.count_reads(batches, k1, timings=tm, structure_batches=structure,
                                device=dev)
    else:
        p1 = _count_sharded(batches, k1, grp, dev, tm)
    if min_count > 1:
        with span(".filter", into=tm, key="filter_s"):
            keep = p1.counts >= min_count
            p1 = _count.KmerCounts(k=p1.k, words=p1.words[keep], counts=p1.counts[keep])
    if extra_sequences and not fused_structure:
        # structure rows absent from the read counts carry coverage 0
        # (SPAdes keeps contig streams apart "for not counting it in
        # coverage", stages/construction.cpp:110,233)
        with span(".extra_count", into=tm, key="extra_count_s"):
            p_extra = _count.count_sequences(extra_sequences, k1, batch_size=batch_size,
                                             device=dev)
            structure = _count.merge_counts([p1, p_extra])
            cov = np.zeros(structure.num_unique, np.int64)
            rows = _count.searchsorted_rows(structure.words, p1.words)
            cov[rows] = p1.counts
            p1 = _count.KmerCounts(k=p1.k, words=structure.words, counts=cov)
    with span(".ext_build", into=tm, key="ext_build_s") as s:
        if dev.type == "cuda" or native.lib() is None:
            # the torch build: on the card, or on CPU tensors without the
            # native library, where the index then condenses as it stands
            index = _ext.build_extension_index_device(_ext.keys_to_device(p1.words, dev), k)
        else:
            index = _ext.build_extension_index(p1)
        tm["ext_device"] = int(dev.type == "cuda")
        sizes = _index_sizes(index)
        s.set(path=_path(index), **sizes)
    if early_at_clip or early_tip_clip:
        with span(".early_clip", into=tm, key="early_clip_s"):
            if isinstance(index, _ext.DeviceExtensionIndex):
                index = index.to_host()
            if early_at_clip:
                _early.remove_at_edges(index)
                _early.remove_at_tips(index)
            if early_tip_clip:
                bound = early_tc_length_bound
                if bound is None:
                    bound = (read_length - k) if read_length and read_length > k else k
                _early.clip_tips_early(index, bound)
        sizes = _index_sizes(index)
    with span(".condense", into=tm, key="condense_s", path=_path(index), **sizes) as s:
        graph = _condense.condense(index, p1, device=dev)
        s.set(unique_kmers=int(p1.num_unique), edges=int(graph.num_edges))
    return ConstructionResult(graph=graph, p1_counts=p1, _index=index, timings=tm)


def _path(index) -> str:
    """The spans' `path` of a step on this index: "device" for the torch
    pair's index (on the card, or on CPU tensors), else "host"."""
    return "device" if isinstance(index, _ext.DeviceExtensionIndex) else "host"


def _index_sizes(index) -> dict:
    """The span counters of an index, while tracing is on: its k-mers (U)
    and its arcs (A)."""
    if not timetracer.enabled():
        return {}
    return {"kmers": index.num_kmers, "arcs": index.num_arcs}
