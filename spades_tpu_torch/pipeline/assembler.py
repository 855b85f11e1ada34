"""Single-k and multi-k assembly entry points.

Mirrors SPAdes' inner pipeline
(`src/projects/spades/pipeline.cpp:217-306`: Construction ->
GenomicInfoFiller -> Simplification -> ContigOutput) and the outer multi-k
ladder (`src/projects/spades/pipeline/spades_pipeline/stages/
spades_iteration_stage.py:49-187`: per-K assembly with previous-K contigs fed
forward as trusted additional sequences).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from ..graph.coverage_model import GenomicInfo, fit_coverage_model
from ..graph.graph import CondensedGraph
from ..graph.simplify import SimplifyConfig, SimplifyStats, simplify
from ..io.contigs import Contig, extract_contigs
from .construction import construct_graph

log = logging.getLogger("spades_tpu_torch")


def default_k_ladder(read_length: int) -> list[int]:
    """SPAdes' K auto-selection (options_storage.py:88-93)."""
    if read_length >= 250:
        return [21, 33, 55, 77, 99, 127]
    if read_length >= 150:
        return [21, 33, 55, 77]
    return [21, 33, 55]


@dataclass
class AssemblyResult:
    graph: CondensedGraph
    contigs: list[Contig]
    genomic_info: GenomicInfo
    stats: SimplifyStats
    k: int


def assemble_single_k(
    reads: list[str],
    k: int,
    cfg: SimplifyConfig | None = None,
    extra_sequences: list[str] | None = None,
    min_count: int = 1,
    device=None,
) -> AssemblyResult:
    """One construction + simplification iteration at a fixed odd k.
    device: where counting runs (None: the CUDA card; see `resolve_device`)."""
    seqs = list(reads)
    if extra_sequences:
        # previous-K contigs enter construction as trusted sequences
        # (use_additional_contigs semantics)
        seqs = seqs + list(extra_sequences)
    res = construct_graph(seqs, k, min_count=min_count, device=device)
    info = fit_coverage_model(res.p1_counts.counts)
    if cfg is None:
        rl = int(np.median([len(r) for r in reads])) if reads else 100
        cfg = SimplifyConfig(read_length=rl)
    g, stats = simplify(res.graph, info, cfg)
    contigs = extract_contigs(g)
    log.info(
        "k=%d: %d edges after simplification (tips=%d bulges=%d ec=%d isolated=%d)",
        k, g.num_edges, stats.tips, stats.bulges, stats.ec, stats.isolated,
    )
    return AssemblyResult(graph=g, contigs=contigs, genomic_info=info, stats=stats, k=k)


def assemble_multi_k(
    reads: list[str],
    k_list: list[int] | None = None,
    cfg: SimplifyConfig | None = None,
    device=None,
) -> AssemblyResult:
    """Iterative multi-k assembly with contig feed-forward."""
    if k_list is None:
        rl = int(np.median([len(r) for r in reads])) if reads else 100
        k_list = default_k_ladder(rl)
    k_list = [k for k in k_list if k % 2 == 1]
    if not k_list:
        raise ValueError("no odd k values given")
    prev_contigs: list[str] | None = None
    result = None
    for k in k_list:
        usable = [r for r in reads if len(r) > k]
        result = assemble_single_k(
            usable, k, cfg=cfg, extra_sequences=prev_contigs, device=device
        )
        prev_contigs = [c.seq for c in result.contigs]
    return result
