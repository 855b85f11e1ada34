"""Concrete per-K assembly stages (the spades-core stage list).

Mirrors SPAdes' `src/projects/spades/pipeline.cpp:263-298` (stage list by
mode).  Ported so far: the stages of an assembly without repeat resolution,
Construction through ContigOutput.  Pair info, distance estimation, repeat
resolution, mismatch correction and the mode-specific stages are not here yet.
"""
from __future__ import annotations

import logging
import os

from ..graph.coverage_model import fit_coverage_model
from ..graph.simplify import SimplifyConfig, simplify
from ..io.contigs import extract_contigs, write_contigs
from ..io.gfa import write_gfa
from .construction import construct_graph
from .stages import AssemblyContext, AssemblyStage

log = logging.getLogger("spades_tpu_torch.stages")


# (k, construct_graph timings dict) trail for a benchmark's phase breakdown
CONSTRUCT_PHASES: list[tuple[int, dict]] = []
# (k, stage id, close_gaps stats dict) trail: prefilter candidates, pairs,
# prefilter_s, map_s and closed gaps of every GapClosing run
GAP_CLOSER_STATS: list[tuple[int, str, dict]] = []


class Construction(AssemblyStage):
    """reads -> (k+1)-mer counts -> extension index -> condensed graph.

    (stages/construction.cpp composite equivalent)"""

    name = "Construction"
    id = "construction"

    def __init__(
        self,
        min_count: int = 1,
        early_tip_clip: bool = False,
        early_at_clip: bool = False,
    ):
        self.min_count = min_count
        self.early_tip_clip = early_tip_clip
        self.early_at_clip = early_at_clip

    def run(self, ctx: AssemblyContext) -> None:
        seqs = [r for r in ctx.reads if len(r) > ctx.k]
        extras = [s for s in ctx.extra_sequences if len(s) > ctx.k]
        res = construct_graph(
            seqs,
            ctx.k,
            min_count=self.min_count,
            early_tip_clip=self.early_tip_clip,
            early_at_clip=self.early_at_clip,
            read_length=ctx.read_length,
            extra_sequences=extras,
            read_store=ctx.read_store,
            device=ctx.device,
        )
        ctx.graph = res.graph
        ctx.p1_counts = res.p1_counts
        ctx.construct_timings = res.timings
        CONSTRUCT_PHASES.append((ctx.k, dict(res.timings)))
        log.info(
            "k=%d: %d unique (k+1)-mers, %d edges in raw graph (phases: %s)",
            ctx.k, res.p1_counts.num_unique, len(res.graph.canonical_edge_ids()),
            res.timings,
        )


class GenomicInfoFiller(AssemblyStage):
    """Coverage-model fit -> ec/trusted bounds (stages/genomic_info_filler.cpp)."""

    name = "EC Threshold Finding"
    id = "ec_threshold_finder"

    def run(self, ctx: AssemblyContext) -> None:
        if ctx.mode in ("meta", "sc"):
            # uneven-depth branch (genomic_info_filler.cpp:36-44): the k-mer
            # mixture assumes a dominant coverage mode; metagenomes / MDA
            # single-cell use the short-edge coverage threshold finder
            from ..graph.coverage_model import GenomicInfo, find_uneven_threshold

            info = fit_coverage_model(ctx.p1_counts.counts)
            ctx.genomic_info = GenomicInfo(
                ec_bound=find_uneven_threshold(ctx.graph),
                trusted_bound=info.trusted_bound,
                estimated_mean=info.estimated_mean,
                genome_size=info.genome_size,
                converged=False,
            )
        else:
            ctx.genomic_info = fit_coverage_model(ctx.p1_counts.counts)
        log.info(
            "ec_bound=%.1f trusted=%.1f mean=%.1f genome~%d",
            ctx.genomic_info.ec_bound, ctx.genomic_info.trusted_bound,
            ctx.genomic_info.estimated_mean, ctx.genomic_info.genome_size,
        )


class Simplification(AssemblyStage):
    """Tip/bulge/EC simplification schedule (stages/simplification.cpp)."""

    name = "Simplification"
    id = "simplification"

    def __init__(self, cfg: SimplifyConfig | None = None):
        self.cfg = cfg

    def run(self, ctx: AssemblyContext) -> None:
        cfg = self.cfg or SimplifyConfig(read_length=ctx.read_length)
        from ..alignment.kmer_mapper import KmerMapper

        # record bulge-glue substitutions so later mapping stages still hit
        # k-mers of removed arms (alignment/kmer_mapper.hpp role)
        ctx.kmer_mapper = KmerMapper(k=ctx.k)
        flanking = None
        if cfg.rel_cov_enabled and ctx.p1_counts is not None:
            # LocalCoverage for the relative-coverage disconnector
            # (detail_coverage.hpp role); callable so it refreshes after
            # each compaction renumbering
            from ..graph.flanking import build_flanking

            p1 = ctx.p1_counts
            flanking = lambda g: build_flanking(g, p1.words, p1.counts)
        ctx.graph, stats = simplify(
            ctx.graph, ctx.genomic_info, cfg, kmer_mapper=ctx.kmer_mapper,
            flanking=flanking,
        )
        ctx.kmer_mapper.normalize()
        log.info(
            "simplified: %d edges (tips=%d bulges=%d ec=%d isolated=%d)",
            len(ctx.graph.canonical_edge_ids()),
            stats.tips, stats.bulges, stats.ec, stats.isolated,
        )


class RawSimplification(AssemblyStage):
    """Initial cleaning before gap closing (stages/simplification.cpp:442
    RawSimplification): a conservative tip/isolated/low-coverage pass so the
    early gap closer and downstream stages never see the raw error tangle."""

    name = "Raw Simplification"
    id = "raw_simplification"

    def run(self, ctx: AssemblyContext) -> None:
        if ctx.graph is None or ctx.graph.num_edges == 0:
            return
        cfg = SimplifyConfig(
            read_length=ctx.read_length,
            cycle_iter_count=2,
            br_enabled=False,       # no bulge gluing in the raw pass
            rel_cov_enabled=False,
            ier_enabled=False,
        )
        ctx.graph, stats = simplify(ctx.graph, ctx.genomic_info, cfg)
        log.info(
            "raw simplification: %d edges (tips=%d ec=%d)",
            len(ctx.graph.canonical_edge_ids()), stats.tips, stats.ec,
        )


class GapClosing(AssemblyStage):
    """Paired-read tip-to-tip gap closing (gap_closer.cpp:28-514)."""

    name = "Gap Closer"
    id = "gap_closer"

    def __init__(self, label: str = "early"):
        self.id = f"{GapClosing.id}_{label}"
        self.label = label

    def run(self, ctx: AssemblyContext) -> None:
        if not (ctx.paired or ctx.paired_stores) or ctx.graph is None \
                or ctx.graph.num_edges < 2:
            return
        from ..alignment.gap_closer import close_gaps

        stats: dict = {}
        if ctx.paired_stores:
            n = close_gaps(
                ctx.graph,
                engine=ctx.mapping_engine(),
                paired_stores=ctx.paired_stores,
                stats=stats,
            )
        else:
            n = close_gaps(ctx.graph, ctx.paired, device=ctx.device, stats=stats)
        GAP_CLOSER_STATS.append((ctx.k, self.id, stats))
        if n:
            ctx.invalidate_mapping()
        log.info("gap closer (%s): closed %d gaps", self.label, n)


def _assembly_stats(contigs) -> str:
    """N50/total/longest summary line (SPAdes' INFO telemetry and the
    QUAST metric surface)."""
    lens = sorted((len(c.seq) for c in contigs), reverse=True)
    if not lens:
        return "0 contigs"
    total = sum(lens)
    acc, n50 = 0, lens[-1]
    for L in lens:
        acc += L
        if acc * 2 >= total:
            n50 = L
            break
    return (f"{len(lens)} contigs, total {total} bp, longest {lens[0]} bp, "
            f"N50 {n50} bp")


class ContigOutput(AssemblyStage):
    """Emit contigs/scaffolds/GFA (contig_output_stage.cpp equivalent)."""

    name = "Contig Output"
    id = "contig_output"

    def __init__(self, out_prefix: str = "", gfa_version: str = "1.2"):
        self.out_prefix = out_prefix
        self.gfa_version = gfa_version

    def run(self, ctx: AssemblyContext) -> None:
        from ..io.fastg import write_fastg
        from ..paired.path_extend import Path, write_paths

        if not ctx.contigs:  # repeat resolution may already have produced paths
            ctx.contigs = extract_contigs(ctx.graph)
            ctx.contig_paths = [
                (c.name, Path([c.edge_id])) for c in ctx.contigs if c.edge_id >= 0
            ]
        if not ctx.scaffolds:
            ctx.scaffolds = ctx.contigs
            ctx.scaffold_paths = ctx.contig_paths
        d = os.path.join(ctx.output_dir, self.out_prefix) if self.out_prefix else ctx.output_dir
        os.makedirs(d, exist_ok=True)
        write_contigs(os.path.join(d, "contigs.fasta"), ctx.contigs)
        write_contigs(os.path.join(d, "scaffolds.fasta"), ctx.scaffolds)
        if ctx.mode == "rna":
            # rnaSPAdes names its primary output transcripts.fasta
            write_contigs(os.path.join(d, "transcripts.fasta"), ctx.contigs)
        write_gfa(
            os.path.join(d, "assembly_graph_with_scaffolds.gfa"),
            ctx.graph,
            scaffold_paths=ctx.scaffold_paths,
            version=self.gfa_version,
        )
        write_fastg(os.path.join(d, "assembly_graph.fastg"), ctx.graph)
        if ctx.contig_paths:
            write_paths(os.path.join(d, "contigs.paths"), ctx.contig_paths, ctx.graph)
        if ctx.scaffold_paths:
            write_paths(os.path.join(d, "scaffolds.paths"), ctx.scaffold_paths, ctx.graph)
        log.info("%d contigs -> %s", len(ctx.contigs), d)
        if ctx.contigs:
            log.info("assembly stats: %s", _assembly_stats(ctx.contigs))
