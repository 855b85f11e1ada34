"""Concrete per-K assembly stages (the spades-core stage list).

Mirrors SPAdes' `src/projects/spades/pipeline.cpp:263-298` (stage list by
mode).  Ported so far: the stages of a multicell / isolate / sc / sewage
assembly, Construction, GenomicInfoFiller, RawSimplification, GapClosing,
Simplification, MismatchCorrection (careful mode), PairInfoCount,
DistanceEstimation, RepeatResolution and ContigOutput; LoadGraph
(`--assembly-graph`); HybridAligning (PacBio, Nanopore and Sanger reads);
ChromosomeRemoval and MetaplasmidExtraction (plasmid, metaplasmid,
metaviral); and metaSPAdes' two-step repeat resolution (a preliminary
PairInfoCount, DistanceEstimation and RepeatResolution, then
SecondPhaseSetup); SSEdgeSplit (rnaSPAdes' strand-specific splitter),
SeriesAnalysis (`--series-analysis`) and DomainAnalysis (bio / corona and
`--custom-hmms`).
"""
from __future__ import annotations

import logging
import os
import time

import numpy as np

from .. import resolve_device
from ..graph.coverage_model import fit_coverage_model
from ..graph.simplify import SimplifyConfig, simplify
from ..io.contigs import extract_contigs, write_contigs
from ..io.gfa import write_gfa
from .construction import construct_graph
from ..utils.timetracer import span
from .stages import AssemblyContext, AssemblyStage

log = logging.getLogger("spades_tpu_torch.stages")


# (k, construct_graph timings dict) trail for a benchmark's phase breakdown
CONSTRUCT_PHASES: list[tuple[int, dict]] = []
# (k, stage id, close_gaps stats dict) trail: prefilter candidates, pairs,
# prefilter_s, map_s and closed gaps of every GapClosing run
GAP_CLOSER_STATS: list[tuple[int, str, dict]] = []
# (k, stage id, stats dict) trail of the repeat-resolution stages: per paired
# library of PairInfoCount its pairs, mapped mates, insert-size estimate, raw
# index entries and times; DistanceEstimation's clustered, improved and
# scaffolding index sizes; RepeatResolution's paths and scaffolds
RR_STATS: list[tuple[int, str, dict]] = []
# (k, bases fixed) trail of every MismatchCorrection run
MISMATCH_STATS: list[tuple[int, int]] = []
# (k, stage id, stats dict) trail of the mode stages: LoadGraph's edges,
# HybridAligning's aligned reads, stored paths and closed gaps,
# ChromosomeRemoval's removed edges, MetaplasmidExtraction's rounds,
# SecondPhaseSetup's trusted contig paths, SSEdgeSplit's split edges and
# mapping-pass times, and DomainAnalysis's hits and per-profile DP times
MODE_STATS: list[tuple[int, str, dict]] = []


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

            info = fit_coverage_model(ctx.p1_counts.counts, device=resolve_device(ctx.device))
            ctx.genomic_info = GenomicInfo(
                ec_bound=find_uneven_threshold(ctx.graph),
                trusted_bound=info.trusted_bound,
                estimated_mean=info.estimated_mean,
                genome_size=info.genome_size,
                converged=False,
            )
        else:
            ctx.genomic_info = fit_coverage_model(ctx.p1_counts.counts,
                                                  device=resolve_device(ctx.device))
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
            # (detail_coverage.hpp role), kept up to date across each
            # compaction; looked up on the card where the run has one
            from ..graph.flanking import FlankingTable

            dev = resolve_device(ctx.device)
            flanking = FlankingTable(ctx.p1_counts.words, ctx.p1_counts.counts,
                                     device=dev if dev.type == "cuda" else None)
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


class SSEdgeSplit(AssemblyStage):
    """Strand-specific edge splitting for stranded RNA libraries
    (stages/ss_edge_split.cpp + alignment/rna/ss_coverage.hpp
    SSCoverageSplitter): split edges where sense and antisense transcript
    coverage profiles cross (tail-to-tail transcript boundaries).

    Both mapping passes run on the device through the run's MappingEngine:
    the binned fill on the graph before the splits, the per-edge
    strand-specific coverage on a fresh engine of the split graph (which
    PairInfoCount then reuses).  `store` is the library packed once for the
    run (`ss_coverage.read_store`); None packs `ctx.reads` here."""

    name = "SS Edge Splitting"
    id = "ss_edge_split"

    def __init__(self, ss_type: str = "fr", store=None):
        self.ss_type = ss_type
        self.store = store

    def run(self, ctx: AssemblyContext) -> None:
        if ctx.graph is None or ctx.graph.num_edges == 0 or not ctx.reads:
            return
        if ctx.read_length < ctx.k:
            log.info("reads are too short for SS coverage splitter")
            return
        from ..alignment.ss_coverage import SSCoverageSplitter, fill_ss_coverage, read_store

        rf = self.ss_type == "rf"
        store = self.store if self.store is not None else read_store(ctx.reads, rf=rf)
        min_edge_len = max(200, 3 * 50)
        splitter = SSCoverageSplitter(ctx.graph, min_edge_len=min_edge_len)
        t0 = time.perf_counter()
        splitter.fill(store, engine=ctx.mapping_engine())
        fill_s = time.perf_counter() - t0
        n = splitter.split_edges()
        log.info("ss edge splitter: split %d edges", n)
        if n:
            # the split edges are new ids of a changed graph: drop the index
            ctx.invalidate_mapping()
        # strand-specific per-edge coverage for the RNA coverage chooser
        # (SimpleCoverageExtensionChooser input, extenders_logic.cpp:460-466)
        t0 = time.perf_counter()
        ctx.ss_cov = fill_ss_coverage(ctx.graph, store, engine=ctx.mapping_engine())
        MODE_STATS.append((ctx.k, self.id, {
            "binned_edges": len(splitter.bins), "edges_split": n,
            "fill_s": fill_s, "ss_cov_s": time.perf_counter() - t0,
        }))


class SeriesAnalysis(AssemblyStage):
    """Multi-sample coverage-series profile dumps + profile-based clearing
    (projects/spades/series_analysis.cpp, meta mode --series-analysis)."""

    name = "Series Analysis"
    id = "series_analysis"

    def __init__(self, config_path: str):
        self.config_path = config_path

    def run(self, ctx: AssemblyContext) -> None:
        if ctx.graph is None or ctx.graph.num_edges == 0:
            return
        from ..mts.series_analysis import SeriesAnalysisConfig, run_series_analysis

        cfg = SeriesAnalysisConfig.load(self.config_path)
        run_series_analysis(ctx.graph, cfg)
        log.info("series analysis: profiles dumped (k=%d, %d samples)",
                 cfg.k, cfg.sample_cnt)


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


class HybridAligning(AssemblyStage):
    """Long-read alignment + hybrid gap closing (hybrid_aligning.cpp:31-353).

    Aligns PacBio/Nanopore reads to the graph, stores the edge paths for
    repeat resolution, and splices dead-end gaps witnessed by long reads.
    A splice changes the graph's arrays, so the next `ctx.mapping_engine()`
    builds a new device index (its token changes)."""

    name = "Hybrid Aligning"
    id = "hybrid_aligning"

    def run(self, ctx: AssemblyContext) -> None:
        if not ctx.long_reads or ctx.graph is None or ctx.graph.num_edges == 0:
            return
        from ..alignment.long_read import (
            align_long_reads,
            build_long_read_storage,
            close_gaps_with_long_reads,
        )

        t0 = time.perf_counter()
        alignments = align_long_reads(ctx.graph, ctx.long_reads)
        t_align = time.perf_counter() - t0
        aligned = sum(1 for a in alignments if a.path)
        ctx.long_read_storage = build_long_read_storage(ctx.graph, alignments)
        t0 = time.perf_counter()
        closed = close_gaps_with_long_reads(ctx.graph, alignments)
        MODE_STATS.append((ctx.k, self.id, {
            "reads": len(ctx.long_reads), "aligned": aligned,
            "gap_records": sum(len(a.gaps) for a in alignments),
            "paths": len(ctx.long_read_storage.paths), "closed": closed,
            "align_s": t_align, "close_s": time.perf_counter() - t0,
        }))
        log.info(
            "hybrid aligning: %d/%d long reads aligned, %d paths stored, %d gaps closed",
            aligned, len(ctx.long_reads), len(ctx.long_read_storage.paths), closed,
        )


class ChromosomeRemoval(AssemblyStage):
    """plasmid/metaplasmid chromosome extraction
    (projects/spades/chromosome_removal.cpp)."""

    name = "Chromosome Removal"
    id = "chromosome_removal"

    def run(self, ctx: AssemblyContext) -> None:
        if ctx.graph is None or ctx.graph.num_edges == 0:
            return
        from ..graph.chromosome_remover import remove_chromosomal

        before = len(ctx.graph.canonical_edge_ids())
        n = remove_chromosomal(ctx.graph)
        after = len(ctx.graph.canonical_edge_ids())
        MODE_STATS.append((ctx.k, self.id, {
            "edge_pairs_before": before, "removed": n, "edge_pairs_after": after,
        }))
        log.info("chromosome removal: %d edges removed, %d remain", n, after)


class MetaplasmidExtraction(AssemblyStage):
    """Iterative metaplasmid/metaviral extraction loop
    (pipeline.cpp:84-96 AddMetaplasmidStages): coverage cutoffs grow
    cov -> max(cov + additive_step, cov * relative_step) up to 600
    (plasmid_mode.info:16-17 additive_step=5, relative_step=1.3); each round
    emits uniform high-coverage components and strips the background."""

    name = "Metaplasmid Extraction"
    id = "metaplasmid_extraction"

    def run(self, ctx: AssemblyContext) -> None:
        if ctx.graph is None or ctx.graph.num_edges == 0:
            log.info("metaplasmid loop: empty graph, nothing to extract")
            return
        from ..graph.chromosome_remover import metaplasmid_iteration

        cov, add, mult, max_cov = 5.0, 5.0, 1.3, 600.0
        total_components = 0
        rounds = []
        while cov < max_cov and ctx.graph.num_edges > 0:
            comps, removed = metaplasmid_iteration(ctx.graph, cov)
            rounds.append((int(cov), len(comps), removed))
            if comps:
                path = os.path.join(
                    ctx.output_dir, f"components{int(cov):04d}.fasta"
                )
                with open(path, "w") as fh:
                    for name, seq in comps:
                        fh.write(f">{name}\n{seq}\n")
                total_components += len(comps)
            cov = max(cov + add, cov * mult)
        MODE_STATS.append((ctx.k, self.id, {
            "rounds": rounds, "component_contigs": total_components,
            "edges_left": int(ctx.graph.num_edges),
        }))
        log.info(
            "metaplasmid loop: %d component contigs emitted, %d edges remain",
            total_components, ctx.graph.num_edges,
        )


class LoadGraph(AssemblyStage):
    """Start from an existing GFA assembly graph instead of reads
    (projects/spades/load_graph.cpp + --assembly-graph CLI option)."""

    name = "Load Graph"
    id = "load_graph"

    def __init__(self, gfa_path: str):
        self.gfa_path = gfa_path

    def run(self, ctx: AssemblyContext) -> None:
        from ..core import kmers as KK
        from ..graph.from_gfa import graph_from_gfa
        from ..io.gfa import read_gfa
        from ..ops.count import KmerCounts

        ctx.graph = graph_from_gfa(read_gfa(self.gfa_path), ctx.k)
        # synthesize (k+1)-mer pseudo-counts from edge coverage so the
        # coverage-model stage has a histogram to fit: zero (k+1)-mer words
        # in the counts' layout, each edge's rounded coverage repeated once
        # per k-mer of the edge, int64 as a counted table holds them
        cov = np.maximum(np.round(ctx.graph.coverage()), 1).astype(np.int64)
        lens = ctx.graph.edge_kmer_lengths()
        counts = np.repeat(cov, np.maximum(lens, 1))
        W = KK.kmer_words(ctx.k + 1)
        ctx.p1_counts = KmerCounts(
            k=ctx.k + 1,
            words=np.zeros((len(counts), W), np.uint32),
            counts=counts,
        )
        MODE_STATS.append((ctx.k, self.id, {
            "edges": int(ctx.graph.num_edges), "vertices": int(ctx.graph.num_vertices),
            "pseudo_counts": int(len(counts)),
        }))
        log.info(
            "loaded graph from %s: %d edges, %d vertices",
            self.gfa_path, ctx.graph.num_edges, ctx.graph.num_vertices,
        )


class SecondPhaseSetup(AssemblyStage):
    """Two-step (meta) repeat resolution hand-off
    (projects/spades/second_phase_setup.cpp + pipeline.cpp:139-151): preserve
    the preliminary contigs as `first_pe_contigs.fasta`, clear the RR
    products, and feed the contigs back as trusted paths for the main RR pass
    (SPAdes appends them as a PathExtendContigs library).

    The graph is not changed, so the main pass's PairInfoCount maps the
    reads onto the device index the preliminary pass built (one index on the
    card, the same mappings); the contigs are aligned on the host."""

    name = "Second Phase Setup"
    id = "second_phase_setup"

    def run(self, ctx: AssemblyContext) -> None:
        if not ctx.contigs or ctx.graph is None:
            return
        from ..alignment.long_read import align_long_reads, build_long_read_storage

        write_contigs(
            os.path.join(ctx.output_dir, "first_pe_contigs.fasta"), ctx.contigs
        )
        contig_seqs = [c.seq for c in ctx.contigs]
        t0 = time.perf_counter()
        alignments = align_long_reads(ctx.graph, contig_seqs)
        storage = build_long_read_storage(ctx.graph, alignments)
        if ctx.long_read_storage is not None:
            for path, c in ctx.long_read_storage.paths.items():
                storage.paths[path] = storage.paths.get(path, 0) + c
        ctx.long_read_storage = storage
        MODE_STATS.append((ctx.k, self.id, {
            "first_pe_contigs": len(contig_seqs),
            "aligned": sum(1 for a in alignments if a.path),
            "trusted_paths": len(storage.paths), "align_s": time.perf_counter() - t0,
        }))
        # ClearRRIndicesAndPaths: drop preliminary RR products + indices
        ctx.contigs, ctx.scaffolds = [], []
        ctx.contig_paths, ctx.scaffold_paths = [], []
        ctx.raw_pair_libs = []
        ctx.paired_index = ctx.scaffold_index = ctx.mp_index = None
        ctx.is_stats = None
        log.info(
            "second phase ready: %d trusted contig paths", len(storage.paths)
        )


class DomainAnalysis(AssemblyStage):
    """HMM domain extraction + domain-cluster candidates (biosyntheticSPAdes:
    projects/spades/{extract_domains.cpp,domain_graph_construction.cpp},
    domain_matcher.cpp; also the corona mode's HMM-guided path surface).

    Aligns every profile to the graph, writes hits, and groups hits whose
    paths share edges into candidate clusters (the domain-graph ordering at
    its simplest).  The cursor DP is host numpy (`hmm/align.py`)."""

    name = "Domain Analysis"
    id = "domain_analysis"

    def run(self, ctx: AssemblyContext) -> None:
        profiles = ctx.hmm_profiles or []
        if not profiles or ctx.graph is None or ctx.graph.num_edges == 0:
            return
        from ..hmm import align_hmm_to_graph

        all_hits = []
        dp_s = []
        for hmm in profiles:
            t0 = time.perf_counter()
            hits = align_hmm_to_graph(ctx.graph, hmm, score_threshold=5.0)
            dp_s.append((hmm.name, hmm.length, time.perf_counter() - t0))
            for h in hits:
                all_hits.append((hmm.name, h))
            log.info("domain %s: %d hits", hmm.name, len(hits))
        tsv = os.path.join(ctx.output_dir, "domain_hits.tsv")
        with open(tsv, "w") as fh:
            fh.write("domain\tscore\tpath\tseq_len\n")
            for name, h in sorted(all_hits, key=lambda t: -t[1].score):
                fh.write(
                    f"{name}\t{h.score:.2f}\t{','.join(map(str, h.path))}\t{len(h.seq)}\n"
                )
        # cluster hits sharing edges -> gene cluster candidates
        clusters: list[list[tuple[str, object]]] = []
        for name, h in all_hits:
            placed = False
            for cl in clusters:
                if any(set(h.path) & set(h2.path) for _n, h2 in cl):
                    cl.append((name, h))
                    placed = True
                    break
            if not placed:
                clusters.append([(name, h)])
        with open(os.path.join(ctx.output_dir, "gene_clusters.txt"), "w") as fh:
            for i, cl in enumerate(clusters):
                doms = ",".join(n for n, _ in cl)
                fh.write(f"cluster_{i+1}\t{doms}\n")
        MODE_STATS.append((ctx.k, self.id, {
            "hits": len(all_hits), "clusters": len(clusters), "dp_s": dp_s,
        }))
        log.info("domain analysis: %d hits in %d clusters", len(all_hits), len(clusters))


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


class MismatchCorrection(AssemblyStage):
    """Careful-mode edge-sequence polishing (mismatch_correction.cpp:119-280)."""

    name = "Mismatch Correction"
    id = "mismatch_correction"

    def run(self, ctx: AssemblyContext) -> None:
        if ctx.graph is None or ctx.graph.num_edges == 0 \
                or not (ctx.reads or ctx.read_store):
            return
        from ..alignment.mismatch import correct_mismatches

        if ctx.read_store is not None:
            n = correct_mismatches(ctx.graph, store=ctx.read_store,
                                   engine=ctx.mapping_engine())
        else:
            n = correct_mismatches(ctx.graph, ctx.reads, device=ctx.device)
        if n:
            # sequences rewritten in place: cached edge index is stale
            ctx.invalidate_mapping()
        MISMATCH_STATS.append((ctx.k, n))
        log.info("mismatch correction: %d bases fixed", n)


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


class PairInfoCount(AssemblyStage):
    """Map paired libraries to the graph, estimate insert sizes, fill the raw
    (unclustered) paired indices (pair_info_count.cpp:1-60)."""

    name = "Paired Information Counting"
    id = "pair_info_count"

    def __init__(self, preliminary: bool = False):
        if preliminary:
            # meta's first pass has an id of its own, so its checkpoint and
            # its `STAGE_TIMES` / `RR_STATS` rows are not the main pass's
            self.name = "Preliminary Paired Information Counting"
            self.id = "pair_info_count_preliminary"

    def run(self, ctx: AssemblyContext) -> None:
        ctx.raw_pair_libs = []
        if not (ctx.paired or ctx.paired_stores) or ctx.graph is None \
                or ctx.graph.num_edges == 0:
            log.info("no paired libraries — skipping pair info count")
            return
        if ctx.paired_stores:
            self._run_stores(ctx)
            return
        from ..alignment.mapper import build_edge_index, map_read_batch
        from ..io.libraries import iter_fr_libs
        from ..paired.paired_info import build_paired_index, estimate_insert_size

        idx = build_edge_index(ctx.graph)
        for r1s, r2s, lib_type in iter_fr_libs(ctx.paired):
            m1 = map_read_batch(idx, ctx.graph, r1s, kmer_mapper=ctx.kmer_mapper,
                                device=ctx.device)
            m2 = map_read_batch(idx, ctx.graph, r2s, kmer_mapper=ctx.kmer_mapper,
                                device=ctx.device)
            st = estimate_insert_size(
                ctx.graph, m1, m2, [len(r) for r in r1s], [len(r) for r in r2s]
            )
            log.info(
                "%s library: %d pairs mapped, insert size %.1f +- %.1f (%d obs)",
                lib_type, sum(m is not None for m in m1), st.median, st.mad, st.count,
            )
            if st.count == 0 or st.median <= 0:
                continue
            raw = build_paired_index(
                ctx.graph, m1, m2, [len(r) for r in r2s], st.median
            )
            ctx.raw_pair_libs.append((lib_type, raw, st))

    def _run_stores(self, ctx: AssemblyContext) -> None:
        """Packed-store path: shared MappingEngine + the vectorized
        `*_arrays` index functions (no per-pair Python loop, no re-encoding).

        The right mate is stored reverse-complemented (forward strand), so
        its mapping relates to the original read2's as
        edge = conj(edge_rc), start = len(edge) - (start_rc + rl); the
        array functions below take the original-orientation convention."""
        from ..paired.paired_info import (
            build_paired_index_arrays,
            estimate_insert_size_arrays,
        )

        g = ctx.graph
        tm: dict = {}
        with span("pair_info_count.index", into=tm, key="index_s"):
            engine = ctx.mapping_engine()
            engine._device_index()
        for st1, st2rc, lib_type in ctx.paired_stores:
            if st1.n == 0 or st2rc.n == 0:
                log.info("%s library: empty — skipped", lib_type)
                continue
            tm["map_s"] = 0.0
            with span("pair_info_count.map", into=tm, key="map_s", pairs=int(st1.n)):
                e1, s1, _ = engine.map_store(st1, kmer_mapper=ctx.kmer_mapper)
                e2r, s2r, _ = engine.map_store(st2rc, kmer_mapper=ctx.kmer_mapper)
            log.info("pair info: index %.1fs, mapping %.1fs", tm["index_s"], tm["map_s"])
            # convert the RC-mate mapping back to original-read2 orientation:
            # rc(read2) maps at (e, s) => read2 maps at (conj e, L - k_nt...)
            rl2 = np.concatenate([ch.lengths[: ch.n] for ch in st2rc.chunks])
            ok2 = e2r >= 0
            e2 = np.where(ok2, np.asarray(g.e_conj)[np.maximum(e2r, 0)], -1)
            L2 = np.asarray(g.e_len)[np.maximum(e2, 0)]
            s2 = np.where(ok2, L2 - (s2r + rl2[: len(e2r)]), 0)
            st = estimate_insert_size_arrays(g, e1, s1, e2, s2)
            log.info(
                "%s library: %d pairs mapped, insert size %.1f +- %.1f (%d obs)",
                lib_type, int((e1 >= 0).sum()), st.median, st.mad, st.count,
            )
            stats = {
                "lib_type": lib_type, "pairs": int(st1.n),
                "mapped_left": int((e1 >= 0).sum()), "mapped_right": int(ok2.sum()),
                "mapped_both": int(((e1 >= 0) & ok2).sum()),
                "is_median": st.median, "is_mad": st.mad, "is_mean": st.mean,
                "is_count": st.count, "index_s": tm["index_s"], "map_s": tm["map_s"],
                "index_timings": dict(engine.index_timings), "raw_entries": 0,
            }
            RR_STATS.append((ctx.k, self.id, stats))
            if st.count == 0 or st.median <= 0:
                continue
            raw = build_paired_index_arrays(g, e1, s1, e2, s2, st.median)
            stats["raw_entries"] = int(raw.e1.size)
            ctx.raw_pair_libs.append((lib_type, raw, st))


class DistanceEstimation(AssemblyStage):
    """Cluster the raw paired indices into point-estimate distance indices
    (distance_estimation.cpp:33; per-library estimator choice of
    distance_estimation_utils.cpp: mate-pairs -> smoothing, scaffolding-only)."""

    name = "Distance Estimation"
    id = "distance_estimation"

    def __init__(self, preliminary: bool = False):
        if preliminary:
            self.name = "Preliminary Distance Estimation"
            self.id = "distance_estimation_preliminary"

    def run(self, ctx: AssemblyContext) -> None:
        from ..paired.distance_estimation import estimate_distances
        from ..paired.paired_info import merge_paired_indices

        ctx.paired_index = ctx.scaffold_index = ctx.mp_index = None
        ctx.is_stats = None
        if not ctx.raw_pair_libs:
            return
        pe_indices, mp_indices = [], []
        for lib_type, raw, st in ctx.raw_pair_libs:
            clustered = estimate_distances(raw, lib_type)
            if lib_type == "mate-pairs":
                mp_indices.append(clustered)
            else:
                pe_indices.append(clustered)
                ctx.is_stats = st
        if ctx.is_stats is None:
            log.info("no usable insert-size estimate")
            return
        ctx.insert_size = ctx.is_stats.median
        ctx.paired_index = merge_paired_indices(pe_indices)
        clustered_entries = int(ctx.paired_index.e1.size)
        # contradiction removal + split-path fill-in before RR
        # (distance_estimation_utils.cpp:141-143 PairInfoImprover)
        from ..paired.pair_info_improver import improve_paired_info

        ctx.paired_index, imp = improve_paired_info(
            ctx.graph, ctx.paired_index,
            insert_size=ctx.is_stats.median,
            is_var=max(ctx.is_stats.mad, 1.0),
        )
        if imp.removed or imp.added:
            log.info(
                "pair info improver: removed %d contradictional, added %d",
                imp.removed, imp.added,
            )
        ctx.scaffold_index = merge_paired_indices(pe_indices + mp_indices)
        if mp_indices:
            ctx.mp_index = merge_paired_indices(mp_indices)
        RR_STATS.append((ctx.k, self.id, {
            "clustered_entries": clustered_entries,
            "improved_entries": int(ctx.paired_index.e1.size),
            "removed": imp.removed, "added": imp.added,
            "scaffold_entries": int(ctx.scaffold_index.e1.size),
            "mp_entries": 0 if ctx.mp_index is None else int(ctx.mp_index.e1.size),
        }))
        log.info(
            "clustered paired index: %d entries (%d scaffolding)",
            len(ctx.paired_index.e1), len(ctx.scaffold_index.e1),
        )


class RepeatResolution(AssemblyStage):
    """exSPAnder path extension + scaffolding (repeat_resolving.cpp:17-80).

    Maps paired libraries to the simplified graph, estimates insert size,
    builds the clustered paired index, then runs greedy path extension and
    pair-info scaffolding.  Without usable paired data, contigs fall back to
    graph edges (SPAdes behaves the same in --only-assembler single-lib
    corner cases)."""

    name = "Repeat Resolving"
    id = "repeat_resolving"

    def __init__(self, preliminary: bool = False):
        if preliminary:
            self.name = "Preliminary Repeat Resolving"
            self.id = "repeat_resolving_preliminary"
        self.preliminary = preliminary

    def run(self, ctx: AssemblyContext) -> None:
        from ..io.contigs import Contig
        from ..paired.path_extend import (
            PEConfig,
            make_chooser_chain,
            path_coverage,
            path_sequence,
            resolve_repeats,
            scaffold_paths,
            traverse_loops,
        )

        if ctx.graph is None or ctx.graph.num_edges == 0:
            log.info("empty graph — skipping repeat resolution")
            return
        if ctx.paired_index is None:
            # stage list without explicit PairInfoCount/DistanceEstimation
            # (direct library use) — run them in place
            PairInfoCount().run(ctx)
            DistanceEstimation().run(ctx)
        if ctx.paired_index is None or ctx.is_stats is None:
            log.info("no usable paired info — skipping repeat resolution")
            return
        is_stats = ctx.is_stats
        pi = ctx.paired_index
        scaffold_pi = ctx.scaffold_index
        cfg = PEConfig(
            insert_size=is_stats.median,
            is_var=max(is_stats.mad, 10.0),
            read_length=ctx.read_length,
        )
        from .config_overlay import apply_overlay

        apply_overlay(cfg, getattr(ctx, "config_overlay", None), "path_extend")
        # per-library composite extender chain in SPAdes' order
        # (extenders_logic.cpp:469-548); clustered per-lib indices come from
        # DistanceEstimation's raw_pair_libs pass
        from ..paired.distance_estimation import estimate_distances

        lib_chain = [
            (lt, estimate_distances(raw, lt), st)
            for lt, raw, st in (ctx.raw_pair_libs or [])
        ]
        choosers = make_chooser_chain(
            pair_libs=lib_chain,
            long_reads=ctx.long_read_storage,
            ss_cov=ctx.ss_cov,
            mode=ctx.mode,
            merged_pi=pi,
        )
        paths = resolve_repeats(ctx.graph, pi, cfg, choosers=choosers)
        n_loops = traverse_loops(ctx.graph, paths, cfg)
        if n_loops:
            log.info("loop traverser joined %d path pairs", n_loops)
        from ..paired.path_extend import trim_end_overlaps

        n_trim = trim_end_overlaps(ctx.graph, paths)
        if n_trim:
            log.info("overlap remover trimmed %d shared end edges", n_trim)
        log.info("%d paths after extension", len(paths))

        def to_contigs(path_list, prefix="NODE"):
            """Contigs ordered by length, with their edge paths retained for
            the .paths output (bidirectional_path_io)."""
            rows = sorted(
                (
                    (path_sequence(ctx.graph, p), path_coverage(ctx.graph, p), p)
                    for p in path_list
                ),
                key=lambda t: -len(t[0]),
            )
            contigs, named_paths = [], []
            for i, (s, c, p) in enumerate(rows):
                name = f"{prefix}_{i+1}_length_{len(s)}_cov_{c:.6f}"
                contigs.append(Contig(name=name, seq=s, coverage=c, edge_id=-1))
                named_paths.append((name, p))
            return contigs, named_paths

        ctx.contigs, ctx.contig_paths = to_contigs(paths)
        scaffolds = scaffold_paths(ctx.graph, scaffold_pi, paths, cfg)
        n_scaffolded = len(scaffolds)
        sg = None
        if ctx.mp_index is not None:
            # mate-pair scaffold graph pass (scaffolder2015): join remaining
            # paths along unambiguous long-edge links
            from ..paired.path_extend import (
                build_scaffold_graph_2015,
                scaffold_with_graph_2015,
            )

            sg = build_scaffold_graph_2015(ctx.graph, ctx.mp_index)
            scaffolds = scaffold_with_graph_2015(ctx.graph, sg, scaffolds, cfg)
            log.info(
                "mate-pair scaffold graph: %d vertices, %d links",
                sg.num_vertices, sg.num_edges,
            )
        # PathPolisher: replace scaffold N-gaps with real graph paths when a
        # bounded search finds a unique connection (launcher.cpp:477-510)
        from ..paired.path_extend import polish_paths, refine_scaffold_gaps

        scaffolds = polish_paths(ctx.graph, scaffolds, cfg)
        # composite gap analyzer (LA + Hamming) over the remaining N-gaps
        scaffolds = refine_scaffold_gaps(ctx.graph, scaffolds, cfg)
        ctx.scaffolds, ctx.scaffold_paths = to_contigs(scaffolds)
        RR_STATS.append((ctx.k, self.id, {
            "paths": len(paths), "loops_joined": n_loops, "overlaps_trimmed": n_trim,
            "after_scaffolding": n_scaffolded,
            "scaffold_graph_links": None if sg is None else sg.num_edges,
            "scaffolds": len(ctx.scaffolds),
        }))
        log.info(
            "%d contigs, %d scaffolds after repeat resolution",
            len(ctx.contigs), len(ctx.scaffolds),
        )
