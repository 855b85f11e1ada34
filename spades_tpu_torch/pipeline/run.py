"""Multi-K pipeline runner with per-K stage managers and checkpoints.

The outer loop mirrors `spades_pipeline/stages/spades_stage.py:282-396`
(per-K IterationStage chain with additional_contigs feed-forward, then final
copy) on top of the inner stage manager (pipeline/stages.py).

Every mode of the JAX package runs: `multicell`, `isolate` (no stage
branches on it), `sc` and `sewage` (they change only the simplification
config and the coverage model's branch, or skip error correction before the
run), `meta` (metaSPAdes' two-step repeat resolution), `plasmid`,
`metaplasmid` and `metaviral` (chromosome removal and the metaplasmid loop),
`rna` and `rnaviral` (the early A/T clipper; `ss`: SSEdgeSplit at every K in
`rna`), `bio` and `corona` (DomainAnalysis over `hmm_profiles`, which any
mode may also be given); long reads (`long_reads`: HybridAligning), a GFA
start (`assembly_graph`: LoadGraph) and `series_analysis` (SeriesAnalysis on
the last K); mismatch correction on the last K under `careful` /
`mismatch_correction`, and repeat resolution on the last K unless
`disable_rr`.
"""
from __future__ import annotations

import logging
import os
import shutil
from dataclasses import dataclass

import numpy as np

from ..graph.simplify import SimplifyConfig
from .. import resolve_device
from ..utils.timetracer import span
from .spades_stages import (
    ChromosomeRemoval,
    Construction,
    ContigOutput,
    DistanceEstimation,
    DomainAnalysis,
    GapClosing,
    GenomicInfoFiller,
    HybridAligning,
    LoadGraph,
    MetaplasmidExtraction,
    MismatchCorrection,
    PairInfoCount,
    RawSimplification,
    RepeatResolution,
    SecondPhaseSetup,
    SeriesAnalysis,
    Simplification,
    SSEdgeSplit,
)
from .stages import AssemblyContext, SavesPolicy, StageManager

log = logging.getLogger("spades_tpu_torch.run")


@dataclass
class RunResult:
    contigs: list
    scaffolds: list
    graph: object
    k: int


def mode_simplify_config(mode: str, read_length: int) -> SimplifyConfig:
    cfg = SimplifyConfig(read_length=read_length)
    if mode == "meta":
        # metaSPAdes: more aggressive relative-coverage handling, keep bulges
        # conservative (meta_mode.info overlay semantics)
        cfg.max_relative_coverage = 1.05
        cfg.rctc = 2.0
        cfg.rel_cov_enabled = True  # relative-coverage disconnector (rcc)
        cfg.complex_tc_enabled = True  # meta_mode.info:50-53
    elif mode == "rna":
        cfg.tc_lb = 2.0
        cfg.ier_enabled = False
    elif mode in ("plasmid", "metaplasmid", "metaviral"):
        cfg.ier_enabled = False  # keep short circular components
    elif mode == "sc":
        # single-cell: uneven MDA coverage — weaker coverage conditions
        cfg.max_relative_coverage = 1.2
        cfg.cbr_enabled = True  # mda_mode.info:51 complex bulge remover
    return cfg


def run_assembly(
    reads: list[str],
    k_list: list[int],
    output_dir: str,
    mode: str = "multicell",
    read_length: int = 100,
    paired_libs: list | None = None,  # list of (left_seqs, right_seqs)
    long_reads: list | None = None,
    trusted_contigs: list | None = None,
    min_count: int = 1,
    checkpoints: str = "last",
    restart_from: str | None = None,
    careful: bool = False,
    hmm_profiles: list | None = None,
    ss: str | None = None,
    series_analysis: str | None = None,
    assembly_graph: str | None = None,
    disable_rr: bool = False,
    mismatch_correction: bool | None = None,
    gfa_version: str = "1.2",
    config_overlay: dict | None = None,
    device=None,
) -> RunResult:
    """Assemble `reads` over the K ladder `k_list` into `output_dir`.

    device: where every stage's device work runs (None: the CUDA card; there
    is no silent CPU fallback, see `resolve_device`)."""
    # --disable-rr / --mismatch-correction / --gfa11 CLI contract
    # (options_parser.py: disable_rr skips repeat resolution entirely;
    # mismatch-correction forces the corrector even outside --careful)
    if mismatch_correction is None:
        mismatch_correction = careful
    if not k_list:
        raise ValueError("k_list is empty")
    dev = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    prev_contigs: list[str] = list(trusted_contigs or [])
    result: RunResult | None = None

    # Run-wide packed read stores (core.reads.ReadStore): encode + 2-bit
    # pack every read ONCE for the whole multi-K run; counting at every k
    # and every mapping pass (gap closers, pair info, mismatch correction)
    # consume the same chunks and their one-time device uploads — the
    # binary read-conversion discipline of SPAdes
    # (io/reads/binary_converter.hpp) applied to the packed device wire.
    from ..core.reads import ReadStore
    from ..io.libraries import iter_fr_libs

    with span("cli.pack") as sp:
        paired_stores = []
        count_store = None
        if paired_libs:
            libs = iter_fr_libs(paired_libs)
            for l, r, t in libs:
                paired_stores.append(
                    (ReadStore.build(l), ReadStore.build(r, rc=True), t)
                )
            # reuse the mapped stores for counting when `reads` is exactly the
            # libraries' concatenation (canonical k-mer counts are orientation-
            # invariant, so the RC-stored right mates count identically)
            concat_len = sum(len(l) + len(r) for l, r, _ in libs)
            if concat_len == len(reads):
                flat = []
                for l, r, _ in libs:
                    flat.extend(l)
                    flat.extend(r)
                def _same(a, b):
                    if a is b:
                        return True
                    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
                        return (
                            isinstance(a, np.ndarray)
                            and isinstance(b, np.ndarray)
                            and a.shape == b.shape
                            and bool((a == b).all())
                        )
                    return a == b

                # exact check: a sampled probe could false-positive and
                # silently count the wrong read set (identity short-circuits
                # make the common lefts+rights case O(n) pointer compares)
                if all(_same(a, b) for a, b in zip(reads, flat)):
                    chunks = []
                    for st1, st2rc, _ in paired_stores:
                        chunks.extend(st1.chunks)
                        chunks.extend(st2rc.chunks)
                    count_store = ReadStore(chunks, concat_len)
        if count_store is None and reads:
            count_store = ReadStore.build(reads)
        ss_store = None
        if mode == "rna" and ss and reads:
            # the stranded library packed once for every K's two SS mapping
            # passes (reads of k bases or fewer map nowhere, so the whole set
            # serves every K)
            from ..alignment.ss_coverage import read_store

            ss_store = read_store(reads, rf=ss == "rf")
        sp.set(reads=count_store.n if count_store is not None else 0,
               paired_reads=sum(a.n + b.n for a, b, _ in paired_stores))

    # restart addressing: "k<K>:<stage>", bare "<stage>" (first K), or "last"
    restart_k = None
    restart_stage = restart_from
    if restart_from and restart_from not in (None, "last") and restart_from.startswith("k"):
        kpart, _, spart = restart_from.partition(":")
        restart_k = int(kpart[1:])
        restart_stage = spart or None

    for ki, k in enumerate(k_list):
        with span(f"k{k}", k=k):
            is_last = ki == len(k_list) - 1
            kdir = os.path.join(output_dir, f"K{k}")
            os.makedirs(kdir, exist_ok=True)
            ctx = AssemblyContext(
                k=k,
                output_dir=kdir,
                reads=[r for r in reads if len(r) > k],
                paired=list(paired_libs or []),
                long_reads=list(long_reads or []),
                extra_sequences=list(prev_contigs),
                read_length=read_length,
                mode=mode,
                device=dev,
            )
            ctx.hmm_profiles = list(hmm_profiles or [])
            ctx.config_overlay = config_overlay
            ctx.read_store = count_store
            ctx.paired_stores = paired_stores
            mgr = StageManager(SavesPolicy(checkpoints))
            if assembly_graph and is_last:
                # start from a GFA graph (load_graph.cpp / --assembly-graph)
                mgr.add(LoadGraph(assembly_graph), GenomicInfoFiller())
            elif assembly_graph:
                continue  # GFA input: no multi-K laddering, main iteration only
            else:
                from .config_overlay import apply_overlay, construction_kwargs

                # Early tip clipping exists in SPAdes to shrink the input of its
                # (memory-bound, sequential) condenser (construction.cpp:448-449);
                # here condensation is a native radix pass, so pre-condensation
                # clipping buys nothing while graph-level tip clipping removes the
                # same tips.  Off by default; the config overlay can turn it on.
                # The A/T clipper runs for RNA pipelines only (construction.cpp:446).
                ckw = {
                    "min_count": min_count,
                    "early_tip_clip": False,
                    "early_at_clip": mode in ("rna", "rnaviral"),
                }
                ckw.update(construction_kwargs(config_overlay))
                mgr.add(
                    Construction(**ckw),
                    GenomicInfoFiller(),
                    # AddSimplificationStages order (pipeline.cpp:154-176):
                    # RawSimplification -> early gapcloser -> Simplification ->
                    # late gapcloser
                    RawSimplification(),
                    GapClosing("early"),
                    Simplification(apply_overlay(
                        mode_simplify_config(mode, read_length),
                        config_overlay, "simplification",
                    )),
                    GapClosing("late"),
                )
            if is_last and series_analysis:
                # meta mode multi-sample series analysis (pipeline.cpp gates on
                # cfg.series_analysis being set)
                mgr.add(SeriesAnalysis(series_analysis))
            if mode == "rna" and ss:
                # strand-specific transcript-boundary splitting at every K
                # (pipeline.cpp rna branch: SSEdgeSplit stage); `ss` outside rna
                # mode is ignored, as in the JAX package
                mgr.add(SSEdgeSplit(ss, store=ss_store))
            if is_last and long_reads:
                # long-read alignment feeds RR and closes remaining gaps
                # (pipeline.cpp: HybridLibrariesAligning on the main iteration)
                mgr.add(HybridAligning())
            if is_last and mode in ("plasmid", "metaplasmid", "metaviral"):
                # extract plasmid candidates before repeat resolution
                # (pipeline.cpp plasmid branch: ChromosomeRemoval stage)
                mgr.add(ChromosomeRemoval())
            if is_last and mode in ("metaplasmid", "metaviral"):
                # iterative coverage-cutoff extraction loop (AddMetaplasmidStages)
                mgr.add(MetaplasmidExtraction())
            if is_last and mismatch_correction:
                # careful mode (or --mismatch-correction) polishes edge
                # sequences before output (pipeline.cpp gates MismatchCorrection
                # on cfg.correct_mismatches)
                mgr.add(MismatchCorrection())
            if is_last and mode == "meta" and paired_libs and not disable_rr:
                # two-step repeat resolution (pipeline.cpp:139-151): preliminary
                # RR feeds its contigs back as trusted paths for the main pass
                mgr.add(
                    PairInfoCount(preliminary=True),
                    DistanceEstimation(preliminary=True),
                    RepeatResolution(preliminary=True),
                    SecondPhaseSetup(),
                )
            if is_last and not disable_rr:
                # repeat resolution runs on the main (last) iteration only
                # (pipeline.cpp: RepeatResolution gated on main_iteration,
                # preceded by PairInfoCount + DistanceEstimation)
                mgr.add(PairInfoCount(), DistanceEstimation(), RepeatResolution())
            if is_last and (hmm_profiles or mode in ("bio", "corona")):
                # domain extraction / HMM-guided analysis (bgc + corona modes)
                mgr.add(DomainAnalysis())
            mgr.add(ContigOutput(gfa_version=gfa_version))
            start = None
            if restart_from == "last":
                start = "last"
            elif restart_k is not None:
                if k < restart_k:
                    start = "last"  # fully resume earlier K from its checkpoint
                elif k == restart_k:
                    start = restart_stage
            mgr.run(ctx, start_from=start)
            # the last engine's device index must not outlive its K
            ctx.invalidate_mapping()
            prev_contigs = [c.seq for c in ctx.contigs]
            result = RunResult(
                contigs=ctx.contigs, scaffolds=ctx.scaffolds, graph=ctx.graph, k=k
            )

    # final copy (copy_files semantics): last K products to the output root
    last_kdir = os.path.join(output_dir, f"K{result.k}")
    for f in (
        "contigs.fasta",
        "scaffolds.fasta",
        "transcripts.fasta",
        "assembly_graph_with_scaffolds.gfa",
        "assembly_graph.fastg",
        "contigs.paths",
        "scaffolds.paths",
    ):
        src = os.path.join(last_kdir, f)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(output_dir, f))
    # breaking-scaffolds step (outer pipeline 'bs' stage): split scaffolds at
    # N-gap runs into misc/broken_scaffolds.fasta
    sc_path = os.path.join(output_dir, "scaffolds.fasta")
    if os.path.exists(sc_path):
        from ..io.contigs import break_scaffolds
        from ..io.fastx import read_fastx

        recs = [(r.name, r.seq) for r in read_fastx(sc_path)]
        modified, broken = break_scaffolds(recs)
        if modified:
            misc = os.path.join(output_dir, "misc")
            os.makedirs(misc, exist_ok=True)
            with open(os.path.join(misc, "broken_scaffolds.fasta"), "w") as fh:
                for name, seq in broken:
                    fh.write(f">{name}\n{seq}\n")
            log.info("broken scaffolds -> %s", os.path.join(misc, "broken_scaffolds.fasta"))
    return result
