"""Stage pipeline runtime: stages, manager, checkpoints, restart.

Capability mirror of SPAdes' stage framework
(`src/common/pipeline/stage.hpp:26-274`: `AssemblyStage` with
run/load/save, `StageManager::run` with checkpoint save/restore and
`--restart-from` addressing, `SavesPolicy` none/all/last + checkpoint
pointer), merged with the outer Python done-file mechanism
(`spades_pipeline/executors/executor_local.py`).

State lives in an `AssemblyContext` (the GraphPack analog,
`pipeline/graph_pack.hpp:19`): a typed blackboard the stages read and write.
"""
from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any

log = logging.getLogger("spades_tpu_torch.stages")

# Per-stage wall-time trail (k, stage_id, seconds to 0.01), appended by
# StageManager.run from the stage's span (`utils/timetracer.py`, on
# `time.perf_counter`) — the ledger a benchmark's stage breakdown reads.
# Callers may clear it between runs.
STAGE_TIMES: list[tuple[int, str, float]] = []


class SavesPolicy(str, Enum):
    NONE = "none"
    LAST = "last"
    ALL = "all"


@dataclass
class AssemblyContext:
    """Typed blackboard shared by stages (GraphPack analog)."""

    k: int
    output_dir: str
    reads: list = field(default_factory=list)          # short-read sequences
    paired: list = field(default_factory=list)         # (left, right) index pairs
    long_reads: list = field(default_factory=list)
    extra_sequences: list = field(default_factory=list)  # prev-K contigs etc.
    graph: Any = None                                   # CondensedGraph
    p1_counts: Any = None                               # KmerCounts of (k+1)-mers
    genomic_info: Any = None
    contigs: list = field(default_factory=list)
    scaffolds: list = field(default_factory=list)
    contig_paths: list = field(default_factory=list)     # (name, Path) for .paths
    scaffold_paths: list = field(default_factory=list)
    mode: str = "multicell"
    read_length: int = 100
    insert_size: float = 0.0
    long_read_storage: Any = None                       # LongReadStorage
    ss_cov: Any = None                                  # strand-specific coverage (rna)
    hmm_profiles: list = field(default_factory=list)    # ProfileHMMs (DomainAnalysis)
    kmer_mapper: Any = None                             # alignment.kmer_mapper.KmerMapper
    # paired-info pack (UnclusteredPairedInfoIndices / clustered indices of
    # SPAdes GraphPack, graph_pack.cpp:30-53)
    raw_pair_libs: list = field(default_factory=list)   # (lib_type, PairedIndex, InsertSizeStats)
    paired_index: Any = None                            # clustered PE index (merged)
    scaffold_index: Any = None                          # clustered PE+MP index
    mp_index: Any = None                                # clustered mate-pair index
    is_stats: Any = None                                # InsertSizeStats of the PE libs
    config: Any = None
    # Run-wide packed read store (core.reads.ReadStore): reads encoded +
    # 2-bit packed ONCE for the whole multi-K run (the binary_converter.hpp
    # discipline); `paired_stores` holds (left_store, right_rc_store,
    # lib_type) per FR library with the right mate pre-reverse-complemented.
    read_store: Any = None
    paired_stores: list = field(default_factory=list)
    # where the device work of every stage runs (counting, index build,
    # mapper, prefilter); None is the CUDA card, see `resolve_device`
    device: Any = None
    _me: Any = None                                     # cached MappingEngine
    _me_token: Any = None

    def saves_dir(self, stage_id: str) -> str:
        return os.path.join(self.output_dir, "saves", stage_id)

    def mapping_engine(self):
        """Shared per-graph-state MappingEngine (EdgeIndex built + uploaded
        once, reused by gap closing / pair info / mismatch correction).

        The cache key tracks graph identity and cheap shape/topology
        signatures; stages that rewrite sequences in place must call
        `invalidate_mapping()` explicitly."""
        from ..alignment.mapper import MappingEngine

        g = self.graph
        token = (
            len(g.e_len), int(g.alive.sum()), int(len(g.seq_pool)),
            int(g.e_len.sum()),
        )
        if self._me is None or self._me.g is not g or self._me_token != token:
            self.invalidate_mapping()
            self._me = MappingEngine(g, device=self.device)
            self._me_token = token
        return self._me

    def invalidate_mapping(self) -> None:
        """Drop the cached engine and the device index it holds, so the
        indices of successive graph states do not pile up on the card."""
        if self._me is not None:
            self._me.release()
        self._me = None
        self._me_token = None


class AssemblyStage:
    """Base stage: subclass and implement run(); optionally save/load."""

    name = "stage"
    id = "stage"

    def run(self, ctx: AssemblyContext) -> None:
        raise NotImplementedError

    def save(self, ctx: AssemblyContext, path: str) -> None:
        """Full-pack checkpoint (FullPackIO, io/binary/graph_pack.hpp): graph,
        contigs, genomic info, paired indices, long-read storage, kmer
        mapper — everything a restart inside the RR region needs."""
        os.makedirs(path, exist_ok=True)
        from ..graph.serialize import (
            save_graph,
            save_kmer_mapper,
            save_long_reads,
            save_paired_index,
        )

        if ctx.graph is not None:
            save_graph(os.path.join(path, "graph.npz"), ctx.graph)
        state = {
            "k": ctx.k,
            "read_length": ctx.read_length,
            "insert_size": ctx.insert_size,
            "contigs": [(c.name, c.seq, c.coverage) for c in ctx.contigs],
            "scaffolds": [(c.name, c.seq, c.coverage) for c in ctx.scaffolds],
        }
        if ctx.genomic_info is not None:
            gi = ctx.genomic_info
            state["genomic_info"] = {
                "ec_bound": gi.ec_bound,
                "trusted_bound": gi.trusted_bound,
                "estimated_mean": gi.estimated_mean,
                "genome_size": gi.genome_size,
            }
        for name in ("paired_index", "scaffold_index", "mp_index"):
            pi = getattr(ctx, name)
            if pi is not None:
                save_paired_index(os.path.join(path, f"{name}.npz"), pi)
        if ctx.raw_pair_libs:
            state["raw_pair_libs"] = []
            for i, (lib_type, raw, st) in enumerate(ctx.raw_pair_libs):
                save_paired_index(os.path.join(path, f"raw_pairs_{i}.npz"), raw)
                state["raw_pair_libs"].append(
                    (lib_type, [st.median, st.mad, st.mean, st.count])
                )
        if ctx.is_stats is not None:
            st = ctx.is_stats
            state["is_stats"] = [st.median, st.mad, st.mean, st.count]
        if ctx.long_read_storage is not None and ctx.long_read_storage.paths:
            save_long_reads(os.path.join(path, "long_reads.npz"), ctx.long_read_storage)
        if ctx.kmer_mapper is not None and ctx.kmer_mapper.size:
            save_kmer_mapper(os.path.join(path, "kmer_mapper.npz"), ctx.kmer_mapper)
        with open(os.path.join(path, "state.json"), "w") as fh:
            json.dump(state, fh)

    def load(self, ctx: AssemblyContext, path: str) -> None:
        from ..graph.coverage_model import GenomicInfo
        from ..graph.serialize import (
            load_graph,
            load_kmer_mapper,
            load_long_reads,
            load_paired_index,
        )
        from ..io.contigs import Contig

        gpath = os.path.join(path, "graph.npz")
        if os.path.exists(gpath):
            ctx.graph = load_graph(gpath)
        with open(os.path.join(path, "state.json")) as fh:
            state = json.load(fh)
        ctx.read_length = state["read_length"]
        ctx.insert_size = state.get("insert_size", 0.0)
        ctx.contigs = [
            Contig(name=n, seq=s, coverage=c, edge_id=-1)
            for n, s, c in state["contigs"]
        ]
        ctx.scaffolds = [
            Contig(name=n, seq=s, coverage=c, edge_id=-1)
            for n, s, c in state.get("scaffolds", [])
        ]
        if "genomic_info" in state:
            ctx.genomic_info = GenomicInfo(**state["genomic_info"])
        for name in ("paired_index", "scaffold_index", "mp_index"):
            f = os.path.join(path, f"{name}.npz")
            if os.path.exists(f):
                setattr(ctx, name, load_paired_index(f))
        if "raw_pair_libs" in state or "is_stats" in state:
            from ..paired.paired_info import InsertSizeStats
        if "raw_pair_libs" in state:
            ctx.raw_pair_libs = []
            for i, (lib_type, st) in enumerate(state["raw_pair_libs"]):
                raw = load_paired_index(os.path.join(path, f"raw_pairs_{i}.npz"))
                ctx.raw_pair_libs.append(
                    (lib_type, raw, InsertSizeStats(st[0], st[1], st[2], int(st[3])))
                )
        if "is_stats" in state:
            s = state["is_stats"]
            ctx.is_stats = InsertSizeStats(s[0], s[1], s[2], int(s[3]))
        f = os.path.join(path, "long_reads.npz")
        if os.path.exists(f):
            ctx.long_read_storage = load_long_reads(f)
        f = os.path.join(path, "kmer_mapper.npz")
        if os.path.exists(f):
            ctx.kmer_mapper = load_kmer_mapper(f)


class StageManager:
    """Runs a stage list with checkpointing and restart-from."""

    def __init__(self, saves_policy: SavesPolicy = SavesPolicy.LAST):
        self.stages: list[AssemblyStage] = []
        self.saves_policy = saves_policy

    def add(self, *stages: AssemblyStage) -> "StageManager":
        self.stages.extend(stages)
        return self

    def _checkpoint_file(self, ctx: AssemblyContext) -> str:
        return os.path.join(ctx.output_dir, "saves", "checkpoint.json")

    def last_checkpoint(self, ctx: AssemblyContext) -> str | None:
        cp = self._checkpoint_file(ctx)
        if os.path.exists(cp):
            with open(cp) as fh:
                return json.load(fh).get("last_stage")
        return None

    def run(self, ctx: AssemblyContext, start_from: str | None = None) -> None:
        """Run stages; start_from may name a stage id to resume at (loading
        the previous stage's checkpoint), or "last" to auto-resume."""
        ids = [s.id for s in self.stages]
        begin = 0
        if start_from == "last":
            last = self.last_checkpoint(ctx)
            if last in ids:
                begin = ids.index(last) + 1
                if begin < len(self.stages):
                    log.info("resuming after stage '%s'", last)
                    self.stages[ids.index(last)].load(ctx, ctx.saves_dir(last))
                else:
                    log.info("pipeline already complete at '%s'", last)
                    self.stages[-1].load(ctx, ctx.saves_dir(last))
                    return
        elif start_from is not None:
            if start_from not in ids:
                raise ValueError(f"unknown stage id '{start_from}' (have {ids})")
            begin = ids.index(start_from)
            if begin > 0:
                prev = self.stages[begin - 1]
                prev.load(ctx, ctx.saves_dir(prev.id))

        from ..utils.timetracer import span

        for i in range(begin, len(self.stages)):
            stage = self.stages[i]
            log.info("== STAGE %s (%s) ==", stage.name, stage.id)
            tm: dict = {}
            with span(stage.name, stage.id, into=tm, key="s"):
                stage.run(ctx)
            STAGE_TIMES.append((ctx.k, stage.id, round(tm["s"], 2)))
            log.info("== done %s (%.2fs)", stage.name, tm["s"])
            if self.saves_policy != SavesPolicy.NONE:
                with span("cli.checkpoint", stage=stage.id):
                    is_last = i == len(self.stages) - 1
                    if self.saves_policy == SavesPolicy.ALL or is_last:
                        stage.save(ctx, ctx.saves_dir(stage.id))
                    os.makedirs(os.path.dirname(self._checkpoint_file(ctx)), exist_ok=True)
                    with open(self._checkpoint_file(ctx), "w") as fh:
                        json.dump({"last_stage": stage.id, "time": time.time()}, fh)
