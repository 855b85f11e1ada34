"""Build the port's host state from the JAX package's, array for array.

The assembler has no weights; what crosses between the two packages is
state: counted (k+1)-mers, the extension index, the condensed graph, the
edge k-mer index of the read mapper, and what the stages of an assembly hand
on (the coverage model's `GenomicInfo`, a `SimplifyConfig`, the `KmerMapper`
of glued k-mers, contigs, and for repeat resolution the paired indices, the
insert-size estimate and the paths; a profile HMM of the domain stage and
the k-mer profiles of series analysis).
Each function takes that state as a dict of numpy arrays and scalars, as
`dataclasses.asdict` gives it for `spades_tpu`'s `KmerCounts`,
`ExtensionIndex`, `CondensedGraph`, `EdgeIndex`, `GenomicInfo` or
`SimplifyConfig`, and returns the port's object, so the state after one
JAX-run stage can feed the port's next stage (the parity tests do this).
"""
from __future__ import annotations

import numpy as np

from .alignment.kmer_mapper import KmerMapper
from .alignment.mapper import EdgeIndex
from .graph.coverage_model import GenomicInfo
from .graph.graph import CondensedGraph
from .graph.simplify import SimplifyConfig
from .hmm.io import ProfileHMM
from .io.contigs import Contig
from .mts.multiplicity import KmerProfiles
from .ops.count import KmerCounts
from .ops.extension import ExtensionIndex
from .paired.paired_info import InsertSizeStats, PairedIndex
from .paired.path_extend import Path


def counts_from_arrays(d: dict) -> KmerCounts:
    return KmerCounts(
        k=int(d["k"]),
        words=np.ascontiguousarray(d["words"], np.uint32),
        counts=np.ascontiguousarray(d["counts"], np.int64),
    )


def ext_index_from_arrays(d: dict) -> ExtensionIndex:
    def opt(name, dtype):
        a = d.get(name)
        return None if a is None else np.ascontiguousarray(a, dtype)

    return ExtensionIndex(
        k=int(d["k"]),
        kmers=np.ascontiguousarray(d["kmers"], np.uint32),
        in_mask=np.ascontiguousarray(d["in_mask"], np.uint8),
        out_mask=np.ascontiguousarray(d["out_mask"], np.uint8),
        pref_idx=opt("pref_idx", np.int64),
        suf_idx=opt("suf_idx", np.int64),
        pref_rc=opt("pref_rc", np.uint8),
        suf_rc=opt("suf_rc", np.uint8),
    )


def graph_from_arrays(d: dict) -> CondensedGraph:
    return CondensedGraph(
        k=int(d["k"]),
        e_start=np.ascontiguousarray(d["e_start"], np.int64),
        e_end=np.ascontiguousarray(d["e_end"], np.int64),
        e_conj=np.ascontiguousarray(d["e_conj"], np.int64),
        e_off=np.ascontiguousarray(d["e_off"], np.int64),
        e_len=np.ascontiguousarray(d["e_len"], np.int64),
        e_cov=np.ascontiguousarray(d["e_cov"], np.float64),
        alive=np.ascontiguousarray(d["alive"], bool),
        seq_pool=np.ascontiguousarray(d["seq_pool"], np.uint8),
        v_conj=np.ascontiguousarray(d["v_conj"], np.int64),
    )


def edge_index_from_arrays(d: dict) -> EdgeIndex:
    return EdgeIndex(
        k=int(d["k"]),
        kmers=np.ascontiguousarray(d["kmers"], np.uint32),
        edge=np.ascontiguousarray(d["edge"], np.int64),
        offset=np.ascontiguousarray(d["offset"], np.int64),
        strand=np.ascontiguousarray(d["strand"], np.uint8),
    )


def genomic_info_from_dict(d: dict) -> GenomicInfo:
    return GenomicInfo(
        ec_bound=float(d["ec_bound"]),
        trusted_bound=float(d["trusted_bound"]),
        estimated_mean=float(d["estimated_mean"]),
        genome_size=int(d["genome_size"]),
        estimated_sd=float(d.get("estimated_sd", 0.0)),
        converged=bool(d.get("converged", True)),
    )


def simplify_config_from_dict(d: dict) -> SimplifyConfig:
    """Every field must be one the port's `SimplifyConfig` has: an unknown
    name raises `TypeError`, so a field added on one side only is noticed."""
    return SimplifyConfig(**d)


def kmer_mapper_from_arrays(k: int, src: np.ndarray | None, dst: np.ndarray | None) -> KmerMapper:
    """A `KmerMapper` from its materialized substitution table: sorted unique
    source rows `(N, W)` uint32 and their destination rows (None or empty for
    a mapper that recorded nothing)."""
    m = KmerMapper(k=int(k))
    if src is not None and len(src):
        m._sorted_src = np.ascontiguousarray(src, np.uint32)
        m._sorted_dst = np.ascontiguousarray(dst, np.uint32)
        # `size` counts the recorded rows
        m._src, m._dst = [m._sorted_src], [m._sorted_dst]
    return m


def contigs_from_records(records) -> list[Contig]:
    """Contigs from (name, seq, coverage, edge_id) tuples."""
    return [Contig(name=str(n), seq=str(s), coverage=float(c), edge_id=int(e))
            for n, s, c, e in records]


def paired_index_from_arrays(d: dict) -> PairedIndex:
    """A `PairedIndex` from its four columns.  `dist` keeps its dtype: int64
    in a raw index, float64 once clustered."""
    return PairedIndex(
        e1=np.array(d["e1"], np.int64),
        e2=np.array(d["e2"], np.int64),
        dist=np.array(d["dist"]),
        weight=np.array(d["weight"], np.float64),
    )


def insert_size_stats_from_list(v) -> InsertSizeStats:
    """`InsertSizeStats` from [median, mad, mean, count], the order in which
    a checkpoint's `state.json` stores it."""
    return InsertSizeStats(float(v[0]), float(v[1]), float(v[2]), int(v[3]))


def paths_from_lists(records) -> list[Path]:
    """Paths from (edges, gaps) pairs of int lists."""
    return [Path([int(e) for e in edges], [int(x) for x in gaps])
            for edges, gaps in records]


def profile_hmm_from_arrays(d: dict) -> ProfileHMM:
    compo = d.get("compo")
    return ProfileHMM(
        name=str(d["name"]), length=int(d["length"]), alphabet=str(d["alphabet"]),
        K=int(d["K"]),
        match_emit=np.ascontiguousarray(d["match_emit"], np.float64),
        insert_emit=np.ascontiguousarray(d["insert_emit"], np.float64),
        trans=np.ascontiguousarray(d["trans"], np.float64),
        compo=None if compo is None else np.ascontiguousarray(compo, np.float64),
    )


def kmer_profiles_from_arrays(d: dict) -> KmerProfiles:
    return KmerProfiles(
        k=int(d["k"]),
        words=np.ascontiguousarray(d["words"], np.uint32),
        mpl=np.ascontiguousarray(d["mpl"], np.uint16),
    )
