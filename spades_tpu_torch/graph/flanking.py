"""Flanking coverage index: per-edge coverage of the leading k-mers.

Capability mirror of SPAdes' FlankingCoverage
(`src/common/assembly_graph/graph_support/detail_coverage.hpp:22-174`):
each edge stores the raw coverage SUM over its first
`min(length, averaging_range)` (k+1)-mers; `CoverageOfStart(e)` is that sum
averaged, and `CoverageOfEnd(e) = CoverageOfStart(conjugate(e))` by strand
symmetry (:82-88).  `LocalCoverage(e, v)` picks the flank touching vertex v
— the signal the relative-coverage component remover and the EC loop remover
consult instead of whole-edge averages
(`modules/simplification/relative_coverage_remover.hpp:240-249`,
`erroneous_connection_remover.hpp:320,376-380`).

Note SPAdes' tip-clip RelativeCoverageTipCondition itself still uses
whole-edge competitor coverage (`tip_clipper.hpp:21` carries the TODO); the
flanking signal enters through the relative-coverage machinery.

Build is one vectorized pass: leading windows of every alive edge are packed
and canonicalized on host, looked up in the sorted (k+1)-mer count table
(the PHMCoverageFiller role, `stages/construction.cpp:371-435`), and
segment-summed per edge.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import kmers as K
from .graph import CondensedGraph

DEFAULT_AVERAGING_RANGE = 50  # cfg flanking_range (config.info simp defaults)


@dataclass
class FlankingCoverage:
    averaging_range: int
    raw: np.ndarray  # (E,) float64: coverage sum over leading window

    def cov_of_start(self, g: CondensedGraph, e) -> np.ndarray | float:
        lens = np.minimum(g.edge_kmer_lengths()[e], self.averaging_range)
        return self.raw[e] / np.maximum(lens, 1)

    def cov_of_end(self, g: CondensedGraph, e) -> np.ndarray | float:
        return self.cov_of_start(g, g.e_conj[e])

    def local_coverage(self, g: CondensedGraph, e: int, v: int) -> float:
        """Flank of e at vertex v (LocalCoverage :240)."""
        if int(g.e_start[e]) == int(v):
            return float(self.cov_of_start(g, e))
        return float(self.cov_of_end(g, e))


def build_flanking(
    g: CondensedGraph,
    p1_words: np.ndarray,
    p1_counts: np.ndarray,
    averaging_range: int = DEFAULT_AVERAGING_RANGE,
) -> FlankingCoverage:
    """Fill raw flanking sums from the sorted canonical (k+1)-mer table."""
    from ..ops.count import searchsorted_rows
    from ..ops.extension import canonicalize

    k1 = g.k + 1
    E = g.alive.shape[0]
    raw = np.zeros(E, np.float64)
    ids = g.alive_edge_ids()
    if ids.size == 0 or p1_words.shape[0] == 0:
        return FlankingCoverage(averaging_range, raw)
    # leading min(len_kmers, range) (k+1)-mer windows per edge, flattened
    nw = np.minimum(g.edge_kmer_lengths()[ids], averaging_range).astype(np.int64)
    total = int(nw.sum())
    seg = np.repeat(np.arange(ids.size), nw)
    ends = np.cumsum(nw)
    within = np.arange(total) - (ends - nw)[seg]
    base = g.e_off[ids][seg] + within
    win = g.seq_pool[base[:, None] + np.arange(k1)[None, :]]
    words = K.pack(win)
    canon, _ = canonicalize(words, k1)
    pos = searchsorted_rows(p1_words, canon)
    cnt = np.where(pos >= 0, p1_counts[np.maximum(pos, 0)], 0).astype(np.float64)
    np.add.at(raw, ids[seg], cnt)
    return FlankingCoverage(averaging_range, raw)
