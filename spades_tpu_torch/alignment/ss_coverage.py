"""Strand-specific coverage tracking and edge splitting (stranded RNA).

Capability mirror of SPAdes' `src/common/alignment/rna/ss_coverage.hpp`
(SSCoverageStorage :18-66, SSCoverageSplitter :137-300),
`ss_coverage_filler.hpp` (SSCoverageFiller/SSBinCoverageFiller), and the
SSEdgeSplit stage (`src/common/stages/ss_edge_split.cpp`): reads of a
strand-specific library are mapped WITHOUT reverse-complement following,
oriented k-mer counts are accumulated per edge (optionally binned), and an
edge whose forward-strand coverage descends while its conjugate's ascends —
two transcripts meeting tail-to-tail — is split at the coverage intersection
point.

The reads are mapped on the device through a `MappingEngine` (the run's
engine of the graph state, `AssemblyContext.mapping_engine()`), one packed
`ReadStore` of the library for every pass.  The per-edge coverage and the bin
fill are one `np.add.at` scatter each; split detection is the host numpy of
`spades_tpu.alignment.ss_coverage`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.reads import ReadStore
from ..graph.graph import CondensedGraph
from .mapper import MappingEngine

# rna_mode.info ss_coverage_splitter defaults
DEFAULT_BIN_SIZE = 50
DEFAULT_MIN_EDGE_LEN = 200
DEFAULT_MIN_EDGE_COVERAGE = 5.0
DEFAULT_COVERAGE_MARGIN = 5.0
DEFAULT_MIN_FLANKING_COVERAGE = 2.0


def read_store(reads, rf: bool = False) -> ReadStore:
    """Pack a strand-specific read set once for its mapping passes.  `rf`
    reverse-complements every read, so that the mapping orientation always
    equals the transcript strand (SPAdes encodes this through the library's
    strand-specificity flag)."""
    return ReadStore.build(list(reads), rc=rf)


def _mapped_spans(
    g: CondensedGraph, store: ReadStore, engine: MappingEngine | None = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Map a packed strand-specific read set on the device -> (edge, start,
    end) arrays of the spans longer than k, in read order.

    engine: the mapping engine of `g` (a new one on `device` when None)."""
    if engine is None:
        engine = MappingEngine(g, device=device)
    edge, start, _votes = engine.map_store(store, force_device=True)
    hit = np.flatnonzero(edge >= 0)
    es = edge[hit]
    L = g.e_len[es].astype(np.int64)
    a = np.maximum(0, start[hit])
    lengths = np.concatenate([ch.lengths[: ch.n] for ch in store.chunks]
                             or [np.zeros(0, np.int32)]).astype(np.int64)
    b = np.minimum(L, start[hit] + lengths[hit])
    keep = b - a > g.k
    return es[keep], a[keep], b[keep]


def fill_ss_coverage(
    g: CondensedGraph,
    store: ReadStore,
    engine: MappingEngine | None = None,
    symmetric: bool = False,
    device=None,
) -> np.ndarray:
    """Per-oriented-edge strand-specific k-mer coverage (SSCoverageFiller).

    Returns an (E,) float array of average k-mer coverage per edge (after
    SPAdes' RecalculateCoverage division by edge length)."""
    es, lo, hi = _mapped_spans(g, store, engine, device)
    cov = np.zeros(len(g.e_start), np.float64)
    kmer_counts = np.maximum(hi - lo - g.k, 0)
    np.add.at(cov, es, kmer_counts)
    if symmetric:
        np.add.at(cov, g.e_conj[es], kmer_counts)
    return cov / np.maximum(g.edge_kmer_lengths(), 1)


@dataclass
class SSCoverageSplitter:
    """Detect and apply antisense-boundary edge splits (SSCoverageSplitter)."""

    g: CondensedGraph
    bin_size: int = DEFAULT_BIN_SIZE
    min_edge_len: int = DEFAULT_MIN_EDGE_LEN
    min_edge_coverage: float = DEFAULT_MIN_EDGE_COVERAGE
    coverage_margin: float = DEFAULT_COVERAGE_MARGIN
    min_flanking_coverage: float = DEFAULT_MIN_FLANKING_COVERAGE
    bins: dict[int, np.ndarray] = field(default_factory=dict)

    def __post_init__(self):
        assert self.min_edge_len >= 3 * self.bin_size
        cov = self.g.coverage()
        for e in self.g.alive_edge_ids():
            e = int(e)
            if self.g.e_conj[e] == e:
                continue
            if self.g.e_len[e] - self.g.k < self.min_edge_len:
                continue
            if cov[e] < self.min_edge_coverage:
                continue
            n_bins = int(self.g.e_len[e] - self.g.k + self.bin_size - 1) // self.bin_size
            self.bins[e] = np.zeros(n_bins, np.int64)

    def fill(self, store: ReadStore, engine: MappingEngine | None = None,
             device=None) -> None:
        """Accumulate binned strand-specific k-mer counts (SSBinCoverageFiller).

        Each span [a, b) adds to bin bi the overlap of its k-mer positions
        [a, b - k) with [bi * bin_size, (bi + 1) * bin_size), over the bins
        from a // bin_size to the last whole-read bin; every (span, bin) pair
        is one row of a single scatter-add (integer sums, so the order does
        not matter)."""
        es, lo, hi = _mapped_spans(self.g, store, engine, device)
        if not self.bins or es.size == 0:
            return
        ids = np.fromiter(self.bins, np.int64, len(self.bins))
        sizes = np.fromiter((len(v) for v in self.bins.values()), np.int64, len(ids))
        base = np.concatenate([[0], np.cumsum(sizes)])
        order = np.argsort(ids)
        pos = np.searchsorted(ids[order], es)
        pos = np.minimum(pos, len(ids) - 1)
        slot = order[pos]
        binned = ids[slot] == es
        es, lo, hi, slot = es[binned], lo[binned], hi[binned], slot[binned]
        bs, k = self.bin_size, self.g.k
        n = sizes[slot]
        first = lo // bs
        last = np.minimum(np.minimum(hi - k - 1, n * bs - 1) // bs, n - 1)
        nb = np.maximum(last - first + 1, 0)
        rows = np.repeat(np.arange(len(es)), nb)
        bi = first[rows] + (np.arange(rows.size) - np.repeat(np.cumsum(nb) - nb, nb))
        add = np.maximum(0, np.minimum(hi[rows] - k, (bi + 1) * bs) - np.maximum(lo[rows], bi * bs))
        flat = np.zeros(int(base[-1]), np.int64)
        np.add.at(flat, base[slot[rows]] + bi, add)
        for j, e in enumerate(ids):
            self.bins[int(e)] += flat[base[j] : base[j + 1]]

    # -- detection (DetectEdgeSplit, ss_coverage.hpp:174-204) --------------
    def _is_coverage_different(self, c1: float, c2: float) -> bool:
        if c1 == 0.0 and c2 == 0.0:
            return False
        if c1 > c2:
            return c1 >= self.min_flanking_coverage and c1 >= c2 * self.coverage_margin
        return c2 >= self.min_flanking_coverage and c2 >= c1 * self.coverage_margin

    def detect_split(self, e: int) -> int:
        """Split position in graph (k-mer) coordinates, 0 = no split."""
        cov_bins = self.bins.get(e)
        conj_bins = self.bins.get(int(self.g.e_conj[e]))
        if cov_bins is None or conj_bins is None or len(cov_bins) < 3:
            return 0
        assert len(cov_bins) == len(conj_bins)
        b = float(self.bin_size)
        last_whole = len(cov_bins) - 2
        f_front, f_back = cov_bins[0] / b, cov_bins[last_whole] / b
        r_front, r_back = conj_bins[1] / b, conj_bins[-1] / b
        if not (
            self._is_coverage_different(f_front, f_back)
            and self._is_coverage_different(r_front, r_back)
            and self._is_coverage_different(f_front, r_back)
            and self._is_coverage_different(r_front, f_back)
        ):
            return 0
        descends = f_front > f_back
        if descends:
            if f_front < r_back or r_front < f_back:
                return 0
        else:
            if f_front > r_back or r_front > f_back:
                return 0
        rev = conj_bins[::-1]
        inter = (cov_bins < rev) if descends else (cov_bins > rev)
        idx = np.flatnonzero(inter)
        if len(idx) == 0:
            return 0
        pos = int(idx[0]) * self.bin_size
        if pos <= 0 or pos >= int(self.g.e_len[e]) - self.g.k:
            return 0
        return pos

    def split_edges(self) -> int:
        """Apply all detected splits; returns number of edges split."""
        n = 0
        for e in list(self.bins):
            if not self.g.alive[e]:
                continue
            if int(self.g.e_conj[e]) < e:
                continue  # handle each conjugate pair once
            pos = self.detect_split(e)
            if pos:
                split_edge(self.g, e, pos)
                n += 1
        return n


def split_edge(g: CondensedGraph, e: int, pos: int) -> tuple[int, int]:
    """Split edge `e` at k-mer position `pos` into two edges joined by a new
    vertex pair (the Graph::SplitEdge the SS splitter relies on).

    Returns (first new edge id, second new edge id)."""
    k = g.k
    L = int(g.e_len[e])
    assert 0 < pos < L - k
    codes = g.edge_codes(e)
    v_new = len(g.v_conj)
    g.v_conj = np.append(g.v_conj, [v_new + 1, v_new])
    cov = float(g.e_cov[e])
    total = L - k
    e1, _ = g.add_edge_pair(int(g.e_start[e]), v_new, codes[: pos + k], cov * pos / total)
    e2, _ = g.add_edge_pair(v_new, int(g.e_end[e]), codes[pos:], cov * (total - pos) / total)
    g.kill_edges(np.array([e]))
    return e1, e2
