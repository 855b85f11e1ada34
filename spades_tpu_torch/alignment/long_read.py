"""Sensitive long-read-to-graph alignment (PacBio/Nanopore).

Capability mirror of SPAdes' sensitive aligner
(`src/common/alignment/pacbio/g_aligner.cpp` `GAligner`,
`pac_index.hpp` shared-k-mer clustering, QuickStep chaining, and the
Dijkstra-bounded gap filler of `gap_dijkstra.cpp`/`gap_filler.cpp`): anchor
long reads on the graph with short exact k-mers, cluster anchors per
(edge, diagonal), chain clusters along the read, and emit the edge path plus
gap records where the chain jumps across disconnected edges.

Host numpy, as in `spades_tpu.alignment.long_read`: the 13-mer anchors are
looked up in a smaller-k edge index by binary search (`searchsorted_rows`),
and clustering/chaining is a small DP over the handful of clusters per read
(SPAdes' is likewise a per-read serial step inside an OpenMP loop).  The
order of `LongReadStorage.paths` (a dict) is the order of its `add` calls,
each path followed by its conjugate, as in the JAX package: the long-read
chooser of repeat resolution reads the votes in that order."""
from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

from ..core import dna
from ..core import kmers as K
from ..graph.graph import CondensedGraph
from ..ops.count import searchsorted_rows
from ..ops.extension import canonicalize
from .mapper import EdgeIndex, build_edge_index

log = logging.getLogger("spades_tpu_torch.long_read")


@dataclass
class AlignerConfig:
    k: int = 13                 # anchor k (pacbio_k analog; < graph k).
                                # 13 keeps anchor yield usable at CLR-level
                                # ~12% noise (a clean 13-mer survives ~19% of
                                # positions vs 15-mer's 15%)
    min_cluster_anchors: int = 3
    diag_tolerance: int = 40    # indel slack within one cluster
    min_identity_span: int = 50  # minimal read span of a usable cluster
    max_clusters_per_read: int = 64


@dataclass
class Chained:
    """One chained edge visit of a read path."""

    edge: int
    read_start: int
    read_end: int
    edge_start: int
    edge_end: int
    anchors: int


@dataclass
class GapRecord:
    """A jump between two chained edges that are not graph-adjacent."""

    left_edge: int
    right_edge: int
    left_trim: int     # unmatched tail of left edge after its last anchor
    right_trim: int    # unmatched head of right edge before its first anchor
    segment: str       # read sequence spanning the jump


@dataclass
class LongReadAlignment:
    read_id: int
    path: list[Chained] = field(default_factory=list)
    gaps: list[GapRecord] = field(default_factory=list)

    @property
    def edges(self) -> list[int]:
        return [c.edge for c in self.path]


def _anchors(index: EdgeIndex, g: CondensedGraph, seq: str, k: int):
    """(read_pos, oriented_edge, edge_offset) exact anchor triplets."""
    codes = dna.encode(seq)
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros((0, 3), np.int64)
    ok = codes < 4
    wins = np.lib.stride_tricks.sliding_window_view(np.where(codes >= 4, 0, codes), k)
    valid = np.lib.stride_tricks.sliding_window_view(ok, k).all(axis=1)
    packed = K.pack(np.ascontiguousarray(wins))
    canon, read_rc = canonicalize(packed, k)
    idx = searchsorted_rows(index.kmers, canon)
    hit = (idx >= 0) & valid
    if not hit.any():
        return np.zeros((0, 3), np.int64)
    pos = np.flatnonzero(hit)
    ii = idx[hit]
    e = index.edge[ii]
    off = index.offset[ii]
    same = read_rc[hit] == index.strand[ii]
    oc = g.e_len[e] - k - off
    edge = np.where(same, e, g.e_conj[e])
    eoff = np.where(same, off, oc)
    return np.stack([pos, edge, eoff], axis=1)


def align_long_read(
    index: EdgeIndex, g: CondensedGraph, seq: str, read_id: int = 0,
    cfg: AlignerConfig | None = None,
) -> LongReadAlignment:
    cfg = cfg or AlignerConfig()
    k = index.k
    a = _anchors(index, g, seq, k)
    out = LongReadAlignment(read_id=read_id)
    if a.shape[0] == 0:
        return out

    # cluster anchors per edge along the diagonal (pac_index clustering):
    # sort by (edge, diagonal) and split where the diagonal jumps by more
    # than the indel slack — drifting diagonals stay in one cluster instead
    # of being cut at fixed bucket boundaries
    diag = a[:, 2] - a[:, 0]
    order = np.lexsort((a[:, 0], diag, a[:, 1]))
    a, diag = a[order], diag[order]
    newc = np.concatenate(
        [[True],
         (a[1:, 1] != a[:-1, 1]) | (np.diff(diag) > cfg.diag_tolerance)]
    )
    # the clusters are contiguous runs of the sorted anchors: cut at their
    # starts (the JAX package selects each with `a[cid == c]`, the same rows)
    bounds = np.append(np.flatnonzero(newc), len(a))
    clusters = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        rows = a[lo:hi]
        if rows.shape[0] < cfg.min_cluster_anchors:
            continue
        rs, re = int(rows[:, 0].min()), int(rows[:, 0].max()) + k
        if re - rs < cfg.min_identity_span:
            continue
        clusters.append(
            Chained(
                edge=int(rows[0, 1]),
                read_start=rs, read_end=re,
                edge_start=int(rows[:, 2].min()), edge_end=int(rows[:, 2].max()) + k,
                anchors=int(rows.shape[0]),
            )
        )
    if not clusters:
        return out
    clusters.sort(key=lambda c: (-c.anchors, c.read_start))
    clusters = clusters[: cfg.max_clusters_per_read]

    # chain: max-weight increasing subsequence over read coordinates
    clusters.sort(key=lambda c: c.read_start)
    n = len(clusters)
    best = [float(c.anchors) for c in clusters]
    prev = [-1] * n
    for j in range(n):
        for i in range(j):
            if (
                clusters[i].read_end <= clusters[j].read_start + k
                and clusters[i].edge != clusters[j].edge
                or (
                    clusters[i].edge == clusters[j].edge
                    and clusters[i].edge_end <= clusters[j].edge_start + k
                    and clusters[i].read_end <= clusters[j].read_start + k
                )
            ):
                w = best[i] + clusters[j].anchors
                if w > best[j]:
                    best[j] = w
                    prev[j] = i
    end = int(np.argmax(best))
    chain = []
    while end != -1:
        chain.append(clusters[end])
        end = prev[end]
    chain.reverse()
    out.path = chain

    # gap records between non-adjacent consecutive chain edges
    for c1, c2 in zip(chain, chain[1:]):
        if c1.edge == c2.edge:
            continue
        if g.e_end[c1.edge] == g.e_start[c2.edge]:
            continue  # graph-adjacent: no gap
        seg = seq[c1.read_end : c2.read_start]
        out.gaps.append(
            GapRecord(
                left_edge=c1.edge,
                right_edge=c2.edge,
                left_trim=int(g.e_len[c1.edge]) - c1.edge_end,
                right_trim=c2.edge_start,
                segment=seg,
            )
        )
    return out


def align_long_reads(
    g: CondensedGraph, seqs: list[str], cfg: AlignerConfig | None = None
) -> list[LongReadAlignment]:
    cfg = cfg or AlignerConfig()
    index = build_edge_index(g, cfg.k)
    return [align_long_read(index, g, s, i, cfg) for i, s in enumerate(seqs)]


# ---------------------------------------------------------------------------
# Long-read path storage (alignment/long_read_storage.hpp analog)
# ---------------------------------------------------------------------------

@dataclass
class LongReadStorage:
    """Aggregated long-read edge paths with support counts."""

    paths: dict = field(default_factory=dict)  # tuple(edges) -> count

    def add(self, edges: list[int]) -> None:
        if len(edges) >= 2:
            t = tuple(edges)
            self.paths[t] = self.paths.get(t, 0) + 1

    def next_edge_votes(self, e: int) -> dict[int, int]:
        """Votes for the edge following e in any stored path."""
        votes: dict[int, int] = {}
        for path, c in self.paths.items():
            for i in range(len(path) - 1):
                if path[i] == e:
                    votes[path[i + 1]] = votes.get(path[i + 1], 0) + c
        return votes


def build_long_read_storage(
    g: CondensedGraph, alignments: list[LongReadAlignment]
) -> LongReadStorage:
    """Store every aligned path and its conjugate (SPAdes' storage is
    likewise conjugate-symmetric so backward extension sees the same votes)."""
    st = LongReadStorage()
    for al in alignments:
        st.add(al.edges)
        st.add([int(g.e_conj[e]) for e in reversed(al.edges)])
    return st


# ---------------------------------------------------------------------------
# Hybrid gap closing (hybrid_aligning.cpp + hybrid_gap_closer.hpp analog)
# ---------------------------------------------------------------------------

def close_gaps_with_long_reads(
    g: CondensedGraph, alignments: list[LongReadAlignment], min_support: int = 2
) -> int:
    """Splice tip-to-tip gaps witnessed by >= min_support long reads.

    The filling sequence is a pileup consensus of all supporting read
    segments (SPAdes runs SPOA over the collected gap sequences,
    `hybrid_gap_closer.hpp:312-320`; here `alignment/edit.consensus` —
    medoid backbone + banded-alignment column voting — plays that role, with
    Myers-distance outlier filtering like SPAdes' edlib pre-check in
    `gap_filler.cpp`)."""
    from .edit import consensus, edit_distances

    by_junction: dict[tuple[int, int], list[GapRecord]] = {}
    for al in alignments:
        for rec in al.gaps:
            by_junction.setdefault((rec.left_edge, rec.right_edge), []).append(rec)

    out_deg = g.out_degrees()
    in_deg = g.in_degrees()
    closed = 0
    for (ea, eb), recs in sorted(by_junction.items(), key=lambda kv: -len(kv[1])):
        if len(recs) < min_support:
            continue
        if not (g.alive[ea] and g.alive[eb]) or ea == eb or eb == g.e_conj[ea]:
            continue
        if out_deg[g.e_end[ea]] != 0 or in_deg[g.e_start[eb]] != 0:
            continue  # only close dead-end junctions (gap closer contract)
        tail = g.edge_codes(ea)
        head = g.edge_codes(eb)
        # normalize every record to the same anchored window: the last T
        # bases of the left edge + gap segment + first H bases of the right
        # edge, so copies are directly comparable for consensus
        T = max(r.left_trim for r in recs)
        H = max(r.right_trim for r in recs)
        T = min(T + 10, len(tail))
        H = min(H + 10, len(head))
        windows = []
        for r in recs:
            if r.left_trim > len(tail) or r.right_trim > len(head):
                continue
            mid = dna.encode(r.segment)
            if (mid >= 4).any():
                continue
            win = np.concatenate(
                [
                    tail[len(tail) - T : len(tail) - r.left_trim],
                    mid,
                    head[r.right_trim : H],
                ]
            )
            windows.append(dna.decode(win.astype(np.uint8)))
        if len(windows) < min_support:
            continue
        if len(windows) >= 3:
            # drop outliers: copies far from the medoid are misaligned reads
            med = windows[len(windows) // 2]
            d = edit_distances(med, windows)
            lens = np.array([max(len(w), 1) for w in windows])
            keep = d / lens < 0.45
            if keep.sum() >= min_support:
                windows = [w for w, k in zip(windows, keep) if k]
        fill = consensus(windows)
        mid = dna.encode(fill)
        if (mid >= 4).any():
            continue
        joined = np.concatenate([tail[: len(tail) - T], mid, head[H:]])
        if len(joined) < g.k + 1:
            continue
        g.add_edge_pair(
            int(g.e_start[ea]), int(g.e_end[eb]), joined,
            float(g.e_cov[ea] + g.e_cov[eb]),
        )
        g.kill_edges(np.array([ea, eb]))
        closed += 1
        log.info(
            "hybrid gap close %d->%d: %dnt consensus window, support %d",
            ea, eb, len(fill), len(windows),
        )
    return closed
