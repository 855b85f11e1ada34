"""Paired-end information: insert-size estimation, paired index, distance
estimation.

Capability mirrors:
* insert-size refinement from same-edge pairs —
  SPAdes' `src/common/paired_info/{insert_size_refiner.hpp,is_counter.hpp}`
* symmetric paired index (EdgeId,EdgeId) -> histogram{(distance, weight)}
  with conjugate merging — `paired_info/paired_info.hpp:26`
* clustering raw histograms into point estimates —
  `paired_info/distance_estimation.hpp:107` (simple/weighted estimators)

Array shape: the "index" is a sorted (e1, e2, d) -> w tuple table built
by one vectorized group-by over all mapped pairs; conjugate symmetrization is
an array transform; clustering is a segmented scan.  (SPAdes' cuckoo
hash buffers exist to survive concurrent inserts; a sort-based build needs no
concurrency control.)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..alignment.mapper import EdgeIndex, ReadMapping, map_read_batch
from ..graph.graph import CondensedGraph


@dataclass
class InsertSizeStats:
    median: float
    mad: float
    mean: float
    count: int


def estimate_insert_size(
    g: CondensedGraph,
    m1: list[ReadMapping | None],
    m2: list[ReadMapping | None],
    read_lengths_1: list[int],
    read_lengths_2: list[int],
) -> InsertSizeStats:
    """Estimate insert size from FR pairs mapping to the same oriented edge.

    For an FR library, read2 (as given) maps to the conjugate strand: its
    mapping lands on conj(e) at mirrored coordinates.  The insert spans from
    read1's start to read2's start on the genome strand of read1:
      IS = (len(e) - 1 - start2_on_conj - (rl2 - 1)) ... expressed below via
    edge-forward coordinates.
    """
    sizes = []
    for a, b, rl1, rl2 in zip(m1, m2, read_lengths_1, read_lengths_2):
        if a is None or b is None:
            continue
        # read2 forward-maps onto conj(e) when the pair is FR on edge e
        if int(g.e_conj[b.edge]) != a.edge:
            continue
        # position of read2's START on e's forward strand:
        #   conj coordinate start2 -> e coordinate  L - start2 - 1  is the
        #   position of read2's first base; its last base (leftmost on e) is
        #   at  L - start2 - rl2.
        L = int(g.e_len[a.edge])
        end2_fwd = L - b.start_offset  # one past read2's rightmost base on e
        isize = end2_fwd - a.start_offset
        if 0 < isize < 10000:
            sizes.append(isize)
    if not sizes:
        return InsertSizeStats(0.0, 0.0, 0.0, 0)
    arr = np.array(sizes, float)
    med = float(np.median(arr))
    mad = float(np.median(np.abs(arr - med)))
    return InsertSizeStats(med, mad, float(arr.mean()), len(arr))


@dataclass
class PairedIndex:
    """Sorted (e1, e2, d) -> weight table, conjugate-symmetrized."""

    e1: np.ndarray
    e2: np.ndarray
    dist: np.ndarray
    weight: np.ndarray

    def pairs_from(self, e: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All (e2, d, w) entries with e1 == e."""
        lo = np.searchsorted(self.e1, e, side="left")
        hi = np.searchsorted(self.e1, e, side="right")
        return self.e2[lo:hi], self.dist[lo:hi], self.weight[lo:hi]


def build_paired_index(
    g: CondensedGraph,
    m1: list[ReadMapping | None],
    m2: list[ReadMapping | None],
    read_lengths_2: list[int],
    insert_size: float,
) -> PairedIndex:
    """Accumulate pair info (e1, e2, d): d estimates start(e2) - start(e1)
    along the genome when walking e1's strand.

    For an FR pair: read1 at offset o1 on e1; read2's rc at offset o2' on
    e2' = conj(read2.edge) (so e2' is on read1's strand), with o2' being the
    offset of read2's *end*; the genomic distance between edge starts is
      d = (o1 + IS - rl2_span...) estimated as  o1 + IS - (o2_end)  where
    o2_end is read2's rightmost coordinate within e2'.
    Conjugate-symmetric entries (conj(e2), conj(e1), d') are added as in
    SPAdes' PairedIndex.
    """
    E1, E2, D = [], [], []
    for a, b, rl2 in zip(m1, m2, read_lengths_2):
        if a is None or b is None:
            continue
        e1 = a.edge
        o1 = a.start_offset
        # read2 maps FR: conj(b.edge) is on read1's strand
        e2 = int(g.e_conj[b.edge])
        L2 = int(g.e_len[e2])
        # read2's end position (one past) in e2-forward coordinates:
        o2_end = L2 - b.start_offset
        # genome: start(e1) + o1 + IS == start(e2) + o2_end
        d = o1 + insert_size - o2_end
        E1.append(e1)
        E2.append(e2)
        D.append(d)
    if not E1:
        z = np.zeros(0)
        return PairedIndex(z.astype(np.int64), z.astype(np.int64), z, z)
    e1 = np.array(E1, np.int64)
    e2 = np.array(E2, np.int64)
    d = np.round(np.array(D, float)).astype(np.int64)
    # conjugate symmetrization: (e1,e2,d) <=> (conj e2, conj e1, d + len(e1) - len(e2))
    ce1 = g.e_conj[e2]
    ce2 = g.e_conj[e1]
    cd = d + (g.e_len[e1] - g.k) - (g.e_len[e2] - g.k)
    e1 = np.concatenate([e1, ce1])
    e2 = np.concatenate([e2, ce2])
    d = np.concatenate([d, cd])
    w = np.ones_like(d, float)

    order = np.lexsort((d, e2, e1))
    e1, e2, d, w = e1[order], e2[order], d[order], w[order]
    key_new = np.concatenate(
        [[True], (e1[1:] != e1[:-1]) | (e2[1:] != e2[:-1]) | (d[1:] != d[:-1])]
    )
    seg = np.cumsum(key_new) - 1
    wsum = np.zeros(seg[-1] + 1)
    np.add.at(wsum, seg, w)
    return PairedIndex(e1[key_new], e2[key_new], d[key_new], wsum)


def merge_paired_indices(indices: list[PairedIndex]) -> PairedIndex:
    """Concatenate sorted (e1,e2,d)->w tables, summing duplicate keys."""
    indices = [p for p in indices if p.e1.size]
    if not indices:
        z = np.zeros(0)
        return PairedIndex(z.astype(np.int64), z.astype(np.int64), z, z)
    if len(indices) == 1:
        return indices[0]
    e1 = np.concatenate([p.e1 for p in indices])
    e2 = np.concatenate([p.e2 for p in indices])
    d = np.concatenate([p.dist for p in indices])
    w = np.concatenate([p.weight for p in indices])
    order = np.lexsort((d, e2, e1))
    e1, e2, d, w = e1[order], e2[order], d[order], w[order]
    new = np.concatenate(
        [[True], (e1[1:] != e1[:-1]) | (e2[1:] != e2[:-1]) | (d[1:] != d[:-1])]
    )
    seg = np.cumsum(new) - 1
    wsum = np.zeros(seg[-1] + 1)
    np.add.at(wsum, seg, w)
    return PairedIndex(e1[new], e2[new], d[new], wsum)


def cluster_distances(pi: PairedIndex, max_delta: int = 10) -> PairedIndex:
    """Distance estimation: merge histogram points within max_delta into
    weighted-mean clusters (simple/weighted estimator semantics)."""
    if pi.e1.size == 0:
        return pi
    E1, E2, D, W = [], [], [], []
    n = pi.e1.size
    i = 0
    while i < n:
        j = i
        # walk one (e1, e2) group
        while j < n and pi.e1[j] == pi.e1[i] and pi.e2[j] == pi.e2[i]:
            j += 1
        ds = pi.dist[i:j]
        ws = pi.weight[i:j]
        # cluster consecutive distances within max_delta
        start = 0
        for t in range(1, len(ds) + 1):
            if t == len(ds) or ds[t] - ds[t - 1] > max_delta:
                cw = ws[start:t].sum()
                cd = float((ds[start:t] * ws[start:t]).sum() / cw)
                E1.append(pi.e1[i])
                E2.append(pi.e2[i])
                D.append(cd)
                W.append(cw)
                start = t
        i = j
    return PairedIndex(
        np.array(E1, np.int64), np.array(E2, np.int64),
        np.array(D, float), np.array(W, float),
    )


def estimate_insert_size_arrays(
    g: CondensedGraph,
    e1: np.ndarray, s1: np.ndarray,
    e2: np.ndarray, s2: np.ndarray,
) -> InsertSizeStats:
    """Vectorized `estimate_insert_size` over mapping arrays (edge == -1
    unmapped).  Same geometry: FR pairs whose mates land on the same oriented
    edge; IS = read2's forward-end coordinate minus read1's start."""
    e1 = np.asarray(e1, np.int64)
    e2 = np.asarray(e2, np.int64)
    ok = (e1 >= 0) & (e2 >= 0)
    ok &= np.asarray(g.e_conj)[np.maximum(e2, 0)] == e1
    if not ok.any():
        return InsertSizeStats(0.0, 0.0, 0.0, 0)
    L = np.asarray(g.e_len)[e1[ok]]
    isize = (L - np.asarray(s2)[ok]) - np.asarray(s1)[ok]
    isize = isize[(isize > 0) & (isize < 10000)]
    if isize.size == 0:
        return InsertSizeStats(0.0, 0.0, 0.0, 0)
    arr = isize.astype(float)
    med = float(np.median(arr))
    mad = float(np.median(np.abs(arr - med)))
    return InsertSizeStats(med, mad, float(arr.mean()), len(arr))


def build_paired_index_arrays(
    g: CondensedGraph,
    e1: np.ndarray, s1: np.ndarray,
    e2: np.ndarray, s2: np.ndarray,
    insert_size: float,
) -> PairedIndex:
    """Vectorized `build_paired_index` over mapping arrays (edge == -1
    unmapped): same FR geometry, conjugate symmetrization and (e1,e2,d)
    weight aggregation, with the per-pair Python loop replaced by one
    lexsort group-by."""
    e1 = np.asarray(e1, np.int64)
    e2 = np.asarray(e2, np.int64)
    ok = (e1 >= 0) & (e2 >= 0)
    if not ok.any():
        z = np.zeros(0)
        return PairedIndex(z.astype(np.int64), z.astype(np.int64), z, z)
    a = e1[ok]
    o1 = np.asarray(s1)[ok].astype(np.int64)
    b = np.asarray(g.e_conj)[e2[ok]].astype(np.int64)
    o2_end = np.asarray(g.e_len)[b] - np.asarray(s2)[ok].astype(np.int64)
    d = np.round(o1 + insert_size - o2_end).astype(np.int64)
    ce1 = np.asarray(g.e_conj)[b]
    ce2 = np.asarray(g.e_conj)[a]
    cd = d + (np.asarray(g.e_len)[a] - g.k) - (np.asarray(g.e_len)[b] - g.k)
    E1 = np.concatenate([a, ce1])
    E2 = np.concatenate([b, ce2])
    D = np.concatenate([d, cd])
    w = np.ones_like(D, float)
    order = np.lexsort((D, E2, E1))
    E1, E2, D, w = E1[order], E2[order], D[order], w[order]
    key_new = np.concatenate(
        [[True], (E1[1:] != E1[:-1]) | (E2[1:] != E2[:-1]) | (D[1:] != D[:-1])]
    )
    seg = np.cumsum(key_new) - 1
    wsum = np.zeros(seg[-1] + 1)
    np.add.at(wsum, seg, w)
    return PairedIndex(E1[key_new], E2[key_new], D[key_new], wsum)
