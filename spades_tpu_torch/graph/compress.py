"""Graph compression: re-condense after edge deletions.

SPAdes mutates its pointer graph through `Compressor`
(`src/common/modules/simplification/compressor.hpp`) by
walking unbranching vertex chains sequentially.  Here compression is the same
log-depth pointer-doubling chain reduction used at construction time
(`ops/condense.py`), applied at the edge level: alive edges are the
arcs, vertices with indeg == outdeg == 1 link consecutive edges, maximal
chains become merged edges whose sequences are concatenated with k-overlap
trimming.
"""
from __future__ import annotations

import numpy as np

from .graph import CondensedGraph


def _ragged_copy(dst, dst_starts, src, src_starts, lens):
    lens = np.asarray(lens, np.int64)
    total = int(lens.sum())
    if total == 0:
        return
    ends = np.cumsum(lens)
    starts = ends - lens
    seg = np.repeat(np.arange(len(lens)), lens)
    within = np.arange(total) - starts[seg]
    dst[np.asarray(dst_starts)[seg] + within] = src[np.asarray(src_starts)[seg] + within]


def compress(g: CondensedGraph) -> CondensedGraph:
    """Merge edge chains through unbranching vertices; drops dead edges."""
    return compress_tracked(g)[0]


def compress_tracked(g: CondensedGraph) -> tuple[CondensedGraph, np.ndarray, np.ndarray]:
    """`compress`, and for each new edge the old edge its chain starts with
    and how many old edges it merges: (graph, heads (E,), n_arcs (E,))."""
    k = g.k
    ids = g.alive_edge_ids()
    A = ids.shape[0]
    if A == 0:
        none = np.zeros(0, np.int64)
        return CondensedGraph(
            k=k,
            e_start=np.zeros(0, np.int64), e_end=np.zeros(0, np.int64),
            e_conj=np.zeros(0, np.int64), e_off=np.zeros(0, np.int64),
            e_len=np.zeros(0, np.int64), e_cov=np.zeros(0, np.float64),
            alive=np.zeros(0, bool), seq_pool=np.zeros(0, np.uint8),
            v_conj=g.v_conj.copy(),
        ), none, none
    # dense arc ids for alive edges
    old2arc = -np.ones(g.alive.shape[0], np.int64)
    old2arc[ids] = np.arange(A)
    src = g.e_start[ids]
    dst = g.e_end[ids]
    w = (g.e_len[ids] - k).astype(np.int64)  # arc weight = length in kmers
    rc_arc = old2arc[g.e_conj[ids]]

    outdeg = np.bincount(src, minlength=g.num_vertices).astype(np.int64)
    indeg = np.bincount(dst, minlength=g.num_vertices).astype(np.int64)
    # unique out-edge per vertex (valid only where outdeg == 1)
    vout = np.full(g.num_vertices, -1, np.int64)
    vout[src] = np.arange(A)

    link_ok = (outdeg[dst] == 1) & (indeg[dst] == 1)
    nxt = np.where(link_ok, vout[dst], -1)
    prv = np.full(A, -1, np.int64)
    vn = nxt >= 0
    prv[nxt[vn]] = np.flatnonzero(vn)

    rounds = max(1, int(np.ceil(np.log2(max(A, 2)))) + 1)

    # cut perfect cycles at min arc
    parent = np.where(prv >= 0, prv, np.arange(A))
    done = prv < 0
    for _ in range(rounds):
        done = done | done[parent]
        parent = parent[parent]
    in_cycle = ~done
    if in_cycle.any():
        m = np.arange(A)
        q = np.where(nxt >= 0, nxt, np.arange(A))
        for _ in range(rounds):
            m = np.minimum(m, m[q])
            q = q[q]
        heads = np.unique(m[in_cycle])
        nxt[prv[heads]] = -1
        prv[heads] = -1

    # weighted Wyllie ranking: off = sum of w over proper predecessors
    parent = np.where(prv >= 0, prv, np.arange(A))
    off = np.where(prv >= 0, w[parent], 0).astype(np.int64)
    pos = np.where(prv >= 0, 1, 0).astype(np.int64)
    for _ in range(rounds):
        off = off + off[parent]
        pos = pos + pos[parent]
        parent = parent[parent]
    head = parent

    uheads, edge_of_arc = np.unique(head, return_inverse=True)
    E = uheads.shape[0]
    # chain positions are a 0..size-1 ranking, so max(pos)+1 == member count
    n_arcs = np.bincount(edge_of_arc, minlength=E).astype(np.int64)
    kmer_len = np.bincount(edge_of_arc, weights=w, minlength=E).astype(np.int64)
    e_len = kmer_len + k
    e_cov = np.bincount(edge_of_arc, weights=g.e_cov[ids], minlength=E)

    # Lazy sequence pool: single-member chains (the common case after a
    # removal pass) keep their slice of the OLD pool untouched; only merged
    # chains write concatenated bases, appended at the end.  Dead bases are
    # garbage-collected when they outgrow the live ones — this turns the
    # former full-pool rebuild (the profile hot spot at 1M edges) into work
    # proportional to the merged chains only.
    singleton = n_arcs == 1
    multi = ~singleton
    e_off = np.empty(E, np.int64)
    e_off[singleton] = g.e_off[ids[uheads[singleton]]]
    m_len = e_len[multi]
    base = np.int64(g.seq_pool.shape[0])
    e_off[multi] = base + np.concatenate([[0], np.cumsum(m_len)])[:-1].astype(np.int64)
    if m_len.size:
        append = np.zeros(int(m_len.sum()), np.uint8)
        local_off = e_off - base  # valid on multi rows only
        sel = multi[edge_of_arc]
        # every member of a merged chain writes its seq[k:] at off + k + rank
        _ragged_copy(
            append,
            local_off[edge_of_arc[sel]] + k + off[sel],
            g.seq_pool,
            g.e_off[ids[sel]] + k,
            w[sel],
        )
        # merged-chain heads write their first k bases
        mh = np.flatnonzero(multi)
        _ragged_copy(
            append,
            local_off[mh],
            g.seq_pool,
            g.e_off[ids[uheads[mh]]],
            np.full(len(mh), k, np.int64),
        )
        seq_pool = np.concatenate([g.seq_pool, append])
    else:
        seq_pool = g.seq_pool
    live = int(e_len.sum())
    if seq_pool.shape[0] > 2 * live:
        packed = np.zeros(live, np.uint8)
        packed_off = np.concatenate([[0], np.cumsum(e_len)])[:-1].astype(np.int64)
        _ragged_copy(packed, packed_off, seq_pool, e_off, e_len)
        seq_pool, e_off = packed, packed_off

    tail_arc = np.zeros(E, np.int64)
    is_tail = pos == (n_arcs[edge_of_arc] - 1)
    tail_arc[edge_of_arc[is_tail]] = np.flatnonzero(is_tail)
    e_conj = edge_of_arc[rc_arc[tail_arc]]
    assert np.array_equal(e_conj[e_conj], np.arange(E)), "compress: conj broken"

    return CondensedGraph(
        k=k,
        e_start=src[uheads], e_end=dst[tail_arc], e_conj=e_conj,
        e_off=e_off, e_len=e_len, e_cov=e_cov,
        alive=np.ones(E, bool), seq_pool=seq_pool,
        v_conj=g.v_conj.copy(),
    ), ids[uheads], n_arcs
