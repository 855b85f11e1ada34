"""Bounded Dijkstra framework over the flat conjugate graph.

Capability mirror of SPAdes' templated Dijkstra framework
(`src/common/assembly_graph/dijkstra/{dijkstra_algorithm.hpp,
dijkstra_helper.hpp,length_calculator.hpp,vertex_process_checker.hpp,
vertex_put_checker.hpp}`): bounded shortest distances from one or many
source vertices, forward or backward, with pluggable edge-length semantics
(k-mer units / nucleotides / unit hops), an edge filter (the put-checker
role), a distance bound and a per-source visited-vertex work bound, plus
path retrieval.

Batched form: instead of one priority queue per source (SPAdes runs
one Dijkstra per OpenMP task), the batched form relaxes a sparse frontier of
(source-row, vertex, dist) triplets each round with a lexsort scatter-min —
one vectorized pass serves every source at once.  With non-negative weights and a distance bound, iterating rounds to
a fixpoint yields exactly the Dijkstra distances restricted to the bound.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .graph import CondensedGraph


def _edge_weights(g: CondensedGraph, length: str) -> np.ndarray:
    if length == "kmer":
        return g.edge_kmer_lengths()
    if length == "nt":
        return g.e_len.copy()
    if length == "unit":
        return np.ones(len(g.alive), np.int64)
    raise ValueError(f"unknown length mode {length!r}")


def _csr(g: CondensedGraph, direction: str, edge_mask: np.ndarray | None):
    ids = g.alive_edge_ids()
    if edge_mask is not None:
        ids = ids[edge_mask[ids]]
    tail = g.e_start if direction == "fwd" else g.e_end
    order = np.argsort(tail[ids], kind="stable")
    eo = ids[order]
    off = np.searchsorted(tail[eo], np.arange(g.num_vertices + 1))
    return off, eo


@dataclass
class DijkstraResult:
    """Sparse bounded distances: parallel arrays over reached (row, vertex)."""

    rows: np.ndarray       # (N,) source row index
    vertices: np.ndarray   # (N,) vertex id
    dists: np.ndarray      # (N,) distance
    parent_edge: np.ndarray  # (N,) edge that finalized the entry (-1 at source)
    truncated: np.ndarray  # (S,) True where max_vertices stopped expansion

    def for_row(self, r: int) -> tuple[np.ndarray, np.ndarray]:
        m = self.rows == r
        return self.vertices[m], self.dists[m]

    def distances_dict(self, r: int = 0) -> dict[int, int]:
        v, d = self.for_row(r)
        return dict(zip(v.tolist(), d.tolist()))


def bounded_dijkstra(
    g: CondensedGraph,
    sources: np.ndarray | list[int],
    max_dist: int,
    direction: str = "fwd",
    length: str = "kmer",
    edge_mask: np.ndarray | None = None,
    max_vertices: int | None = None,
    csr: tuple[np.ndarray, np.ndarray] | None = None,
) -> DijkstraResult:
    """Shortest distances within max_dist from every source, batched.

    direction: 'fwd' follows out-edges, 'bwd' in-edges.  edge_mask (E,) bool
    restricts traversal (the put-checker role).  max_vertices bounds the
    number of vertices recorded per source (SPAdes'
    MAX_VERTEX_NUMBER process checker — a work bound, not a semantics
    change: a truncated source is flagged in `truncated`).  csr: the
    adjacency `_csr(g, direction, edge_mask)` gives, for a caller that runs
    many searches over one graph state (building it sorts every edge)."""
    sources = np.asarray(sources, np.int64)
    S = len(sources)
    V = g.num_vertices
    if S == 0:
        z = np.zeros(0, np.int64)
        return DijkstraResult(z, z, z, z, np.zeros(0, bool))
    off, eo = csr if csr is not None else _csr(g, direction, edge_mask)
    head = g.e_end[eo] if direction == "fwd" else g.e_start[eo]
    w = _edge_weights(g, length)[eo]
    deg = off[1:] - off[:-1]

    best_keys = np.sort(np.arange(S, dtype=np.int64) * V + sources)
    best_dist = np.zeros(S, np.int64)
    best_par = np.full(S, -1, np.int64)
    truncated = np.zeros(S, bool)

    f_rows = np.arange(S, dtype=np.int64)
    f_vert = sources.copy()
    f_dist = np.zeros(S, np.int64)
    while len(f_rows):
        rep = deg[f_vert]
        tot = int(rep.sum())
        if tot == 0:
            break
        src_i = np.repeat(np.arange(len(f_rows)), rep)
        slot = np.arange(tot) - np.repeat(np.cumsum(rep) - rep, rep)
        eidx = np.repeat(off[f_vert], rep) + slot
        nd = f_dist[src_i] + w[eidx]
        ok = nd <= max_dist
        rows = f_rows[src_i[ok]]
        verts = head[eidx[ok]]
        nd = nd[ok]
        pare = eo[eidx[ok]]
        if max_vertices is not None and len(rows):
            # drop expansions for rows already over their work bound
            counts = np.bincount(best_keys // V, minlength=S)
            over = counts >= max_vertices
            if over.any():
                dropm = over[rows]
                truncated |= np.bincount(rows[dropm], minlength=S).astype(bool)
                rows, verts, nd, pare = (
                    rows[~dropm], verts[~dropm], nd[~dropm], pare[~dropm]
                )
        if not len(rows):
            break
        cand_keys = rows * V + verts
        # scatter-min among candidates of this round
        co = np.lexsort((nd, cand_keys))
        cand_keys, nd, pare = cand_keys[co], nd[co], pare[co]
        first = np.ones(len(co), bool)
        first[1:] = cand_keys[1:] != cand_keys[:-1]
        cand_keys, nd, pare = cand_keys[first], nd[first], pare[first]
        # compare with settled bests
        pos = np.searchsorted(best_keys, cand_keys)
        exists = (pos < len(best_keys)) & (best_keys[np.minimum(pos, len(best_keys) - 1)] == cand_keys)
        improved = ~exists | (nd < np.where(exists, best_dist[np.minimum(pos, len(best_dist) - 1)], 0))
        cand_keys, nd, pare = cand_keys[improved], nd[improved], pare[improved]
        if not len(cand_keys):
            break
        # merge improved entries into the sorted best arrays
        allk = np.concatenate([best_keys, cand_keys])
        alld = np.concatenate([best_dist, nd])
        allp = np.concatenate([best_par, pare])
        mo = np.lexsort((alld, allk))
        allk, alld, allp = allk[mo], alld[mo], allp[mo]
        firstm = np.ones(len(allk), bool)
        firstm[1:] = allk[1:] != allk[:-1]
        best_keys, best_dist, best_par = allk[firstm], alld[firstm], allp[firstm]
        f_rows = cand_keys // V
        f_vert = cand_keys % V
        f_dist = nd
    return DijkstraResult(
        rows=best_keys // V,
        vertices=best_keys % V,
        dists=best_dist,
        parent_edge=best_par,
        truncated=truncated,
    )


def reached_vertices(
    g: CondensedGraph, v: int, max_dist: int, direction: str = "fwd",
    length: str = "kmer", edge_mask: np.ndarray | None = None,
) -> dict[int, int]:
    """Vertices within max_dist of v (DijkstraHelper::CreateBoundedDijkstra
    consumer shape): {vertex: distance}."""
    return bounded_dijkstra(
        g, [v], max_dist, direction, length, edge_mask
    ).distances_dict(0)


def shortest_path(
    g: CondensedGraph,
    v_from: int,
    v_to: int,
    max_dist: int,
    length: str = "kmer",
    skip_edges: tuple[int, ...] = (),
    edge_mask: np.ndarray | None = None,
) -> list[int] | None:
    """Edge list of a shortest bounded path, or None (the
    bounded-path-searcher role used by the bulge remover / gap closer)."""
    mask = edge_mask.copy() if edge_mask is not None else np.ones(len(g.alive), bool)
    for e in skip_edges:
        mask[e] = False
        mask[int(g.e_conj[e])] = False
    res = bounded_dijkstra(g, [v_from], max_dist, "fwd", length, mask)
    d = res.distances_dict(0)
    if v_to not in d:
        return None
    # walk parents back from v_to
    par = {int(v): int(p) for v, p in zip(res.vertices, res.parent_edge)}
    tail = g.e_start
    path = []
    v = v_to
    while v != v_from:
        e = par.get(v, -1)
        if e < 0:
            return None
        path.append(e)
        v = int(tail[e])
    return path[::-1]
