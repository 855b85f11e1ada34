"""Barcode-guided complex-vertex resolution (SPlitteR core algorithm).

Capability mirror of SPAdes `src/projects/splitter/vertex_resolver.hpp`
(ResolveVertices :80-108, ResolveVertex :110-171, GetState :250-289),
`path_extractor.cpp:12-78` (chained path extraction from resolved pairs) and
`graph_resolver.cpp:75-101` (MergePaths).  For every complex vertex
(indegree >= 2 and outdegree >= 2), each incoming edge is matched to the
outgoing edge with the highest shared-barcode score between the incoming
edge's tail cloud and the outgoing edge's head cloud; trusted contig links
get a large additive bonus; a runner-up within `rel_threshold` marks the
vertex ambiguous.

Host code, the JAX package's `spades_tpu/aux_graphs/vertex_resolver.py`
unchanged: a loop over the canonical complex vertices that scores every
(in, out) pair with `FrameBarcodeIndex.link_score`, its float sums in the
same order (`total_score` and `supporting_score` are printed).
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

import numpy as np

from ..graph.graph import CondensedGraph
from .barcode_index import FrameBarcodeIndex

TRUSTED_LINK_BONUS = 1_000_000.0


class VertexState(Enum):
    COMPLETELY = "Completely"
    PARTIALLY = "Partially"
    AMBIGUOUS = "Ambiguous"
    UNCOVERED = "Uncovered"


@dataclass
class VertexResult:
    state: VertexState
    total_score: float
    supporting_score: float
    supported_pairs: dict[int, int]  # in edge id -> out edge id


def resolve_vertices(
    g: CondensedGraph,
    bindex: FrameBarcodeIndex,
    trusted_links: dict[int, set[int]] | None = None,
    count_threshold: int = 1,
    tail_threshold: int = 200_000,
    score_threshold: float = 2.0,
    rel_threshold: float = 2.0,
) -> dict[int, VertexResult]:
    """Resolve every canonical complex vertex.  Returns vertex -> result."""
    trusted_links = trusted_links or {}
    in_deg = g.in_degrees()
    out_deg = g.out_degrees()
    results: dict[int, VertexResult] = {}
    for v in range(g.num_vertices):
        if v > int(g.v_conj[v]):
            continue  # canonical vertices only (vertex_resolver.hpp:86)
        if in_deg[v] < 2 or out_deg[v] < 2:
            continue
        results[v] = _resolve_vertex(
            g, bindex, v, trusted_links, count_threshold, tail_threshold,
            score_threshold, rel_threshold, in_deg[v],
        )
    return results


def _resolve_vertex(
    g: CondensedGraph,
    bindex: FrameBarcodeIndex,
    v: int,
    trusted_links: dict[int, set[int]],
    count_threshold: int,
    tail_threshold: int,
    score_threshold: float,
    rel_threshold: float,
    vertex_in_degree: int,
) -> VertexResult:
    total_score = 0.0
    supporting_score = 0.0
    in_to_out: dict[int, int] = {}
    is_ambiguous = False
    is_covered = False

    for in_e in g.in_edges_of(v):
        in_e = int(in_e)
        max_score = 0.0
        contender_score = 0.0
        max_pair: tuple[int, int] | None = None
        for out_e in g.out_edges_of(v):
            out_e = int(out_e)
            if in_e == out_e or in_e == int(g.e_conj[out_e]):
                continue
            score = bindex.link_score(
                in_e, int(g.e_len[in_e]), out_e, int(g.e_len[out_e]),
                tail_threshold, count_threshold,
            )
            if out_e in trusted_links.get(in_e, ()):
                score += TRUSTED_LINK_BONUS
            total_score += score
            if score >= score_threshold:
                is_covered = True
                if score > max_score:
                    contender_score = max_score
                    max_score = score
                    max_pair = (in_e, out_e)
        if max_score < contender_score * rel_threshold:
            is_ambiguous = True
        elif max_score >= score_threshold and max_pair is not None:
            in_to_out[max_pair[0]] = max_pair[1]
            supporting_score += max_score

    state, in_to_out = _get_state(in_to_out, is_ambiguous, is_covered, vertex_in_degree)
    return VertexResult(state, total_score, supporting_score, in_to_out)


def _get_state(
    in_to_out: dict[int, int], is_ambiguous: bool, is_covered: bool, vertex_in_degree: int
) -> tuple[VertexState, dict[int, int]]:
    """State classification (vertex_resolver.hpp GetState :250-289)."""
    out_edges = set(in_to_out.values())
    if is_ambiguous or len(in_to_out) > len(out_edges):
        # keep only pairs whose out edge is claimed exactly once
        claims: dict[int, int] = {}
        for o in in_to_out.values():
            claims[o] = claims.get(o, 0) + 1
        kept = {i: o for i, o in in_to_out.items() if claims[o] == 1}
        if kept:
            return VertexState.PARTIALLY, kept
        return VertexState.AMBIGUOUS, {}
    if not is_covered:
        return VertexState.UNCOVERED, in_to_out
    if len(in_to_out) == vertex_in_degree:
        return VertexState.COMPLETELY, in_to_out
    return VertexState.PARTIALLY, in_to_out


def extract_paths(g: CondensedGraph, results: dict[int, VertexResult]) -> list[list[int]]:
    """Chain supported (in -> out) pairs into edge paths (path_extractor.cpp:12-78).

    Every canonical edge appears in exactly one output path (singletons for
    unresolved edges); conjugates are covered implicitly."""
    in_to_out: dict[int, int] = {}
    for res in results.values():
        if res.state in (VertexState.COMPLETELY, VertexState.PARTIALLY):
            for i, o in res.supported_pairs.items():
                in_to_out[i] = o
                in_to_out[int(g.e_conj[o])] = int(g.e_conj[i])
    has_in: set[int] = set(in_to_out.values())

    paths: list[list[int]] = []
    visited: set[int] = set()
    for start in sorted(in_to_out):
        if start in has_in or start in visited:
            continue
        path = [start]
        visited.add(start)
        visited.add(int(g.e_conj[start]))
        cur = start
        while cur in in_to_out:
            nxt = in_to_out[cur]
            if nxt in visited:
                break
            path.append(nxt)
            visited.add(nxt)
            visited.add(int(g.e_conj[nxt]))
            cur = nxt
        paths.append(path)
    for e in g.canonical_edge_ids():
        e = int(e)
        if e not in visited:
            paths.append([e])
            visited.add(e)
            visited.add(int(g.e_conj[e]))
    return paths


def merge_paths(
    g: CondensedGraph,
    paths: list[list[int]],
    link_overlaps: dict[tuple[int, int], int] | None = None,
) -> tuple[CondensedGraph, dict[int, int]]:
    """Merge each multi-edge path into a single edge (graph_resolver MergePaths).

    Returns the transformed graph and an original-edge -> new-edge map.
    The transformed graph keeps the original vertices; each merged path runs
    from the start vertex of its first edge to the end vertex of its last.
    Consecutive edges overlap by k, unless `link_overlaps[(prev, next)]`
    gives a different per-link overlap — the multiplexed-dBG variable-overlap
    case (`graph_resolver.cpp:89-91` uses graph.link_length per junction)."""
    out = CondensedGraph(
        k=g.k,
        e_start=np.zeros(0, np.int64), e_end=np.zeros(0, np.int64),
        e_conj=np.zeros(0, np.int64), e_off=np.zeros(0, np.int64),
        e_len=np.zeros(0, np.int64), e_cov=np.zeros(0, np.float64),
        alive=np.zeros(0, bool), seq_pool=np.zeros(0, np.uint8),
        v_conj=g.v_conj.copy(),
    )
    link_overlaps = link_overlaps or {}
    edge_map: dict[int, int] = {}
    for path in paths:
        codes = g.edge_codes(path[0]).copy()
        cov = float(g.e_cov[path[0]])
        for prev, e in zip(path, path[1:]):
            ov = link_overlaps.get((prev, e), g.k)
            ov = min(ov, len(g.edge_codes(e)))
            codes = np.concatenate([codes, g.edge_codes(e)[ov:]])
            cov += float(g.e_cov[e])
        new_e, new_conj = out.add_edge_pair(
            int(g.e_start[path[0]]), int(g.e_end[path[-1]]), codes, cov
        )
        for e in path:
            edge_map[e] = new_e
            edge_map[int(g.e_conj[e])] = new_conj
    return out, edge_map
