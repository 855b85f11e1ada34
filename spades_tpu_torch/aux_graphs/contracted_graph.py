"""Contracted graph: assembly graph collapsed onto a set of long edges.

Capability mirror of SPAdes `src/common/auxiliary_graphs/contracted_graph/`
(`contracted_graph_builder.hpp:34-83` DBGContractedGraphFactory): vertices of
the assembly graph are union-found along every edge that fails the "long"
predicate, and each long edge becomes a contracted edge between the DSU roots
of its endpoints.  Used by scaffolders and the SPlitteR resolver to reason
about the macro-structure between unique edges.

Array design (as in the JAX package): the DSU runs as vectorized pointer-doubling
(min-label propagation) over the edge endpoint arrays instead of a pointer
DSU — identical fixpoint, log-depth, no per-edge host loop.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..graph.graph import CondensedGraph


def _components(n_vertices: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Connected-component labels via iterated min-neighbor propagation."""
    label = np.arange(n_vertices, dtype=np.int64)
    while True:
        # pull the smaller label across every contracted (non-long) edge
        new = label.copy()
        np.minimum.at(new, src, label[dst])
        np.minimum.at(new, dst, label[src])
        # pointer-jump to the root of the current labels
        new = new[new]
        if np.array_equal(new, label):
            return label
        label = new


@dataclass
class ContractedGraph:
    """Contracted multigraph: roots as vertices, long edges as arcs."""

    root: np.ndarray       # (V,) int64 contracted vertex (component label) per graph vertex
    long_edges: np.ndarray  # (L,) int64 assembly edge ids (both strands)
    c_start: np.ndarray    # (L,) int64 contracted start vertex per long edge
    c_end: np.ndarray      # (L,) int64 contracted end vertex per long edge
    capacity: dict[int, int]  # contracted vertex -> total short-edge length inside it

    @property
    def num_vertices(self) -> int:
        return len(np.unique(self.root))

    def out_edges_of(self, cv: int) -> np.ndarray:
        return self.long_edges[self.c_start == cv]

    def in_edges_of(self, cv: int) -> np.ndarray:
        return self.long_edges[self.c_end == cv]

    def vertex_of(self, v: int) -> int:
        return int(self.root[v])


def build_contracted_graph(g: CondensedGraph, long_edge_mask: np.ndarray) -> ContractedGraph:
    """Contract every edge where `long_edge_mask` is False.

    `long_edge_mask` is a boolean per-edge predicate (the reference passes
    e.g. length >= threshold, `contracted_graph_builder.hpp:69` edge_predicate).
    Conjugate symmetry of the predicate is enforced by OR-ing with the
    conjugate's value, mirroring the reference's conjugate handling."""
    long_edge_mask = np.asarray(long_edge_mask, bool)
    sym = long_edge_mask | long_edge_mask[g.e_conj]
    alive = g.alive
    short = alive & ~sym
    label = _components(g.num_vertices, g.e_start[short], g.e_end[short])
    long_ids = np.flatnonzero(alive & sym)
    cap: dict[int, int] = {}
    for e in np.flatnonzero(short):
        r = int(label[g.e_start[e]])
        cap[r] = cap.get(r, 0) + int(g.e_len[e] - g.k)
    return ContractedGraph(
        root=label,
        long_edges=long_ids,
        c_start=label[g.e_start[long_ids]],
        c_end=label[g.e_end[long_ids]],
        capacity=cap,
    )
