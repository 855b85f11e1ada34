"""Scaffold graph: oriented assembly-graph edges as vertices, weighted links.

Capability mirror of SPAdes' scaffold graph
(`src/common/auxiliary_graphs/scaffold_graph/scaffold_graph.hpp:25-193`):
vertices are oriented edge ids of the underlying assembly graph, scaffold
edges carry (lib id, weight, length/gap).  Array design: edges are
parallel numpy columns instead of an adjacency-map of heap objects, so
filtering by weight, top-k selection, and degree counting are vectorized.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ScaffoldGraph:
    """Flat-array scaffold graph over oriented assembly edges."""

    # scaffold vertices = oriented assembly-edge ids present in the graph
    vertices: set[int] = field(default_factory=set)
    src: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    dst: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    weight: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    length: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    lib: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))

    def add_vertex(self, v: int) -> None:
        self.vertices.add(int(v))

    def add_edges(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        weight: np.ndarray | None = None,
        length: np.ndarray | None = None,
        lib: int = 0,
    ) -> None:
        """Bulk append of scaffold links (vectorized AddEdge)."""
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        n = len(src)
        self.vertices.update(src.tolist())
        self.vertices.update(dst.tolist())
        self.src = np.concatenate([self.src, src])
        self.dst = np.concatenate([self.dst, dst])
        self.weight = np.concatenate(
            [self.weight, np.ones(n) if weight is None else np.asarray(weight, np.float64)]
        )
        self.length = np.concatenate(
            [self.length, np.zeros(n, np.int64) if length is None else np.asarray(length, np.int64)]
        )
        self.lib = np.concatenate([self.lib, np.full(n, lib, np.int64)])

    def add_edge(self, src: int, dst: int, weight: float = 1.0, length: int = 0, lib: int = 0) -> None:
        self.add_edges(np.array([src]), np.array([dst]), np.array([weight]), np.array([length]), lib)

    @property
    def num_edges(self) -> int:
        return int(len(self.src))

    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    def filter_by_weight(self, min_weight: float) -> "ScaffoldGraph":
        """New graph keeping links with weight >= min_weight (score filter of
        ScoreFunctionGraphConstructor, `scaffolder2015/scaffold_graph_constructor.hpp`)."""
        keep = self.weight >= min_weight
        out = ScaffoldGraph(vertices=set(self.vertices))
        out.src, out.dst = self.src[keep], self.dst[keep]
        out.weight, out.length, out.lib = self.weight[keep], self.length[keep], self.lib[keep]
        return out

    def dedup(self) -> None:
        """Keep the max-weight link per (src, dst) pair."""
        if self.num_edges == 0:
            return
        order = np.lexsort((-self.weight, self.dst, self.src))
        s, d = self.src[order], self.dst[order]
        first = np.concatenate([[True], (s[1:] != s[:-1]) | (d[1:] != d[:-1])])
        keep = order[first]
        self.src, self.dst = self.src[keep], self.dst[keep]
        self.weight, self.length, self.lib = self.weight[keep], self.length[keep], self.lib[keep]

    def out_edges_of(self, v: int) -> np.ndarray:
        return np.flatnonzero(self.src == v)

    def in_edges_of(self, v: int) -> np.ndarray:
        return np.flatnonzero(self.dst == v)

    def out_degrees(self) -> dict[int, int]:
        u, c = np.unique(self.src, return_counts=True)
        return dict(zip(u.tolist(), c.tolist()))

    def in_degrees(self) -> dict[int, int]:
        u, c = np.unique(self.dst, return_counts=True)
        return dict(zip(u.tolist(), c.tolist()))
