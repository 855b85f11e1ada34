"""Pair-info improver: contradiction removal + split-path fill-in.

Capability mirror of SPAdes' PairInfoImprover
(`src/common/paired_info/pair_info_improver.hpp:53-231`) and
SplitPathConstructor (`paired_info/split_path_constructor.hpp:66-143`),
run on the clustered index before repeat resolution
(`distance_estimation_utils.cpp:141-143`):

* RemoveContradictional (:137-172): for every long (>= max_repeat_length)
  base edge, every pair of its clustered entries (e1, p1), (e2, p2) is
  checked for path consistency (`IsConsistent` :85-115): if p2 should lie
  `p2.d - p1.d` downstream of p1 then either e1 directly precedes e2 or a
  path of the right length must exist; otherwise the lighter-ranked point is
  deleted (together with its conjugate mirror — the index is symmetric).
* FillMissing (:174-211): split paths — for each base edge, walk pair infos
  by decreasing distance; the forced (unambiguous) path suffix toward each
  partner (`GetCommonPathsEnd`, `assembly_graph/paths/path_utils.hpp:27-75`)
  yields inferred pair infos for the intermediate edges, added when they do
  not intersect existing clusters (`AddNonIntersectingInfo` :41-50).

Two rounds, as in ImprovePairedInfo (:68-73).

The repo's clustered PairedIndex carries no per-point variance column; the
cluster variance is passed as a scalar (default: the DE linkage distance),
matching how every cluster of the simple estimator is built.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..graph.graph import CondensedGraph
from .paired_info import PairedIndex


@dataclass
class ImproveStats:
    removed: int = 0
    added: int = 0


def _pair_info_path_upper_bound(k: int, insert_size: float, is_var: float) -> int:
    """PairInfoPathLengthUpperBound (pair_info_bounds.hpp:17-22)."""
    return max(0, int(np.ceil(insert_size + 2.0 * is_var - k - 2)))


class _Improver:
    def __init__(self, g: CondensedGraph, rows: dict, insert_size: float,
                 is_var: float, max_repeat_length: int, var: float):
        self.g = g
        self.rows = rows        # (e1) -> {(e2): [(d, w), ...]}
        self.is_ = insert_size
        self.is_var = is_var
        self.max_repeat_length = max_repeat_length
        self.var = var
        self.lens = g.edge_kmer_lengths()
        self.stats = ImproveStats()
        self._adjacency = {}

    def _csr(self, direction: str):
        """One adjacency per direction (`dijkstra._csr`): the graph does not
        change while the improver runs, and building one sorts every edge."""
        from ..graph.dijkstra import _csr

        if direction not in self._adjacency:
            self._adjacency[direction] = _csr(self.g, direction, None)
        return self._adjacency[direction]

    def _edges_at(self, v: int, direction: str) -> np.ndarray:
        """The alive out-edges ('fwd') or in-edges ('bwd') of v in ascending
        id order, as `g.out_edges_of` / `g.in_edges_of` give them without
        their scan of every edge slot."""
        off, eo = self._csr(direction)
        return eo[off[v] : off[v + 1]]

    # -- structural helpers -------------------------------------------------
    def _mirror(self, e1: int, e2: int, d: float) -> tuple[int, int, float]:
        g = self.g
        return (
            int(g.e_conj[e2]),
            int(g.e_conj[e1]),
            d + float(self.lens[e1]) - float(self.lens[e2]),
        )

    def _remove_point(self, e1: int, e2: int, d: float) -> int:
        cnt = 0
        for a, b, dd in ((e1, e2, d), self._mirror(e1, e2, d)):
            hist = self.rows.get(a, {}).get(b)
            if not hist:
                continue
            for i, (pd, _w) in enumerate(hist):
                if abs(pd - dd) < 1e-6:
                    hist.pop(i)
                    cnt += 1
                    break
        return cnt

    def _add_point(self, e1: int, e2: int, d: float, w: float) -> int:
        cnt = 0
        for a, b, dd in ((e1, e2, d), self._mirror(e1, e2, d)):
            hist = self.rows.setdefault(a, {}).setdefault(b, [])
            # AddNonIntersectingInfo: skip when an existing cluster intersects
            if any(
                pd <= dd + 2 * self.var and dd <= pd + 2 * self.var
                for pd, _ in hist
            ):
                continue
            hist.append((dd, w))
            hist.sort()
            cnt += 1
        return cnt

    # -- consistency (IsConsistent :85-115) ---------------------------------
    def _paths_exist(self, e1: int, e2: int, lo: float, hi: float) -> bool:
        """Any path end(e1) -> start(e2) with k-mer length in [lo, hi]
        (GetAllPathsBetweenEdges role) — bounded DFS over (vertex, dist)."""
        g = self.g
        lo = max(0.0, lo)
        if hi < 0:
            return False
        v_from = int(g.e_end[e1])
        v_to = int(g.e_start[e2])
        if v_from == v_to and lo <= 0:
            return True
        seen = set()
        stack = [(v_from, 0)]
        budget = 20000
        while stack and budget:
            budget -= 1
            v, dist = stack.pop()
            for e in self._edges_at(v, "fwd"):
                nd = dist + int(self.lens[e])
                if nd > hi:
                    continue
                t = int(g.e_end[e])
                if t == v_to and lo <= nd <= hi:
                    return True
                if (t, nd) not in seen:
                    seen.add((t, nd))
                    stack.append((t, nd))
        return False

    def _is_consistent(self, e1: int, e2: int, p1, p2) -> bool:
        d1, _ = p1
        d2, _ = p2
        if d1 <= 0 or d2 <= 0 or d1 > d2:
            return True
        pi_dist = d2 - d1
        fl = int(self.lens[e1])
        var = 2 * self.var
        g = self.g
        if pi_dist <= fl + var and fl <= pi_dist + var:
            if int(g.e_end[e1]) == int(g.e_start[e2]):
                return True
            return self._paths_exist(e1, e2, 0, np.ceil(pi_dist - fl + var))
        if d2 > d1 + fl:
            return self._paths_exist(
                e1, e2,
                np.floor(pi_dist - fl - var), np.ceil(pi_dist - fl + var),
            )
        return False

    def remove_contradictional(self) -> int:
        to_remove: list[tuple[int, int, float]] = []
        for base, nbrs in self.rows.items():
            if self.lens[base] < self.max_repeat_length:
                continue
            items = [
                (e, p) for e, hist in nbrs.items() for p in hist
            ]
            for i, (e1, p1) in enumerate(items):
                for e2, p2 in items:
                    if e1 == e2:
                        continue
                    if self._is_consistent(e1, e2, p1, p2):
                        continue
                    # remove the lexicographically smaller point (p1.lt(p2))
                    bad = (e1, p1) if (p1, e1) < (p2, e2) else (e2, p2)
                    to_remove.append((base, bad[0], bad[1][0]))
        cnt = 0
        for e1, e2, d in to_remove:
            cnt += self._remove_point(e1, e2, d)
        self.stats.removed += cnt
        return cnt

    # -- split paths (SplitPathConstructor :76-138) -------------------------
    def _common_path_end(self, base: int, target: int, lo: float, hi: float,
                         dists: dict) -> list[int]:
        """Forced suffix of all bounded paths end(base) -> start(target)
        (GetCommonPathsEnd: backward walk, stop at first ambiguity)."""
        g = self.g
        fl = int(self.lens[base])
        if lo < fl or hi < fl:
            return []
        dist = hi - fl
        cur = int(g.e_start[target])
        if cur not in dists or dists[cur] > dist:
            return []
        res: list[int] = []
        suffix_len = 0
        cur_dist = dists[cur]
        while cur_dist > 0:
            prev_edge = None
            for e in self._edges_at(cur, "bwd"):
                e = int(e)
                s = int(g.e_start[e])
                if s in dists and suffix_len + int(self.lens[e]) + dists[s] <= dist:
                    if prev_edge is not None:
                        return res[::-1]
                    prev_edge = e
            if prev_edge is None:
                return res[::-1]
            suffix_len += int(self.lens[prev_edge])
            res.append(prev_edge)
            cur = int(g.e_start[prev_edge])
            cur_dist = dists.get(cur, 0)
        return res[::-1]

    def fill_missing(self) -> int:
        from ..graph.dijkstra import bounded_dijkstra

        g = self.g
        upper = _pair_info_path_upper_bound(g.k, self.is_, self.is_var)
        added = 0
        new_points: list[tuple[int, int, float, float]] = []
        # one adjacency for every search (a new one per search sorted every
        # edge slot: most of the pass's time on a large raw graph)
        csr = self._csr("fwd")
        for base, nbrs in list(self.rows.items()):
            infos = sorted(
                ((d, e2, w) for e2, hist in nbrs.items() for d, w in hist),
            )
            if not infos:
                continue
            res = bounded_dijkstra(
                g, [int(g.e_end[base])], upper, max_vertices=3000, csr=csr
            )
            dists = {
                int(v): int(dd) for v, dd in zip(res.vertices, res.dists)
            }
            used = set()
            # decreasing distance (SPAdes sorts descending)
            for d, e2, w in reversed(infos):
                if d <= 0 or (e2, d) in used:
                    continue
                common = self._common_path_end(
                    base, e2, d - self.var, d + self.var, dists
                )
                if not common:
                    continue
                total = sum(int(self.lens[c]) for c in common)
                for c in common:
                    pd = d - total
                    new_points.append((base, int(c), pd, w))
                    total -= int(self.lens[c])
                    used.add((int(c), pd))
        for e1, e2, d, w in new_points:
            added += self._add_point(e1, e2, d, w)
        self.stats.added += added
        return added


def improve_paired_info(
    g: CondensedGraph,
    pi: PairedIndex,
    insert_size: float,
    is_var: float,
    max_repeat_length: int = 7500,
    var: float | None = None,
) -> tuple[PairedIndex, ImproveStats]:
    """Two rounds of contradiction removal + split-path fill-in over the
    clustered index (ImprovePairedInfo :68-73).  Returns a new index."""
    if pi.e1.size == 0:
        return pi, ImproveStats()
    if var is None:
        var = 10.0  # DEConfig.linkage_distance default
    rows: dict[int, dict[int, list]] = {}
    for e1, e2, d, w in zip(pi.e1, pi.e2, pi.dist, pi.weight):
        rows.setdefault(int(e1), {}).setdefault(int(e2), []).append(
            (float(d), float(w))
        )
    imp = _Improver(g, rows, insert_size, is_var, max_repeat_length, var)
    for _ in range(2):
        imp.remove_contradictional()
        imp.fill_missing()
    E1, E2, D, W = [], [], [], []
    for e1, nbrs in rows.items():
        for e2, hist in nbrs.items():
            for d, w in hist:
                E1.append(e1)
                E2.append(e2)
                D.append(d)
                W.append(w)
    if not E1:
        z = np.zeros(0)
        out = PairedIndex(z.astype(np.int64), z.astype(np.int64), z, z)
        return out, imp.stats
    e1 = np.array(E1, np.int64)
    e2 = np.array(E2, np.int64)
    d = np.array(D, float)
    w = np.array(W, float)
    order = np.lexsort((d, e2, e1))
    out = PairedIndex(e1[order], e2[order], d[order], w[order])
    return out, imp.stats
