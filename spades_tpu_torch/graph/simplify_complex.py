"""Advanced simplification: superbubbles, complex tips, max-flow EC removal.

Capability mirror of SPAdes' subgraph-based simplifiers:
- SuperbubbleFinder (`src/common/modules/simplification/
  superbubble_finder.hpp:22-130`): grow a dominated vertex set from an
  entrance, processing a vertex only when every in-edge starts inside; track
  the heaviest (total-coverage) path; stop at the common exit.
- Complex bulge removal (`complex_bulge_remover.hpp`): collapse everything
  inside a superbubble onto the heaviest entrance->exit path (coverage glue).
- ComplexTipClipper (`complex_tip_clipper.hpp:125-160` + ComplexTipFinder):
  remove dead-end components of short edges whose coverage is low relative
  to the surrounding graph.
- MaxFlowECRemover (`mf_ec_remover.hpp:358-470`): remove a short unreliable
  edge when plausible alternative paths (length >= plausibility bound) still
  carry all flow between the adjacent unique (long) edges.

These are control-heavy local subgraph rewrites over the already tiny
simplified graph: host orchestration over the flat arrays (masked rewrites
plus periodic compaction).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .graph import CondensedGraph


@dataclass
class Superbubble:
    start: int
    end: int
    inner_vertices: set[int]
    heaviest_path: list[int]  # edge ids from start to end


def find_superbubble(
    g: CondensedGraph, start: int, max_length: int = 1000, max_count: int = 64
) -> Superbubble | None:
    """SuperbubbleFinder::FindSuperbubble from one entrance vertex.

    Standard dominated-set growth (superbubble_finder.hpp:38-130): a vertex
    is processed only when every in-edge starts at an already-processed
    vertex; the bubble closes when exactly one candidate remains."""
    if len(g.out_edges_of(start)) < 2:
        return None
    lens = g.edge_kmer_lengths()
    cov_sum = g.e_cov
    # vertex -> (best path weight, best path length, backtrace edge)
    info: dict[int, tuple[float, int, int]] = {start: (0.0, 0, -1)}
    seen: set[int] = set()       # discovered, not yet processed
    visited: set[int] = set()
    stack = [start]
    cnt = 0
    while stack:
        v = stack.pop()
        visited.add(v)
        seen.discard(v)
        cnt += 1
        if cnt > max_count:
            return None
        outs = g.out_edges_of(v)
        if len(outs) == 0:
            return None  # dead end (tip) inside the bubble
        w0, l0, _ = info[v]
        for e in outs:
            e = int(e)
            u = int(g.e_end[e])
            if u == start or u == int(g.v_conj[start]) or u == v:
                return None  # cycle back to the entrance / self-loop
            nl = l0 + int(lens[e])
            if nl > max_length:
                return None
            nw = w0 + float(cov_sum[e])
            if u not in info or nw > info[u][0]:
                best_l = nl if u not in info else max(nl, info[u][1])
                info[u] = (nw, best_l, e)
            seen.add(u)
            if u not in visited and all(
                int(g.e_start[x]) in visited for x in g.in_edges_of(u)
            ):
                stack.append(u)
        if len(stack) == 1 and len(seen) == 1 and stack[0] in seen:
            t = stack.pop()
            # exit must not connect straight back to the entrance
            path = []
            vv = t
            while vv != start:
                e = info[vv][2]
                path.append(e)
                vv = int(g.e_start[e])
            path.reverse()
            inner = (visited | {t}) - {start, t}
            return Superbubble(start, t, inner, path)
    return None


def collapse_superbubbles(
    g: CondensedGraph, max_length: int = 1000, max_count: int = 64
) -> int:
    """Complex bulge removal: keep each superbubble's heaviest path, glue the
    rest (complex_bulge_remover.hpp behavior on the flat graph).  Returns the
    number of edges removed."""
    removed = 0
    out_deg = g.out_degrees()
    for start in np.flatnonzero(out_deg >= 2):
        start = int(start)
        sb = find_superbubble(g, start, max_length, max_count)
        if sb is None:
            continue
        keep = set(sb.heaviest_path) | {int(g.e_conj[e]) for e in sb.heaviest_path}
        kill = []
        total_glued = 0.0
        for e in g.alive_edge_ids():
            e = int(e)
            if e in keep:
                continue
            s, t = int(g.e_start[e]), int(g.e_end[e])
            if (s in sb.inner_vertices or s == sb.start) and (
                t in sb.inner_vertices or t == sb.end
            ):
                kill.append(e)
                total_glued += float(g.e_cov[e])
        if not kill:
            continue
        # project removed coverage onto the surviving path
        for e in sb.heaviest_path:
            share = total_glued / (2 * len(sb.heaviest_path))
            g.e_cov[e] += share
            g.e_cov[g.e_conj[e]] += share
        removed += g.kill_edges(np.array(kill))
        out_deg = g.out_degrees()
    return removed


def clip_complex_tips(
    g: CondensedGraph,
    relative_coverage: float = 2.0,
    max_edge_len: int = 100,
    max_path_len: int = 200,
    max_component_edges: int = 16,
) -> int:
    """ComplexTipClipper: remove a dead-end component of short edges when its
    coverage is below relative_coverage x the coverage entering it."""
    lens = g.edge_kmer_lengths()
    cov = g.coverage()
    removed = 0
    out_deg = g.out_degrees()
    in_deg = g.in_degrees()
    for e0 in list(g.alive_edge_ids()):
        e0 = int(e0)
        if not g.alive[e0] or lens[e0] > max_edge_len:
            continue
        v0 = int(g.e_start[e0])
        if in_deg[v0] == 0:
            continue  # plain tip territory, handled by the simple clipper
        # flood forward over short edges; fail if we escape via a long edge
        comp_edges: set[int] = set()
        stack = [e0]
        ok = True
        depth: dict[int, int] = {v0: 0}
        while stack and ok:
            e = stack.pop()
            if e in comp_edges:
                continue
            comp_edges.add(e)
            if len(comp_edges) > max_component_edges:
                ok = False
                break
            if lens[e] > max_edge_len:
                ok = False
                break
            t = int(g.e_end[e])
            d = depth.get(int(g.e_start[e]), 0) + int(lens[e])
            if d > max_path_len:
                ok = False
                break
            depth[t] = max(depth.get(t, 0), d)
            for nxt in g.out_edges_of(t):
                stack.append(int(nxt))
        if not ok or not comp_edges:
            continue
        # component must be a dead end: no edges leave it except via removal
        # and its coverage must be low vs the through coverage at v0
        comp_cov = max(cov[e] for e in comp_edges)
        through = [
            c
            for c in (
                [cov[int(x)] for x in g.in_edges_of(v0)]
                + [cov[int(x)] for x in g.out_edges_of(v0) if int(x) not in comp_edges]
            )
        ]
        if not through or comp_cov * relative_coverage > max(through):
            continue
        removed += g.kill_edges(np.array(sorted(comp_edges)))
        out_deg = g.out_degrees()
        in_deg = g.in_degrees()
        cov = g.coverage()
    return removed


class _FlowNetwork:
    """Residual flow network over component vertices + source/sink
    (mf_ec_remover.hpp FlowGraph :21-131): integer capacities, residual
    arcs created by pushes."""

    SOURCE = -1
    SINK = -2

    def __init__(self):
        self.cap: dict[int, dict[int, int]] = {self.SOURCE: {}, self.SINK: {}}

    def add_vertex(self, v: int) -> None:
        self.cap.setdefault(v, {})

    def add_edge(self, u: int, v: int, capacity: int = 10000) -> None:
        self.cap[u][v] = self.cap[u].get(v, 0) + capacity
        self.cap[v].setdefault(u, 0)

    def bfs_path(self) -> list[int] | None:
        """Shortest augmenting path source->sink over positive-residual arcs
        (the BFS of MaxFlowFinder::Find, :253-265)."""
        prev = {self.SOURCE: self.SOURCE}
        q = [self.SOURCE]
        while q:
            nq = []
            for u in q:
                for v, c in self.cap[u].items():
                    if c > 0 and v not in prev:
                        prev[v] = u
                        if v == self.SINK:
                            path = [v]
                            while path[-1] != self.SOURCE:
                                path.append(prev[path[-1]])
                            return path[::-1]
                        nq.append(v)
            q = nq
        return None

    def max_flow(self) -> None:
        while True:
            path = self.bfs_path()
            if path is None:
                return
            c = min(self.cap[u][v] for u, v in zip(path, path[1:]))
            for u, v in zip(path, path[1:]):
                self.cap[u][v] -= c
                self.cap[v][u] = self.cap[v].get(u, 0) + c

    def complete_flow(self) -> bool:
        """All source/sink capacity saturated (CheckCompleteFlow :405-408)."""
        return all(c == 0 for c in self.cap[self.SOURCE].values()) and all(
            self.cap[u].get(self.SINK, 0) == 0 for u in self.cap
        )

    def residual_scc(self) -> dict[int, int]:
        """SCC colouring of the residual graph (positive-capacity arcs) —
        Kosaraju order as in TopSorter + ReverseDFSComponentFinder
        (:267-336)."""
        order: list[int] = []
        visited: set[int] = set()
        for root in self.cap:
            if root in visited:
                continue
            stack = [(root, iter(self.cap[root].items()))]
            visited.add(root)
            while stack:
                v, it = stack[-1]
                advanced = False
                for w, c in it:
                    if c > 0 and w not in visited:
                        visited.add(w)
                        stack.append((w, iter(self.cap[w].items())))
                        advanced = True
                        break
                if not advanced:
                    order.append(v)
                    stack.pop()
        # reverse adjacency over positive residual arcs
        radj: dict[int, list[int]] = {v: [] for v in self.cap}
        for u, nbrs in self.cap.items():
            for v, c in nbrs.items():
                if c > 0:
                    radj[v].append(u)
        colour: dict[int, int] = {}
        cc = 0
        for v in reversed(order):
            if v in colour:
                continue
            stack = [v]
            colour[v] = cc
            while stack:
                u = stack.pop()
                for w in radj[u]:
                    if w not in colour:
                        colour[w] = cc
                        stack.append(w)
            cc += 1
        return colour


def max_flow_ec_remover(
    g: CondensedGraph,
    max_length: int = 200,
    uniqueness_length: int = 1500,
    plausibility_length: int = 200,
) -> int:
    """MaxFlowECRemover (mf_ec_remover.hpp:358-501): split the graph at
    unique (>= uniqueness_length) edges, build a unit-capacity flow network
    per component — plausible/unique incoming boundary edges feed the
    source, outgoing ones the sink, inner short edges carry capacity 10000 —
    compute max flow, and when the flow saturates completely, remove the
    suspicious (short, non-tip) edges whose endpoints fall into different
    SCCs of the residual network: exactly the edges that carry no flow in
    ANY maximum flow."""
    assert uniqueness_length >= plausibility_length > max_length
    lens = g.edge_kmer_lengths()
    ids = g.alive_edge_ids()
    if ids.size == 0:
        return 0
    outd = g.out_degrees()
    ind = g.in_degrees()

    def is_tip(e: int) -> bool:
        s, t = int(g.e_start[e]), int(g.e_end[e])
        return (outd[s] + ind[s]) == 1 or (outd[t] + ind[t]) == 1

    # components separated by unique edges (LongEdgesExclusiveSplitter)
    short = ids[lens[ids] < uniqueness_length]
    parent = np.arange(g.num_vertices)

    def find(v):
        while parent[v] != v:
            parent[v] = parent[parent[v]]
            v = parent[v]
        return v

    for e in short:
        a, b = find(int(g.e_start[e])), find(int(g.e_end[e]))
        if a != b:
            parent[a] = b
    comp_of: dict[int, list[int]] = {}
    used_vertices = np.unique(
        np.concatenate([g.e_start[ids], g.e_end[ids]])
    )
    for v in used_vertices:
        comp_of.setdefault(find(int(v)), []).append(int(v))

    removed = 0
    for comp in comp_of.values():
        cset = set(comp)
        fg = _FlowNetwork()
        for v in comp:
            fg.add_vertex(v)
        has_inner = False
        for v in comp:
            for e in g.out_edges_of(v):
                e = int(e)
                t = int(g.e_end[e])
                # inner short edge (ProcessShortEdge :424-428)
                if lens[e] < uniqueness_length and t in cset:
                    fg.add_edge(v, t, 10000)
                    has_inner = True
                # sink feed (ProcessSink :436-440)
                if (lens[e] >= plausibility_length and not is_tip(e)) or lens[
                    e
                ] >= uniqueness_length:
                    fg.add_edge(v, _FlowNetwork.SINK, 1)
            for e in g.in_edges_of(v):
                e = int(e)
                # source feed (ProcessSource :430-434)
                if (lens[e] >= plausibility_length and not is_tip(e)) or lens[
                    e
                ] >= uniqueness_length:
                    fg.add_edge(_FlowNetwork.SOURCE, v, 1)
        if not has_inner or not fg.cap[_FlowNetwork.SOURCE]:
            continue
        fg.max_flow()
        if not fg.complete_flow():
            continue  # suspicious component, no deletion (:484-487)
        colour = fg.residual_scc()
        kill = []
        for v in comp:
            for e in g.out_edges_of(v):
                e = int(e)
                t = int(g.e_end[e])
                if (
                    t in cset
                    and lens[e] <= max_length
                    and not is_tip(e)
                    and colour.get(v) != colour.get(t)
                ):
                    kill.append(e)
        if kill:
            removed += g.kill_edges(np.array(kill))
    return removed


# ---------------------------------------------------------------------------
# Dominated-component complex bulge removal (the full machinery)


def _dominated_component(
    g: CondensedGraph, start: int, max_length: int, length_diff: int,
    max_count: int = 128,
) -> tuple[set[int], dict[int, int]] | None:
    """Grow a dominated multi-exit component from `start`.

    LocalizedComponentFinder analog (`complex_bulge_remover.hpp`): a vertex
    joins when every in-edge starts inside; its min/max path length from
    start must agree within length_diff (SPAdes' length-consistency
    requirement) and stay under max_length.  Unlike the superbubble finder
    the component may have MANY exits.  Returns (vertices, min-dist map) or
    None when nothing beyond the trivial set was dominated."""
    lens = g.edge_kmer_lengths()
    inside = {start}
    dmin: dict[int, int] = {start: 0}
    dmax: dict[int, int] = {start: 0}
    frontier = [start]
    while frontier:
        grew = False
        # candidates: heads of edges out of the component
        cand: dict[int, list[int]] = {}
        for v in inside:
            for e in g.out_edges_of(v):
                u = int(g.e_end[int(e)])
                if u not in inside:
                    cand.setdefault(u, []).append(int(e))
        for u, _es in cand.items():
            ins = [int(e) for e in g.in_edges_of(u)]
            if not ins or any(int(g.e_start[e]) not in inside for e in ins):
                continue          # not dominated (an outside path reaches u)
            if u == start or int(g.v_conj[u]) in inside:
                return None       # cycle back / conjugate self-overlap
            lo = min(dmin[int(g.e_start[e])] + int(lens[e]) for e in ins)
            hi = max(dmax[int(g.e_start[e])] + int(lens[e]) for e in ins)
            if hi > max_length or hi - lo > length_diff:
                continue          # length-inconsistent: leave u outside
            inside.add(u)
            dmin[u], dmax[u] = lo, hi
            grew = True
            if len(inside) > max_count:
                return None
        if not grew:
            break
    if len(inside) < 3:
        return None
    return inside, dmin


def _find_skeleton_and_project(
    g: CondensedGraph, inside: set[int], start: int, length_diff: int,
) -> list[tuple[int, int]] | None:
    """SkeletonTree + ComponentProjector analog (complex_bulge_remover.hpp
    732-812): vertices get heights (distance from the entrance); component
    end vertices get color bits and every vertex is colored by the set of
    ends it reaches; inner edges spanning intermediate levels are SPLIT at
    each level (SPAdes' SplitComponent, via graph.split_edge); the
    skeleton tree is the union of heaviest entrance->end paths; every
    non-tree inner edge must project onto a color-superset tree edge at the
    same heights (within length_diff).  MUTATES g (edge splits).  Returns
    [(edge, tree_edge)] projections, or None if any edge fails (splits are
    benign: they only refine the graph without changing spelled paths)."""
    lens = g.edge_kmer_lengths()

    def inner_edges():
        out = []
        for u in inside:
            for e in g.out_edges_of(u):
                if int(g.e_end[int(e)]) in inside:
                    out.append(int(e))
        return out

    # heights by forward topological order
    height = {start: 0}
    pending = set(inside) - {start}
    while pending:
        progressed = False
        for u in list(pending):
            ins = [int(e) for e in g.in_edges_of(u)]
            if all(int(g.e_start[e]) in height for e in ins):
                height[u] = max(
                    height[int(g.e_start[e])] + int(lens[e]) for e in ins
                )
                pending.discard(u)
                progressed = True
        if not progressed:
            return None               # not a DAG inside (shouldn't happen)
    # ends: no out-edge staying inside
    ends = [
        u for u in inside
        if not any(int(g.e_end[int(e)]) in inside for e in g.out_edges_of(u))
    ]
    if not ends or len(ends) > 16:
        return None
    end_bit = {u: 1 << i for i, u in enumerate(ends)}
    color = {u: end_bit.get(u, 0) for u in inside}
    for u in sorted(inside, key=lambda v: -height[v]):
        for e in g.out_edges_of(u):
            w = int(g.e_end[int(e)])
            if w in inside:
                color[u] |= color[w]

    # --- SplitComponent: split inner edges at intermediate level heights ---
    levels = sorted(set(height.values()))
    for e in inner_edges():
        hu, hw = height[int(g.e_start[e])], height[int(g.e_end[e])]
        spans = [L for L in levels if hu < L < hw]
        if not spans:
            continue
        if e == int(g.e_conj[e]):
            return None
        cur, off = e, hu
        wcol = color[int(g.e_end[e])]
        for L in spans:
            pos = L - off
            kl = int(g.e_len[cur]) - g.k
            if pos <= 0 or pos >= kl:
                return None           # level falls outside the edge: reject
            a, b = g.split_edge(cur, pos)
            v = int(g.e_end[a])
            inside.add(v)
            height[v] = L
            color[v] = wcol
            cur, off = b, L
    lens = g.edge_kmer_lengths()      # splits appended edges

    # --- skeleton tree: heaviest path from the entrance to every end ------
    tree: set[int] = set()
    for u in ends:
        v = u
        while v != start:
            ins = [
                int(e) for e in g.in_edges_of(v) if int(g.e_start[e]) in inside
            ]
            if not ins:
                return None
            e = max(ins, key=lambda x: (float(g.e_cov[x]), -x))
            tree.add(e)
            v = int(g.e_start[e])

    # --- project non-tree inner edges onto level/color-compatible tree ----
    tlist = sorted(tree)
    projections: list[tuple[int, int]] = []
    for e in inner_edges():
        if e in tree:
            continue
        u, w = int(g.e_start[e]), int(g.e_end[e])
        ecol = color[w]
        tgt = -1
        for t in tlist:
            ts, tw = int(g.e_start[t]), int(g.e_end[t])
            if (
                abs(height[ts] - height[u]) <= length_diff
                and abs(height[tw] - height[w]) <= length_diff
                and (color[tw] & ecol) == ecol
            ):
                tgt = t
                break
        if tgt < 0:
            return None
        projections.append((e, tgt))
    return projections or None


def remove_complex_bulges(
    g: CondensedGraph,
    max_length: int = 1000,
    length_diff: int = 5,
    max_count: int = 128,
    kmer_mapper=None,
) -> int:
    """Full complex bulge removal: dominated component -> skeleton tree ->
    project non-tree edges onto their tree paths.

    ComplexBulgeRemover analog (`complex_bulge_remover.hpp:1081-1214`,
    LocalizedComponentFinder + SkeletonTree + ComponentProjector): grow a
    dominated multi-exit component, split level-spanning edges, build the
    heaviest entrance->ends skeleton tree, and project every non-tree inner
    edge onto a same-level color-superset tree edge — its coverage moves to
    the tree edge and the edge (plus conjugate) is deleted.  A component
    with any unprojectable inner edge is left untouched (SPAdes'
    ProjectComponent failure)."""
    removed = 0
    out_deg = g.out_degrees()
    for start in np.flatnonzero(out_deg >= 2):
        start = int(start)
        if start >= g.num_vertices or (g.alive & (g.e_start == start)).sum() < 2:
            continue
        comp = _dominated_component(g, start, max_length, length_diff, max_count)
        if comp is None:
            continue
        inside, _dmin = comp
        projections = _find_skeleton_and_project(g, inside, start, length_diff)
        if not projections:
            continue
        for e, t in projections:
            c = float(g.e_cov[e])
            g.e_cov[t] += c
            g.e_cov[int(g.e_conj[t])] += c
            if kmer_mapper is not None:
                kmer_mapper.remap_sequences(g.edge_codes(e), g.edge_codes(t))
        removed += g.kill_edges(np.array([e for e, _ in projections]))
        out_deg = g.out_degrees()
    return removed
