"""Graph simplification: tip clipping, bulge removal, erroneous-connection
removal, isolated-edge cleaning — as vectorized masked passes.

Capability mirror of SPAdes' simplification module
(`src/common/modules/simplification/`):

* TipClipper — `tip_clipper.hpp:23-59` TipCondition (an endpoint vertex of
  total degree 1, with an alternative at the other end), LengthUpperBound
  (tc_lb semantics: max_tip_length = max(min(k, RL/2)*tc_lb, RL)),
  CoverageUpperBound, RelativeCoverageTipCondition (rctc).
* BulgeRemover — `bulge_remover.hpp:346,400`; this pass handles simple bulges
  (parallel edges between the same vertex pair) with SPAdes' length /
  delta / relative-coverage gates, projecting ("gluing") removed-arm coverage
  onto the survivor; Dijkstra path alternatives are a planned extension.
* LowCoverageECRemover — `erroneous_connection_remover.hpp:1-635` basic
  condition: short (<= k + ec_lb), low-coverage, and "alternatively reachable"
  (start has other outgoing, end has other incoming).
* IsolatedEdgeRemover — `simplification.cpp` init_clean.ier: single-edge
  components shorter than the read length.

The iteration schedule mirrors `stages/simplification.cpp:405-429`: up to
`cycle_iter_count` rounds of TC -> BR -> EC with the EC/TC coverage bound
ramped linearly ("iterative threshold"), followed by a final cleanup, with
compression (graph/compress.py) after every mutating pass.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.timetracer import span
from .compress import compress, compress_tracked
from .coverage_model import GenomicInfo
from .flanking import FlankingTable
from .graph import CondensedGraph

# how often `simplify` ran its schedule on each engine: the native library,
# or the numpy loop (taken with relative-coverage flanking, as in meta mode,
# or without the library); instrumentation for the smoke run
ENGINE_RUNS = {"native": 0, "numpy": 0}


@dataclass
class SimplifyConfig:
    read_length: int = 100
    cycle_iter_count: int = 10
    # tip clipper: {tc_lb 3.5, cb 1000000, rctc 2.0} {tc_lb 10, cb auto}
    tc_lb: float = 3.5
    tc_lb_alt: float = 10.0
    rctc: float = 2.0
    # bulge remover
    br_enabled: bool = True
    max_bulge_length_coeff: float = 3.0
    max_additive_length_coeff: float = 100.0
    max_relative_coverage: float = 1.1
    max_delta: float = 3.0
    max_relative_delta: float = 0.1
    # erroneous connection remover: {to_ec_lb 5, icb auto}
    ec_lb: float = 10.0
    # relative-coverage component disconnector (meta mode; rcc section)
    rel_cov_enabled: bool = False
    rel_cov_ratio: float = 5.0
    # isolated edge remover
    ier_enabled: bool = True
    # native engine: event-driven Dijkstra-bulge retriggering (the
    # reference's SmartSet semantics); False = exact full re-scan each pass
    retrigger: bool = True
    # complex tip clipper (complex_tc; enabled in meta_mode.info:50-53)
    complex_tc_enabled: bool = False
    # complex (superbubble) bulge remover (cbr; enabled in mda_mode.info:51)
    cbr_enabled: bool = False
    # max-flow EC remover (mfec; simplification.info:228-234, off by default)
    mfec_enabled: bool = False
    mfec_max_ec_length_coeff: float = 30.0
    mfec_uniqueness_length: int = 1500
    mfec_plausibility_length: int = 200


def max_tip_length(cfg: SimplifyConfig, k: int, lb: float) -> int:
    """Reference formula (simplification.info:43)."""
    return int(max(min(k, cfg.read_length / 2) * lb, cfg.read_length))


def _degrees(g: CondensedGraph):
    outd = g.out_degrees()
    ind = g.in_degrees()
    return outd, ind


def _two_best_per_key(keys: np.ndarray, c: np.ndarray, V: int):
    """Per-key (max, second-max) of ``c`` — one lexsort, no Python loop.

    Segment-max formulation of SPAdes' per-vertex competitor scan
    (`parallel_simplification_algorithms.hpp` runs it as parallel C++; here
    it is a sorted-boundary pass)."""
    best = np.zeros(V)
    second = np.zeros(V)
    if keys.size == 0:
        return best, second
    order = np.lexsort((c, keys))
    ks = keys[order]
    cs = c[order]
    is_last = np.empty(ks.shape[0], bool)
    is_last[:-1] = ks[:-1] != ks[1:]
    is_last[-1] = True
    last = np.flatnonzero(is_last)
    best[ks[last]] = cs[last]
    prev = last - 1
    valid = (prev >= 0) & (ks[np.maximum(prev, 0)] == ks[last])
    second[ks[last[valid]]] = cs[prev[valid]]
    return best, second


def _max_competitor_cov(g: CondensedGraph) -> np.ndarray:
    """For each alive edge: max coverage among non-loop edges sharing its
    start vertex (outgoing) or end vertex (incoming), excluding itself.

    Vectorized version of RelativeCoverageTipCondition::MaxCompetitorCoverage.
    """
    V = g.num_vertices
    ids = g.alive_edge_ids()
    cov = g.coverage()
    not_loop = g.e_start[ids] != g.e_end[ids]
    c = np.where(not_loop, cov[ids], 0.0)

    # max over competitors = best at the vertex unless self is the best
    out_best, out_second = _two_best_per_key(g.e_start[ids], c, V)
    in_best, in_second = _two_best_per_key(g.e_end[ids], c, V)
    res = np.zeros(g.alive.shape[0])
    cself = np.where(not_loop, cov[ids], -1.0)
    o = np.where(cself >= out_best[g.e_start[ids]], out_second[g.e_start[ids]], out_best[g.e_start[ids]])
    i = np.where(cself >= in_best[g.e_end[ids]], in_second[g.e_end[ids]], in_best[g.e_end[ids]])
    res[ids] = np.maximum(o, i)
    return res


def clip_tips(
    g: CondensedGraph,
    max_len: int,
    cov_bound: float = np.inf,
    rctc: float | None = None,
) -> int:
    """One tip-clipping pass; returns number of (oriented) edges removed."""
    ids = g.alive_edge_ids()
    if ids.size == 0:
        return 0
    outd, ind = _degrees(g)
    s, e = g.e_start[ids], g.e_end[ids]
    # TipCondition::Check (tip_clipper.hpp): one endpoint has total degree 1
    # and there is an alternative at the junction end
    end_is_dead = (outd[e] + ind[e]) == 1
    start_is_dead = (outd[s] + ind[s]) == 1
    topo = (end_is_dead | start_is_dead) & ((outd[s] + ind[e]) > 2)
    length_ok = g.edge_kmer_lengths()[ids] <= max_len
    cov = g.coverage()
    cov_ok = cov[ids] <= cov_bound
    cond = topo & length_ok & cov_ok
    if rctc is not None:
        comp = _max_competitor_cov(g)
        cond &= cov[ids] <= rctc * (comp[ids] + 1.0)
    kill = ids[cond]
    return g.kill_edges(kill)


def remove_bulges(g: CondensedGraph, cfg: SimplifyConfig, kmer_mapper=None) -> int:
    """Simple-bulge pass: parallel edges between the same vertices.

    Removes the lower-coverage arm when lengths agree within delta and its
    coverage is below max_relative_coverage * survivor coverage; the removed
    arm's coverage is projected onto the survivor (SPAdes' glue).
    """
    ids = g.alive_edge_ids()
    if ids.size == 0:
        return 0
    k = g.k
    max_len = int(cfg.max_bulge_length_coeff * k + cfg.max_additive_length_coeff)
    lens = g.edge_kmer_lengths()
    cov = g.coverage()
    # group alive non-loop edges by (start, end); process only the canonical
    # member of each conjugate group pair — killing an arm also kills its
    # conjugate in the mirror group, so one-sided processing is exact (and
    # deterministic, unlike order-dependent sequential gluing).
    s, e = g.e_start[ids], g.e_end[ids]
    not_loop = s != e
    ids, s, e = ids[not_loop], s[not_loop], e[not_loop]
    if ids.size == 0:
        return 0
    V = np.int64(g.num_vertices)
    grp = s * V + e
    conj_grp = g.v_conj[e] * V + g.v_conj[s]
    canon = grp <= conj_grp
    ids, grp = ids[canon], grp[canon]
    if ids.size == 0:
        return 0
    # one vectorized pass: inside each group order by (-cov, len, id);
    # the first row is the survivor, the rest are candidate arms
    order = np.lexsort((ids, lens[ids], -cov[ids], grp))
    oid = ids[order]
    og = grp[order]
    new_grp = np.empty(len(og), bool)
    new_grp[0] = True
    new_grp[1:] = og[1:] != og[:-1]
    head_row = np.flatnonzero(new_grp)
    keep = oid[head_row[np.cumsum(new_grp) - 1]]  # survivor per row
    x = oid
    delta = np.maximum(cfg.max_delta, cfg.max_relative_delta * lens[keep])
    cond = (
        (x != keep)
        & (g.e_conj[x] != keep)  # never glue onto your own conjugate
        & (lens[x] <= max_len)
        & (np.abs(lens[x] - lens[keep]) <= delta)
        & (cov[x] <= cfg.max_relative_coverage * cov[keep])
    )
    kill = x[cond]
    if kill.size == 0:
        return 0
    keep_of = keep[cond]
    # a self-conjugate group holds both x and conj(x): the sequential pass
    # killed the pair once — dedupe to one representative per conjugate pair
    pair_rep = np.minimum(kill, g.e_conj[kill])
    _, first = np.unique(pair_rep, return_index=True)
    kill, keep_of = kill[first], keep_of[first]
    # project coverage onto the survivor, then remove; record the glue so
    # reads spelling the removed arm still map (KmerMapper::RemapKmers)
    arm_cov = g.e_cov[kill].copy()
    np.add.at(g.e_cov, keep_of, arm_cov)
    np.add.at(g.e_cov, g.e_conj[keep_of], arm_cov)
    if kmer_mapper is not None:
        for x_, kp in zip(kill, keep_of):
            kmer_mapper.remap_sequences(g.edge_codes(int(x_)), g.edge_codes(int(kp)))
    return g.kill_edges(kill)


def _out_csr(g: CondensedGraph) -> tuple[np.ndarray, np.ndarray]:
    """CSR out-adjacency over alive edges: (offsets (V+1,), edge ids)."""
    ids = g.alive_edge_ids()
    order = np.argsort(g.e_start[ids], kind="stable")
    eo = ids[order]
    off = np.searchsorted(g.e_start[eo], np.arange(g.num_vertices + 1))
    return off, eo


def _bounded_shortest_path(
    g: CondensedGraph,
    csr: tuple[np.ndarray, np.ndarray],
    lens: np.ndarray,
    v_from: int,
    v_to: int,
    skip_edge: int,
    max_len: int,
) -> list[int] | None:
    """Dijkstra bounded by path length (k-mer units), excluding skip_edge and
    its conjugate.  Returns the edge list of the shortest path or None.

    Fallback mirror of native/bulge.cpp via the vectorized bounded-Dijkstra
    framework (`graph/dijkstra.py`, the `dijkstra_algorithm.hpp` analog)."""
    from .dijkstra import shortest_path as _sp

    return _sp(g, v_from, v_to, max_len, length="kmer", skip_edges=(skip_edge,))


def remove_bulges_dijkstra(g: CondensedGraph, cfg: SimplifyConfig) -> int:
    """Path-alternative bulge removal (BulgeRemover with Dijkstra search,
    `bulge_remover.hpp:346`): a short low-coverage edge whose endpoints are
    joined by an alternative *path* of similar length is removed and its
    coverage projected onto the path edges.

    The sequential candidate loop runs in native C++ (native/bulge.cpp); a
    pure-Python CSR fallback covers builds without the native library."""
    k = g.k
    max_len = int(cfg.max_bulge_length_coeff * k + cfg.max_additive_length_coeff)
    lens = g.edge_kmer_lengths()
    outd, ind = _degrees(g)
    ids = g.alive_edge_ids()
    s, e = g.e_start[ids], g.e_end[ids]
    cand = ids[(lens[ids] <= max_len) & (s != e) & (outd[s] > 1) & (ind[e] > 1)]
    if cand.size == 0:
        return 0
    cov = g.coverage()
    # lowest-coverage candidates first (SPAdes' buffered ordering)
    cand = cand[np.lexsort((cand, cov[cand]))]

    from .. import native as _native

    if g.alive.dtype == bool and g.alive.flags.c_contiguous:
        n = _native.bulge_pass_native(
            g.e_start,
            g.e_end,
            g.e_conj,
            lens,
            cov,
            g.e_cov,
            g.alive.view(np.uint8),
            cand,
            g.num_vertices,
            max_len,
            cfg.max_delta,
            cfg.max_relative_delta,
            cfg.max_relative_coverage,
        )
        if n is not None:
            return n

    removed = 0
    csr = _out_csr(g)
    for e in cand:
        e = int(e)
        if not g.alive[e]:
            continue
        delta = int(max(cfg.max_delta, cfg.max_relative_delta * lens[e]))
        path = _bounded_shortest_path(
            g, csr, lens, int(g.e_start[e]), int(g.e_end[e]), e, int(lens[e]) + delta
        )
        if path is None:
            continue
        plen = int(sum(lens[x] for x in path))
        if abs(plen - int(lens[e])) > delta:
            continue
        pcov = float(min(cov[x] for x in path))
        if cov[e] > cfg.max_relative_coverage * pcov:
            continue
        # project the arm's coverage onto the path (glue semantics)
        for x in path:
            share = g.e_cov[e] * (lens[x] / max(plen, 1))
            g.e_cov[x] += share
            g.e_cov[g.e_conj[x]] += share
        removed += g.kill_edges(np.array([e]))
    return removed


def disconnect_relative_coverage(
    g: CondensedGraph, ratio: float = 5.0, max_len: int | None = None,
    flanking=None,
) -> int:
    """Relative-coverage disconnector (`relative_coverage_remover.hpp`,
    the meta-mode workhorse): remove edges whose coverage is `ratio`-times
    below the strongest flow at BOTH endpoints (chimeric joins between
    differently-covered genomic contexts).

    With a FlankingCoverage index the per-endpoint signal is the edge's
    LOCAL flank at that vertex (SPAdes' LocalCoverage,
    `relative_coverage_remover.hpp:240-249`) instead of the whole-edge
    average — on long edges spanning differently-covered contexts the flank
    is the honest signal at the junction."""
    ids = g.alive_edge_ids()
    if ids.size == 0:
        return 0
    cov = g.coverage()
    comp = _max_competitor_cov(g)

    if flanking is not None:
        start_local = flanking.cov_of_start(g, ids)
        end_local = flanking.cov_of_end(g, ids)
    else:
        start_local = end_local = cov[ids]
    # competitor maxima per endpoint separately
    V = g.num_vertices
    out_sum = np.bincount(g.e_start[ids], weights=start_local, minlength=V)
    in_sum = np.bincount(g.e_end[ids], weights=end_local, minlength=V)
    s, e = g.e_start[ids], g.e_end[ids]
    # strongest alternative flow around each endpoint of the edge
    start_alt = np.maximum(out_sum[s] - start_local, in_sum[s])
    end_alt = np.maximum(in_sum[e] - end_local, out_sum[e])
    cond = (start_local * ratio <= start_alt) & (end_local * ratio <= end_alt)
    if max_len is not None:
        cond &= g.edge_kmer_lengths()[ids] <= max_len
    # only disconnect genuine joins (both endpoints have alternatives)
    outd, ind = _degrees(g)
    cond &= (outd[s] + ind[s] > 1) & (outd[e] + ind[e] > 1)
    return g.kill_edges(ids[cond])


def remove_low_cov_ec(g: CondensedGraph, max_len: int, cov_bound: float) -> int:
    """Erroneous-connection pass: short, low-coverage, alternatively bridged."""
    ids = g.alive_edge_ids()
    if ids.size == 0:
        return 0
    outd, ind = _degrees(g)
    s, e = g.e_start[ids], g.e_end[ids]
    cond = (
        (g.edge_kmer_lengths()[ids] <= max_len)
        & (g.coverage()[ids] < cov_bound)
        & (outd[s] > 1)
        & (ind[e] > 1)
    )
    return g.kill_edges(ids[cond])


def remove_isolated(g: CondensedGraph, max_len: int, cov_bound: float = np.inf) -> int:
    """Remove single-edge connected components (init_clean.ier semantics)."""
    ids = g.alive_edge_ids()
    if ids.size == 0:
        return 0
    outd, ind = _degrees(g)
    s, e = g.e_start[ids], g.e_end[ids]
    isolated = (ind[s] == 0) & (outd[s] == 1) & (outd[e] == 0) & (ind[e] == 1)
    # self-loops are not isolated tips
    isolated &= s != e
    cond = isolated & (g.edge_kmer_lengths()[ids] <= max_len) & (
        g.coverage()[ids] <= cov_bound
    )
    return g.kill_edges(ids[cond])


def remove_low_coverage_edges(g: CondensedGraph, cov_bound: float, max_len: int) -> int:
    ids = g.alive_edge_ids()
    if ids.size == 0:
        return 0
    cond = (g.coverage()[ids] < cov_bound) & (g.edge_kmer_lengths()[ids] <= max_len)
    return g.kill_edges(ids[cond])


@dataclass
class SimplifyStats:
    tips: int = 0
    bulges: int = 0
    ec: int = 0
    isolated: int = 0
    iterations: int = 0


def _chain_codes(g: CondensedGraph, arc_orig: np.ndarray) -> np.ndarray:
    """Concatenate arc sequences with k-overlap trimming (head keeps its
    first k bases; every arc contributes seq[k:])."""
    parts = [g.edge_codes(int(arc_orig[0]))]
    for a in arc_orig[1:]:
        parts.append(g.edge_codes(int(a))[g.k:])
    return np.concatenate(parts)


def _simplify_loop_native(
    g: CondensedGraph,
    cfg: SimplifyConfig,
    auto_cb: float,
    ec_len: int,
    tip_len_1: int,
    tip_len_2: int,
    kmer_mapper,
    stats: "SimplifyStats",
) -> CondensedGraph | None:
    """Run the main TC/BR/EC loop on the native chain-merging engine
    (native/simplify.cpp) and materialize the resulting graph in one
    vectorized ragged copy.  Returns None when the native library is
    unavailable (callers fall back to the vectorized numpy loop)."""
    from .. import native as _native

    if _native.lib() is None:
        return None
    ids = g.alive_edge_ids()
    if ids.size == 0:
        return None
    old2sub = -np.ones(g.alive.shape[0], np.int64)
    old2sub[ids] = np.arange(ids.size)
    k = g.k
    res = _native.simplify_native(
        g.e_start[ids], g.e_end[ids], old2sub[g.e_conj[ids]],
        g.e_len[ids] - k, g.e_cov[ids], g.v_conj,
        cycle_iter_count=cfg.cycle_iter_count,
        tip_len_1=tip_len_1, tip_len_2=tip_len_2,
        tip_cb1=1e6, auto_cb=float(auto_cb), rctc=cfg.rctc,
        br_enabled=cfg.br_enabled,
        br_max_len=int(cfg.max_bulge_length_coeff * k + cfg.max_additive_length_coeff),
        max_delta=cfg.max_delta, max_rel_delta=cfg.max_relative_delta,
        max_rel_cov=cfg.max_relative_coverage,
        ec_len=ec_len, rel_cov_enabled=cfg.rel_cov_enabled,
        rel_cov_ratio=cfg.rel_cov_ratio,
        record_glue=kmer_mapper is not None,
        retrigger=cfg.retrigger,
        arc_seq_pool=g.seq_pool, arc_seq_off=g.e_off[ids], k=k,
    )
    if res is None:
        return None
    stats.tips += res["tips"]
    stats.bulges += res["bulges"]
    stats.ec += res["ec"]
    stats.iterations = res["iterations"]
    # glue records -> kmer mapper (RemapKmers semantics, as in remove_bulges)
    if kmer_mapper is not None:
        gao, gaa = res["glue_arm_off"], res["glue_arm_arcs"]
        gko, gka = res["glue_keep_off"], res["glue_keep_arcs"]
        for gi in range(len(gao) - 1):
            arm = _chain_codes(g, ids[gaa[gao[gi]:gao[gi + 1]]])
            keep = _chain_codes(g, ids[gka[gko[gi]:gko[gi + 1]]])
            kmer_mapper.remap_sequences(arm, keep)
    # sequences were materialized inside the engine (one sequential sweep)
    E = len(res["e_start"])
    e_len = res["e_klen"] + k
    return CondensedGraph(
        k=k,
        e_start=res["e_start"], e_end=res["e_end"], e_conj=res["e_conj"],
        e_off=res["e_off"], e_len=e_len, e_cov=res["e_cov"],
        alive=np.ones(E, bool), seq_pool=res["seq_pool"],
        v_conj=g.v_conj.copy(),
    )


def simplify(
    g: CondensedGraph,
    info: GenomicInfo | None = None,
    cfg: SimplifyConfig | None = None,
    kmer_mapper=None,
    flanking=None,
) -> tuple[CondensedGraph, SimplifyStats]:
    """Full simplification schedule (simplification.cpp:405-429 shape).

    flanking: optional FlankingCoverage index — or a callable
    ``g -> FlankingCoverage`` so it can be rebuilt after compress()
    renumbers edges, or a `FlankingTable` that keeps its sums across each
    compress and recomputes only new edges — consulted by the
    relative-coverage disconnector (LocalCoverage semantics); when provided
    with rel_cov enabled the schedule runs on the numpy loop (the native
    engine's rel-cov pass reads whole-edge averages).

    Spans: `simplification.loop` (`engine`, `iterations`),
    `simplification.compress` (`edges`) after each mutating pass,
    `simplification.flanking` per refresh of a `FlankingTable`, and
    `simplification.tail` around the post-loop passes."""
    cfg = cfg or SimplifyConfig()
    stats = SimplifyStats()
    k = g.k
    auto_cb = info.ec_bound if info is not None else np.inf
    ec_len = int(k + cfg.ec_lb)
    tip_len_1 = max_tip_length(cfg, k, cfg.tc_lb)
    tip_len_2 = max_tip_length(cfg, k, cfg.tc_lb_alt)

    with span("simplification.loop") as s:
        gn = None
        if flanking is None or not cfg.rel_cov_enabled:
            gn = _simplify_loop_native(
                g, cfg, auto_cb, ec_len, tip_len_1, tip_len_2, kmer_mapper, stats
            )
        engine = "native" if gn is not None else "numpy"
        ENGINE_RUNS[engine] += 1
        if gn is None:
            gn = _simplify_loop_numpy(
                g, cfg, auto_cb, ec_len, tip_len_1, tip_len_2, kmer_mapper, stats, flanking
            )
        s.set(engine=engine, iterations=stats.iterations)
    with span("simplification.tail"):
        return _simplify_tail(gn, cfg, stats, kmer_mapper)


def _simplify_loop_numpy(
    g: CondensedGraph,
    cfg: SimplifyConfig,
    auto_cb: float,
    ec_len: int,
    tip_len_1: int,
    tip_len_2: int,
    kmer_mapper,
    stats: "SimplifyStats",
    flanking,
) -> CondensedGraph:
    """The main TC/BR/EC loop as vectorized numpy passes, with compression
    after every mutating pass (a `FlankingTable` carries its sums across
    each)."""
    table = flanking if isinstance(flanking, FlankingTable) else None
    for it in range(cfg.cycle_iter_count):
        stats.iterations = it + 1
        # iterative coverage threshold ramp (icb auto semantics)
        frac = (it + 1) / cfg.cycle_iter_count
        icb = auto_cb * frac if np.isfinite(auto_cb) else np.inf
        changed = 0
        n = clip_tips(g, tip_len_1, cov_bound=1e6, rctc=cfg.rctc)
        n += clip_tips(g, tip_len_2, cov_bound=auto_cb)
        if n:
            g = _compress(g, table)
        stats.tips += n
        changed += n
        if cfg.br_enabled:
            n = remove_bulges(g, cfg, kmer_mapper)
            n += remove_bulges_dijkstra(g, cfg)
            if n:
                g = _compress(g, table)
            stats.bulges += n
            changed += n
        n = remove_low_cov_ec(g, ec_len, icb)
        if cfg.rel_cov_enabled:
            if table is not None:
                fl = table.refresh(g)
            else:
                fl = flanking(g) if callable(flanking) else flanking
            n += disconnect_relative_coverage(
                g, cfg.rel_cov_ratio, ec_len * 5, flanking=fl
            )
        if n:
            g = _compress(g, table)
        stats.ec += n
        changed += n
        if changed == 0 and frac >= 1.0:
            break
        if changed == 0 and not np.isfinite(auto_cb):
            break
    return g


def _compress(g: CondensedGraph, table: FlankingTable | None = None) -> CondensedGraph:
    """`compress` in a `simplification.compress` span; with a flanking
    table, its sums are carried onto the new edges."""
    with span("simplification.compress") as s:
        if table is None:
            gn = compress(g)
        else:
            gn, heads, n_arcs = compress_tracked(g)
            table.carry(g, gn, heads, n_arcs)
        s.set(edges=int(gn.num_edges))
    return gn


def _simplify_tail(
    g: CondensedGraph, cfg: SimplifyConfig, stats: "SimplifyStats", kmer_mapper
) -> tuple[CondensedGraph, SimplifyStats]:
    """Post-loop passes: complex bulge/tip/max-flow removers, then isolated
    cleanup — shared by the native and numpy main loops."""
    k = g.k
    if cfg.cbr_enabled or cfg.complex_tc_enabled or cfg.mfec_enabled:
        from .simplify_complex import (
            clip_complex_tips, collapse_superbubbles, max_flow_ec_remover,
            remove_complex_bulges,
        )

        n = 0
        if cfg.cbr_enabled:
            n += collapse_superbubbles(
                g, max_length=int(5.0 * k + cfg.max_additive_length_coeff)
            )
            # dominated multi-exit components the superbubble pass cannot
            # close (complex_bulge_remover.hpp full machinery)
            n += remove_complex_bulges(
                g,
                max_length=int(5.0 * k + cfg.max_additive_length_coeff),
                length_diff=int(cfg.max_delta),
                kmer_mapper=kmer_mapper,
            )
            stats.bulges += n
        if cfg.complex_tc_enabled:
            m = clip_complex_tips(g, relative_coverage=2.0, max_edge_len=100,
                                  max_path_len=max_tip_length(cfg, k, cfg.tc_lb))
            stats.tips += m
            n += m
        if cfg.mfec_enabled:
            m = max_flow_ec_remover(
                g,
                max_length=int(k + cfg.mfec_max_ec_length_coeff),
                uniqueness_length=cfg.mfec_uniqueness_length,
                plausibility_length=cfg.mfec_plausibility_length,
            )
            stats.ec += m
            n += m
        if n:
            g = _compress(g)
    if cfg.ier_enabled:
        n = remove_isolated(g, cfg.read_length)
        if n:
            g = _compress(g)
        stats.isolated += n
    return g, stats
