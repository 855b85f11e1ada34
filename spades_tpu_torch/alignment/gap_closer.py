"""Paired-read gap closing over the condensed graph.

Capability mirror of SPAdes' GapClosing stage
(`src/projects/spades/gap_closer.cpp:28-514`): map read pairs
whose mates land on tip-adjacent edges of two different dead ends, collect
(left edge, right edge) junction candidates weighted by pair support, then
close each supported gap by suffix/prefix overlap alignment of the two tip
sequences and splice the edges together.

Mapping is the batched k-mer anchor mapper (alignment.mapper), on the device
for the store path; candidate collection is a vectorized group-by over mapped
pairs; only the final overlap scoring of the handful of surviving candidates
runs as small host loops (SPAdes also does this part serially per gap under a
lock).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from ..core import dna
from ..graph.graph import CondensedGraph
from ..utils.timetracer import span
from .mapper import EdgeIndex, build_edge_index, map_read_batch

log = logging.getLogger("spades_tpu_torch.gap_closer")


@dataclass
class GapCloserConfig:
    min_pair_support: int = 3      # pairs needed to consider a junction
    min_intersection: int = 10     # gc.minimal_intersection (config.info:130)
    max_overlap_mismatches: int = 2  # hamming_dist_bound = min_intersection/5
    max_tip_scan: int = 400        # how far from the tip a mate may map


def _dead_end_edges(g: CondensedGraph):
    """Edges whose end vertex has no outgoing edges (forward dead ends)."""
    out_deg = g.out_degrees()
    ids = g.alive_edge_ids()
    return set(ids[out_deg[g.e_end[ids]] == 0].tolist())


def _dead_start_edges(g: CondensedGraph):
    in_deg = g.in_degrees()
    ids = g.alive_edge_ids()
    return set(ids[in_deg[g.e_start[ids]] == 0].tolist())


def _join_with_correction(
    tail: np.ndarray, head: np.ndarray, k: int, cfg: GapCloserConfig
) -> np.ndarray | None:
    """Overlap-join the two tip sequences, correcting overlap mismatches.

    Mirror of GapCloser::ProcessPair (gap_closer.cpp:322-365): gaps 1..k -
    min_intersection are tried largest-overlap-first; a low-complexity
    overlap rejects the candidate outright (:337-352); a perfect overlap
    joins directly (HandleSimpleCase :301-317); an imperfect one is
    corrected by rewriting the overlap with one side's version when the
    graph structure allows it (HandlePositiveHammingDistanceCase +
    CorrectLeft/CorrectRight :249-298 — expressed here directly on the
    joined sequence: CorrectLeft replaces first's overlap bases with
    second's, CorrectRight keeps first's), leaving the closed contig free of
    the tip errors."""
    len1, len2 = len(tail), len(head)
    max_gap = k - cfg.min_intersection
    for gap in range(1, max_gap + 1):
        o = k - gap
        if o > min(len1, len2):
            continue
        t, h = tail[-o:], head[:o]
        diff = np.flatnonzero(t != h)
        if diff.size > cfg.max_overlap_mismatches:
            continue
        # complexity check: dominant-base ratio ramps 0.8 -> 1.0 with gap
        counts = np.bincount(t, minlength=4)
        ratio = 0.8 + 0.2 * (gap - 1) / max(max_gap - 1, 1)
        if counts.max() > ratio * o:
            return None
        if diff.size == 0:
            return np.concatenate([tail, head[o:]])
        # CanCorrectLeft: every mismatch must leave the split inside first
        # (overlap - pos + k < len1); then second's overlap version wins
        if np.all(o - diff + k < len1):
            return np.concatenate([tail[: len1 - o], head])
        # CanCorrectRight: symmetric on second; first's version wins
        if np.all(diff + 1 + k < len2):
            return np.concatenate([tail, head[o:]])
        return None
    return None


def _collect_votes(
    g: CondensedGraph,
    ea_arr: np.ndarray, sa_arr: np.ndarray,
    eb_arr: np.ndarray, sb_arr: np.ndarray,
    dead_end: set, dead_start: set, cfg: "GapCloserConfig",
) -> dict[tuple[int, int], int]:
    """Vectorized junction-vote collection from mapped mate arrays
    (edge == -1 means unmapped)."""
    votes: dict[tuple[int, int], int] = {}
    ok = (ea_arr >= 0) & (eb_arr >= 0)
    ok &= (ea_arr != eb_arr) & (eb_arr != g.e_conj[np.maximum(ea_arr, 0)])
    de_mask = np.zeros(len(g.e_len), bool)
    ds_mask = np.zeros(len(g.e_len), bool)
    if dead_end:
        de_mask[np.fromiter(dead_end, np.int64)] = True
    if dead_start:
        ds_mask[np.fromiter(dead_start, np.int64)] = True
    ea_c = np.maximum(ea_arr, 0)
    eb_c = np.maximum(eb_arr, 0)
    # direct: left mate near its edge's dead END, right near a dead START
    direct = ok & de_mask[ea_c] & ds_mask[eb_c]
    direct &= (g.e_len[ea_c] - sa_arr) <= cfg.max_tip_scan
    direct &= sb_arr <= cfg.max_tip_scan
    # conjugate pairing: conj(b) .. conj(a) on the other strand.  Both mates
    # must sit near their tips, symmetric with the direct branch (the
    # reference checks both sides too, gap_closer.cpp:380-420; the one-sided
    # check also admitted mid-edge left mates, overcounting votes)
    eac = g.e_conj[ea_c]
    ebc = g.e_conj[eb_c]
    conj = ok & de_mask[ebc] & ds_mask[eac]
    conj &= (g.e_len[ebc] - (g.e_len[eb_c] - sb_arr - 1)) <= cfg.max_tip_scan
    conj &= (g.e_len[ea_c] - sa_arr) <= cfg.max_tip_scan
    for m, k1, k2 in ((direct, ea_c, eb_c), (conj, ebc, eac)):
        idx = np.flatnonzero(m)
        if idx.size == 0:
            continue
        key = k1[idx].astype(np.int64) * np.int64(len(g.e_len)) + k2[idx]
        uniq, cnt = np.unique(key, return_counts=True)
        for u, c in zip(uniq, cnt):
            pair = (int(u) // len(g.e_len), int(u) % len(g.e_len))
            votes[pair] = votes.get(pair, 0) + int(c)
    return votes


def _tip_region_words(g: CondensedGraph, dead_end: set, dead_start: set,
                      T: int, device=None) -> np.ndarray:
    """Sorted unique canonical k-mer rows of all tip-adjacent regions:
    dead-end edges' last T nt + dead-start edges' first T nt (canonical
    windows cover the conjugate orientations for free)."""
    from ..ops import count as C

    regions: list[np.ndarray] = []
    for e in dead_end:
        c = g.edge_codes(int(e))
        regions.append(np.ascontiguousarray(c[-T:]))
    for e in dead_start:
        c = g.edge_codes(int(e))
        regions.append(np.ascontiguousarray(c[:T]))
    if not regions:
        from ..core import kmers as KK

        return np.zeros((0, KK.kmer_words(g.k)), np.uint32)
    # count_sequences routes small region sets to the host counter and big
    # ones (graphs with many dead ends) to the device engine
    kc = C.count_sequences(regions, g.k, device=device)
    return kc.words


def close_gaps(
    g: CondensedGraph,
    paired: list[tuple[list[str], list[str]]] | None = None,
    index: EdgeIndex | None = None,
    device=None,
    engine=None,
    paired_stores: list | None = None,
    stats: dict | None = None,
    group=None,
) -> int:
    """Close tip-to-tip gaps supported by read pairs.  Returns #gaps closed.

    Mutates the graph in place (splices edges, kills the originals).

    Preferred input is `engine` (a shared `alignment.mapper.MappingEngine`)
    + `paired_stores` ((left ReadStore, right-RC ReadStore, lib_type)
    triples): reads are packed once per run and the edge index is built and
    uploaded once per graph state.  The legacy `paired` string-list path
    remains for tools/tests.

    device: where the prefilter, the mapper and the tip-region counting run
    (None: the engine's device, else the CUDA card; see `resolve_device`);
    vote collection and the final overlap splices stay on the host, as
    SPAdes' are serial under a lock.

    group: the process group the prefilter and the mapping run across (the
    JAX package's `mesh`; None: the engine's group, else the default group
    of a multi-process run), GapCloserMPI's split of the reads.

    stats: optional dict that receives `candidates` and `pairs` (prefilter
    survivors and pairs seen, store path), `prefilter_s` and `map_s` (wall
    seconds) and `closed`."""
    cfg = GapCloserConfig()
    if stats is None:
        stats = {}
    stats.update(candidates=0, pairs=0, prefilter_s=0.0, map_s=0.0, closed=0)
    if g.num_edges < 2 or not (paired or paired_stores):
        return 0
    dead_end = _dead_end_edges(g)
    dead_start = _dead_start_edges(g)
    if not dead_end or not dead_start:
        return 0

    votes: dict[tuple[int, int], int] = {}
    if paired_stores:
        if engine is None:
            from .mapper import MappingEngine

            engine = MappingEngine(g, index=index, device=device, group=group)
        from ..core.reads import subset_store
        from ..parallel.sharded_mapping import hit_filter_store

        # Device prefilter: a qualifying pair needs BOTH mates' windows
        # inside tip-adjacent regions (dead-end suffixes / dead-start
        # prefixes — canonical k-mers cover both orientations), so only
        # candidate reads pay the full-index mapping (on gapless datasets
        # this skips nearly all of the mapping work).
        # a qualifying mate's ON-EDGE windows all start within max_tip_scan
        # of its tip (see _collect_votes bounds), so T = scan + k covers them
        with span("gap_closer.prefilter", into=stats, key="prefilter_s"):
            tipw = _tip_region_words(g, dead_end, dead_start,
                                     cfg.max_tip_scan + g.k + 1, engine.device)
        if tipw.shape[0] == 0:
            return 0
        for st1, st2rc, _lib_type in paired_stores:
            with span("gap_closer.prefilter", into=stats, key="prefilter_s",
                      pairs=int(st1.n)) as sp:
                h1 = hit_filter_store(st1, tipw, g.k, device=engine.device, group=engine.group)
                h2 = hit_filter_store(st2rc, tipw, g.k, device=engine.device, group=engine.group)
                cand = np.flatnonzero(h1 & h2)
                sp.set(candidates=int(cand.size))
            stats["candidates"] += int(cand.size)
            stats["pairs"] += int(st1.n)
            log.info("gap closer prefilter: %d/%d candidate pairs",
                     cand.size, st1.n)
            if cand.size == 0:
                continue
            with span("gap_closer.map", into=stats, key="map_s"):
                sub1 = subset_store(st1, cand)
                sub2 = subset_store(st2rc, cand)
                e1a, s1a, _ = engine.map_store(sub1, force_device=True)
                e2a, s2a, _ = engine.map_store(sub2, force_device=True)
            for pair, c in _collect_votes(
                g, e1a, s1a, e2a, s2a, dead_end, dead_start, cfg
            ).items():
                votes[pair] = votes.get(pair, 0) + c
    else:
        from ..io.libraries import iter_fr_libs
        from ..parallel.distributed import resolve_group

        index = index or build_edge_index(g)
        grp = resolve_group(group)

        for r1s, r2s, _lib_type in iter_fr_libs(paired):
            r2rc = [
                dna.revcomp_str(s) if isinstance(s, str)
                else dna.revcomp_codes(dna.encode(s))
                for s in r2s
            ]
            with span("gap_closer.map", into=stats, key="map_s"):
                if grp is not None:
                    from ..core.reads import ReadBatch
                    from ..parallel.sharded_mapping import map_reads_sharded

                    e1a, s1a, _ = map_reads_sharded(index, g, ReadBatch.from_sequences(r1s),
                                                    device, group=grp)
                    e2a, s2a, _ = map_reads_sharded(index, g, ReadBatch.from_sequences(r2rc),
                                                    device, group=grp)
                    e1a, s1a = e1a[: len(r1s)].astype(np.int64), s1a[: len(r1s)].astype(np.int64)
                    e2a, s2a = e2a[: len(r2rc)].astype(np.int64), s2a[: len(r2rc)].astype(np.int64)
                else:
                    m1 = map_read_batch(index, g, r1s, device=device)
                    # FR orientation: the right mate spells the reverse strand
                    m2 = map_read_batch(index, g, r2rc, device=device)
                    e1a = np.array([m.edge if m else -1 for m in m1], np.int64)
                    s1a = np.array([m.start_offset if m else 0 for m in m1], np.int64)
                    e2a = np.array([m.edge if m else -1 for m in m2], np.int64)
                    s2a = np.array([m.start_offset if m else 0 for m in m2], np.int64)
            for pair, c in _collect_votes(
                g, e1a, s1a, e2a, s2a, dead_end, dead_start, cfg
            ).items():
                votes[pair] = votes.get(pair, 0) + c

    closed = 0
    used: set[int] = set()
    for (ea, eb), w in sorted(votes.items(), key=lambda kv: -kv[1]):
        if w < cfg.min_pair_support:
            break
        if not (g.alive[ea] and g.alive[eb]):
            continue
        if used & {ea, eb, int(g.e_conj[ea]), int(g.e_conj[eb])}:
            continue
        tail = g.edge_codes(ea)
        head = g.edge_codes(eb)
        joined = _join_with_correction(tail, head, g.k, cfg)
        if joined is None:
            continue
        cov = float(g.e_cov[ea] + g.e_cov[eb])
        g.add_edge_pair(int(g.e_start[ea]), int(g.e_end[eb]), joined, cov)
        g.kill_edges(np.array([ea, eb]))
        used.update({ea, eb, int(g.e_conj[ea]), int(g.e_conj[eb])})
        closed += 1
        log.info("closed gap %d->%d: support %d", ea, eb, w)
    stats["closed"] = closed
    return closed
