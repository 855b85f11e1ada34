"""Repeat resolution and scaffolding as greedy path extension (exSPAnder).

Capability mirror of SPAdes' path_extend module
(`src/common/modules/path_extend/`): seeds from long edges
(`MakeSimpleSeeds`), a paired-weight extension chooser
(`extension_chooser.hpp` SimpleExtensionChooser: candidate score = sum of
paired-info weights from path edges at consistent distances, with a
relative-weight filter), conjugate-paired bidirectional paths, overlap/
containment removal (`pe_resolver.hpp`), and pair-info-driven scaffold gap
joining (`scaffolder2015` surface, simple-gap variant).

Host-side control loop (SPAdes' is inherently sequential/greedy too,
`launcher.cpp:633-702`); the per-candidate weight scoring is vectorized over
the sorted paired-index table.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

from ..graph.graph import CondensedGraph
from .paired_info import PairedIndex

log = logging.getLogger("spades_tpu_torch.path_extend")


@dataclass
class PEConfig:
    insert_size: float = 250.0
    is_var: float = 50.0
    read_length: int = 100
    min_weight: float = 1.0
    rel_weight: float = 0.6     # priority filter (prior_coeff analog: keep >= rel*best)
    max_edge_repeat: int = 8
    scaffold_min_weight: float = 2.0
    min_gap: int = 1
    max_gap: int = 2000
    # PathCoverWeightCounter knobs (weight_counter.hpp:218-280)
    normalize_weight: bool = True
    single_threshold: float = 0.1   # per-path-edge support cut (pe_config single_threshold)
    weight_threshold: float = 0.35  # final normalized score cut (extension_options)
    # polishing / loops
    max_polisher_gap: int = 700     # pe_config max_polisher_gap (launcher.cpp:485)
    loop_unroll_nt_limit: int = 1000  # full unroll only for short loops (path_extender.hpp:126)
    # scaffolder gap-analyzer options (pe_params.info:57-73 scaffolder block)
    min_gap_score: float = 0.7      # Hamming analyzer accept score
    short_overlap: int = 6          # stop scanning below this once a hit exists
    artificial_gap: int = 10        # fallback N-gap when no overlap found
    min_la_length: int = 10         # min local-alignment length (min_overlap_length)
    flank_multiplication_coefficient: float = 0.5
    flank_addition_coefficient: int = 5
    basic_overlap_coeff: float = 2.0  # max Hamming overlap = coeff * read_length
    max_can_overlap: float = 1.0    # may_overlap_threshold = coeff * is_var
    var_coeff: float = 3.0          # must_overlap_threshold = -coeff * is_var


@dataclass
class Path:
    edges: list[int]
    gaps: list[int] = field(default_factory=list)  # gap BEFORE edge i (gaps[0]=0)

    def __post_init__(self):
        if not self.gaps:
            self.gaps = [0] * len(self.edges)


def path_positions(g: CondensedGraph, path: Path) -> np.ndarray:
    """Start position of every path edge in path coordinates (k-mer lengths)."""
    pos = np.zeros(len(path.edges), np.int64)
    run = 0
    for i, e in enumerate(path.edges):
        run += path.gaps[i]
        pos[i] = run
        run += int(g.e_len[e]) - g.k
    return pos


def conj_path(g: CondensedGraph, path: Path) -> Path:
    edges = [int(g.e_conj[e]) for e in reversed(path.edges)]
    gaps = [0] + list(reversed(path.gaps[1:])) if len(path.gaps) > 1 else [0]
    return Path(edges, gaps)


def ideal_pair_count(
    len1: int, len2: int, dist: int, insert_size: int, read_len: int, k: int
) -> int:
    """Expected read-pair count between two edges at a given start distance,
    for a point insert-size distribution — the IdealReads formula of
    `modules/path_extend/ideal_pair_info.hpp:63-88` (non-additive branch).
    Lengths and dist are in k-mer units, insert size / read length in nt."""
    if dist == 0:
        return max(len1 - insert_size + 2 * read_len - 2 - k + 1, 0)
    if dist < 0:
        len1, len2 = len2, len1
        dist = -dist
    gap_len = dist - len1
    right = min(insert_size - read_len - 1, gap_len + len2 - 1)
    left = max(gap_len + k + 1 - read_len, insert_size - read_len - len1 - read_len + k + 1)
    return max(right - left + 1, 0)


def ideal_pair_counts_vec(
    len1, len2, dist, insert_size: int, read_len: int, k: int
) -> np.ndarray:
    """Vectorized `ideal_pair_count` over broadcastable arrays — the same
    IdealReads formula (`ideal_pair_info.hpp:63-88`) evaluated for a whole
    (path-edge x candidate) matrix in one numpy pass."""
    len1 = np.asarray(len1, np.int64)
    len2 = np.asarray(len2, np.int64)
    dist = np.asarray(dist, np.int64)
    swap = dist < 0
    l1 = np.where(swap, len2, len1)
    l2 = np.where(swap, len1, len2)
    d = np.abs(dist)
    gap_len = d - l1
    right = np.minimum(insert_size - read_len - 1, gap_len + l2 - 1)
    left = np.maximum(
        gap_len + k + 1 - read_len, insert_size - read_len - l1 - read_len + k + 1
    )
    res = np.maximum(right - left + 1, 0)
    zero_d = np.maximum(l1 - insert_size + 2 * read_len - 2 - k + 1, 0)
    return np.where(d == 0, zero_d, res).astype(float)


def candidate_weights(
    g: CondensedGraph,
    pi: PairedIndex,
    path: Path,
    pos: np.ndarray,
    cands: list[int],
    cand_pos: int,
    cfg: PEConfig,
    edge_use_mask: np.ndarray | None = None,
) -> np.ndarray:
    """Normalized paired support for every candidate in ONE vectorized pass
    over the whole (path-edge x candidate) matrix
    (PathCoverWeightCounter::CountWeight, `weight_counter.hpp:218-280`):
    a path edge supports a candidate when its actual/ideal pair-weight ratio
    clears single_threshold; the score is the ideal-weight-fraction of
    supporting path edges (in [0, 1]).  No Python loop over path edges: the
    pair-table slices of every path edge are gathered with one batched
    searchsorted and scattered into the (E, C) weight matrix.

    Returns (weights, normalized): normalized=True means scores are in
    [0, 1] and should be cut at cfg.weight_threshold; False means raw summed
    pair weights (ReadCountWeightCounter analog; also the fallback when no
    path edge has positive ideal coverage), cut at cfg.min_weight."""
    C = len(cands)
    delta = max(3.0 * cfg.is_var, 10.0)
    cands_arr = np.asarray(cands, np.int64)
    corder = np.argsort(cands_arr)
    csorted = cands_arr[corder]
    clens = (g.e_len[cands_arr] - g.k).astype(np.int64)
    is_nt = int(cfg.insert_size)
    rl = int(cfg.read_length)

    edges = np.asarray(path.edges, np.int64)
    dists = (int(cand_pos) - np.asarray(pos, np.int64)).astype(np.int64)
    elens = (g.e_len[edges] - g.k).astype(np.int64)
    active = (dists - elens) <= cfg.insert_size + delta
    if edge_use_mask is not None:
        active &= np.asarray(edge_use_mask, bool)
    if not active.any():
        return np.zeros(C), False
    edges, dists, elens = edges[active], dists[active], elens[active]
    E = len(edges)

    # actual weights: gather every path edge's pair-table slice at once
    w = np.zeros((E, C))
    lo = np.searchsorted(pi.e1, edges, side="left")
    hi = np.searchsorted(pi.e1, edges, side="right")
    cnt = hi - lo
    total = int(cnt.sum())
    if total:
        row = np.repeat(np.arange(E), cnt)
        idx = np.repeat(lo, cnt) + np.arange(total) - np.repeat(
            np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt
        )
        m = np.abs(pi.dist[idx] - dists[row]) <= delta
        if m.any():
            idx_m, row_m = idx[m], row[m]
            e2m = pi.e2[idx_m]
            ins = np.searchsorted(csorted, e2m)
            ins_c = np.minimum(ins, C - 1)
            hit = csorted[ins_c] == e2m
            flat = row_m[hit] * C + corder[ins_c[hit]]
            np.add.at(w.ravel(), flat, pi.weight[idx_m][hit])

    ideal = ideal_pair_counts_vec(
        elens[:, None], clens[None, :], dists[:, None], is_nt, rl, g.k
    )
    has = ideal > 0
    raw = w.sum(axis=0)
    ideal_tot = np.where(has, ideal, 0.0).sum(axis=0)
    supp = has & (w / np.maximum(ideal, 1e-9) >= cfg.single_threshold)
    support = np.where(supp, ideal, 0.0).sum(axis=0)
    if not cfg.normalize_weight or not ideal_tot.any():
        return raw, False
    return np.where(ideal_tot > 0, support / np.maximum(ideal_tot, 1e-9), 0.0), True


def _long_read_choice(long_reads, last: int, cands: list[int]) -> int | None:
    """LongReadsExtensionChooser analog: a unique dominant long-read vote."""
    if long_reads is None:
        return None
    votes = long_reads.next_edge_votes(last)
    scored = sorted(((votes.get(c, 0), c) for c in cands), reverse=True)
    if scored[0][0] >= 2 and (len(scored) == 1 or scored[0][0] >= 2 * max(scored[1][0], 1)):
        return scored[0][1]
    return None


def get_loop_and_exit(g: CondensedGraph, fwd: int):
    """GetLoopAndExit (loop_detector.cpp:15-45): detect the canonical short
    loop pattern around forward-cycle edge `fwd`.  Returns (back_cycle_edge,
    loop_outgoing, loop_incoming) or None."""
    loop_end = int(g.e_end[fwd])
    loop_start = int(g.e_start[fwd])
    outs = [int(e) for e in g.out_edges_of(loop_end)]
    ins_end = g.in_edges_of(loop_end)
    outs_start = g.out_edges_of(loop_start)
    ins_start = [int(e) for e in g.in_edges_of(loop_start)]
    if len(outs) != 2 or len(ins_end) != 1 or len(outs_start) != 1 or len(ins_start) != 2:
        return None
    e1, e2 = outs
    if int(g.e_end[e1]) == int(g.e_end[e2]):
        return None  # pathological: two glued loops
    if int(g.e_end[e1]) == loop_start:
        back, exit_edge = e1, e2
    elif int(g.e_end[e2]) == loop_start:
        back, exit_edge = e2, e1
    else:
        return None
    incoming = next((e for e in ins_start if e != back), None)
    if incoming is None:
        return None
    return back, exit_edge, incoming


def resolve_short_loop(g: CondensedGraph, path: Path, cfg: PEConfig) -> bool:
    """ShortLoopResolver::MakeBestChoice with the CoverageLoopEstimator
    (path_extender.hpp:58-186): undo any traversed (back, fwd) iterations,
    estimate the loop multiplicity from coverage, then unroll it that many
    times (full unroll when the unrolled span is short — the plasmid branch)
    or emit a 100-N jump to the exit edge.  Returns True if the path was
    advanced past the loop."""
    if len(path.edges) < 2:
        return False
    fwd = int(path.edges[-1])
    loop = get_loop_and_exit(g, fwd)
    if loop is None:
        return False
    back, exit_edge, incoming = loop
    # UndoCycles: pop already-walked (back, fwd) pairs
    start = len(path.edges)
    while start > 2 and path.edges[start - 1] == fwd and path.edges[start - 2] == back:
        start -= 2
    if path.edges[start - 1] == fwd:
        del path.edges[start:]
        del path.gaps[start:]
    if len(path.edges) < 2:
        return False
    cov = g.coverage()
    incoming_path_edge = int(path.edges[-2])
    avg = (cov[incoming_path_edge] + cov[exit_edge]) / 2.0
    if avg <= 0:
        return False
    fwd_count = round(float(cov[fwd]) / avg)
    back_count = round(float(cov[back]) / avg)
    loop_count = int(round(max(0.0, min(fwd_count - 1.0, back_count))))
    span = int(g.e_len[fwd] + g.e_len[back]) - 2 * g.k
    if loop_count == 0:
        path.edges.append(exit_edge)
        path.gaps.append(0)
    elif loop_count == 1 or loop_count * span < cfg.loop_unroll_nt_limit:
        for _ in range(loop_count):
            path.edges.append(back)
            path.gaps.append(0)
            path.edges.append(fwd)
            path.gaps.append(0)
        path.edges.append(exit_edge)
        path.gaps.append(0)
    else:
        # many long cycles: jump to the exit with a fixed 100-N stretch
        path.edges.append(back)
        path.gaps.append(0)
        path.edges.append(exit_edge)
        path.gaps.append(g.k + 100)
    return True


class PEChooser:
    """SimpleExtensionChooser over one paired library's clustered index
    (`extension_chooser.hpp` Simple/LongEdge/RNA variants, selected by
    flags): normalized paired support + relative-priority filter.

    min_path_edge_nt > 0 gives LongEdgeExtensionChooser (:603-628): path
    edges shorter than that contribute no weight (mate-pair libraries).
    rna=True gives RNAExtensionChooser (:573-600): trailing simple-path
    edges back to the last branching vertex are excluded unless that reaches
    the path start."""

    def __init__(self, pi: PairedIndex, insert_size: float | None = None,
                 is_var: float | None = None, min_path_edge_nt: int = 0,
                 rna: bool = False):
        self.pi = pi
        self.insert_size = insert_size
        self.is_var = is_var
        self.min_path_edge_nt = min_path_edge_nt
        self.rna = rna

    def _use_mask(self, g, path: Path) -> np.ndarray | None:
        n = len(path.edges)
        mask = np.ones(n, bool)
        if self.min_path_edge_nt > 0:
            for i, e in enumerate(path.edges):
                if int(g.e_len[e]) < self.min_path_edge_nt:
                    mask[i] = False
        if self.rna and n >= 2:
            ind = g.in_degrees()
            i = n - 1
            excluded = []
            while i > 0:
                if ind[int(g.e_start[path.edges[i]])] > 1:
                    break
                excluded.append(i)
                i -= 1
            if i > 0:
                mask[excluded] = False
        return mask if not mask.all() else None

    def choose(self, g, path: Path, pos, cands: list[int], cand_pos: int,
               cfg: PEConfig) -> int | None:
        eff = cfg
        if self.insert_size is not None:
            from dataclasses import replace

            eff = replace(cfg, insert_size=self.insert_size,
                          is_var=self.is_var if self.is_var is not None else cfg.is_var)
        weights, normalized = candidate_weights(
            g, self.pi, path, pos, cands, cand_pos, eff,
            edge_use_mask=self._use_mask(g, path),
        )
        best = int(np.argmax(weights))
        threshold = eff.weight_threshold if normalized else eff.min_weight
        if weights[best] >= threshold:
            strong = np.flatnonzero(weights >= eff.rel_weight * weights[best])
            if strong.size == 1:
                return cands[best]
        return None


class CoverageChooser:
    """SimpleCoverageExtensionChooser (extension_chooser.hpp:284-396):
    strand-specific coverage disambiguates 2-way RNA splits — the candidate
    whose coverage matches the path's side of the last 2-in split wins."""

    def __init__(self, ss_cov: np.ndarray, coverage_margin: float = 2.0,
                 max_coverage_variation: float = 3.0,
                 min_upper_coverage: float = 5.0):
        self.ss = ss_cov
        self.margin = coverage_margin
        self.variation = max_coverage_variation
        self.min_upper = min_upper_coverage

    def _cov(self, g, e: int, reverse: bool) -> float:
        return float(self.ss[int(g.e_conj[e])] if reverse else self.ss[int(e)])

    @staticmethod
    def _similar(c1: float, c2: float, thr: float) -> bool:
        if c1 == 0.0 or c2 == 0.0:
            return False
        return max(c1, c2) / min(c1, c2) <= thr

    def choose(self, g, path: Path, pos, cands: list[int], cand_pos: int,
               cfg: PEConfig) -> int | None:
        if len(cands) != 2:
            return None
        ind = g.in_degrees()
        idx = len(path.edges) - 1
        while idx > 0:
            if ind[int(g.e_start[path.edges[idx]])] == 2:
                break
            idx -= 1
        if idx == 0:
            return None
        at_split = int(path.edges[idx - 1])
        split_v = int(g.e_end[at_split])
        other = next(
            (int(e) for e in g.in_edges_of(split_v) if int(e) != at_split), None
        )
        if other is None:
            return None
        reverse = self._cov(g, at_split, False) < self._cov(g, at_split, True)
        cov_path = self._cov(g, at_split, reverse)
        cov_other = self._cov(g, other, reverse)
        c1 = self._cov(g, cands[0], reverse)
        c2 = self._cov(g, cands[1], reverse)
        if self._similar(cov_path, cov_other, self.margin) or self._similar(
            c1, c2, self.margin
        ):
            return None
        hp, lp = max(cov_path, cov_other), min(cov_path, cov_other)
        he, le = max(c1, c2), min(c1, c2)
        enough = lambda lo, hi: lo == 0.0 or hi >= self.min_upper
        if not enough(lp, hp) or not enough(le, he):
            return None
        if cov_path > cov_other:
            if self._similar(hp, he, self.variation):
                return cands[0] if c1 > c2 else cands[1]
        else:
            if self._similar(lp, le, self.variation):
                return cands[0] if c1 < c2 else cands[1]
        return None


class LongReadChooser:
    """LongReadsExtensionChooser role: unique dominant long-read vote."""

    def __init__(self, long_reads):
        self.long_reads = long_reads

    def choose(self, g, path: Path, pos, cands: list[int], cand_pos: int,
               cfg: PEConfig) -> int | None:
        return _long_read_choice(self.long_reads, path.edges[-1], cands)


def make_chooser_chain(
    pair_libs=None,
    long_reads=None,
    ss_cov: np.ndarray | None = None,
    mode: str = "multicell",
    merged_pi: PairedIndex | None = None,
) -> list:
    """Build the composite chooser chain in SPAdes' extender order
    (`pipeline/extenders_logic.cpp:469-548` MakeBasicExtenders): long-read
    extenders first, then per-library PE (LongEdgePE for mate-pairs, RNA
    chooser in rna mode), then the coverage extender (rna ss data).

    pair_libs: list of (lib_type, PairedIndex, InsertSizeStats)."""
    chain: list = []
    if long_reads is not None:
        chain.append(LongReadChooser(long_reads))
    for lib_type, pi, st in pair_libs or []:
        is_ = st.median if st is not None and st.count else None
        var = max(st.mad, 10.0) if st is not None and st.count else None
        if lib_type == "mate-pairs":
            chain.append(PEChooser(pi, is_, var, min_path_edge_nt=200))
        elif mode == "rna":
            chain.append(PEChooser(pi, is_, var, rna=True))
        else:
            chain.append(PEChooser(pi, is_, var))
    if not (pair_libs) and merged_pi is not None:
        chain.append(PEChooser(merged_pi, rna=(mode == "rna")))
    if mode == "rna" and ss_cov is not None:
        chain.append(CoverageChooser(ss_cov))
    return chain


def _extend_step(
    g: CondensedGraph, path: Path, cfg: PEConfig, choosers: list
) -> bool:
    """One forward growth step through the composite chain
    (CompositeExtender::MakeGrowStep: first chooser that decides wins)."""
    last = path.edges[-1]
    v = int(g.e_end[last])
    cands = [int(e) for e in g.out_edges_of(v)]
    if not cands:
        return False
    from collections import Counter

    counts = Counter(path.edges)
    cands = [e for e in cands if counts[e] < cfg.max_edge_repeat]
    if not cands:
        return False
    # LoopDetectingPathExtender: entering the canonical short loop is handled
    # by the resolver (coverage-estimated unroll), not the chooser — and it
    # must run BEFORE the transition guard below, which would otherwise cap
    # legitimate multi-lap unrolls of short tandem loops at one lap
    if len(path.edges) >= 2 and get_loop_and_exit(g, int(last)) is not None:
        if resolve_short_loop(g, path, cfg):
            return True
    # cycle guard (LoopDetector role, path_extender.hpp): re-walking an
    # ordered transition the path already contains means we are lapping a
    # non-canonical cycle with no new information — a circular plasmid
    # would otherwise be unrolled max_edge_repeat times.  Distinct entries
    # into a repeat edge (A->R vs B->R) remain allowed, and transitions that
    # belong to a canonical short loop are exempt: the loop resolver owns
    # those (it may need to re-enter the loop to then UndoCycles and unroll
    # by the coverage estimate).
    seen_trans = set(zip(path.edges, path.edges[1:]))
    if any((last, e) in seen_trans for e in cands):
        in_canonical_loop = get_loop_and_exit(g, int(last)) is not None
        cands = [
            e for e in cands
            if (last, e) not in seen_trans
            or in_canonical_loop
            or get_loop_and_exit(g, int(e)) is not None
        ]
    if not cands:
        return False
    if len(cands) == 1:
        path.edges.append(cands[0])
        path.gaps.append(0)
        return True
    pos = path_positions(g, path)
    cand_pos = int(pos[-1]) + int(g.e_len[last]) - g.k
    for chooser in choosers:
        choice = chooser.choose(g, path, pos, cands, cand_pos, cfg)
        if choice is not None:
            path.edges.append(choice)
            path.gaps.append(0)
            return True
    return False  # ambiguous — stop


def _default_choosers(pi: PairedIndex, long_reads) -> list:
    """One PE chooser over `pi`, with the long-read chooser as tie-breaker."""
    choosers: list = [PEChooser(pi)]
    if long_reads is not None:
        choosers.append(LongReadChooser(long_reads))
    return choosers


def extend_path_forward(
    g: CondensedGraph, pi: PairedIndex, path: Path, cfg: PEConfig, long_reads=None
) -> bool:
    """Try one forward extension step; returns True if extended.

    Back-compat wrapper over the composite chain: one PE chooser over the
    merged index, with the long-read chooser as tie-breaker."""
    return _extend_step(g, path, cfg, _default_choosers(pi, long_reads))


def resolve_repeats(
    g: CondensedGraph, pi: PairedIndex, cfg: PEConfig, long_reads=None,
    choosers: list | None = None,
) -> list[Path]:
    """Greedy seed-and-extend over all edges, longest seeds first.

    choosers: explicit composite chooser chain (make_chooser_chain); when
    None, one PE chooser over `pi` plus the long-read tie-breaker."""
    if choosers is None:
        choosers = _default_choosers(pi, long_reads)
    ids = g.canonical_edge_ids()
    order = sorted(ids, key=lambda e: (-int(g.e_len[e]), int(e)))
    used: set[int] = set()
    paths: list[Path] = []
    for seed in order:
        seed = int(seed)
        if seed in used:
            continue
        path = Path([seed])
        # extend forward, then extend the conjugate forward (== backward)
        while _extend_step(g, path, cfg, choosers):
            pass
        path = conj_path(g, path)
        while _extend_step(g, path, cfg, choosers):
            pass
        path = conj_path(g, path)  # restore original orientation
        for e in path.edges:
            used.add(int(e))
            used.add(int(g.e_conj[e]))
        paths.append(path)
    trim_cyclic_periods(g, paths)
    return remove_contained(g, paths)


def traverse_loops(
    g: CondensedGraph,
    paths: list[Path],
    cfg: PEConfig,
    long_edge_limit: int = 1000,
    component_size_limit: int = 10,
    shortest_path_limit: int = 1000,
) -> int:
    """LoopTraverser (loop_traverser.{hpp,cpp}; pe_params loop_traversal
    min_edge_length=1000 max_component_size=10 max_path_length=1000): for
    every small short-edge component with a unique entrance and exit edge,
    when exactly one path ends through the entrance and exactly one starts
    from the exit, join them — through the shortest connecting path inside
    the component when one exists within the limit, else with a 100-N gap.
    Mutates `paths` in place; returns the number of joins."""
    lens_nt = g.e_len
    ids = g.alive_edge_ids()
    if ids.size == 0 or not paths:
        return 0
    # short-edge components (the loop candidates)
    parent = np.arange(g.num_vertices)

    def find(v):
        while parent[v] != v:
            parent[v] = parent[parent[v]]
            v = parent[v]
        return v

    short = ids[lens_nt[ids] < long_edge_limit]
    for e in short:
        a, b = find(int(g.e_start[e])), find(int(g.e_end[e]))
        if a != b:
            parent[a] = b
    comps: dict[int, set[int]] = {}
    for e in short:
        comps.setdefault(find(int(g.e_start[e])), set()).update(
            (int(g.e_start[e]), int(g.e_end[e]))
        )
    # path lookup by first/last edge
    joins = 0
    outd = g.out_degrees()
    ind = g.in_degrees()
    for comp in comps.values():
        if len(comp) > component_size_limit or len(comp) < 2:
            continue
        # no tips inside (AnyTipsInComponent)
        if any(outd[v] + ind[v] <= 1 for v in comp):
            continue
        entr = [
            int(e)
            for v in comp
            for e in g.in_edges_of(v)
            if int(g.e_start[e]) not in comp
        ]
        exits = [
            int(e)
            for v in comp
            for e in g.out_edges_of(v)
            if int(g.e_end[e]) not in comp
        ]
        if len(entr) != 1 or len(exits) != 1:
            continue
        start, end = entr[0], exits[0]
        # covering paths of the entrance / exit edges (GetCoveringPaths)
        p1s = [p for p in paths if any(int(e) == start for e in p.edges)]
        p2s = [p for p in paths if any(int(e) == end for e in p.edges)]
        if len(p1s) != 1 or len(p2s) != 1 or p1s[0] is p2s[0]:
            continue
        p1, p2 = p1s[0], p2s[0]
        if any(int(e) == end for e in p1.edges):
            continue  # already routed through
        # the start path must END inside the component after the entrance,
        # and the end path must BEGIN inside it (IsEndInsideComponent)
        i1 = max(i for i, e in enumerate(p1.edges) if int(e) == start)
        if any(int(g.e_end[e]) not in comp for e in p1.edges[i1:]):
            continue
        i2 = min(i for i, e in enumerate(p2.edges) if int(e) == end)
        if any(int(g.e_start[e]) not in comp for e in p2.edges[: i2 + 1]):
            continue
        # conjugate-pair guard: joining a path with its own conjugate
        if [int(g.e_conj[e]) for e in reversed(p2.edges)] == [int(e) for e in p1.edges]:
            continue
        from ..graph.dijkstra import shortest_path as _sp

        mid = _sp(
            g, int(g.e_end[start]), int(g.e_start[end]),
            shortest_path_limit, length="kmer",
        )
        if mid is not None:
            p1.edges.extend(int(x) for x in mid)
            p1.gaps.extend([0] * len(mid))
            gap0 = 0
        else:
            gap0 = g.k + 100  # BASIC_N_CNT
        p1.edges.extend(int(e) for e in p2.edges)
        p1.gaps.extend([gap0] + list(p2.gaps[1:]))
        paths.remove(p2)
        joins += 1
    return joins


def trim_cyclic_periods(g: CondensedGraph, paths: list[Path]) -> int:
    """Collapse lapped cycles to ONE period (SPAdes emits a circular
    component's sequence exactly once — plasmid `--test` asserts 9689 bp,
    not a tandem unroll; cycle handling in `path_extender.hpp` loop
    machinery + contig output).  A path whose edge sequence is a repetition
    (possibly with a partial trailing lap) of a closed p-edge cycle is cut
    to its first p edges.  Returns the number of trimmed paths."""
    trimmed = 0
    for p in paths:
        n = len(p.edges)
        if n < 2 or any(gp > 0 for gp in p.gaps):
            continue
        for per in range(1, n):
            if all(p.edges[i] == p.edges[i % per] for i in range(n)):
                # prefix must itself be a closed cycle
                if int(g.e_end[p.edges[per - 1]]) == int(g.e_start[p.edges[0]]):
                    del p.edges[per:]
                    del p.gaps[per:]
                    trimmed += 1
                break
    return trimmed


def remove_contained(g: CondensedGraph, paths: list[Path]) -> list[Path]:
    """Drop paths whose edge sequence is contained in another path (or its
    conjugate) — PEResolver overlap-removal light.

    Near-linear: occurrences are found through a first-edge position index
    instead of the all-pairs windowed scan (SPAdes deduplicates
    through a coverage map keyed by edge for the same reason,
    pe_resolver.hpp)."""
    all_tups = [(tuple(p.edges), tuple(conj_path(g, p).edges)) for p in paths]
    # first-edge -> [(path j, window start)]
    occ: dict[int, list[tuple[int, int, bool]]] = {}
    for j, (tq, tqc) in enumerate(all_tups):
        for s, e in enumerate(tq):
            occ.setdefault(int(e), []).append((j, s, False))
        for s, e in enumerate(tqc):
            occ.setdefault(int(e), []).append((j, s, True))

    keep: list[Path] = []
    for i, p in enumerate(paths):
        t = all_tups[i][0]
        contained = False
        for j, s, is_conj in occ.get(int(t[0]), ()):
            if j == i:
                continue
            tq = all_tups[j][1] if is_conj else all_tups[j][0]
            if len(t) < len(tq) or (len(t) == len(tq) and i > j):
                if tq[s : s + len(t)] == t:
                    contained = True
                    break
        if not contained:
            keep.append(p)
    return keep


def find_paths_bounded(
    g: CondensedGraph,
    v_from: int,
    v_to: int,
    max_len: int,
    max_paths: int = 64,
    max_steps: int = 8000,
) -> list[list[int]] | None:
    """Exhaustive bounded path search between two vertices
    (omnigraph::ProcessPaths / PathProcessor analog): all edge paths from
    v_from to v_to with total k-mer length <= max_len.  Returns None when the
    search budget is exhausted (SPAdes' nonzero exit code)."""
    out: list[list[int]] = []
    lens = g.edge_kmer_lengths()
    stack: list[tuple[int, int, list[int]]] = [(int(v_from), 0, [])]
    steps = 0
    while stack:
        v, dist, prefix = stack.pop()
        steps += 1
        if steps > max_steps:
            return None
        if v == v_to and prefix:
            out.append(prefix)
            if len(out) >= max_paths:
                return None
            continue
        for e in g.out_edges_of(v):
            e = int(e)
            nd = dist + int(lens[e])
            if nd <= max_len:
                stack.append((int(g.e_end[e]), nd, prefix + [e]))
    return out


def polish_paths(g: CondensedGraph, paths: list[Path], cfg: PEConfig) -> list[Path]:
    """PathPolisher (scaffolder2015/path_polisher.cpp): try to replace every
    scaffold gap with real graph edges.

    Per gap, a bounded exhaustive search connects the flanking edges; a
    unique path fills the gap with its edges (gap -> 0); multiple paths
    re-estimate the gap as the shortest connection length (FillWithBridge's
    length fix) and keep the N stretch."""
    result: list[Path] = []
    exhausted = 0
    for p in paths:
        edges: list[int] = [p.edges[0]]
        gaps: list[int] = [p.gaps[0]]
        for i in range(1, len(p.edges)):
            prev, cur, gap = edges[-1], int(p.edges[i]), int(p.gaps[i])
            adjacent = int(g.e_end[prev]) == int(g.e_start[cur])
            if gap <= 0 and adjacent:
                edges.append(cur)
                gaps.append(gap)
                continue
            found = find_paths_bounded(
                g, int(g.e_end[prev]), int(g.e_start[cur]),
                max_len=max(cfg.max_polisher_gap, gap + int(3 * cfg.is_var)),
            )
            if found is None:
                # search budget exhausted on a dense tangle — a distinct
                # signal from "no connecting path" (SPAdes'
                # PathProcessor returns a nonzero status here); the gap is
                # kept but the give-up is surfaced
                exhausted += 1
                edges.append(cur)
                gaps.append(gap)
            elif len(found) == 0:
                edges.append(cur)
                gaps.append(gap)
            elif len(found) == 1:
                for e in found[0]:
                    edges.append(int(e))
                    gaps.append(0)
                edges.append(cur)
                gaps.append(0)
            else:
                shortest = min(int(sum(g.edge_kmer_lengths()[e] for e in f)) for f in found)
                edges.append(cur)
                gaps.append(max(shortest, cfg.min_gap))
        result.append(Path(edges, gaps))
    if exhausted:
        log.warning(
            "path polisher: %d gap searches exhausted their budget "
            "(dense tangles) — N gaps kept", exhausted,
        )
    return result


def path_sequence(g: CondensedGraph, path: Path) -> str:
    """Spell the path: k-overlap concatenation; gaps become N runs; a
    negative gap -l (from the gap analyzer) means the next edge overlaps the
    running sequence by l nt and is spelled from offset l."""
    from ..core import dna

    parts: list[str] = []
    for i, e in enumerate(path.edges):
        s = g.edge_seq(int(e))
        if i == 0:
            parts.append(s)
        elif path.gaps[i] > 0:
            parts.append("N" * path.gaps[i])
            parts.append(s)
        elif path.gaps[i] < 0:
            parts.append(s[-path.gaps[i]:])
        else:
            parts.append(s[g.k :])
    return "".join(parts)


def overlap_align(s1: np.ndarray, s2: np.ndarray) -> tuple[int, int, int, int]:
    """Overlap alignment of a left flank s1 against a right flank s2
    (code arrays): the alignment must reach the END of s1 and start at the
    BEGINNING of s2 (scaffold-junction geometry; SPAdes'
    SWOverlapAnalyzer additionally supports trimmed flanks,
    `overlap_analysis.hpp` — the trim-free case covers GapDescription's
    no_trim contract that both its callers VERIFY).

    Scores +1 match / -1 mismatch / -1 indel.  Returns
    (score, overlap2, matches, aln_len) where overlap2 is the number of s2
    bases consumed (the overlap length on the right edge)."""
    n, m = len(s1), len(s2)
    if n == 0 or m == 0:
        return 0, 0, 0, 0
    NEG = -(1 << 29)
    # S[i][j]: best score aligning some suffix s1[i0:i] with s2[0:j]
    S = np.full((n + 1, m + 1), NEG, np.int32)
    tb = np.zeros((n + 1, m + 1), np.uint8)  # 0=start,1=diag,2=up(del s1),3=left(ins s2)
    S[:, 0] = 0                     # free start anywhere in s1
    S[0, 1:] = -np.arange(1, m + 1)  # leading s2 chars must be paid for
    tb[0, 1:] = 3
    for i in range(1, n + 1):
        sub = np.where(s2 == s1[i - 1], 1, -1).astype(np.int32)
        diag = S[i - 1, :-1] + sub
        up = S[i - 1, 1:] - 1
        row = np.maximum(diag, up)
        t = np.where(diag >= up, 1, 2).astype(np.uint8)
        # left transitions: with linear gap cost the best chain into column c
        # is max over c'<c of (S[c'] + c') - c — one prefix-max, no scan
        pre = np.concatenate([[np.int32(0)], row])        # S[i][0] = 0
        run = np.maximum.accumulate(pre + np.arange(m + 1, dtype=np.int32))
        left = run[:-1] - np.arange(1, m + 1, dtype=np.int32)
        t = np.where(left > row, np.uint8(3), t)
        row = np.maximum(row, left)
        S[i, 1:] = row
        tb[i, 1:] = t
    j_best = int(np.argmax(S[n, :]))
    score = int(S[n, j_best])
    # traceback for matches / length
    i, j = n, j_best
    matches = 0
    aln_len = 0
    while not (tb[i, j] == 0 and (j == 0)):
        d = tb[i, j]
        if d == 1:
            matches += int(s1[i - 1] == s2[j - 1])
            i, j = i - 1, j - 1
        elif d == 2:
            i -= 1
        elif d == 3:
            j -= 1
        else:
            break
        aln_len += 1
    return score, j_best, matches, aln_len


def analyze_gap(
    g: CondensedGraph, left: int, right: int, est_gap: int, cfg: PEConfig,
) -> int | None:
    """CompositeGapAnalyzer::FixGap (`gap_analyzer.cpp:139-162`): refine one
    scaffold junction's estimated gap between edges `left` and `right`.

    Tries the local-alignment joiner (LAGapAnalyzer::FixGap,
    `gap_analyzer.cpp:86-135`) then the Hamming joiner
    (HammingGapAnalyzer::FixGap, `gap_analyzer.cpp:31-84`).  Returns the
    refined gap — negative = overlap of that many nt — or the (possibly
    clamped) estimate when the edges are too far apart, or None when the
    estimate demands an overlap that cannot be found (the join should be
    dropped)."""
    from ..core import dna

    may_overlap = int(round(cfg.max_can_overlap * cfg.is_var))
    must_overlap = int(round(-cfg.var_coeff * cfg.is_var))
    if est_gap > may_overlap:
        return est_gap

    s1 = dna.encode(g.edge_seq(int(left)))
    s2 = dna.encode(g.edge_seq(int(right)))

    # --- LA joiner ---------------------------------------------------------
    est_overlap = -est_gap if est_gap < 0 else 0
    flank = int(round(est_overlap * 2.0)) + 30   # ESTIMATED_GAP_MULTIPLIER / GAP_ADDITIONAL_COEFFICIENT
    f1 = s1[-min(flank, len(s1)):]
    f2 = s2[:min(flank, len(s2))]
    score, ov2, matches, aln_len = overlap_align(f1, f2)
    if aln_len >= cfg.min_la_length and score > 0:
        identity = matches / max(aln_len, 1)
        if identity >= 0.9 and 0 < ov2 < len(s2):
            return -ov2
    # --- Hamming joiner ----------------------------------------------------
    max_overlap = int(cfg.basic_overlap_coeff * cfg.read_length)
    if est_gap < 0:
        max_overlap -= est_gap
    # Reference caps at g_.k() + min edge *k-mer* length = min nt length
    # (gap_analyzer.cpp:49); cap at the sequences themselves so s1[-l:] and
    # s2[:l] always have equal shape l.
    max_overlap = min(max_overlap, len(s1), len(s2))
    min_overlap = 1
    if est_gap < 0:
        min_overlap = max(min_overlap, int(round(0.05 * -est_gap)))
    best_score, fixed = cfg.min_gap_score, None
    for l in range(max_overlap, min_overlap - 1, -1):
        sc = float(np.mean(s1[-l:] == s2[:l]))
        if sc > best_score:
            best_score, fixed = sc, -l
        if l == cfg.short_overlap and fixed is not None:
            break
    if fixed is not None:
        return fixed
    if est_gap < must_overlap:
        return None          # unreliable: demanded a big overlap, none found
    return max(est_gap, cfg.artificial_gap)


def refine_scaffold_gaps(
    g: CondensedGraph, paths: list[Path], cfg: PEConfig
) -> list[Path]:
    """Run the composite gap analyzer over every scaffold N-gap
    (ScaffoldingPathExtender consults MakeGapAnalyzer at join time,
    `extenders_logic.cpp:93-115`; here the refinement runs as a scaffold
    post-pass).  Junctions whose join is rejected split the scaffold."""
    out: list[Path] = []
    for p in paths:
        cur_edges, cur_gaps = [p.edges[0]], [p.gaps[0]]
        for i in range(1, len(p.edges)):
            gap = int(p.gaps[i])
            e_prev, e_cur = int(cur_edges[-1]), int(p.edges[i])
            if gap > 0 and int(g.e_end[e_prev]) != int(g.e_start[e_cur]):
                fixed = analyze_gap(g, e_prev, e_cur, gap, cfg)
                if fixed is None:
                    out.append(Path(cur_edges, cur_gaps))
                    cur_edges, cur_gaps = [e_cur], [0]
                    continue
                gap = fixed
            cur_edges.append(e_cur)
            cur_gaps.append(gap)
        out.append(Path(cur_edges, cur_gaps))
    return out


def trim_end_overlaps(g: CondensedGraph, paths: list[Path]) -> int:
    """End-overlap removal (`pe_resolver.hpp:34` RemoveOverlaps): when the
    edge-suffix of one path equals the edge-prefix of another (in either
    orientation), trim the shared run from the END of the first path so the
    sequence is emitted exactly once.  Containments are handled separately
    by `remove_contained`.  Mutates paths in place; returns trimmed-edge
    count."""
    if len(paths) < 2:
        return 0
    # index: first edge -> [(path j, conj?)], built once; entries are
    # re-validated against the CURRENT path state before use (an earlier
    # trim of path j's end moves its conjugate's first edge — acting on the
    # stale entry would delete the shared run from BOTH paths)
    first: dict[int, list[tuple[int, bool]]] = {}
    for j, p in enumerate(paths):
        if p.edges:
            first.setdefault(int(p.edges[0]), []).append((j, False))
            first.setdefault(int(g.e_conj[p.edges[-1]]), []).append((j, True))
    trimmed = 0
    for i, p in enumerate(paths):
        n = len(p.edges)
        if n < 2:
            continue
        # longest proper suffix of p that is a prefix of some other path
        best_t = 0
        for s in range(1, n):          # suffix start (never the whole path)
            e = int(p.edges[s])
            for j, is_conj in first.get(e, ()):  # noqa: B007
                if j == i:
                    continue
                q = conj_path(g, paths[j]).edges if is_conj else paths[j].edges
                if not q or int(q[0]) != e:
                    continue           # stale index entry (j was trimmed)
                t = n - s
                if len(q) >= t and all(
                    int(p.edges[s + x]) == int(q[x]) for x in range(t)
                ) and all(p.gaps[s + x] <= 0 for x in range(1, t)):
                    best_t = t
                    break
            if best_t:
                break
        if best_t:
            del p.edges[n - best_t:]
            del p.gaps[n - best_t:]
            trimmed += best_t
    return trimmed


def path_to_string(g: CondensedGraph, path: Path) -> str:
    """Spell a path as SPAdes' .paths record line: oriented canonical
    edge ids, ';' before gap-separated runs (bidirectional_path_io)."""
    parts: list[str] = []
    for i, e in enumerate(path.edges):
        can = min(int(e), int(g.e_conj[e]))
        tok = f"{can}{'+' if int(e) == can else '-'}"
        if i > 0 and path.gaps[i] > 0:
            parts.append(";\n" + tok)
        elif i > 0:
            parts.append("," + tok)
        else:
            parts.append(tok)
    return "".join(parts)


def write_paths(path_file: str, named_paths, g: CondensedGraph) -> None:
    """Write contigs.paths/scaffolds.paths: name line + path line, plus the
    conjugate record (name') as SPAdes does."""
    with open(path_file, "w") as fh:
        for name, p in named_paths:
            fh.write(f"{name}\n{path_to_string(g, p)}\n")
            fh.write(f"{name}'\n{path_to_string(g, conj_path(g, p))}\n")


def path_coverage(g: CondensedGraph, path: Path) -> float:
    lens = np.array([g.e_len[e] - g.k for e in path.edges], float)
    covs = g.coverage()[np.array(path.edges, np.int64)]
    return float((lens * covs).sum() / max(lens.sum(), 1.0))


def scaffold_paths(
    g: CondensedGraph, pi: PairedIndex, paths: list[Path], cfg: PEConfig
) -> list[Path]:
    """Join paths whose ends are linked by pair info with an estimated gap."""
    if not paths:
        return paths
    first_edge = {}
    for i, p in enumerate(paths):
        first_edge.setdefault(p.edges[0], i)
        first_edge.setdefault(int(g.e_conj[p.edges[-1]]), ~i)  # conj start

    joined: list[Path] = []
    consumed = [False] * len(paths)
    for i, p in enumerate(paths):
        if consumed[i]:
            continue
        cur = Path(list(p.edges), list(p.gaps))
        while True:
            last = cur.edges[-1]
            e2s, ds, ws = pi.pairs_from(int(last))
            if e2s.size == 0:
                break
            # candidate links: to first edges of other paths, in either
            # orientation — a link landing on conj(q.last) joins cur with
            # conj(q) (SPAdes' paths are conjugate pairs, so both
            # orientations are legal join targets, pe_resolver semantics)
            best_j, best_w, best_gap, best_conj = None, 0.0, 0, False
            for e2, d, w in zip(e2s, ds, ws):
                j = first_edge.get(int(e2))
                if j is None:
                    continue
                jj, is_conj = (j, False) if j >= 0 else (~j, True)
                if jj == i or consumed[jj]:
                    continue
                gap = int(d) - (int(g.e_len[last]) - g.k)
                if not (-g.k < gap <= cfg.max_gap):
                    continue
                if w > best_w:
                    best_j, best_w, best_gap, best_conj = jj, float(w), gap, is_conj
            if best_j is None or best_w < cfg.scaffold_min_weight:
                break
            q = paths[best_j]
            if best_conj:
                q = conj_path(g, q)
            cur.edges += list(q.edges)
            cur.gaps += [max(best_gap, cfg.min_gap)] + list(q.gaps[1:])
            consumed[best_j] = True
        joined.append(cur)
        consumed[i] = True
    return joined


def build_scaffold_graph_2015(
    g: CondensedGraph,
    pi: PairedIndex,
    min_edge_length: int = 500,
    min_weight: float = 2.0,
):
    """Mate-pair scaffold graph over long unique edges.

    The scaffolder2015 construction (`modules/path_extend/scaffolder2015/
    scaffold_graph_constructor.hpp` + `connection_condition2015.hpp`):
    scaffold vertices are oriented long edges, a scaffold edge (e1 -> e2)
    aggregates the mate-pair support weight; links below `min_weight` are
    dropped and only the max-weight link per ordered pair is kept."""
    from ..aux_graphs.scaffold_graph import ScaffoldGraph

    lens = g.edge_kmer_lengths()
    long_edge = np.zeros(len(g.e_start), bool)
    ids = g.alive_edge_ids()
    long_edge[ids[lens[ids] >= min_edge_length]] = True

    sg = ScaffoldGraph()
    for e in np.flatnonzero(long_edge):
        sg.add_vertex(int(e))
    keep = long_edge[pi.e1] & long_edge[pi.e2] & (pi.e1 != pi.e2)
    if keep.any():
        # aggregate weight per (e1, e2) over all distances
        key = pi.e1[keep] * np.int64(len(g.e_start)) + pi.e2[keep]
        order = np.argsort(key)
        k_s = key[order]
        w_s = pi.weight[keep][order]
        first = np.concatenate([[True], k_s[1:] != k_s[:-1]])
        gid = np.cumsum(first) - 1
        w_sum = np.zeros(int(gid[-1]) + 1)
        np.add.at(w_sum, gid, w_s)
        uniq = k_s[first]
        e1u = (uniq // len(g.e_start)).astype(np.int64)
        e2u = (uniq % len(g.e_start)).astype(np.int64)
        ok = w_sum >= min_weight
        sg.add_edges(e1u[ok], e2u[ok], w_sum[ok])
        sg.dedup()
    return sg


def scaffold_with_graph_2015(
    g: CondensedGraph, sg, paths: list[Path], cfg: PEConfig,
    default_gap: int = 100, relative_cutoff: float = 2.0,
) -> list[Path]:
    """Join paths along scaffold-graph links.

    A link is used when it is unambiguous (source scaffold out-degree 1 and
    target in-degree 1) OR when its weight dominates every competing link
    from the same source / into the same target by `relative_cutoff` — the
    SPAdes' relative-weight connection discipline for ambiguous links
    (`scaffolder2015/connection_condition2015.hpp` WeightDistCondition +
    the coordinated-extension ratio check in extension_chooser.hpp)."""
    if sg.num_edges == 0 or not paths:
        return paths
    path_by_first = {p.edges[0]: i for i, p in enumerate(paths)}
    path_by_last = {p.edges[-1]: i for i, p in enumerate(paths)}

    # per-source and per-target links sorted by weight
    by_src: dict[int, list[tuple[float, int]]] = {}
    by_dst: dict[int, list[tuple[float, int]]] = {}
    for s, d, w in zip(sg.src, sg.dst, sg.weight):
        by_src.setdefault(int(s), []).append((float(w), int(d)))
        by_dst.setdefault(int(d), []).append((float(w), int(s)))

    def dominant(links: list[tuple[float, int]]):
        """The single usable link out of a fan, or None if ambiguous."""
        if len(links) == 1:
            return links[0][1]
        links = sorted(links, reverse=True)
        return links[0][1] if links[0][0] >= relative_cutoff * links[1][0] else None

    next_of: dict[int, int] = {}
    for s, links in by_src.items():
        d = dominant(links)
        if d is None or dominant(by_dst[d]) != s:
            continue
        i = path_by_last.get(s)
        j = path_by_first.get(d)
        if i is not None and j is not None and i != j:
            next_of[i] = j

    has_prev = set(next_of.values())
    joined: list[Path] = []
    consumed = [False] * len(paths)
    for i in range(len(paths)):
        if consumed[i] or i in has_prev:
            continue
        cur = Path(list(paths[i].edges), list(paths[i].gaps))
        consumed[i] = True
        j = next_of.get(i)
        while j is not None and not consumed[j]:
            q = paths[j]
            cur.edges += list(q.edges)
            cur.gaps += [default_gap] + list(q.gaps[1:])
            consumed[j] = True
            j = next_of.get(j)
        joined.append(cur)
    for i in range(len(paths)):
        if not consumed[i]:
            joined.append(paths[i])
    return joined
