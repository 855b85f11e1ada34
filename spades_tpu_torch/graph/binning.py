"""Metagenomic bin refinement by label propagation over the assembly graph.

Capability mirror of BinSPreader
(SPAdes `src/projects/binspreader/labels_propagation.cpp`,
`binning_refiner.cpp:163`; docs `docs/binspreader.md`): contig bin labels are
diffused over assembly-graph adjacencies until convergence, unlabelled edges
adopt the stationary distribution, and the refined (optionally multi-bin)
assignment is written back.

Host numpy, as in the JAX package: the per-edge bin distribution is a
dense (E, B) matrix and one propagation sweep is a gather plus `np.add.at`
in index order, so the float64 sums and the bins equal the reference's.
The state is edges x bins (tens of thousands by a handful), too small for
the card to gain anything; the reads that feed the link index map on the
device (`tools/binspreader.py`)."""
from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from .graph import CondensedGraph

log = logging.getLogger("spades_tpu_torch.binning")


@dataclass
class BinningConfig:
    eps: float = 1e-5          # convergence threshold (labels_propagation)
    max_iters: int = 100
    alpha: float = 0.6         # neighbor mass vs initial label mass
    multi_bin_threshold: float = 0.35  # secondary assignment cutoff


def _adjacency(g: CondensedGraph) -> tuple[np.ndarray, np.ndarray]:
    """Undirected adjacency pairs (a, b) of alive edges sharing a vertex,
    conjugate-aware (an edge is adjacent to the neighbors of both strands)."""
    pairs = set()
    by_vertex: dict[int, list[int]] = {}
    for e in g.alive_edge_ids():
        e = int(e)
        for v in (int(g.e_start[e]), int(g.e_end[e])):
            by_vertex.setdefault(v, []).append(e)
    canon = {int(e): min(int(e), int(g.e_conj[e])) for e in g.alive_edge_ids()}
    for _v, edges in by_vertex.items():
        for i in range(len(edges)):
            for j in range(i + 1, len(edges)):
                a, b = canon[edges[i]], canon[edges[j]]
                if a != b:
                    pairs.add((a, b))
                    pairs.add((b, a))
    if not pairs:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    arr = np.array(sorted(pairs), np.int64)
    return arr[:, 0], arr[:, 1]


def propagate_labels(
    g: CondensedGraph,
    initial: dict[int, int],
    n_bins: int,
    cfg: BinningConfig | None = None,
) -> np.ndarray:
    """Diffuse bin labels; returns (E, n_bins) probabilities (canonical ids).

    `initial` maps canonical edge id -> bin id for the labelled subset."""
    cfg = cfg or BinningConfig()
    E = len(g.e_start)
    state = np.zeros((E, n_bins))
    labelled = np.zeros(E, bool)
    for e, b in initial.items():
        state[e, b] = 1.0
        labelled[e] = True
    init = state.copy()
    src, dst = _adjacency(g)
    deg = np.zeros(E)
    np.add.at(deg, dst, 1.0)
    deg = np.maximum(deg, 1.0)
    for it in range(cfg.max_iters):
        nbr = np.zeros_like(state)
        np.add.at(nbr, dst, state[src])
        nbr /= deg[:, None]
        new = cfg.alpha * nbr + (1 - cfg.alpha) * init
        # labelled edges keep pulling toward their assignment, unlabelled ones
        # follow the neighborhood only
        new[~labelled] = nbr[~labelled]
        norm = new.sum(axis=1, keepdims=True)
        nz = norm[:, 0] > 0
        new[nz] /= norm[nz]
        delta = float(np.abs(new - state).max()) if E else 0.0
        state = new
        if delta < cfg.eps:
            log.info("label propagation converged after %d iterations", it + 1)
            break
    return state


def refine_binning(
    g: CondensedGraph,
    binning: dict[str, str],
    segment_names: dict[str, int],
    cfg: BinningConfig | None = None,
    multi: bool = False,
) -> dict[str, list[str]]:
    """Refine a (contig name -> bin name) assignment.  Returns name -> bins.

    `segment_names` maps GFA segment name -> canonical edge id."""
    cfg = cfg or BinningConfig()
    bin_names = sorted(set(binning.values()))
    bin_idx = {b: i for i, b in enumerate(bin_names)}
    initial = {}
    for name, b in binning.items():
        e = segment_names.get(name)
        if e is not None:
            initial[e] = bin_idx[b]
    state = propagate_labels(g, initial, len(bin_names), cfg)
    out: dict[str, list[str]] = {}
    for name, e in segment_names.items():
        p = state[e]
        if p.sum() <= 0:
            continue
        if multi:
            chosen = [bin_names[i] for i in np.flatnonzero(p >= cfg.multi_bin_threshold)]
            if not chosen:
                chosen = [bin_names[int(p.argmax())]]
        else:
            chosen = [bin_names[int(p.argmax())]]
        out[name] = chosen
    return out


# ---------------------------------------------------------------------------
# Link index (Hi-C / paired-end links between edges), assignment strategies,
# alpha propagation, read splitting — the deeper BinSPreader surface
# (SPAdes `src/projects/binspreader/{link_index.cpp,
# binning_assignment_strategy.cpp, majority_length_strategy.cpp,
# max_likelihood_strategy.cpp, alpha_propagation.cpp, read_splitting.cpp}`).
# ---------------------------------------------------------------------------


@dataclass
class LinkIndex:
    """Symmetric weighted edge-edge links (canonical ids), unique pairs."""

    src: np.ndarray   # (L,) int64
    dst: np.ndarray   # (L,) int64
    weight: np.ndarray  # (L,) float64

    @property
    def num_links(self) -> int:
        return int(self.src.size) // 2


def mapped_edges(mappings) -> np.ndarray:
    """(n,) int64 oriented edge of each read, -1 where unmapped, from a list
    of `ReadMapping | None` or an edge array as `MappingEngine.map_store`
    returns it."""
    if isinstance(mappings, np.ndarray):
        return mappings.astype(np.int64, copy=False)
    return np.fromiter((-1 if m is None else int(m.edge) for m in mappings), np.int64,
                       count=len(mappings))


def build_link_index(g: CondensedGraph, m1, m2) -> LinkIndex:
    """Accumulate links from mate mappings (`paired_end.cpp` FillPairedEndLinks:
    every mapped pair whose mates land on different canonical edges adds
    weight 1 to the symmetric link).  m1, m2: the mates' mappings (see
    `mapped_edges`); one vectorized pass where the JAX package loops over
    the pairs, with the same unique pairs and weights."""
    n = min(len(m1), len(m2))
    x, y = mapped_edges(m1)[:n], mapped_edges(m2)[:n]
    ok = (x >= 0) & (y >= 0)
    e1 = np.minimum(x[ok], g.e_conj[x[ok]])
    e2 = np.minimum(y[ok], g.e_conj[y[ok]])
    diff = e1 != e2
    a = np.minimum(e1, e2)[diff].astype(np.int64)
    b = np.maximum(e1, e2)[diff].astype(np.int64)
    if not a.size:
        z = np.zeros(0, np.int64)
        return LinkIndex(z, z.copy(), np.zeros(0))
    key = a * np.int64(len(g.e_start)) + b
    uniq, cnt = np.unique(key, return_counts=True)
    e1u = uniq // len(g.e_start)
    e2u = uniq % len(g.e_start)
    w = cnt.astype(float)
    return LinkIndex(
        src=np.concatenate([e1u, e2u]),
        dst=np.concatenate([e2u, e1u]),
        weight=np.concatenate([w, w]),
    )


def propagate_labels_linked(
    g: CondensedGraph,
    initial: dict[int, int],
    n_bins: int,
    links: LinkIndex | None = None,
    alpha: np.ndarray | None = None,
    cfg: BinningConfig | None = None,
) -> np.ndarray:
    """Label propagation over graph adjacency PLUS the weighted link index,
    with an optional PER-EDGE alpha (the alpha-propagation correction):
    new = alpha_e * nbr + (1 - alpha_e) * init for labelled edges."""
    cfg = cfg or BinningConfig()
    E = len(g.e_start)
    state = np.zeros((E, n_bins))
    labelled = np.zeros(E, bool)
    for e, b in initial.items():
        state[e, b] = 1.0
        labelled[e] = True
    init = state.copy()
    src, dst = _adjacency(g)
    w = np.ones(len(src))
    if links is not None and links.src.size:
        src = np.concatenate([src, links.src])
        dst = np.concatenate([dst, links.dst])
        w = np.concatenate([w, links.weight])
    deg = np.zeros(E)
    np.add.at(deg, dst, w)
    deg = np.maximum(deg, 1.0)
    a_vec = np.full(E, cfg.alpha) if alpha is None else np.asarray(alpha, float)
    for it in range(cfg.max_iters):
        nbr = np.zeros_like(state)
        np.add.at(nbr, dst, state[src] * w[:, None])
        nbr /= deg[:, None]
        new = a_vec[:, None] * nbr + (1 - a_vec[:, None]) * init
        new[~labelled] = nbr[~labelled]
        norm = new.sum(axis=1, keepdims=True)
        nz = norm[:, 0] > 0
        new[nz] /= norm[nz]
        delta = float(np.abs(new - state).max()) if E else 0.0
        state = new
        if delta < cfg.eps:
            log.info("linked label propagation converged after %d iterations", it + 1)
            break
    return state


def assign_bins(
    state: np.ndarray, strategy: str = "majority_length", thr: float = 0.35,
) -> list[set[int]]:
    """Per-edge bin assignment from soft probabilities.

    majority_length (`majority_length_strategy.cpp`): every bin tied at the
    maximum probability; empty when all-zero.  max_likelihood
    (`max_likelihood_strategy.cpp`): every bin above `thr`."""
    out: list[set[int]] = []
    for p in state:
        if strategy == "max_likelihood":
            out.append(set(np.flatnonzero(p > thr).tolist()))
        else:
            m = p.max()
            out.append(set() if m <= 0 else set(np.flatnonzero(p >= m - 1e-12).tolist()))
    return out


def assign_scaffold_bins(
    path_edges: list[int],
    edge_bins: list[set[int]],
    state: np.ndarray,
    lens: np.ndarray,
    n_bins: int,
    strategy: str = "majority_length",
    thr: float = 0.35,
) -> np.ndarray:
    """Length-weighted scaffold bin vector (AssignScaffoldBins of both
    strategies): majority_length weights each assigned bin by edge length;
    max_likelihood weights by length * probability and cuts at thr."""
    res = np.zeros(n_bins)
    total = 0
    for e in path_edges:
        bins = edge_bins[e]
        if not bins:
            continue
        L = int(lens[e])
        if strategy == "max_likelihood":
            for b in bins:
                res[b] += L * state[e, b]
            total += L
        else:
            for b in bins:
                res[b] += L
                total += L
    if total:
        res /= total
    if strategy == "max_likelihood":
        res[res <= thr] = 0.0
    return res


def alpha_mask(
    g: CondensedGraph,
    binned: set[int],
    links: LinkIndex | None = None,
    length_threshold: int = 5000,
    distance_bound: int = 10000,
    metaalpha: float = 0.6,
    cfg: BinningConfig | None = None,
) -> np.ndarray:
    """Alpha-propagation correction (`alpha_propagation.cpp` GetAlphaMask):
    dilate the binned set over short edges within a distance bound, run a
    binary BINNED/UNBINNED propagation, and return the per-edge final alpha
    = metaalpha * P(binned) — edges far from any binned region get their
    label-retention damped."""
    cfg = cfg or BinningConfig()
    E = len(g.e_start)
    # dilation: BFS from binned-edge endpoints along edges <= length_threshold
    # accumulating nt distance, within distance_bound
    from collections import deque

    dist: dict[int, int] = {}
    q: deque = deque()
    for e in binned:
        for v in (int(g.e_end[e]), int(g.e_start[e])):
            if v not in dist:
                dist[v] = 0
                q.append(v)
    dilated = set(binned)
    out_of = {}
    for e in g.alive_edge_ids():
        out_of.setdefault(int(g.e_start[e]), []).append(int(e))
    while q:
        v = q.popleft()
        for e in out_of.get(v, ()):  # noqa: B007
            L = int(g.e_len[e])
            if L > length_threshold:
                continue
            dilated.add(min(e, int(g.e_conj[e])))
            nd = dist[v] + L
            u = int(g.e_end[e])
            if nd <= distance_bound and (u not in dist or dist[u] > nd):
                dist[u] = nd
                q.append(u)
    initial = {}
    for e in g.alive_edge_ids():
        ce = min(int(e), int(g.e_conj[e]))
        initial[ce] = 0 if ce in dilated else 1   # 0=BINNED, 1=UNBINNED
    state = propagate_labels_linked(g, initial, 2, links=links, cfg=cfg)
    return metaalpha * state[:, 0]


def split_reads(
    g: CondensedGraph, mappings, edge_bins: list[set[int]]
) -> dict[int, list[int]]:
    """Read splitting (`read_splitting.cpp`): route every read to the bin of
    its mapped edge.  Returns bin id -> read indices (reads mapping to
    multi-bin or unbinned edges are dropped, as the reference only emits
    confidently-assigned reads).  `mappings` as for `build_link_index`."""
    edge = mapped_edges(mappings)
    only = np.array([next(iter(b)) if len(b) == 1 else -1 for b in edge_bins], np.int64)
    rows = np.flatnonzero(edge >= 0)
    b = only[np.minimum(edge[rows], g.e_conj[edge[rows]])]
    rows, b = rows[b >= 0], b[b >= 0]
    out: dict[int, list[int]] = {}
    for bin_id in np.unique(b).tolist():
        out[bin_id] = rows[b == bin_id].tolist()
    return out
