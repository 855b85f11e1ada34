"""Flanking coverage index: per-edge coverage of the leading k-mers.

Capability mirror of SPAdes' FlankingCoverage
(`src/common/assembly_graph/graph_support/detail_coverage.hpp:22-174`):
each edge stores the raw coverage SUM over its first
`min(length, averaging_range)` (k+1)-mers; `CoverageOfStart(e)` is that sum
averaged, and `CoverageOfEnd(e) = CoverageOfStart(conjugate(e))` by strand
symmetry (:82-88).  `LocalCoverage(e, v)` picks the flank touching vertex v
— the signal the relative-coverage component remover and the EC loop remover
consult instead of whole-edge averages
(`modules/simplification/relative_coverage_remover.hpp:240-249`,
`erroneous_connection_remover.hpp:320,376-380`).

Note SPAdes' tip-clip RelativeCoverageTipCondition itself still uses
whole-edge competitor coverage (`tip_clipper.hpp:21` carries the TODO); the
flanking signal enters through the relative-coverage machinery.

Build is one vectorized pass: leading windows of every alive edge are packed
and canonicalized on host, looked up in the sorted (k+1)-mer count table
(the PHMCoverageFiller role, `stages/construction.cpp:371-435`), and
segment-summed per edge.

`FlankingTable` keeps the index up to date across a simplification loop
instead of rebuilding it: an edge's sum depends only on its sequence and the
fixed table, so `carry` moves every sum that `compress` leaves valid onto the
new edge ids, and `refresh` computes only the edges whose leading windows are
new.  With a device it looks them up there (the canonical-windows kernel over
the edges' prefixes, `device_searchsorted_rows` in the table's key planes,
uploaded once); without one, on the host as `build_flanking` does.  Either
way the sums equal a fresh `build_flanking`'s.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import kmers as K
from ..utils.timetracer import span
from .graph import CondensedGraph

DEFAULT_AVERAGING_RANGE = 50  # cfg flanking_range (config.info simp defaults)


@dataclass
class FlankingCoverage:
    averaging_range: int
    raw: np.ndarray  # (E,) float64: coverage sum over leading window

    def cov_of_start(self, g: CondensedGraph, e) -> np.ndarray | float:
        lens = np.minimum(g.edge_kmer_lengths()[e], self.averaging_range)
        return self.raw[e] / np.maximum(lens, 1)

    def cov_of_end(self, g: CondensedGraph, e) -> np.ndarray | float:
        return self.cov_of_start(g, g.e_conj[e])

    def local_coverage(self, g: CondensedGraph, e: int, v: int) -> float:
        """Flank of e at vertex v (LocalCoverage :240)."""
        if int(g.e_start[e]) == int(v):
            return float(self.cov_of_start(g, e))
        return float(self.cov_of_end(g, e))


def _host_sums(g: CondensedGraph, ids: np.ndarray, p1_words: np.ndarray,
               p1_counts: np.ndarray, averaging_range: int) -> np.ndarray:
    """Raw flank sums of edges `ids` on the host: (len(ids),) float64."""
    from ..ops.count import searchsorted_rows
    from ..ops.extension import canonicalize

    k1 = g.k + 1
    # leading min(len_kmers, range) (k+1)-mer windows per edge, flattened
    nw = np.minimum(g.edge_kmer_lengths()[ids], averaging_range).astype(np.int64)
    total = int(nw.sum())
    seg = np.repeat(np.arange(ids.size), nw)
    ends = np.cumsum(nw)
    within = np.arange(total) - (ends - nw)[seg]
    base = g.e_off[ids][seg] + within
    win = g.seq_pool[base[:, None] + np.arange(k1)[None, :]]
    words = K.pack(win)
    canon, _ = canonicalize(words, k1)
    pos = searchsorted_rows(p1_words, canon)
    cnt = np.where(pos >= 0, p1_counts[np.maximum(pos, 0)], 0).astype(np.float64)
    raw = np.zeros(ids.size, np.float64)
    np.add.at(raw, seg, cnt)
    return raw


def build_flanking(
    g: CondensedGraph,
    p1_words: np.ndarray,
    p1_counts: np.ndarray,
    averaging_range: int = DEFAULT_AVERAGING_RANGE,
) -> FlankingCoverage:
    """Fill raw flanking sums from the sorted canonical (k+1)-mer table."""
    E = g.alive.shape[0]
    raw = np.zeros(E, np.float64)
    ids = g.alive_edge_ids()
    if ids.size == 0 or p1_words.shape[0] == 0:
        return FlankingCoverage(averaging_range, raw)
    raw[ids] = _host_sums(g, ids, p1_words, p1_counts, averaging_range)
    return FlankingCoverage(averaging_range, raw)


# edges whose prefixes one launch of the canonical-windows kernel takes
DEVICE_EDGES = 65536


class FlankingTable:
    """A flanking index kept up to date over one graph's simplification.

    p1_words / p1_counts: the sorted canonical (k+1)-mer table.  device: a
    torch device to look the windows up on (the table's key planes go there
    at the first refresh and stay for this object's life), or None for the
    host.  `refresh(g)` returns `build_flanking(g, ...)`'s index, computing
    only the edges it holds no sum for; `carry(old, new, heads, n_arcs)`
    moves the sums across a `compress` of `old` into `new`."""

    def __init__(self, p1_words: np.ndarray, p1_counts: np.ndarray,
                 averaging_range: int = DEFAULT_AVERAGING_RANGE, device=None):
        self.words, self.counts = p1_words, p1_counts
        self.averaging_range = averaging_range
        self.device = device
        self._keys = self._cnt = None
        # raw sums of the edges of `_graph` (NaN: not known)
        self._graph = None
        self._raw = None

    @property
    def path(self) -> str:
        return "host" if self.device is None else "device"

    def carry(self, old: CondensedGraph, new: CondensedGraph, heads: np.ndarray,
              n_arcs: np.ndarray) -> None:
        """`new` is `compress(old)`, whose edge i starts with old edge
        `heads[i]` and merges `n_arcs[i]` old edges.  Its leading windows are
        the head's where it merged nothing or the head holds them all."""
        if old is not self._graph:
            self._graph = self._raw = None
            return
        klen = old.edge_kmer_lengths()[heads]
        keep = (n_arcs == 1) | (klen >= self.averaging_range)
        raw = np.full(heads.shape[0], np.nan)
        raw[keep] = self._raw[heads[keep]]
        self._graph, self._raw = new, raw

    def refresh(self, g: CondensedGraph) -> FlankingCoverage:
        """The flanking index of `g` (spans `simplification.flanking`)."""
        with span("simplification.flanking", path=self.path) as s:
            E = g.alive.shape[0]
            raw = self._raw if g is self._graph else np.full(E, np.nan)
            ids = g.alive_edge_ids()
            todo = ids[np.isnan(raw[ids])]
            windows = 0
            if todo.size:
                if self.words.shape[0] == 0:
                    raw[todo] = 0.0
                else:
                    windows = int(np.minimum(g.edge_kmer_lengths()[todo],
                                             self.averaging_range).sum())
                    raw[todo] = (_host_sums(g, todo, self.words, self.counts,
                                            self.averaging_range)
                                 if self.device is None else self._device_sums(g, todo))
            self._graph, self._raw = g, raw
            out = np.zeros(E, np.float64)
            out[ids] = raw[ids]
            s.set(edges=int(ids.size), windows=windows, recomputed=int(todo.size))
        return FlankingCoverage(self.averaging_range, out)

    def _device_sums(self, g: CondensedGraph, ids: np.ndarray) -> np.ndarray:
        """`_host_sums` on the device: each edge's first min(len, range) + k
        bases are one row of a batch for the canonical-windows kernel, whose
        keys are looked up in the table's key planes and summed per row."""
        import torch

        from ..core.reads import ReadBatch
        from ..ops.cuda_kernels import canonical_window_keys
        from ..ops.extension import keys_to_device
        from ..parallel.sharded_mapping import device_searchsorted_rows

        dev = torch.device(self.device)
        if self._keys is None:
            self._keys = keys_to_device(self.words, dev)
            self._cnt = torch.from_numpy(np.ascontiguousarray(self.counts, np.int64)).to(dev)
        k, k1 = g.k, g.k + 1
        nw = np.minimum(g.edge_kmer_lengths()[ids], self.averaging_range).astype(np.int64)
        out = np.empty(ids.size, np.float64)
        for a in range(0, ids.size, DEVICE_EDGES):
            sl = slice(a, a + DEVICE_EDGES)
            ln = nw[sl] + k
            L = int(ln.max())
            # the prefixes as a padded batch, gathered on the host
            pos = np.minimum(np.arange(L)[None, :], ln[:, None] - 1)
            codes = g.seq_pool[g.e_off[ids[sl]][:, None] + pos]
            batch = ReadBatch(codes=codes, lengths=ln.astype(np.int32),
                              n_mask=np.zeros(codes.shape, bool))
            pc, pn, lengths, _L = batch.packed()
            pc, pn, lengths = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                               for x in (pc, pn, lengths))
            keys, valid = canonical_window_keys(pc, pn, lengths, L, k1)
            idx = device_searchsorted_rows(self._keys, keys).reshape(valid.shape)
            hit = valid & (idx >= 0)
            cnt = torch.where(hit, self._cnt[idx.clamp(min=0).long()], 0)
            out[sl] = cnt.sum(dim=1).cpu().numpy().astype(np.float64)
        return out
