"""The graph of the ladder's first K against the reads' (k+1)-mers.

The first K's graph is built from the reads alone (`--cov-cutoff off`: no
(k+1)-mer is dropped), so its edges must hold every canonical (k+1)-mer of
the reads, each once, and no other, and each edge's coverage sum must be the
sum of its (k+1)-mers' counts in the reads.  The reference counts the reads'
(k+1)-mers itself; from the program it reads only the graph's edge arrays,
copied when Construction returned at the first K.

Readings:
  k1_kmers_off  (k+1)-mers in the reads and not in the graph, in the graph
                and not in the reads, or held twice by the graph
  k1_cov_off    edges whose coverage sum differs from the reads' counts
"""
from __future__ import annotations

import numpy as np

from . import kmers as R

NEEDS = ("first_graph",)


def _edge_windows(g: dict, k1: int, edges: np.ndarray):
    """Canonical keys of every (k+1)-window of the given edges, and the edge
    each belongs to."""
    off, ln = g["e_off"][edges], g["e_len"][edges]
    nwin = np.maximum(ln - k1 + 1, 0)
    starts = np.repeat(off, nwin) + (np.arange(int(nwin.sum())) - np.repeat(np.cumsum(nwin) - nwin, nwin))
    keys, ok = R.window_keys(g["seq_pool"], k1)
    return keys[starts], ok[starts], np.repeat(np.arange(len(edges)), nwin)


def readings(job: dict, sample: dict, traffic: dict) -> dict:
    g = job.get("first_graph")
    first_k = int(traffic["first_k"])
    reads = np.concatenate([sample["r1"], sample["r2"]])
    ref_keys, ref_counts = R.count_reads(reads, first_k + 1)
    if g is None or int(g["k"]) != first_k:
        return {"k1_kmers_off": float(len(ref_keys)), "k1_cov_off": float(len(ref_keys))}
    k1 = first_k + 1
    alive = np.flatnonzero(g["alive"])
    conj = g["e_conj"][alive]
    # one of each conjugate pair; a self-conjugate edge holds each of its
    # (k+1)-mers twice (once per strand) unless the (k+1)-mer is its own
    # reverse complement
    own = alive[alive <= conj]
    keys, ok, edge_of = _edge_windows(g, k1, own)
    selfc = g["e_conj"][own] == own
    in_self = selfc[edge_of]
    uniq_self = np.unique(keys[in_self])
    all_keys = np.concatenate([keys[~in_self], uniq_self])
    held, times = np.unique(all_keys, return_counts=True)
    twice = int((times - 1).sum()) + int((~ok).sum())
    only_ref = int((~R.member(held, ref_keys)).sum())
    only_graph = int((~R.member(ref_keys, held)).sum())
    # coverage: the sum of the counts of each edge's (k+1)-mers
    at = np.minimum(np.searchsorted(ref_keys, keys), max(len(ref_keys) - 1, 0))
    cnt = np.where(ref_keys[at] == keys, ref_counts[at], 0) if len(ref_keys) else np.zeros(len(keys), np.int64)
    want = np.bincount(edge_of, weights=cnt.astype(np.float64), minlength=len(own))
    got = g["e_cov"][own].astype(np.float64)
    cov_off = int((np.abs(got - want) > 0.5).sum())
    return {"k1_kmers_off": float(only_ref + only_graph + twice), "k1_cov_off": float(cov_off)}
