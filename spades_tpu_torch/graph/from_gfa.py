"""Rebuild a CondensedGraph from a parsed GFA file.

Covers SPAdes' GFA reader + LoadGraph stage surface
(`src/common/io/graph/gfa_reader.hpp:35`,
`src/projects/spades/load_graph.cpp`): segments become conjugate edge pairs,
links glue edge endpoints into shared vertices (union-find over endpoint
slots, with conjugate-consistent vertex pairing).

Host numpy, as in `spades_tpu.graph.from_gfa`: the union order of the DSU
decides the vertex ids, so it is the JAX package's statement for statement.
`read_gfa` ignores the header line, the one line in which the two packages'
GFA files differ, so a file written by either loads to the same graph.
"""
from __future__ import annotations

import numpy as np

from ..core import dna
from ..io.gfa import GfaGraph
from .graph import CondensedGraph


class _DSU:
    def __init__(self, n: int):
        self.p = list(range(n))

    def find(self, x: int) -> int:
        while self.p[x] != x:
            self.p[x] = self.p[self.p[x]]
            x = self.p[x]
        return x

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[ra] = rb


def graph_from_gfa(gg: GfaGraph, k: int) -> CondensedGraph:
    names = sorted(gg.segments)
    E = 2 * len(names)  # oriented edges: 2i = '+', 2i+1 = '-'
    name2i = {n: i for i, n in enumerate(names)}

    seqs: list[np.ndarray] = []
    for n in names:
        fwd = dna.encode(gg.segments[n])
        seqs.append(fwd)
        seqs.append(dna.revcomp_codes(fwd))

    def oid(name: str, orient: str) -> int:
        return 2 * name2i[name] + (0 if orient == "+" else 1)

    def conj(e: int) -> int:
        return e ^ 1

    # endpoint slots: slot 2e = start of edge e, slot 2e+1 = end of edge e
    dsu = _DSU(2 * E)

    def s_in(e: int) -> int:
        return 2 * e

    def s_out(e: int) -> int:
        return 2 * e + 1

    for a, o1, b, o2, ov in gg.links:
        if a not in name2i or b not in name2i:
            continue
        # The flat-k graph model requires every L-line overlap to equal k
        # (vertices ARE k-overlaps).  SPAdes' graph core carries
        # per-vertex explicit/complex overlap links instead
        # (assembly_graph/core/debruijn_data.hpp:31-42 OverlapKind /
        # OverlapStorage) and can ingest mixed-overlap GFA; here that is a
        # typed user error rather than silent corruption.
        if ov not in (None, 0, k):  # 0 = '*' (unspecified) — assume k
            from ..utils.errors import ExitCode, SpadesError

            raise SpadesError(
                f"GFA link {a}{o1} -> {b}{o2} has overlap {ov} != k={k}: "
                "variable-overlap (multiplex) GFA is not representable in "
                "the flat-k graph model — re-export the graph with uniform "
                f"{k}M overlaps or load at the k matching the L-line "
                "overlaps",
                ExitCode.INVALID_INPUT_FORMAT,
            )
        ea, eb = oid(a, o1), oid(b, o2)
        dsu.union(s_out(ea), s_in(eb))
        # conjugate link
        dsu.union(s_out(conj(eb)), s_in(conj(ea)))

    roots = {}
    slot_class = np.zeros(2 * E, np.int64)
    for s in range(2 * E):
        r = dsu.find(s)
        if r not in roots:
            roots[r] = len(roots)
        slot_class[s] = roots[r]
    V = len(roots)

    e_start = slot_class[2 * np.arange(E)]
    e_end = slot_class[2 * np.arange(E) + 1]
    # vertex conjugation: class(start of e) <-> class(end of conj(e))
    v_conj = -np.ones(V, np.int64)
    for e in range(E):
        v_conj[e_start[e]] = e_end[conj(e)]
        v_conj[e_end[e]] = e_start[conj(e)]
    assert np.all(v_conj >= 0)
    assert np.array_equal(v_conj[v_conj], np.arange(V)), "GFA vertex conj broken"

    lens = np.array([len(s) for s in seqs], np.int64)
    e_off = np.concatenate([[0], np.cumsum(lens)])[:-1].astype(np.int64)
    pool = np.concatenate(seqs) if seqs else np.zeros(0, np.uint8)
    cov = np.zeros(E, np.float64)
    for n in names:
        c = gg.seg_cov.get(n, 0.0)
        i = name2i[n]
        # e_cov stores the coverage *sum* over (k+1)-mer positions
        span = max(len(gg.segments[n]) - k, 1)
        cov[2 * i] = cov[2 * i + 1] = c * span

    e_conj = np.arange(E) ^ 1
    g = CondensedGraph(
        k=k,
        e_start=e_start, e_end=e_end, e_conj=e_conj,
        e_off=e_off, e_len=lens, e_cov=cov,
        alive=np.ones(E, bool), seq_pool=pool,
        v_conj=v_conj,
    )
    return g
