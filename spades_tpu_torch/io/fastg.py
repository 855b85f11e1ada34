"""FASTG assembly-graph writer.

Capability mirror of SPAdes' FASTG output
(`src/common/io/graph/fastg_writer.hpp`): every oriented edge
becomes a record `>EDGE_<id>_length_<l>_cov_<c>[:<successors>];` where the
successor list names the adjacent oriented edges (conjugate orientation
carries a trailing apostrophe), followed by the edge nucleotide sequence.
"""
from __future__ import annotations

from ..graph.graph import CondensedGraph


def _fastg_name(g: CondensedGraph, e: int, cov) -> str:
    """EDGE_<id>_length_<l>_cov_<c>, with ' for conjugate orientation."""
    can = min(e, int(g.e_conj[e]))
    name = f"EDGE_{can}_length_{int(g.e_len[e])}_cov_{cov[can]:.6f}"
    return name + ("'" if e != can else "")


def write_fastg(path: str, g: CondensedGraph, width: int = 60) -> None:
    cov = g.coverage()
    by_start: dict[int, list[int]] = {}
    for e in g.alive_edge_ids():
        e = int(e)
        by_start.setdefault(int(g.e_start[e]), []).append(e)
    with open(path, "w") as fh:
        for e in sorted(int(x) for x in g.alive_edge_ids()):
            succs = sorted(by_start.get(int(g.e_end[e]), []))
            head = _fastg_name(g, e, cov)
            if succs:
                head += ":" + ",".join(_fastg_name(g, s, cov) for s in succs)
            fh.write(f">{head};\n")
            seq = g.edge_seq(e)
            for i in range(0, len(seq), width):
                fh.write(seq[i : i + width] + "\n")
