"""DOT graph printer for developer-mode pictures.

Capability mirror of the reference's visualization surface
(SPAdes `src/common/visualization/*`: DOT printers with edge
colorers/labelers used by picture dumps and online_vis): emits a Graphviz
digraph of the condensed graph with length/coverage labels; edges are colored
by coverage band (the reference's default colorer semantics)."""
from __future__ import annotations

from .graph import CondensedGraph


def _color(cov: float, low: float, high: float) -> str:
    if cov <= low:
        return "red"        # suspicious / erroneous coverage
    if cov >= high:
        return "blue"       # repeat-like high coverage
    return "black"


def write_dot(
    path: str,
    g: CondensedGraph,
    low_cov: float = 2.0,
    high_cov: float = 1e9,
    max_label_len: int = 12,
) -> None:
    cov = g.coverage()
    with open(path, "w") as fh:
        fh.write("digraph assembly {\n  node [shape=circle,fontsize=9];\n")
        for e in sorted(int(x) for x in g.alive_edge_ids()):
            label = f"id{e} len={int(g.e_len[e])} cov={cov[e]:.1f}"
            seq = g.edge_seq(e)
            if len(seq) <= max_label_len:
                label += f" {seq}"
            fh.write(
                f'  v{int(g.e_start[e])} -> v{int(g.e_end[e])} '
                f'[label="{label}",color={_color(float(cov[e]), low_cov, high_cov)}];\n'
            )
        fh.write("}\n")
