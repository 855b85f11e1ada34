"""online_vis equivalent: interactive REPL graph debugger over saves.

Reference: SPAdes `src/projects/online_vis/main.cpp:40`
(`debruijn_online_visualizer.hpp` command surface): load a saved graph and
inspect it interactively — vertex/edge queries, neighborhood DOT drawing,
basic stats.  Host code: it needs no card.

    python -m spades_tpu_torch.tools.online_vis g.gfa -k 55     (or a saves/ .npz)
"""
from __future__ import annotations

import os
import sys

from .common import check_odd_k, make_parser, setup

HELP = """commands:
  stats                    graph summary (edges, total length, coverage)
  edge <id>                details of one edge
  seq <id> [n]             first n (default 80) nt of an edge sequence
  out <vertex> / in <vertex>   adjacent edges of a vertex
  draw <file.dot> [edge]   DOT dump (optionally the component of one edge)
  contigs <n>              top-n longest edges
  help                     this text
  exit / quit
"""


def _load(path: str, k: int):
    if path.endswith(".gfa"):
        from ..graph.from_gfa import graph_from_gfa
        from ..io.gfa import read_gfa

        return graph_from_gfa(read_gfa(path), k)
    from ..graph.serialize import load_graph

    return load_graph(path)


def repl(g, out=sys.stdout, inp=sys.stdin) -> None:
    import numpy as np

    cov = g.coverage()
    print(f"loaded graph: {len(g.canonical_edge_ids())} segments, k={g.k}", file=out)
    while True:
        print("> ", end="", file=out, flush=True)
        line = inp.readline()
        if not line:
            break
        t = line.split()
        if not t:
            continue
        cmd = t[0]
        try:
            if cmd in ("exit", "quit"):
                break
            elif cmd == "help":
                print(HELP, file=out)
            elif cmd == "stats":
                ids = g.alive_edge_ids()
                total = int(g.e_len[ids].sum()) // 2
                print(
                    f"{len(g.canonical_edge_ids())} segments, {total} nt total, "
                    f"median cov {np.median(cov[ids]):.1f}",
                    file=out,
                )
            elif cmd == "edge":
                e = int(t[1])
                print(
                    f"edge {e}: len={int(g.e_len[e])} cov={cov[e]:.2f} "
                    f"start=v{int(g.e_start[e])} end=v{int(g.e_end[e])} "
                    f"conj={int(g.e_conj[e])} alive={bool(g.alive[e])}",
                    file=out,
                )
            elif cmd == "seq":
                e = int(t[1])
                n = int(t[2]) if len(t) > 2 else 80
                print(g.edge_seq(e)[:n], file=out)
            elif cmd == "out":
                print(list(map(int, g.out_edges_of(int(t[1])))), file=out)
            elif cmd == "in":
                print(list(map(int, g.in_edges_of(int(t[1])))), file=out)
            elif cmd == "draw":
                from ..graph.dot import write_dot

                write_dot(t[1], g)
                print(f"wrote {t[1]}", file=out)
            elif cmd == "contigs":
                n = int(t[1]) if len(t) > 1 else 10
                ids = sorted(
                    (int(e) for e in g.canonical_edge_ids()),
                    key=lambda e: -int(g.e_len[e]),
                )[:n]
                for e in ids:
                    print(f"  edge {e}: {int(g.e_len[e])} nt, cov {cov[e]:.1f}", file=out)
            else:
                print(f"unknown command '{cmd}' (try help)", file=out)
        except (ValueError, IndexError) as exc:
            print(f"error: {exc}", file=out)


def main(argv=None) -> int:
    p = make_parser("spades_tpu_torch-online-vis", __doc__.split("\n")[0])
    p.add_argument("graph", help="saved graph (.npz from saves/) or GFA")
    args = p.parse_args(argv)
    setup(args)
    check_odd_k(args.kmer)
    g = _load(args.graph, args.kmer)
    repl(g)
    return 0


if __name__ == "__main__":
    sys.exit(main())
