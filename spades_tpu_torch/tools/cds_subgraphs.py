"""cds-subgraphs equivalent: extract graph neighborhoods around query CDSes.

Reference: SPAdes `src/projects/cds_subgraphs/cds_subgraphs.cpp`
(docs: MAG improvement — given CDS sequences of interest, cut out the
assembly-subgraph around each so the gene context can be reassembled or
inspected): map each query onto the graph, take the bounded-radius
neighborhood of the matched edges, write one GFA per query.  The queries
map on `--device` (the CUDA card unless `--device cpu` is given) through the
device index of the graph (`MappingEngine.map_sequences`), however few they
are: a handful of CDSes costs no host index of the whole graph.

    python -m spades_tpu_torch.tools.cds_subgraphs g.gfa cds.fa -k 55 -w out [--device cpu]
"""
from __future__ import annotations

import os
import sys

from .common import check_odd_k, make_parser, setup


def _neighborhood(g, seeds: set[int], radius_nt: int) -> set[int]:
    """Edges reachable from the seed set within radius_nt of sequence."""
    out = set(seeds)
    frontier = [(e, 0) for e in seeds]
    while frontier:
        e, d = frontier.pop()
        for v in (int(g.e_end[e]), int(g.e_start[e])):
            for nxt in list(g.out_edges_of(v)) + list(g.in_edges_of(v)):
                nxt = int(nxt)
                nd = d + int(g.e_len[nxt])
                if nxt not in out and nd <= radius_nt:
                    out.add(nxt)
                    out.add(int(g.e_conj[nxt]))
                    frontier.append((nxt, nd))
    return out


def main(argv=None) -> int:
    p = make_parser("spades_tpu_torch-cds-subgraphs", __doc__.split("\n")[0])
    p.add_argument("gfa", help="assembly graph (GFA 1.x)")
    p.add_argument("queries", help="CDS sequences (FASTA)")
    p.add_argument("--radius", type=int, default=2000, help="neighborhood radius (nt)")
    args = p.parse_args(argv)
    setup(args)
    check_odd_k(args.kmer)

    from .. import resolve_device
    from ..alignment.mapper import MappingEngine
    from ..graph.from_gfa import graph_from_gfa
    from ..io.fastx import read_fastx
    from ..io.gfa import read_gfa, write_gfa

    dev = resolve_device(args.device)
    g = graph_from_gfa(read_gfa(args.gfa), args.kmer)
    recs = list(read_fastx(args.queries))
    edges = MappingEngine(g, device=dev).map_sequences([r.seq for r in recs])[0]
    os.makedirs(args.workdir, exist_ok=True)
    n_written = 0
    for rec, edge in zip(recs, edges.tolist()):
        if edge < 0:
            print(f"{rec.name}: no graph hit")
            continue
        seeds = {edge, int(g.e_conj[edge])}
        comp = _neighborhood(g, seeds, args.radius)
        # subgraph view: clone with only the component edges alive
        import copy

        sub = copy.deepcopy(g)
        alive = sub.alive.copy()
        alive[:] = False
        alive[list(comp)] = True
        sub.alive = alive & g.alive
        out = os.path.join(args.workdir, f"{rec.name.split()[0]}.gfa")
        write_gfa(out, sub)
        n_written += 1
        print(f"{rec.name}: {len(comp)//2} segments -> {out}")
    print(f"{n_written}/{len(recs)} subgraphs written")
    return 0


if __name__ == "__main__":
    sys.exit(main())
