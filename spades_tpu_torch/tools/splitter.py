"""SPlitteR equivalent: barcode-guided repeat resolution of an assembly graph.

Reference: SPAdes `src/projects/splitter/main.cpp:336` — resolves
complex vertices (indegree >= 2 and outdegree >= 2) of a GFA assembly graph
using linked-read / synthetic-long-read barcode clouds (`BC:Z:`/`BX:Z:` read
tags), splits resolved vertices, merges the resulting unambiguous paths, and
writes the transformed graph plus a per-vertex resolution report.

Modes mirror the reference (`-Mdiploid` default, `-Mmeta` with trusted
contig links from GFA paths and optional metaFlye `assembly_info.txt`
repetitive-edge annotations, `main.cpp:174-254`).  The reads map on
`--device` (the CUDA card unless `--device cpu` is given) through the
device index of the graph at `--mapping-k` (`aux_graphs/barcode_index.py`);
vertex resolution and path merging are host code.

    python -m spades_tpu_torch.tools.splitter g.gfa reads.fq -k 55 --mapping-k 31 -w out
        [--device cpu]
"""
from __future__ import annotations

import os
import sys

from .common import check_inputs_exist, make_parser, setup


def _collect_barcoded_reads(source: str) -> list[tuple[str, str]]:
    """Reads with names from a dataset YAML or a FASTA/FASTQ file."""
    from ..io.fastx import read_fastx

    files: list[str] = []
    if source.endswith((".yaml", ".yml")):
        import yaml

        with open(source) as fh:
            data = yaml.safe_load(fh)
        for entry in data or []:
            for key in ("left reads", "right reads", "single reads", "interlaced reads"):
                files += entry.get(key, [])
    else:
        files = [source]
    reads: list[tuple[str, str]] = []
    for f in files:
        for rec in read_fastx(f):
            reads.append((rec.name, rec.seq))
    return reads


def _parse_repetitive_edges(path: str, name2edge: dict[str, int], conj) -> set[int]:
    """metaFlye assembly_info.txt -> repetitive edge ids (main.cpp:174-213)."""
    rep: set[int] = set()
    with open(path) as fh:
        header = fh.readline()
        for line in fh:
            f = line.split()
            if len(f) < 8:
                continue
            is_repeat, graph_path = f[4], f[7]
            if is_repeat != "Y":
                continue
            for tok in graph_path.split(","):
                tok = tok.strip()
                if tok in ("", "*"):
                    continue
                num = tok.lstrip("-")
                for cand in (f"edge_{num}", num):
                    if cand in name2edge:
                        e = name2edge[cand]
                        rep.add(e)
                        rep.add(conj(e))
                        break
    return rep


def _trusted_links_from_paths(gg, name2edge: dict[str, int], conj, repetitive: set[int]):
    """Consecutive non-repetitive GFA-path edges become trusted links
    (GetTrustedContigLinks, main.cpp:228-254)."""
    links: dict[int, set[int]] = {}
    for _, path_str in gg.paths:
        edges = []
        for seg in path_str.split(","):
            seg = seg.strip()
            if not seg:
                continue
            name, orient = seg[:-1], seg[-1]
            if name not in name2edge:
                continue
            e = name2edge[name] if orient == "+" else conj(name2edge[name])
            if e not in repetitive:
                edges.append(e)
        for a, b in zip(edges, edges[1:]):
            links.setdefault(a, set()).add(b)
            links.setdefault(conj(b), set()).add(conj(a))
    return links


def main(argv=None) -> int:
    p = make_parser("spades_tpu_torch-splitter", __doc__.split("\n")[0])
    p.add_argument("gfa", help="assembly graph (GFA 1.x)")
    p.add_argument("reads", help="SLR library: dataset YAML or FASTA/FASTQ with BX:Z:/BC:Z: tags")
    p.add_argument("--mapping-k", type=int, default=31, help="k for read mapping")
    p.add_argument("--frame-size", type=int, default=40000, help="barcode index resolution")
    p.add_argument("--tail-threshold", type=int, default=200000,
                   help="cloud tail length considered at edge ends")
    p.add_argument("--count-threshold", type=int, default=1,
                   help="min reads per (edge, barcode) entry")
    p.add_argument("--score", type=float, default=2.0, help="link score threshold")
    p.add_argument("--rel-threshold", type=float, default=2.0,
                   help="relative score threshold for ambiguity")
    p.add_argument("--mode", choices=("diploid", "meta"), default="diploid")
    p.add_argument("--assembly-info", default=None,
                   help="metaFlye assembly_info.txt (meta mode)")
    p.add_argument("--length-threshold", type=int, default=2000,
                   help="min scaffold-graph edge length (meta mode)")
    p.set_defaults(kmer=55)  # reference default k=55 (main.cpp gcfg)
    args = p.parse_args(argv)
    setup(args)
    check_inputs_exist([args.gfa, args.reads])

    from .. import resolve_device
    from ..aux_graphs.barcode_index import build_barcode_index
    from ..aux_graphs.vertex_resolver import (
        VertexState, extract_paths, merge_paths, resolve_vertices,
    )
    from ..graph.from_gfa import graph_from_gfa
    from ..io.gfa import read_gfa, write_gfa

    dev = resolve_device(args.device)
    gg = read_gfa(args.gfa)
    g = graph_from_gfa(gg, args.kmer)
    names = sorted(gg.segments)
    name2edge = {n: 2 * i for i, n in enumerate(names)}
    conj = lambda e: int(g.e_conj[e])
    print(f"graph: {g.num_edges} edges, {g.num_vertices} vertices")

    reads = _collect_barcoded_reads(args.reads)
    bindex = build_barcode_index(
        g, reads, mapping_k=args.mapping_k, frame_size=args.frame_size,
        device=dev,
    )
    print(f"barcode index: {bindex.num_entries} (edge, barcode) entries, "
          f"{bindex.num_barcodes} barcodes from {len(reads)} reads")

    trusted: dict[int, set[int]] = {}
    if args.mode == "meta":
        repetitive: set[int] = set()
        if args.assembly_info:
            repetitive = _parse_repetitive_edges(args.assembly_info, name2edge, conj)
            print(f"{len(repetitive)} repetitive edges from assembly info")
        trusted = _trusted_links_from_paths(gg, name2edge, conj, repetitive)

    results = resolve_vertices(
        g, bindex, trusted,
        count_threshold=args.count_threshold,
        tail_threshold=args.tail_threshold,
        score_threshold=args.score,
        rel_threshold=args.rel_threshold,
    )
    counts = {s: 0 for s in VertexState}
    for r in results.values():
        counts[r.state] += 1
    for s in VertexState:
        print(f"{counts[s]} {s.value.lower()} vertices")

    os.makedirs(args.workdir, exist_ok=True)
    # per-vertex report (PrintVertexResults columns, vertex_resolver.hpp:173)
    with open(os.path.join(args.workdir, "vertex_results.tsv"), "w") as out:
        out.write("Vertex Id\tInDegree\tInEdges\tOutDegree\tOutEdges\tVertex result"
                  "\tSupported paths\tTotal links\tAnswer links\tAnswer\n")
        for v, r in sorted(results.items()):
            ins = g.in_edges_of(v)
            outs = g.out_edges_of(v)
            answer = ",".join(f"{i}#{o}" for i, o in sorted(r.supported_pairs.items()))
            out.write(
                f"{v}\t{len(ins)}\t{','.join(map(str, ins))}\t{len(outs)}\t"
                f"{','.join(map(str, outs))}\t{r.state.value}\t"
                f"{len(r.supported_pairs)}\t{r.total_score:.0f}\t"
                f"{r.supporting_score:.0f}\t{answer}\n"
            )

    paths = extract_paths(g, results)
    # per-link overlaps from the GFA (variable-overlap / multiplexed dBG):
    # default k, overridden by explicit L-record CIGARs
    link_ov: dict[tuple[int, int], int] = {}
    for a, o1, b, o2, ov in gg.links:
        if a in name2edge and b in name2edge and ov:
            ea = name2edge[a] if o1 == "+" else conj(name2edge[a])
            eb = name2edge[b] if o2 == "+" else conj(name2edge[b])
            link_ov[(ea, eb)] = ov
            link_ov[(conj(eb), conj(ea))] = ov
    resolved, edge_map = merge_paths(g, paths, link_ov)
    write_gfa(os.path.join(args.workdir, "resolved_graph.gfa"), resolved)
    with open(os.path.join(args.workdir, "resolved_paths.fasta"), "w") as out:
        for i, path in enumerate(paths):
            e = edge_map[path[0]]
            seq = resolved.edge_seq(e)
            out.write(f">path_{i}_length_{len(seq)}_edges_{len(path)}\n{seq}\n")
    print(f"{len(paths)} resolved paths -> {args.workdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
