"""GFA v1.1/v1.2 assembly-graph writer and reader.

Mirrors SPAdes' GFA I/O surface
(`src/common/io/graph/gfa_writer.hpp:24,39-54` and `gfa_reader.hpp:35`):
segments are conjugate edge pairs (one S-record per pair, orientation via
+/-), links record k-overlap adjacencies with `<k>M` CIGAR overlaps, and path
records carry contig paths.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..graph.graph import CondensedGraph


def _segment_names(g: CondensedGraph) -> dict[int, tuple[str, str]]:
    """edge id -> (segment name, orientation). Conjugate pairs share a name."""
    names: dict[int, tuple[str, str]] = {}
    for e in g.canonical_edge_ids():
        e = int(e)
        ec = int(g.e_conj[e])
        names[e] = (str(e), "+")
        if ec != e:
            names[ec] = (str(e), "-")
    return names


def write_gfa(
    path: str,
    g: CondensedGraph,
    paths: list[tuple[str, list[int]]] | None = None,
    scaffold_paths: list[tuple[str, object]] | None = None,
    version: str = "1.2",
) -> None:
    """Write the graph as GFA v1.1/v1.2 (gfa_writer.cpp + GFAPathWriter,
    bidirectional_path_output.cpp:79-166).

    S per conjugate pair (DP:f: average coverage, KC:i: raw k-mer count),
    L per adjacency with <k>M overlap.

    paths: simple (name, [edge ids]) records — one P-line each, `*` overlaps.
    scaffold_paths: (name, Path) records with per-position gaps; under v1.1
    each scaffold is split at gaps into `name_<segment>` P-lines, under v1.2
    a J-line (jump link, SC:i:1) is emitted per gap junction and the single
    P-line separates gap-adjacent segments with ';' (the cfg.gfa11 switch of
    contig_output_stage.cpp:158).
    """
    if version not in ("1.1", "1.2"):
        raise ValueError(f"unsupported GFA version {version}")
    names = _segment_names(g)
    cov = g.coverage()
    k = g.k

    def estr(e: int) -> str:
        n, o = names[int(e)]
        return n + o

    from .. import __version__

    with open(path, "w") as fh:
        # SPAdes' header is `H\tsp:Z:<flavour>-<package>`
        # (gfa_writer.cpp:113-116); the GFA-spec VN tag is kept as well so
        # the requested version is observable.  Every line but this one is
        # byte-identical to `spades_tpu.io.gfa.write_gfa` on the same graph.
        fh.write(f"H\tVN:Z:{version}\tsp:Z:spades-tpu-torch-{__version__}\n")
        for e in g.canonical_edge_ids():
            e = int(e)
            name, _ = names[e]
            seq = g.edge_seq(e)
            # DP:f: is `<< float(cov)` in SPAdes (gfa_writer.cpp
            # WriteSegment): 32-bit float through default ostream precision
            # (6 significant digits, general format)
            dp = f"{float(np.float32(cov[e])):.6g}"
            fh.write(
                f"S\t{name}\t{seq}\tDP:f:{dp}\tKC:i:{int(round(g.e_cov[e]))}\n"
            )
        # links: for every vertex, each incoming edge connects to each
        # outgoing edge with a k-overlap
        by_start: dict[int, list[int]] = {}
        by_end: dict[int, list[int]] = {}
        for e in g.alive_edge_ids():
            e = int(e)
            by_start.setdefault(int(g.e_start[e]), []).append(e)
            by_end.setdefault(int(g.e_end[e]), []).append(e)
        seen = set()
        for v in sorted(by_end):
            for ein in by_end[v]:
                for eout in by_start.get(v, []):
                    n1, o1 = names[ein]
                    n2, o2 = names[eout]
                    # the conjugate of a link is implied by GFA semantics;
                    # emit each undirected link once
                    conj_key = (names[int(g.e_conj[eout])], names[int(g.e_conj[ein])])
                    key = ((n1, o1), (n2, o2))
                    if conj_key in seen:
                        continue
                    seen.add(key)
                    fh.write(f"L\t{n1}\t{o1}\t{n2}\t{o2}\t{k}M\n")
        if paths:
            for pname, edge_list in paths:
                segs = ",".join(estr(e) for e in edge_list)
                fh.write(f"P\t{pname}\t{segs}\t*\n")
        if scaffold_paths:
            if version == "1.2":
                # WriteJumpLinks (bidirectional_path_output.cpp:98-112):
                # deduplicated, sorted by edge pair
                def is_jump(p, i):
                    # gap or topological discontinuity (WritePaths12: EdgeEnd
                    # != EdgeStart || gap > 0)
                    return p.gaps[i] > 0 or (
                        g.e_end[int(p.edges[i - 1])] != g.e_start[int(p.edges[i])]
                    )

                jumps: set[tuple[int, int]] = set()
                for _n, p in scaffold_paths:
                    for i in range(1, len(p.edges)):
                        if is_jump(p, i):
                            jumps.add((int(p.edges[i - 1]), int(p.edges[i])))
                for e1, e2 in sorted(jumps):
                    n1, o1 = names[e1]
                    n2, o2 = names[e2]
                    fh.write(f"J\t{n1}\t{o1}\t{n2}\t{o2}\t*\tSC:i:1\n")
                for pname, p in scaffold_paths:
                    if not p.edges:
                        continue
                    parts = [estr(p.edges[0])]
                    for i in range(1, len(p.edges)):
                        parts.append(";" if is_jump(p, i) else ",")
                        parts.append(estr(p.edges[i]))
                    fh.write(f"P\t{pname}\t{''.join(parts)}\t*\n")
            else:
                # WritePaths11: split the scaffold at gaps into name_<seg>
                for pname, p in scaffold_paths:
                    if not p.edges:
                        continue
                    seg_id, run = 1, [estr(p.edges[0])]
                    for i in range(1, len(p.edges)):
                        if p.gaps[i] > 0 or (
                            g.e_end[int(p.edges[i - 1])] != g.e_start[int(p.edges[i])]
                        ):
                            fh.write(f"P\t{pname}_{seg_id}\t{','.join(run)}\t*\n")
                            seg_id += 1
                            run = []
                        run.append(estr(p.edges[i]))
                    fh.write(f"P\t{pname}_{seg_id}\t{','.join(run)}\t*\n")


@dataclass
class GfaGraph:
    """Parsed GFA: segments + links (host-side)."""

    segments: dict[str, str] = field(default_factory=dict)     # name -> seq
    seg_cov: dict[str, float] = field(default_factory=dict)
    links: list[tuple[str, str, str, str, int]] = field(default_factory=list)
    paths: list[tuple[str, str]] = field(default_factory=list)
    jumps: list[tuple[str, str, str, str]] = field(default_factory=list)  # J records (v1.2)


def read_gfa(path: str) -> GfaGraph:
    out = GfaGraph()
    with open(path) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if not f or not f[0]:
                continue
            if f[0] == "S":
                out.segments[f[1]] = f[2]
                dp = kc = None
                for tag in f[3:]:
                    if tag.startswith(("DP:f:", "dp:f:")):
                        dp = float(tag[5:])
                    elif tag.startswith("KC:i:"):
                        kc = float(tag[5:]) / max(len(f[2]), 1)
                if dp is not None:
                    out.seg_cov[f[1]] = dp
                elif kc is not None:
                    out.seg_cov[f[1]] = kc
            elif f[0] == "L":
                ov = int(f[5].rstrip("M")) if len(f) > 5 and f[5] not in ("*", "") else 0
                out.links.append((f[1], f[2], f[3], f[4], ov))
            elif f[0] == "P":
                out.paths.append((f[1], f[2]))
            elif f[0] == "J":
                out.jumps.append((f[1], f[2], f[3], f[4]))
    return out
