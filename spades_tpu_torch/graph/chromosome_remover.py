"""plasmidSPAdes chromosome removal.

Capability mirror of SPAdes' `ChromosomeRemover`
(`src/common/modules/chromosome_remover.cpp`:
`RemoveLongGenomicEdges` :101 computes the length-weighted median coverage of
long edges and deletes long edges whose coverage falls inside the chromosomal
median band; `PlasmidSimplify` :182 then clears the debris; finally only
circular / small components survive as plasmid candidates).

Host numpy, as in `spades_tpu.graph.chromosome_remover`: the passes are mask
rewrites over the flat edge arrays (no observer bus); component analysis is a
union-find over edge endpoints, whose union order fixes the component order
and so the names and order of the metaplasmid component contigs."""
from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from .graph import CondensedGraph

log = logging.getLogger("spades_tpu_torch.chromosome_remover")


@dataclass
class PlasmidConfig:
    long_edge_length: int = 1000      # plasmid_config.long_edge_length analog
    relative_coverage: float = 0.3    # coverage_limits band around the median
    small_component_size: int = 10000  # keep small components regardless
    min_component_length: int = 150   # drop dust


def _components(g: CondensedGraph) -> dict[int, list[int]]:
    """Connected components over alive edges (undirected via vertices)."""
    parent = np.arange(g.num_vertices, dtype=np.int64)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for e in g.alive_edge_ids():
        a, b = find(int(g.e_start[e])), find(int(g.e_end[e]))
        if a != b:
            parent[b] = a
        # keep conjugate strands in one component
        c, d = find(int(g.e_start[g.e_conj[e]])), find(a)
        if c != d:
            parent[c] = d
    comps: dict[int, list[int]] = {}
    for e in g.alive_edge_ids():
        comps.setdefault(find(int(g.e_start[e])), []).append(int(e))
    return comps


def weighted_median_coverage(g: CondensedGraph, long_edge_length: int) -> float:
    """Length-weighted median coverage over long edges
    (CoverageUniformityAnalyzer::CountMedianCoverage)."""
    ids = g.alive_edge_ids()
    lens = g.e_len[ids]
    long_ids = ids[lens >= long_edge_length]
    if long_ids.size == 0:
        return 0.0
    cov = g.coverage()[long_ids]
    w = g.e_len[long_ids].astype(float)
    order = np.argsort(cov)
    cum = np.cumsum(w[order])
    half = cum[-1] / 2
    return float(cov[order][np.searchsorted(cum, half)])


def remove_chromosomal(g: CondensedGraph, cfg: PlasmidConfig | None = None) -> int:
    """Remove chromosomal edges/components; returns #edges removed.

    Keeps components that are circular (no dead ends) or small — the plasmid
    candidates plasmidSPAdes outputs."""
    cfg = cfg or PlasmidConfig()
    removed = 0

    # phase 1: RemoveLongGenomicEdges — long edges in the chromosomal band.
    # A long edge inside a SMALL (< 300 kb) connected component with zero
    # dead ends is spared: that is a circular plasmid-shaped component, the
    # very thing being extracted (chromosome_remover.cpp:147-149).
    for _ in range(10):
        med = weighted_median_coverage(g, cfg.long_edge_length)
        if med <= 0:
            break
        ids = g.alive_edge_ids()
        lens = g.e_len[ids]
        cov = g.coverage()[ids]
        band = (
            (lens >= cfg.long_edge_length)
            & (cov >= med * (1 - cfg.relative_coverage))
            & (cov <= med * (1 + cfg.relative_coverage))
        )
        if band.any():
            in_deg = g.in_degrees()
            out_deg = g.out_degrees()
            spare = np.zeros(len(ids), bool)
            edge_pos = {int(e): i for i, e in enumerate(ids)}
            for _root, edges in _components(g).items():
                verts = set()
                total = 0
                for e in edges:
                    verts.add(int(g.e_start[e]))
                    verts.add(int(g.e_end[e]))
                    total += int(g.e_len[e])
                dead = sum(
                    1 for v in verts if in_deg[v] == 0 or out_deg[v] == 0
                )
                if total < 300_000 and dead == 0:
                    for e in edges:
                        if e in edge_pos:
                            spare[edge_pos[e]] = True
            band &= ~spare
        victims = ids[band]
        if victims.size == 0:
            break
        removed += g.kill_edges(victims)

    # phase 2: keep only circular or small components (plasmid candidates)
    in_deg = g.in_degrees()
    out_deg = g.out_degrees()
    for _root, edges in _components(g).items():
        verts = set()
        total = 0
        for e in edges:
            verts.add(int(g.e_start[e]))
            verts.add(int(g.e_end[e]))
            total += int(g.e_len[e])
        circular = all(in_deg[v] > 0 and out_deg[v] > 0 for v in verts)
        if circular and total >= cfg.min_component_length:
            continue
        if total <= cfg.small_component_size and total >= cfg.min_component_length and circular:
            continue
        if not circular:
            removed += g.kill_edges(np.array(edges, np.int64))
    log.info("chromosome removal: %d edges removed", removed)
    return removed


def metaplasmid_iteration(
    g: CondensedGraph, ext_limit: float, cfg: PlasmidConfig | None = None
) -> tuple[list[tuple[str, str]], int]:
    """One metaplasmid/metaviral extraction round at coverage cutoff
    `ext_limit` (ChromosomeRemover with ext_limit_, `modules/
    chromosome_remover.cpp:283-397`): emit uniform components whose coverage
    clears the cutoff (OutputSuspiciousComponents naming
    `CUTOFF_<c>_COMPONENT_<n>_...`), then strip edges below the cutoff and
    drop dust components (RemoveNearlyEverythingByCoverage +
    FilterSmallComponents).  Returns (component contigs, edges removed)."""
    cfg = cfg or PlasmidConfig()
    cov = g.coverage()
    lens = g.edge_kmer_lengths()
    out: list[tuple[str, str]] = []
    comp_count = 0
    var = 0.3
    for comp in _components(g).values():
        total_len = int(sum(lens[e] for e in comp))
        if not (1000 <= total_len <= 200000):
            continue
        avg = float(sum(cov[e] * lens[e] for e in comp) / max(total_len, 1))
        if avg < ext_limit * 1.3:
            continue  # coverage too close to the current cutoff
        good_len = int(sum(lens[e] for e in comp if abs(cov[e] - avg) <= var * avg))
        if good_len < 0.8 * total_len:
            continue  # coverage too variable across the component
        comp_count += 1
        count = 1
        for e in comp:
            if int(g.e_conj[e]) < e:
                continue
            name = (f"CUTOFF_{int(ext_limit)}_COMPONENT_{comp_count}_EDGE_{count}"
                    f"_length_{int(lens[e])}_cov_{cov[e]:.6f}_id_{e}")
            out.append((name, g.edge_seq(int(e))))
            count += 1
    # strip everything below the cutoff, then dust
    kill = [int(e) for e in g.alive_edge_ids() if cov[e] < ext_limit]
    removed = g.kill_edges(np.array(kill, np.int64)) if kill else 0
    for comp in _components(g).values():
        total_len = int(sum(g.edge_kmer_lengths()[e] for e in comp))
        if total_len < cfg.min_component_length:
            removed += g.kill_edges(np.array(comp, np.int64))
    return out, removed
