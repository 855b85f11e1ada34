"""Contig extraction and FASTA naming.

Naming follows SPAdes (`src/common/io/reads/header_naming.hpp:15-24`):
`NODE_<n>_length_<len>_cov_<cov>` with contigs ordered by decreasing length.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..graph.graph import CondensedGraph
from .fastx import write_fasta


@dataclass
class Contig:
    name: str
    seq: str
    coverage: float
    edge_id: int


def extract_contigs(g: CondensedGraph, min_length: int = 0) -> list[Contig]:
    """One contig per conjugate edge pair, ordered by decreasing length."""
    ids = g.canonical_edge_ids()
    cov = g.coverage()
    order = sorted(ids, key=lambda e: (-int(g.e_len[e]), int(e)))
    contigs = []
    n = 0
    for e in order:
        L = int(g.e_len[e])
        if L < min_length:
            continue
        n += 1
        c = float(cov[e])
        contigs.append(
            Contig(
                name=f"NODE_{n}_length_{L}_cov_{c:.6f}",
                seq=g.edge_seq(int(e)),
                coverage=c,
                edge_id=int(e),
            )
        )
    return contigs


def write_contigs(path: str, contigs: list[Contig]) -> None:
    write_fasta(path, [(c.name, c.seq) for c in contigs])


def break_scaffolds(records, threshold: int = 3):
    """Split scaffold sequences at runs of >= threshold Ns.

    Mirror of the outer pipeline's breaking-scaffolds step
    (`src/projects/spades/pipeline/spades_pipeline/supplemetary/
    breaking_scaffolds_script.py` + `support.py:428-453`,
    THRESHOLD_FOR_BREAKING_SCAFFOLDS=3): each piece keeps the scaffold name
    with a `_<n>` suffix.  `records` is (name, seq) pairs; returns
    (modified, [(name, seq), ...])."""
    out = []
    modified = False
    for name, seq in records:
        base = name.split()[0]
        rest = " ".join(name.split()[1:])
        piece = 1
        start = 0
        i = 0
        while i < len(seq):
            j = seq.find("N", i)
            if j < 0:
                break
            end = j
            while end < len(seq) and seq[end] == "N":
                end += 1
            if end - j >= threshold:
                modified = True
                if start != j:
                    nm = f"{base}_{piece}" + (f" {rest}" if rest else "")
                    out.append((nm, seq[start:j]))
                    piece += 1
                start = end
            i = end + 1
        if start < len(seq):
            nm = f"{base}_{piece}" + (f" {rest}" if rest else "")
            out.append((nm, seq[start:]))
    return modified, out
