"""Paths over the condensed graph and their `.paths` records.

The part of the path-extension module (exSPAnder,
`src/common/modules/path_extend/` in SPAdes) that contig output needs: the
`Path` container (oriented edges with the gap before each), its conjugate,
and the writer of `contigs.paths` / `scaffolds.paths`
(`bidirectional_path_io`).  Seeds, extension choosers, overlap removal and
scaffolding are not here yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..graph.graph import CondensedGraph


@dataclass
class Path:
    edges: list[int]
    gaps: list[int] = field(default_factory=list)  # gap BEFORE edge i (gaps[0]=0)

    def __post_init__(self):
        if not self.gaps:
            self.gaps = [0] * len(self.edges)


def conj_path(g: CondensedGraph, path: Path) -> Path:
    edges = [int(g.e_conj[e]) for e in reversed(path.edges)]
    gaps = [0] + list(reversed(path.gaps[1:])) if len(path.gaps) > 1 else [0]
    return Path(edges, gaps)


def path_to_string(g: CondensedGraph, path: Path) -> str:
    """Spell a path as SPAdes' .paths record line: oriented canonical
    edge ids, ';' before gap-separated runs (bidirectional_path_io)."""
    parts: list[str] = []
    for i, e in enumerate(path.edges):
        can = min(int(e), int(g.e_conj[e]))
        tok = f"{can}{'+' if int(e) == can else '-'}"
        if i > 0 and path.gaps[i] > 0:
            parts.append(";\n" + tok)
        elif i > 0:
            parts.append("," + tok)
        else:
            parts.append(tok)
    return "".join(parts)


def write_paths(path_file: str, named_paths, g: CondensedGraph) -> None:
    """Write contigs.paths/scaffolds.paths: name line + path line, plus the
    conjugate record (name') as SPAdes does."""
    with open(path_file, "w") as fh:
        for name, p in named_paths:
            fh.write(f"{name}\n{path_to_string(g, p)}\n")
            fh.write(f"{name}'\n{path_to_string(g, conj_path(g, p))}\n")
