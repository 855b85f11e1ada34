"""Auxiliary graph structures over the assembly graph.

Capability mirror of SPAdes' `src/common/auxiliary_graphs/`.  Ported so far:
the scaffold graph, which the mate-pair scaffolder of repeat resolution
builds (`paired/path_extend.py:build_scaffold_graph_2015`).  The contracted
graph and the barcode index serve SPlitteR and are not here yet.
"""
from .scaffold_graph import ScaffoldGraph

__all__ = ["ScaffoldGraph"]
