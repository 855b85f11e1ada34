"""Auxiliary graph structures over the assembly graph.

Capability mirror of SPAdes' `src/common/auxiliary_graphs/` (contracted
graph, scaffold graph) and `src/common/barcode_index/` (frame barcode index
for linked/synthetic-long-read clouds), consumed by the mate-pair scaffolder
of repeat resolution and by the SPlitteR repeat resolver
(`src/projects/splitter/`, `tools/splitter.py`).
"""
from .scaffold_graph import ScaffoldGraph
from .contracted_graph import ContractedGraph, build_contracted_graph
from .barcode_index import FrameBarcodeIndex, build_barcode_index, parse_barcode

__all__ = [
    "ScaffoldGraph",
    "ContractedGraph",
    "build_contracted_graph",
    "FrameBarcodeIndex",
    "build_barcode_index",
    "parse_barcode",
]
