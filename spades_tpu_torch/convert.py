"""Build the port's host state from the JAX package's, array for array.

The assembler has no weights; what crosses between the two packages is
state: counted (k+1)-mers, the extension index, the condensed graph and the
edge k-mer index of the read mapper.
Each function takes that state as a dict of numpy arrays (plus `k`), as
`dataclasses.asdict` gives it for `spades_tpu`'s `KmerCounts`,
`ExtensionIndex`, `CondensedGraph` or `EdgeIndex`, and returns the port's object, so one
JAX-built state can feed a port stage (the parity tests do this).
"""
from __future__ import annotations

import numpy as np

from .alignment.mapper import EdgeIndex
from .graph.graph import CondensedGraph
from .ops.count import KmerCounts
from .ops.extension import ExtensionIndex


def counts_from_arrays(d: dict) -> KmerCounts:
    return KmerCounts(
        k=int(d["k"]),
        words=np.ascontiguousarray(d["words"], np.uint32),
        counts=np.ascontiguousarray(d["counts"], np.int64),
    )


def ext_index_from_arrays(d: dict) -> ExtensionIndex:
    def opt(name, dtype):
        a = d.get(name)
        return None if a is None else np.ascontiguousarray(a, dtype)

    return ExtensionIndex(
        k=int(d["k"]),
        kmers=np.ascontiguousarray(d["kmers"], np.uint32),
        in_mask=np.ascontiguousarray(d["in_mask"], np.uint8),
        out_mask=np.ascontiguousarray(d["out_mask"], np.uint8),
        pref_idx=opt("pref_idx", np.int64),
        suf_idx=opt("suf_idx", np.int64),
        pref_rc=opt("pref_rc", np.uint8),
        suf_rc=opt("suf_rc", np.uint8),
    )


def graph_from_arrays(d: dict) -> CondensedGraph:
    return CondensedGraph(
        k=int(d["k"]),
        e_start=np.ascontiguousarray(d["e_start"], np.int64),
        e_end=np.ascontiguousarray(d["e_end"], np.int64),
        e_conj=np.ascontiguousarray(d["e_conj"], np.int64),
        e_off=np.ascontiguousarray(d["e_off"], np.int64),
        e_len=np.ascontiguousarray(d["e_len"], np.int64),
        e_cov=np.ascontiguousarray(d["e_cov"], np.float64),
        alive=np.ascontiguousarray(d["alive"], bool),
        seq_pool=np.ascontiguousarray(d["seq_pool"], np.uint8),
        v_conj=np.ascontiguousarray(d["v_conj"], np.int64),
    )


def edge_index_from_arrays(d: dict) -> EdgeIndex:
    return EdgeIndex(
        k=int(d["k"]),
        kmers=np.ascontiguousarray(d["kmers"], np.uint32),
        edge=np.ascontiguousarray(d["edge"], np.int64),
        offset=np.ascontiguousarray(d["offset"], np.int64),
        strand=np.ascontiguousarray(d["strand"], np.uint8),
    )
