"""Binary (de)serialization of the condensed graph and pipeline state.

Covers SPAdes' saves layer (`src/common/io/binary/
graph_pack.hpp`, versioned BinRead/BinWrite of every GraphPack member) with
npz archives of the flat graph arrays — the natural format for an
array-of-structs graph.
"""
from __future__ import annotations

import numpy as np

from .graph import CondensedGraph

FORMAT_VERSION = 1


def save_graph(path: str, g: CondensedGraph) -> None:
    np.savez_compressed(
        path,
        version=np.int64(FORMAT_VERSION),
        k=np.int64(g.k),
        e_start=g.e_start, e_end=g.e_end, e_conj=g.e_conj,
        e_off=g.e_off, e_len=g.e_len, e_cov=g.e_cov,
        alive=g.alive, seq_pool=g.seq_pool, v_conj=g.v_conj,
    )


def load_graph(path: str) -> CondensedGraph:
    if not path.endswith(".npz"):
        path = path + ".npz"
    z = np.load(path)
    ver = int(z["version"])
    if ver != FORMAT_VERSION:
        raise ValueError(f"{path}: unsupported graph format version {ver}")
    return CondensedGraph(
        k=int(z["k"]),
        e_start=z["e_start"], e_end=z["e_end"], e_conj=z["e_conj"],
        e_off=z["e_off"], e_len=z["e_len"], e_cov=z["e_cov"],
        alive=z["alive"], seq_pool=z["seq_pool"], v_conj=z["v_conj"],
    )


# -- full-pack members (io/binary/graph_pack.hpp FullPackIO) ----------------

def save_paired_index(path: str, pi) -> None:
    """PairedIndex (sorted (e1,e2,d)->w relation) as an npz archive."""
    np.savez_compressed(
        path, version=np.int64(FORMAT_VERSION),
        e1=pi.e1, e2=pi.e2, dist=pi.dist, weight=pi.weight,
    )


def load_paired_index(path: str):
    from ..paired.paired_info import PairedIndex

    z = np.load(path)
    return PairedIndex(e1=z["e1"], e2=z["e2"], dist=z["dist"], weight=z["weight"])


def save_long_reads(path: str, storage) -> None:
    """LongReadStorage ({edge path -> support count}) as flat offset arrays."""
    paths = list(storage.paths.items())
    edges = np.concatenate([np.asarray(p, np.int64) for p, _ in paths]) if paths else np.zeros(0, np.int64)
    offsets = np.zeros(len(paths) + 1, np.int64)
    np.cumsum([len(p) for p, _ in paths], out=offsets[1:])
    counts = np.array([c for _, c in paths], np.int64)
    np.savez_compressed(
        path, version=np.int64(FORMAT_VERSION),
        edges=edges, offsets=offsets, counts=counts,
    )


def load_long_reads(path: str):
    """LongReadStorage from `save_long_reads`'s archive, its paths in the
    order they were saved (the dict order the long-read chooser reads)."""
    from ..alignment.long_read import LongReadStorage

    z = np.load(path)
    edges, offsets, counts = z["edges"], z["offsets"], z["counts"]
    storage = LongReadStorage()
    for i in range(len(counts)):
        p = tuple(int(e) for e in edges[offsets[i] : offsets[i + 1]])
        storage.paths[p] = int(counts[i])
    return storage


def save_kmer_mapper(path: str, mapper) -> None:
    """KmerMapper substitution map: the materialized sorted src/dst arrays."""
    mapper._materialize()
    src = mapper._sorted_src
    dst = mapper._sorted_dst
    if src is None:
        src = dst = np.zeros((0, 1), np.uint32)
    np.savez_compressed(
        path, version=np.int64(FORMAT_VERSION),
        k=np.int64(mapper.k), src=src, dst=dst,
    )


def load_kmer_mapper(path: str):
    from ..alignment.kmer_mapper import KmerMapper

    z = np.load(path)
    m = KmerMapper(k=int(z["k"]))
    if z["src"].shape[0]:
        m._sorted_src, m._sorted_dst = z["src"], z["dst"]
    return m
