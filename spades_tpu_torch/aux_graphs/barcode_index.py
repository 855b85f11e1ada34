"""Frame barcode index for linked-read / synthetic-long-read clouds.

Capability mirror of SPAdes `src/common/barcode_index/`
(`barcode_index.hpp:299-382` FrameBarcodeInfo, `barcode_index_builder.hpp`
FrameBarcodeIndexBuilder, `barcode_info_extractor.hpp` intersection queries)
as used by SPlitteR (`src/projects/splitter/
barcode_index_construction.cpp:30` — barcodes parsed from `BC:Z:`/`BX:Z:`
read-name tags).

Flat design (as in the JAX package): instead of a per-edge hash map of
per-barcode bitsets, the index is one flat sorted (edge, barcode) relation
with aggregate columns (read count, leftmost/rightmost mapped nt, #covered
frames); every extractor query (barcodes of an edge head/tail, intersection
of two edges) is a slice + set-intersection over the sorted relation.
Building maps every read in one pass on the device
(`MappingEngine.map_sequences`: the index at `mapping_k` extracted and
sorted on the device, no host index), where the JAX package maps batches of
4,096 reads with `map_read_batch` on a host index; mapping is per read, so
the relation is the same.  The (edge, barcode, lo, hi) rows are built as
arrays, and the sort and aggregates are the reference's numpy.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..alignment.mapper import MappingEngine
from ..graph.graph import CondensedGraph

BARCODE_PREFIXES = ("BC:Z:", "BX:Z:")


def parse_barcode(read_name: str) -> str:
    """Extract the barcode string from a read header, '' if none.

    Mirrors the prefix scan of `barcode_index_construction.cpp:30`."""
    for token in read_name.split():
        for pref in BARCODE_PREFIXES:
            if token.startswith(pref):
                return token[len(pref):]
    return ""


@dataclass
class FrameBarcodeIndex:
    """Sorted flat (oriented edge, barcode) -> cloud-aggregate relation."""

    frame_size: int
    edge: np.ndarray       # (N,) int64 oriented edge id, primary sort key
    barcode: np.ndarray    # (N,) int64 barcode id, secondary sort key
    count: np.ndarray      # (N,) int64 number of reads of this barcode on edge
    left_pos: np.ndarray   # (N,) int64 leftmost mapped nt position
    right_pos: np.ndarray  # (N,) int64 rightmost mapped nt position (exclusive)
    covered: np.ndarray    # (N,) int64 number of distinct frames hit
    barcode_names: list[str]

    @property
    def num_entries(self) -> int:
        return int(len(self.edge))

    @property
    def num_barcodes(self) -> int:
        return len(self.barcode_names)

    def _rows(self, e: int) -> slice:
        lo = int(np.searchsorted(self.edge, e, "left"))
        hi = int(np.searchsorted(self.edge, e, "right"))
        return slice(lo, hi)

    def barcodes_of(self, e: int, count_threshold: int = 1) -> np.ndarray:
        r = self._rows(e)
        bc = self.barcode[r]
        return bc[self.count[r] >= count_threshold]

    def barcode_number(self, e: int) -> int:
        """GetBarcodeNumber (`barcode_index.hpp:146`)."""
        return len(self.barcodes_of(e))

    def barcodes_in_head(
        self, e: int, edge_len: int, tail_threshold: int, count_threshold: int = 1
    ) -> np.ndarray:
        """Barcodes whose cloud starts within the first `tail_threshold` nt."""
        r = self._rows(e)
        keep = (self.count[r] >= count_threshold) & (self.left_pos[r] < tail_threshold)
        return self.barcode[r][keep]

    def barcodes_in_tail(
        self, e: int, edge_len: int, tail_threshold: int, count_threshold: int = 1
    ) -> np.ndarray:
        """Barcodes whose cloud reaches into the last `tail_threshold` nt."""
        r = self._rows(e)
        keep = (self.count[r] >= count_threshold) & (
            self.right_pos[r] > edge_len - tail_threshold
        )
        return self.barcode[r][keep]

    def intersection_size(self, e1: int, e2: int, count_threshold: int = 1) -> int:
        """Shared-barcode count (`barcode_info_extractor.hpp:64`)."""
        return len(
            np.intersect1d(
                self.barcodes_of(e1, count_threshold),
                self.barcodes_of(e2, count_threshold),
                assume_unique=True,
            )
        )

    def link_score(
        self,
        e1: int,
        len1: int,
        e2: int,
        len2: int,
        tail_threshold: int,
        count_threshold: int = 1,
    ) -> float:
        """Barcodes shared by the tail of e1 and the head of e2 — the
        TrivialBarcodeScoreFunction of the SPlitteR link index
        (`scaffold_graph_helper.cpp:68-91`)."""
        t1 = self.barcodes_in_tail(e1, len1, tail_threshold, count_threshold)
        h2 = self.barcodes_in_head(e2, len2, tail_threshold, count_threshold)
        return float(len(np.intersect1d(t1, h2, assume_unique=True)))


def read_barcode_ids(names) -> tuple[np.ndarray, list[str]]:
    """(n,) int64 barcode id of each read name (-1 without one) and the
    barcode names in order of first appearance."""
    name_to_id: dict[str, int] = {}
    bcs = np.empty(len(names), np.int64)
    for i, name in enumerate(names):
        b = parse_barcode(name)
        bcs[i] = name_to_id.setdefault(b, len(name_to_id)) if b else -1
    return bcs, list(name_to_id)


def build_barcode_index(
    g: CondensedGraph,
    reads: list[tuple[str, str]],
    mapping_k: int = 31,
    frame_size: int = 40000,
    engine: MappingEngine | None = None,
    device=None,
) -> FrameBarcodeIndex:
    """Map barcoded reads to the graph and aggregate per (edge, barcode).

    Every mapping on oriented edge e at span [a,b) is mirrored onto the
    conjugate edge at [len-b, len-a), so head/tail queries are uniform for
    both strands (the reference builder processes both orientations of each
    read path, `barcode_index_builder.hpp:110`).  engine: a MappingEngine of
    `g` at `mapping_k` to reuse; else one is made on `device` (None: the
    CUDA card, see `resolve_device`)."""
    if engine is None:
        engine = MappingEngine(g, device=device, k=mapping_k)
    bcs, names = read_barcode_ids([n for n, _ in reads])
    seqs = [s for _, s in reads]
    edge, start, _votes = engine.map_sequences(seqs)
    rlen = np.fromiter((len(s) for s in seqs), np.int64, count=len(seqs))
    ok = (edge >= 0) & (bcs >= 0)
    e = edge[ok]
    L = g.e_len[e].astype(np.int64)
    a = np.maximum(0, start[ok])
    b_ = np.minimum(L, start[ok] + rlen[ok])
    span = b_ > a
    if not span.any():
        z = np.zeros(0, np.int64)
        return FrameBarcodeIndex(frame_size, z, z, z, z, z, z, names)
    e, L, a, b_, bc = e[span], L[span], a[span], b_[span], bcs[ok][span]
    # each read's row on its edge, then its mirror on the conjugate
    e_arr = np.stack([e, g.e_conj[e].astype(np.int64)], axis=1).reshape(-1)
    b_arr = np.repeat(bc, 2)
    lo = np.stack([a, L - b_], axis=1).reshape(-1)
    hi = np.stack([b_, L - a], axis=1).reshape(-1)

    order = np.lexsort((b_arr, e_arr))
    e_arr, b_arr, lo, hi = e_arr[order], b_arr[order], lo[order], hi[order]
    new_group = np.concatenate([[True], (e_arr[1:] != e_arr[:-1]) | (b_arr[1:] != b_arr[:-1])])
    gid = np.cumsum(new_group) - 1
    n_groups = int(gid[-1]) + 1

    count = np.bincount(gid, minlength=n_groups)
    left = np.full(n_groups, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(left, gid, lo)
    right = np.zeros(n_groups, np.int64)
    np.maximum.at(right, gid, hi)
    # covered frames: distinct frame indices of read starts per group
    frame = lo // frame_size
    trip = np.stack([gid, frame], axis=1)
    uniq = np.unique(trip, axis=0)
    covered = np.bincount(uniq[:, 0], minlength=n_groups)

    return FrameBarcodeIndex(
        frame_size=frame_size,
        edge=e_arr[new_group],
        barcode=b_arr[new_group],
        count=count.astype(np.int64),
        left_pos=left,
        right_pos=right,
        covered=covered.astype(np.int64),
        barcode_names=names,
    )
