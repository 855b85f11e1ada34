"""Read-to-graph sequence mapping via the edge k-mer index.

Capability mirror of SPAdes' edge index and basic mapper
(`common/assembly_graph/index/edge_position_index.hpp`,
`alignment/sequence_mapper.hpp` BasicSequenceMapper, and the map-reduce
fan-out of `alignment/sequence_mapper_notifier.hpp`), ported from
`spades_tpu.alignment.mapper`.

The edge index is a sorted canonical-k-mer array with parallel (edge, offset)
columns; mapping a read batch is one canonical window extraction, one batched
search and a vote group-by.  Orientation is expressed through the conjugate
edge ids (a reverse-strand hit is a forward hit on the conjugate edge), so a
mapping is always (oriented edge, offset of read start in that edge's forward
coordinates).  Large read sets map on the device
(`parallel/sharded_mapping.py`), small ones on the host in numpy, under the
JAX package's thresholds and environment knobs.

Unlike the JAX package, the device path hides no failure: only a CUDA
out-of-memory error is caught, to halve the sub-slice; anything else raises.
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..core import dna
from ..core import kmers as K
from ..graph.graph import CondensedGraph
from ..ops.count import _lexsort_rows, searchsorted_rows
from ..ops.extension import canonicalize
from ..utils.timetracer import span

log = logging.getLogger("spades_tpu_torch.mapper")

# one dict per `MappingEngine.map_store` call given a non-empty kmer-mapper:
# its reads, whether it mapped on the device, the reads left unmapped there,
# and how many of those the host residue pass re-ran and recovered
# (instrumentation, as `pipeline.spades_stages.GAP_CLOSER_STATS`)
RESIDUE_STATS: list[dict] = []


@dataclass
class EdgeIndex:
    """Sorted canonical k-mer -> (canonical edge id, offset, strand) map."""

    k: int
    kmers: np.ndarray    # (U, W) sorted canonical k-mers
    edge: np.ndarray     # (U,) int64 edge id whose spelled window is indexed
    offset: np.ndarray   # (U,) int64 offset of the window within that edge
    strand: np.ndarray   # (U,) uint8: 0 = spelled == canonical, 1 = spelled == rc


def build_edge_index(g: CondensedGraph, k: int | None = None) -> EdgeIndex:
    """Index every k-window of every canonical edge.  k defaults to the graph
    k; a long-read aligner passes a smaller k for error-tolerant anchoring.

    One vectorized pass over the flat sequence pool (windows of ALL edges
    gathered at once, chunked to bound memory)."""
    k = k or g.k
    ids = g.canonical_edge_ids()
    all_words, all_edge, all_off, all_strand = [], [], [], []
    if ids.size:
        lens = g.e_len[ids].astype(np.int64)
        offs = g.e_off[ids].astype(np.int64)
        nwin = np.maximum(lens - k + 1, 0)
        keep = nwin > 0
        ids_k, offs_k, nwin_k = ids[keep], offs[keep], nwin[keep]
        total = int(nwin_k.sum())
        if total:
            edge_col = np.repeat(ids_k.astype(np.int64), nwin_k)
            base = np.repeat(np.cumsum(nwin_k) - nwin_k, nwin_k)
            off_col = np.arange(total, dtype=np.int64) - base
            pos = np.repeat(offs_k, nwin_k) + off_col
            pool_wins = np.lib.stride_tricks.sliding_window_view(g.seq_pool, k)
            chunk = 4_000_000
            for c0 in range(0, total, chunk):
                sl = slice(c0, min(c0 + chunk, total))
                packed = K.pack(np.ascontiguousarray(pool_wins[pos[sl]]))
                canon, was_rc = canonicalize(packed, k)
                all_words.append(canon)
                all_edge.append(edge_col[sl])
                all_off.append(off_col[sl])
                all_strand.append(np.asarray(was_rc).astype(np.uint8))
    if not all_words:
        W = K.kmer_words(k)
        return EdgeIndex(
            k=k, kmers=np.zeros((0, W), np.uint32), edge=np.zeros(0, np.int64),
            offset=np.zeros(0, np.int64), strand=np.zeros(0, np.uint8),
        )
    words = np.concatenate(all_words)
    edge = np.concatenate(all_edge)
    off = np.concatenate(all_off)
    strand = np.concatenate(all_strand)
    order = _lexsort_rows(words)
    words, edge, off, strand = words[order], edge[order], off[order], strand[order]
    # dedup junction k-mers shared between edges: keep first occurrence
    keep = np.concatenate([[True], np.any(words[1:] != words[:-1], axis=1)])
    return EdgeIndex(
        k=k, kmers=words[keep], edge=edge[keep], offset=off[keep], strand=strand[keep]
    )


@dataclass
class ReadMapping:
    """Dominant anchored mapping of one read onto an oriented edge."""

    read_id: int
    edge: int          # oriented edge the read spells forward into
    start_offset: int  # offset of read position 0 in edge-forward coords (may be <0)
    n_hits: int


def _map_reads_threshold() -> int:
    return int(os.environ.get("SPADES_DEVICE_MAP_READS", 200_000))


class MappingEngine:
    """Per-graph-state mapping engine: one EdgeIndex build + ONE device
    upload, reused by every mapping pass against this graph state.

    Stages share one engine per graph state and must drop it after mutating
    the graph.  `device` is where the device path runs (default: the CUDA
    card, see `resolve_device`); it is resolved at first use.  `k` is the
    index's k when it is not the graph's (a tool mapping at a smaller k).
    `group` (the JAX package's `mesh`; None: the default group of a
    multi-process run) shares each chunk's reads out among the ranks, each
    holding the same device index."""

    def __init__(self, g: CondensedGraph, index: EdgeIndex | None = None,
                 device=None, k: int | None = None, group=None):
        self.g = g
        self._index = index
        self._k = index.k if index is not None else (k or g.k)
        self._device = device
        self._group = group
        self._prep = None
        # wall seconds and row counts of the device index build, once it ran
        self.index_timings: dict = {}

    @property
    def index(self) -> EdgeIndex:
        """Host EdgeIndex, built lazily: the device mapping path never needs
        it (the index is extracted and sorted in device memory,
        `build_index_device`)."""
        if self._index is None:
            self._index = build_edge_index(self.g, self._k)
        return self._index

    @property
    def device(self) -> torch.device:
        if not isinstance(self._device, torch.device):
            self._device = resolve_device(self._device)
        return self._device

    @property
    def group(self):
        """The process group the device path maps across, or None (one
        device): the engine's `group`, else the default group of a
        multi-process run."""
        from ..parallel.distributed import resolve_group

        return resolve_group(self._group)

    def _device_index(self, build_on_device: bool = False):
        """The device index tuple, built once.  build_on_device: extract and
        sort it on the device whatever the pool's size (no host index)."""
        if self._prep is None:
            from ..parallel.sharded_mapping import (
                build_index_device,
                prepare_index_device,
            )

            # big pools: extract + sort the index on the device (the host
            # lexsort scales with pool size); small pools: upload the host
            # index (cheap, and tools may have one)
            thresh = int(os.environ.get("SPADES_DEVICE_INDEX_POOL", 2_000_000))
            if self._index is None and (build_on_device or len(self.g.seq_pool) >= thresh):
                self._prep = build_index_device(self.g, self._k, self.device,
                                                timings=self.index_timings)
            else:
                self._prep = prepare_index_device(self.index, self.g, self.device)
        return self._prep

    def release(self) -> None:
        """Drop the device index (its tensors return to torch's allocator);
        a later mapping pass would build it again."""
        self._prep = None

    def map_store(self, store, kmer_mapper=None, force_device: bool = False):
        """Map every read of a ReadStore.  Returns (edge, start, votes)
        int64 numpy arrays of length store.n (edge == -1 unmapped).

        Device path for large stores (same SPADES_DEVICE_MAP_READS threshold
        as `map_read_batch`); with a non-empty kmer_mapper the unmapped
        residue re-runs with the projection applied (`_map_residue`)."""
        use_device = force_device or store.n >= _map_reads_threshold()
        with span("map_store", reads=int(store.n), device=bool(use_device)) as sp:
            edge = np.full(store.n, -1, np.int64)
            start = np.zeros(store.n, np.int64)
            votes = np.zeros(store.n, np.int64)
            c0 = 0
            for ch in store.chunks:
                if use_device:
                    e, s, v = self._map_chunk_device(ch)
                else:
                    e, s, v = self._map_chunk_host(ch, kmer_mapper)
                edge[c0 : c0 + ch.n] = e[: ch.n]
                start[c0 : c0 + ch.n] = s[: ch.n]
                votes[c0 : c0 + ch.n] = v[: ch.n]
                c0 += ch.n
            if kmer_mapper is None or kmer_mapper.size == 0:
                return edge, start, votes
            stats = {"reads": int(store.n), "device": bool(use_device),
                     "unmapped": int((edge < 0).sum()), "rerun": 0, "recovered": 0}
            if use_device:
                with span("map_store.residue") as rs:
                    miss = np.flatnonzero(edge < 0)
                    # The projection residue only recovers reads whose EVERY anchor
                    # was glued away.  When the residue is a sliver (<1%) on a big
                    # store, the recoveries cannot move insert-size medians or pair
                    # weights — skip and say so.
                    if miss.size and store.n >= 100_000 and miss.size < store.n // 100:
                        log.info("skipping kmer-mapper residue pass (%d/%d unmapped, <1%%)",
                                 miss.size, store.n)
                        miss = np.zeros(0, np.int64)
                    if miss.size:
                        e, s, v = self._map_residue(self._gather_sequences(store, miss),
                                                    kmer_mapper)
                        got = e >= 0
                        edge[miss[got]], start[miss[got]], votes[miss[got]] = e[got], s[got], v[got]
                        stats["rerun"] = int(miss.size)
                        stats["recovered"] = int(got.sum())
                    rs.set(rerun=stats["rerun"], recovered=stats["recovered"])
            RESIDUE_STATS.append(stats)
            sp.set(unmapped=stats["unmapped"], rerun=stats["rerun"], recovered=stats["recovered"])
            log.info("map_store: %d reads on the %s, %d unmapped there; kmer-mapper residue "
                     "pass re-ran %d, recovered %d", stats["reads"],
                     "device" if use_device else "host", stats["unmapped"], stats["rerun"],
                     stats["recovered"])
            return edge, start, votes

    def map_sequences(self, seqs, chunk_reads: int = 262144):
        """Map a list of sequences (str or uint8 codes) on the device: one
        ReadStore of them, the index extracted and sorted on the device from
        the graph's pool (the host index is never built).  Returns (edge,
        start, votes) int64 numpy arrays, edge == -1 for unmapped, equal to
        `map_read_batch` on the host index read for read."""
        from ..core.reads import ReadStore

        self._device_index(build_on_device=True)
        store = ReadStore.build(seqs, chunk_reads)
        return self.map_store(store, force_device=True)

    def _map_chunk_device(self, ch, sub: int | None = None):
        """Map one store chunk in fixed sub-slices (bounded device-memory
        peak).  Every sub-slice is queued first and the results are pulled
        afterwards, so the device works on sub-slice i+1 while sub-slice i's
        results cross to the host.  On a CUDA out-of-memory error the
        sub-slice halves (down to 8,192) and the chunk is retried; any other
        error escapes.  A chunk narrower than k holds no window: none of its
        reads maps.  Under a group every rank maps its share of the chunk's
        reads and the mappings are gathered (`make_sharded_mapper`)."""
        from ..parallel.sharded_mapping import _map_rows_local, make_sharded_mapper

        if ch.L < self._k:
            z = np.zeros(ch.n, np.int64)
            return z - 1, z, z.copy()
        if sub is None:
            sub = int(os.environ.get("SPADES_MAP_SUBCHUNK", 131072))
        pc, pn, lengths = ch.device(self.device)
        prep = self._device_index()
        if self.group is None:
            out = _map_rows_local(prep, self._k, pc, pn, lengths, ch.L, sub)
        else:
            n = ch.n
            out = make_sharded_mapper(self.group, self._k, ch.L, sub)(
                pc[:n], pn[:n], lengths[:n], prep)
        e, s, v = (t.cpu().numpy().astype(np.int64) for t in out)
        return e[: ch.n], s[: ch.n], v[: ch.n]

    def _map_chunk_host(self, ch, kmer_mapper):
        b = ch.unpack_host()
        seqs = [
            np.where(b.n_mask[i, : b.lengths[i]], dna.NCODE,
                     b.codes[i, : b.lengths[i]]).astype(np.uint8)
            for i in range(ch.n)
        ]
        ms = map_read_batch(self.index, self.g, seqs, kmer_mapper=kmer_mapper,
                            _force_host=True)
        e = np.array([m.edge if m else -1 for m in ms], np.int64)
        s = np.array([m.start_offset if m else 0 for m in ms], np.int64)
        v = np.array([m.n_hits if m else 0 for m in ms], np.int64)
        return e, s, v

    def _map_residue(self, seqs, kmer_mapper):
        """The kmer-mapper residue pass: `map_read_batch`'s host path, with
        the lookup and the vote in the engine's device index.  Each read's
        canonical k-windows are projected through the kmer-mapper on the
        host, then `_map_shard_core` looks them up and takes the dominant
        (edge, start) vote, ties to the first in (edge, start) order as the
        host vote does.  No host index is built.  Reads go in slices of
        SPADES_MAP_SUBCHUNK, as the device path's do.  Returns (edge, start,
        votes) int64 arrays, edge -1 where a read did not map."""
        from ..parallel.sharded_mapping import _map_shard_core

        sub = int(os.environ.get("SPADES_MAP_SUBCHUNK", 131072))
        k, n = self._k, len(seqs)
        edge, start, votes = np.full(n, -1, np.int64), np.zeros(n, np.int64), np.zeros(n, np.int64)
        for a in range(0, n, sub):
            part = seqs[a: a + sub]
            L = max(len(c) for c in part)
            if L < k:
                continue
            codes = np.full((len(part), L), dna.NCODE, np.uint8)
            for i, c in enumerate(part):
                codes[i, : len(c)] = c
            wins = np.lib.stride_tricks.sliding_window_view(codes, k, axis=1)
            valid = np.lib.stride_tricks.sliding_window_view(codes < 4, k, axis=1).all(axis=2)
            canon, read_rc = canonicalize(K.pack(np.where(wins >= 4, 0, wins).reshape(-1, k)), k)
            if kmer_mapper is not None and kmer_mapper.k == k:
                ok = valid.reshape(-1)
                canon[ok] = kmer_mapper.substitute(canon[ok])
            dev = self.device
            keys = torch.from_numpy(np.ascontiguousarray(K.words_to_keys(canon).T)).to(dev)
            out = _map_shard_core(keys, torch.from_numpy(valid).to(dev),
                                  torch.from_numpy(read_rc.reshape(valid.shape)).to(dev),
                                  *self._device_index(), k=k)
            for dst, t in zip((edge, start, votes), out):
                dst[a: a + len(part)] = t.cpu().numpy()
        return edge, start, votes

    @staticmethod
    def _gather_sequences(store, idxs):
        """Sequences (uint8 code arrays, N as NCODE) for global read ids."""
        out = []
        bounds = []
        a = 0
        for ch in store.chunks:
            bounds.append((a, a + ch.n, ch))
            a += ch.n
        bi = 0
        cache = {}
        for i in idxs:
            while not (bounds[bi][0] <= i < bounds[bi][1]):
                bi += 1
            a0, _, ch = bounds[bi]
            if bi not in cache:
                cache[bi] = ch.unpack_host()
            b = cache[bi]
            r = int(i - a0)
            n = int(b.lengths[r])
            c = b.codes[r, :n].copy()
            c[b.n_mask[r, :n]] = dna.NCODE
            out.append(c)
        return out


def _map_read_batch_device(
    index: EdgeIndex, g: CondensedGraph, seqs, device=None
) -> list["ReadMapping | None"]:
    """Device-mapped batch, in chunks of 262,144 reads against one upload of
    the index."""
    from ..core.reads import ReadBatch
    from ..parallel.sharded_mapping import map_reads_sharded, prepare_index_device

    dev = resolve_device(device)
    prep = prepare_index_device(index, g, dev)
    out: list[ReadMapping | None] = [None] * len(seqs)
    chunk = 262144
    for c0 in range(0, len(seqs), chunk):
        part = seqs[c0 : c0 + chunk]
        batch = ReadBatch.from_sequences(part)
        edge, start, votes = map_reads_sharded(index, g, batch, dev, prep=prep)
        for j in np.flatnonzero(edge[: len(part)] >= 0):
            out[c0 + int(j)] = ReadMapping(
                c0 + int(j), int(edge[j]), int(start[j]), int(votes[j])
            )
    return out


def map_read_batch(
    index: EdgeIndex, g: CondensedGraph, seqs: list[str], kmer_mapper=None,
    _force_host: bool = False, device=None,
) -> list[ReadMapping | None]:
    """Map reads by k-mer anchor votes.  One ReadMapping (or None) per read.

    Large batches (SPADES_DEVICE_MAP_READS reads or more) run the whole
    extract / search / vote pipeline on `device`
    (`parallel/sharded_mapping.py`).  With a kmer-mapper the pass is hybrid:
    device first, then the host path (which applies the projection) on the
    unmapped residue only.  Smaller batches are grouped by length so window
    extraction and packing run as one numpy matrix operation per group."""
    k = index.k
    by_len: dict[int, list[int]] = {}
    for i, s in enumerate(seqs):
        if len(s) >= k:
            by_len.setdefault(len(s), []).append(i)
    if not by_len:
        return [None] * len(seqs)

    if len(seqs) >= _map_reads_threshold() and not _force_host:
        out = _map_read_batch_device(index, g, seqs, device)
        if kmer_mapper is not None and kmer_mapper.size > 0:
            miss = [i for i, m in enumerate(out) if m is None]
            if miss:
                sub = map_read_batch(
                    index, g, [seqs[i] for i in miss],
                    kmer_mapper=kmer_mapper, _force_host=True,
                )
                for i, m in zip(miss, sub):
                    if m is not None:
                        out[i] = ReadMapping(i, m.edge, m.start_offset, m.n_hits)
        return out

    packed_list, valid_list, rid_list, j_list = [], [], [], []
    for L, idxs in by_len.items():
        first = seqs[idxs[0]]
        if isinstance(first, str):
            joined = "".join(seqs[i] for i in idxs)
            codes = dna.encode(joined).reshape(len(idxs), L)
        else:  # pre-encoded uint8 code arrays (pipeline wire format)
            codes = np.stack([dna.encode(seqs[i]) for i in idxs])
        ok = codes < 4
        wins = np.lib.stride_tricks.sliding_window_view(codes, k, axis=1)
        valid = np.lib.stride_tricks.sliding_window_view(ok, k, axis=1).all(axis=2)
        P = L - k + 1
        packed = K.pack(
            np.ascontiguousarray(np.where(wins >= 4, 0, wins)).reshape(-1, k)
        )
        packed_list.append(packed)
        valid_list.append(valid.reshape(-1))
        rid_list.append(np.repeat(np.asarray(idxs, np.int64), P))
        j_list.append(np.tile(np.arange(P, dtype=np.int64), len(idxs)))

    big = np.concatenate(packed_list)
    valid = np.concatenate(valid_list)
    rid = np.concatenate(rid_list)
    jj = np.concatenate(j_list)

    canon, read_rc = canonicalize(big, k)
    if kmer_mapper is not None and kmer_mapper.k == k:
        # project simplification-glued k-mers onto surviving ones
        canon = kmer_mapper.substitute(canon)
    idx = searchsorted_rows(index.kmers, canon)
    hit = (idx >= 0) & valid
    if not hit.any():
        return [None] * len(seqs)
    idx, rid, jj, read_rc = idx[hit], rid[hit], jj[hit], read_rc[hit]
    e = index.edge[idx]
    off = index.offset[idx]
    same = read_rc == index.strand[idx]
    # reverse-strand hit == forward hit on the conjugate edge at mirrored offset
    oc = g.e_len[e] - k - off
    voted_edge = np.where(same, e, g.e_conj[e])
    voted_start = np.where(same, off, oc) - jj

    # group votes by (read, edge, start) via lexsort + run-length, then pick
    # the dominant vote per read
    order = np.lexsort((voted_start, voted_edge, rid))
    r_s = rid[order]
    e_s = voted_edge[order]
    st_s = voted_start[order]
    new = np.concatenate(
        [[True], (r_s[1:] != r_s[:-1]) | (e_s[1:] != e_s[:-1]) | (st_s[1:] != st_s[:-1])]
    )
    gid = np.cumsum(new) - 1
    counts = np.bincount(gid)
    g_rid, g_e, g_st = r_s[new], e_s[new], st_s[new]
    order2 = np.lexsort((-counts, g_rid))
    first = np.concatenate([[True], g_rid[order2][1:] != g_rid[order2][:-1]])
    best = order2[first]
    out: list[ReadMapping | None] = [None] * len(seqs)
    for r, em, st, votes in zip(g_rid[best], g_e[best], g_st[best], counts[best]):
        out[int(r)] = ReadMapping(int(r), int(em), int(st), int(votes))
    return out
