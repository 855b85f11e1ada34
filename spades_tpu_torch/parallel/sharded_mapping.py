"""Read-to-graph mapping on the device and across a process group, and
paired-info filling.

`spades_tpu.parallel.sharded_mapping` on PyTorch.  The edge k-mer index
(sorted canonical k-mers with parallel (edge, offset, strand) columns,
`alignment/mapper.py` EdgeIndex) lives on the device; a read batch

* has its canonical windows and their strand bits taken by the
  canonical-windows kernel (`ops/cuda_kernels.py`), straight from the packed
  wire format,
* is searched in the index (`device_searchsorted_rows`, leftmost equal row),
* and gives each read its dominant (edge, read-start) vote by a row-wise sort
  and a run-length maximum (`_map_shard_core`), with no host loop.

On the device a k-mer is its int64 sort keys (`core/kmers.py`): the index is
`(ceil(W/2), U)` key planes where the JAX package holds `(U, W)` uint32 words.
Edge, offset, start and votes are int32, as there.  The JAX package pads the
index, the pool and the row plan to powers of two to keep its compiled
program shapes stable; eager PyTorch has no such need, so nothing is padded
here, and every lookup answers the same.

Across a process group (the JAX package's mesh wrappers `make_sharded_mapper`,
`make_sharded_voter`, `make_sharded_hitter`), the index is replicated: every
rank builds the same one from the same graph, maps its rows [lo, hi) of each
chunk (`process_read_slice`), and the mappings and hits are gathered back
into read order on every rank; the votes of every rank's reads are summed by
one int32 `all_reduce` at the end (exact).  Each rank sub-slices and halves
its sub-slice on a CUDA out-of-memory error on its own: no collective runs
inside that loop.  `group=None` is the default group when one is
initialized with several processes (`parallel/distributed.py`); the
sub-slice call `map_packed_async` takes the group path only when it is
given one.
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from .. import resolve_device
from ..core import kmers as K
from ..ops.cuda_kernels import canonical_window_keys
from .distributed import (all_reduce_sum, gather_rows, process_read_slice, rank_and_size,
                          resolve_group)

log = logging.getLogger("spades_tpu_torch.sharded_mapping")

MISS = 2 ** 30          # edge and start of a window that hit nothing
VOTE_SUBCHUNK = 65536   # reads a sub-slice of `position_votes_sharded` maps at once


def _rows_less(a: torch.Tensor, b: torch.Tensor):
    """Lexicographic a < b and a == b for key planes; a, b: (nK, N) int64."""
    lt = torch.zeros(a.shape[1:], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[1:], dtype=torch.bool, device=a.device)
    for j in range(a.shape[0]):
        lt = lt | (eq & (a[j] < b[j]))
        eq = eq & (a[j] == b[j])
    return lt, eq


def device_searchsorted_rows(haystack: torch.Tensor, needles: torch.Tensor) -> torch.Tensor:
    """(nK, U) sorted key planes, (nK, N) queries -> (N,) int32 index of the
    leftmost equal row, or -1.

    One key plane (k <= 32) is one `torch.searchsorted`; more planes take
    the JAX package's fixed number of bisection rounds, each a gather and a
    lexicographic compare (the MPHF-lookup role)."""
    nK, U = haystack.shape
    N = needles.shape[1]
    if U == 0:
        return torch.full((N,), -1, dtype=torch.int32, device=needles.device)
    if nK == 1:
        lo = torch.searchsorted(haystack[0], needles[0], out_int32=True)
    else:
        lo = torch.zeros(N, dtype=torch.int32, device=needles.device)
        hi = torch.full((N,), U, dtype=torch.int32, device=needles.device)
        steps = max(1, int(np.ceil(np.log2(max(U, 2)))) + 1)
        for _ in range(steps):
            mid = (lo + hi) >> 1
            row = haystack.index_select(1, mid.clamp(0, U - 1))
            lt, _ = _rows_less(row, needles)     # haystack[mid] < needle
            lo = torch.where(lt, mid + 1, lo)
            hi = torch.where(lt, hi, mid)
    idx = lo.clamp(0, U - 1)
    hit = (haystack.index_select(1, idx) == needles).all(0)
    return torch.where(hit, idx, -1)


def _map_shard_body(pc, pn, lengths, index_keys, index_edge, index_off,
                    index_strand, conj, e_len, k: int, L: int):
    """Map a packed read batch against the device index.  Reads arrive in
    the 2-bit packed wire format; the kernel unpacks them.  Returns per-read
    (edge, start, votes) int32; edge = -1 for unmapped."""
    keys, valid, read_rc = canonical_window_keys(pc, pn, lengths, L, k, strand=True)
    return _map_shard_core(keys, valid, read_rc, index_keys, index_edge, index_off,
                           index_strand, conj, e_len, k=k)


def _map_shard_core(keys, valid, read_rc, index_keys, index_edge, index_off,
                    index_strand, conj, e_len, k: int):
    """keys (nK, R*P) of the reads' canonical windows, valid and read_rc
    (R, P) -> the dominant (edge, start) vote per read."""
    R, Pn = valid.shape
    dev = keys.device
    if index_edge.shape[0] == 0:
        z = torch.zeros(R, dtype=torch.int32, device=dev)
        return z - 1, z, z.clone()
    idx = device_searchsorted_rows(index_keys, keys)
    idx = torch.where(valid.reshape(-1), idx, -1)
    hit = idx >= 0
    safe = idx.clamp(0, max(index_edge.shape[0] - 1, 0))
    e = index_edge.index_select(0, safe)
    off = index_off.index_select(0, safe)
    same = read_rc.reshape(-1) == index_strand.index_select(0, safe)
    del idx, safe
    # a reverse-strand hit is a forward hit on the conjugate edge at the
    # mirrored offset
    oc = e_len.index_select(0, e) - k - off
    jj = torch.arange(Pn, dtype=torch.int32, device=dev).repeat(R)
    voted_edge = torch.where(same, e, conj.index_select(0, e))
    voted_start = torch.where(same, off, oc) - jj
    del e, off, oc, jj, same
    # (edge, start) as one int64 per window: the signed start rides in the low
    # word, offset to be non-negative, so int64 order is (edge, start) order
    vote = torch.where(hit, (voted_edge.to(torch.int64) << 32)
                       + (voted_start.to(torch.int64) + 2 ** 31),
                       (MISS << 32) + MISS + 2 ** 31)
    del voted_edge, voted_start, hit

    # dominant (edge, start) per read: row-wise sort, then the longest run
    sv = torch.sort(vote.reshape(R, Pn), dim=1).values
    del vote
    newrun = torch.ones((R, Pn), dtype=torch.bool, device=dev)
    newrun[:, 1:] = sv[:, 1:] != sv[:, :-1]
    # positions and run lengths are int32 unless their product outgrows it
    pos_t = torch.int32 if Pn * Pn < 2 ** 31 else torch.int64
    pos = torch.arange(Pn, dtype=pos_t, device=dev)[None, :]
    bpos = torch.where(newrun, pos, Pn)
    suffix_min = torch.cummin(bpos.flip(1), dim=1).values.flip(1)
    nxt = torch.cat([suffix_min[:, 1:],
                     torch.full((R, 1), Pn, dtype=pos_t, device=dev)], dim=1)
    run_len = torch.where(newrun & ((sv >> 32) < MISS), nxt - pos, 0)
    # the first of the longest runs, made explicit: the larger score is the
    # longer run, then the earlier position
    score = (run_len * Pn + (Pn - 1 - pos)).max(dim=1).values
    votes = score // Pn
    best = (Pn - 1 - score % Pn).to(torch.int64)
    top = sv.gather(1, best[:, None])[:, 0]
    mapped = votes > 0
    edge_out = torch.where(mapped, top >> 32, -1).to(torch.int32)
    start_out = torch.where(mapped, (top & 0xFFFFFFFF) - 2 ** 31, 0).to(torch.int32)
    return edge_out, start_out, votes.to(torch.int32)


def _graph_columns(g, dev):
    return (torch.from_numpy(np.ascontiguousarray(g.e_conj, np.int32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(g.e_len, np.int32)).to(dev))


def _empty_index(k: int, dev):
    z = torch.zeros(0, dtype=torch.int32, device=dev)
    return torch.zeros((K.key_planes(k), 0), dtype=torch.int64, device=dev), z, z, z


def prepare_index_device(index, g, device=None):
    """Upload a host EdgeIndex and the graph columns once.

    Returns the device tuple the mapper consumes: (keys (nK, U) int64,
    edge, offset, strand (U,) int32, conj, e_len (E,) int32)."""
    dev = resolve_device(device)
    keys = np.ascontiguousarray(K.words_to_keys(index.kmers).T)
    cols = (keys, index.edge.astype(np.int32), index.offset.astype(np.int32),
            index.strand.astype(np.int32))
    return tuple(torch.from_numpy(a).to(dev) for a in cols) + _graph_columns(g, dev)


def _rank_rows(n: int, group):
    """(lo, hi) of this rank's rows among n, and every rank's row count."""
    rank, world = rank_and_size(group)
    bounds = [process_read_slice(n, r, world) for r in range(world)]
    return bounds[rank], [b - a for a, b in bounds]


def _map_rows_local(prep, k: int, pc, pn, lengths, L: int, sub: int):
    """Map rows in sub-slices of `sub`, each queued before any result is
    read, so the device works on sub-slice i+1 while i's results wait.  On a
    CUDA out-of-memory error the sub-slice halves (down to 8,192) and the
    rows are retried; any other error escapes.  Returns device (edge, start,
    votes) int32 of every row."""
    dev = prep[0].device
    while True:
        try:
            futs = [map_packed_async(prep, k, pc[a : a + sub], pn[a : a + sub],
                                     lengths[a : a + sub], L)
                    for a in range(0, pc.shape[0], sub)]
            if not futs:
                z = torch.zeros(0, dtype=torch.int32, device=dev)
                return z, z, z
            return tuple(torch.cat([f[i] for f in futs]) for i in range(3))
        except torch.cuda.OutOfMemoryError:
            if sub <= 8192:
                raise
            log.info("mapper sub-chunk %d out of device memory, retrying at %d",
                     sub, sub // 2)
            futs = None
            sub //= 2
            torch.cuda.empty_cache()


def make_sharded_mapper(group, k: int, L: int, sub: int = 131072):
    """The mapping step over `group`: fn(pc, pn, lengths, prep) -> device
    (edge, start, votes) int32 of every row, in row order on every rank;
    each rank maps its [lo, hi) rows in sub-slices of `sub`."""
    def fn(pc, pn, lengths, prep):
        (lo, hi), sizes = _rank_rows(pc.shape[0], group)
        mine = _map_rows_local(prep, k, pc[lo:hi], pn[lo:hi], lengths[lo:hi], L, sub)
        out = gather_rows(torch.stack(mine, 1), group, sizes)
        return out[:, 0], out[:, 1], out[:, 2]
    return fn


def map_packed_async(prep, k: int, pc, pn, lengths, L: int, device=None, group=None):
    """Queue one packed wire chunk (host arrays or device tensors) against a
    prepared device index and return DEVICE (edge, start, votes) tensors
    without synchronising: callers queue several sub-chunks and pull
    afterwards, so the device stays busy during the result transfers.
    With a `group`, every rank maps its share of the rows and gathers the
    rest (a collective: every rank of the group calls it)."""
    dev = prep[0].device if device is None else resolve_device(device)
    pc, pn, lengths = (a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
                       for a in (pc, pn, lengths))
    pc, pn, lengths = (a.to(dev).contiguous() for a in (pc, pn, lengths))
    if group is not None:
        return make_sharded_mapper(group, k, L, sub=max(pc.shape[0], 1))(pc, pn, lengths, prep)
    return _map_shard_body(pc, pn, lengths, *prep, k=k, L=L)


def map_packed_sharded(prep, k: int, pc, pn, lengths, L: int, R: int, device=None,
                       group=None):
    """Map one packed wire chunk against a prepared device index.  Returns
    (edge, start, votes) numpy arrays of length R."""
    edge, start, votes = map_packed_async(prep, k, pc, pn, lengths, L, device, group)
    return (edge.cpu().numpy()[:R], start.cpu().numpy()[:R], votes.cpu().numpy()[:R])


def map_reads_sharded(index, g, batch, device=None, prep=None, group=None):
    """Host wrapper: map a ReadBatch against an EdgeIndex on the device, or
    across the group (None: the default group of a multi-process run).

    Returns (edge (R,), start (R,), votes (R,)) numpy arrays; edge == -1
    means unmapped.  Pass `prep` (from `prepare_index_device`) to reuse a
    device-resident index across calls."""
    dev = resolve_device(device)
    R = batch.codes.shape[0]
    pc, pn, lengths_w, L = batch.packed()
    if prep is None:
        prep = prepare_index_device(index, g, dev)
    return map_packed_sharded(prep, index.k, pc, pn, np.asarray(lengths_w), L, R, dev,
                              resolve_group(group))


def pair_info_sharded(g, edge1, start1, edge2, start2, insert_size: float):
    """Vectorized paired-info tuples from two mates' mappings.

    FR pairs, `paired_info/is_counter.hpp` semantics: read2's edge is
    conjugated onto read1's strand and d estimates start(e2) - start(e1).
    Returns (e1, e2, dist) int64 arrays for pairs where both mates mapped."""
    ok = (edge1 >= 0) & (edge2 >= 0)
    e1 = edge1[ok].astype(np.int64)
    o1 = start1[ok].astype(np.int64)
    e2 = np.asarray(g.e_conj)[edge2[ok]].astype(np.int64)
    o2_end = np.asarray(g.e_len)[e2] - start2[ok]
    d = np.round(o1 + insert_size - o2_end).astype(np.int64)
    return e1, e2, d


def _votes_shard_body(pc, pn, lengths, index_keys, index_edge, index_off,
                      index_strand, conj, e_len, e_off, k: int, L: int, pool_len: int):
    """Map a packed read batch, then scatter each mapped read's bases onto
    the pool positions they cover: (pool_len, 4) int32 base votes.  The
    counterpart of the JAX package's `_votes_shard_body` on one device (the
    vote merge across devices waits for the multi-GPU slice); integer adds,
    so the scatter is exact in any order."""
    from ..ops.count import unpack_batch_device

    edge, start, _votes = _map_shard_body(pc, pn, lengths, index_keys, index_edge,
                                          index_off, index_strand, conj, e_len, k=k, L=L)
    codes, n_mask = unpack_batch_device(pc, pn, L)
    return _scatter_votes(codes, n_mask, lengths, edge, start, e_len, e_off, pool_len)


def _scatter_votes(codes, n_mask, lengths, edge, start, e_len, e_off, pool_len: int):
    dev = codes.device
    L = codes.shape[1]
    pos = start[:, None] + torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    safe_e = edge.clamp(0, max(e_len.shape[0] - 1, 0)).to(torch.int64)
    inside = (pos >= 0) & (pos < e_len[safe_e][:, None]) & (edge >= 0)[:, None]
    valid_base = (codes < 4) & ~n_mask & (
        torch.arange(L, device=dev)[None, :] < lengths[:, None])
    ok = inside & valid_base
    # one dump row past the pool takes every vote that does not count
    flat = torch.where(ok, e_off[safe_e][:, None] + pos, pool_len).to(torch.int64)
    votes = torch.zeros((pool_len + 1) * 4, dtype=torch.int32, device=dev)
    votes.scatter_add_(0, (flat * 4 + codes.to(torch.int64)).reshape(-1),
                       ok.reshape(-1).to(torch.int32))
    return votes.reshape(pool_len + 1, 4)[:pool_len]


def votes_plain(codes: np.ndarray, n_mask: np.ndarray, lengths: np.ndarray,
                edge: np.ndarray, start: np.ndarray, e_len: np.ndarray,
                e_off: np.ndarray, pool_len: int) -> np.ndarray:
    """Plain numpy version of the vote scatter of `_votes_shard_body`, from
    each read's mapping (edge, start): `np.add.at` of every base of a mapped
    read that lies inside its edge."""
    R, L = codes.shape
    pos = start[:, None].astype(np.int64) + np.arange(L)[None, :]
    safe_e = np.clip(edge, 0, max(len(e_len) - 1, 0))
    ok = ((pos >= 0) & (pos < e_len[safe_e][:, None]) & (edge >= 0)[:, None]
          & (codes < 4) & ~n_mask & (np.arange(L)[None, :] < lengths[:, None]))
    votes = np.zeros((pool_len, 4), np.int32)
    np.add.at(votes, ((e_off[safe_e][:, None] + pos)[ok], codes[ok]), 1)
    return votes


def make_sharded_voter(group, k: int, L: int, pool_len: int):
    """The vote step: fn(pc, pn, lengths, prep, e_off) -> this rank's
    (pool_len, 4) int32 votes of its rows (all rows without a group, else
    its [lo, hi) share), in sub-slices of `VOTE_SUBCHUNK` rows that halve
    (down to 8,192)
    on a CUDA out-of-memory error.  The merge across ranks (the JAX
    package's psum per call) is the caller's one `all_reduce` at the end."""
    def fn(pc, pn, lengths, prep, e_off):
        if group is not None:
            (lo, hi), _ = _rank_rows(pc.shape[0], group)
            pc, pn, lengths = pc[lo:hi], pn[lo:hi], lengths[lo:hi]
        sub = VOTE_SUBCHUNK
        while True:
            try:
                part = torch.zeros((pool_len, 4), dtype=torch.int32, device=e_off.device)
                for a in range(0, pc.shape[0], sub):
                    part += _votes_shard_body(pc[a : a + sub], pn[a : a + sub],
                                              lengths[a : a + sub], *prep, e_off,
                                              k=k, L=L, pool_len=pool_len)
                return part
            except torch.cuda.OutOfMemoryError:
                if sub <= 8192:
                    raise
                log.info("vote sub-slice %d out of device memory, retrying at %d",
                         sub, sub // 2)
                part = None
                sub //= 2
                torch.cuda.empty_cache()
    return fn


def position_votes_sharded(index, g, batch=None, store=None, prep=None,
                           device=None, group=None) -> np.ndarray:
    """Per-position base votes on the device: (len(seq_pool), 4) int32.

    Same contract as `alignment.mismatch.position_votes`.  Accepts a single
    ReadBatch (`batch`) or a run-wide packed ReadStore (`store`); `prep`
    reuses a `prepare_index_device` / `build_index_device` upload.  Reads go
    in sub-slices of `VOTE_SUBCHUNK` rows, as the JAX package takes them,
    and the tally stays on the device until the end.  On a CUDA
    out-of-memory error the sub-slice halves (down to 8,192) and the chunk
    is retried; any other error escapes.  A chunk narrower than k holds no
    window, so its reads cast no vote (the JAX package raises there).
    group (None: the default group of a multi-process run): each rank votes
    with its share of every chunk's reads, and one int32 `all_reduce` sums
    the ranks' tallies."""
    dev = prep[0].device if prep is not None and device is None else resolve_device(device)
    grp = resolve_group(group)
    pool_len = int(len(g.seq_pool))
    if prep is None:
        prep = prepare_index_device(index, g, dev)
    e_off = torch.from_numpy(np.ascontiguousarray(g.e_off, np.int32)).to(dev)
    if store is not None:
        chunks = [(ch.device(dev), ch.L, ch.n) for ch in store.chunks]
    else:
        pc, pn, lengths, L = batch.packed()
        chunks = [(tuple(torch.from_numpy(np.asarray(a)).to(dev) for a in (pc, pn, lengths)),
                   L, batch.codes.shape[0])]
    votes = torch.zeros((pool_len, 4), dtype=torch.int32, device=dev)
    for (pc, pn, lengths), L, n in chunks:
        if L < index.k:
            continue
        if grp is not None:                   # only the chunk's real reads are shared out
            pc, pn, lengths = pc[:n], pn[:n], lengths[:n]
        votes += make_sharded_voter(grp, index.k, L, pool_len)(pc, pn, lengths, prep, e_off)
    if grp is not None:
        votes = all_reduce_sum(votes, grp)
    return votes.cpu().numpy()


# ---------------------------------------------------------------------------
# Device-side edge index construction: the host pushes the sequence pool and
# a row plan, and the index is extracted, canonicalized and sorted in device
# memory (the index role of SPAdes' edge_position_index.hpp).
# ---------------------------------------------------------------------------

INDEX_ROW_TIERS = (256, 2048, 8192)
# bases gathered per extraction step: bounds the step's temporaries (the
# int64 gather index is 8 bytes a base)
_TIER_STEP_BASES = 1 << 25


def _extract_index_tier(pool, row_starts, row_lens, row_edge, row_off0, row_ord0,
                        k: int, L: int):
    """One row tier: pool codes + row plan -> the columns of its VALID
    windows (key planes, edge, offset, strand, host-order ordinal).

    Rows are <= L-long slices of canonical-edge regions overlapping by k-1
    and never cross an edge boundary (the host row plan guarantees it).
    Each step gathers its rows from the pool, packs them into the wire format
    and takes their canonical windows with the canonical-windows kernel;
    windows past a row's length are dropped at once."""
    dev = pool.device
    P = L - k + 1
    j = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=dev)
    out = []
    step = max(1, _TIER_STEP_BASES // L)
    for a in range(0, row_starts.shape[0], step):
        sl = slice(a, a + step)
        gidx = (row_starts[sl, None].to(torch.int64) + j).clamp_(0, pool.shape[0] - 1)
        codes = pool[gidx]
        r = codes.shape[0]
        del gidx
        pc = (codes.reshape(r, L // 4, 4) << shifts).sum(dim=2, dtype=torch.uint8)
        del codes
        pn = torch.zeros((r, L // 8), dtype=torch.uint8, device=dev)
        keys, valid, rc = canonical_window_keys(pc, pn, row_lens[sl].contiguous(), L, k,
                                                strand=True)
        v = valid.reshape(-1)
        jp = j[:, :P].to(torch.int32)
        out.append((
            keys[:, v],
            row_edge[sl, None].expand(r, P).reshape(-1)[v],
            (row_off0[sl, None] + jp).reshape(-1)[v],
            rc.reshape(-1)[v].to(torch.int32),
            (row_ord0[sl, None] + jp).reshape(-1)[v],
        ))
    return out


def _sort_index(keys, edge, off, strand, ordn):
    """Window columns -> sorted, deduplicated index columns.

    The order is by key planes, then by the host-order ordinal (stable
    passes from the least significant up; ordinals are unique, so the result
    is fully determined): duplicate k-mers order exactly like the host
    build's stable lexsort over its edge-major concatenation, and keeping
    the first of each run is the host build's dedup."""
    order = torch.sort(ordn, stable=True).indices
    for p in range(keys.shape[0] - 1, -1, -1):
        order = order[torch.sort(keys[p][order], stable=True).indices]
    keys = keys[:, order]
    first = torch.ones(keys.shape[1], dtype=torch.bool, device=keys.device)
    first[1:] = (keys[:, 1:] != keys[:, :-1]).any(0)
    order = order[first]
    return keys[:, first], edge[order], off[order], strand[order]


def build_index_device(g, k: int | None = None, device=None,
                       timings: dict | None = None):
    """Build the mapping index tuple ON DEVICE from the graph pool.

    Returns the same tuple as `prepare_index_device(build_edge_index(g), g)`,
    array for array, without the host pack, canonicalize and lexsort.

    Edges are binned into row-length TIERS (256/2048/8192): one fixed row
    length would pad every short edge to it.  Each tier yields the columns of
    its valid windows; one global sort (host-order ordinal as tiebreak) and a
    keep-first dedup produce the index.

    timings: optional dict that receives wall seconds of the host row plan
    and uploads (`plan_s`), the window extraction (`extract_s`) and the sort
    and dedup (`sort_s`), each ended by a device synchronise, the rows of
    each tier (`tier_rows`) and the window and index row counts."""

    def _mark(key, t0):
        if timings is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0

    dev = resolve_device(device)
    k = k or g.k
    t0 = time.perf_counter()
    ids = g.canonical_edge_ids()
    graph_cols = _graph_columns(g, dev)
    lens = g.e_len[ids].astype(np.int64)
    keep = lens >= k
    if not keep.any():
        return _empty_index(k, dev) + graph_cols
    ids_k, lens_k = ids[keep], lens[keep]
    offs_k = g.e_off[ids].astype(np.int64)[keep]
    # host-order ordinal base per edge: the host index concatenates windows
    # edge-major in canonical-id order
    nwin = lens_k - k + 1
    ord_base = np.cumsum(nwin) - nwin
    if int(nwin.sum()) >= 2 ** 31:
        raise ValueError("the edge index holds at most 2^31 - 1 windows")
    pool = torch.from_numpy(np.ascontiguousarray(g.seq_pool, np.uint8) & 3).to(dev)

    def _d(a):
        return torch.from_numpy(a.astype(np.int32)).to(dev)

    parts = []
    tiers = list(INDEX_ROW_TIERS)
    for ti, L in enumerate(tiers):
        step = L - (k - 1)
        lo = tiers[ti - 1] if ti else 0
        sel = lens_k > lo
        if ti + 1 < len(tiers):
            sel &= lens_k <= L
        if not sel.any():
            continue
        s_ids, s_offs, s_lens = ids_k[sel], offs_k[sel], lens_k[sel]
        nrows = np.maximum((s_lens - k) // step + 1, 1)
        total = int(nrows.sum())
        if timings is not None:
            timings.setdefault("tier_rows", {})[L] = total
        base = np.repeat(np.cumsum(nrows) - nrows, nrows)
        off0 = (np.arange(total, dtype=np.int64) - base) * step
        p0 = np.repeat(s_offs, nrows) + off0
        rl = np.minimum(L, np.repeat(s_offs + s_lens, nrows) - p0)
        plan = (_d(p0), _d(rl), _d(np.repeat(s_ids, nrows)), _d(off0),
                _d(np.repeat(ord_base[sel], nrows) + off0))
        _mark("plan_s", t0)
        t0 = time.perf_counter()
        parts += _extract_index_tier(pool, *plan, k=k, L=L)
        _mark("extract_s", t0)
        t0 = time.perf_counter()
    del pool
    cols = [torch.cat([p[i] for p in parts], dim=-1) for i in range(5)]
    del parts
    out = _sort_index(*cols)
    _mark("sort_s", t0)
    if timings is not None:
        timings["windows"] = int(cols[1].shape[0])
        timings["index_rows"] = int(out[1].shape[0])
    return out + graph_cols


def _hit_shard_body(pc, pn, lengths, tip_keys, k: int, L: int):
    """Does each read have >= 1 canonical window in the (small) tip-region
    k-mer table?"""
    keys, valid = canonical_window_keys(pc, pn, lengths, L, k)
    idx = device_searchsorted_rows(tip_keys, keys)
    return ((idx >= 0) & valid.reshape(-1)).reshape(valid.shape).any(dim=1)


def make_sharded_hitter(group, k: int, L: int, sub: int = 65536):
    """The prefilter step: fn(pc, pn, lengths, tip_keys) -> (rows,) bool
    device hits in row order (with a group, every rank tests its [lo, hi)
    share in sub-slices of `sub` and the hits are gathered on every rank)."""
    def fn(pc, pn, lengths, tip_keys):
        sizes = None
        if group is not None:
            (lo, hi), sizes = _rank_rows(pc.shape[0], group)
            pc, pn, lengths = pc[lo:hi], pn[lo:hi], lengths[lo:hi]
        hits = [_hit_shard_body(pc[a : a + sub], pn[a : a + sub], lengths[a : a + sub],
                                tip_keys, k=k, L=L)
                for a in range(0, pc.shape[0], sub)]
        hits = (torch.cat(hits) if hits
                else torch.zeros(0, dtype=torch.bool, device=tip_keys.device))
        if group is None:
            return hits
        return gather_rows(hits.to(torch.uint8), group, sizes).to(torch.bool)
    return fn


def hit_filter_store(store, tip_words: np.ndarray, k: int, device=None,
                     sub: int = 65536, group=None) -> np.ndarray:
    """(store.n,) bool: read has >= 1 canonical window among tip_words.

    The gap closer's device prefilter: the tip-region table is tiny, so the
    expensive full-index search runs only for candidate reads afterwards.
    A chunk narrower than k holds no window, so none of its reads hits.
    group (None: the default group of a multi-process run): every rank
    tests its share of each chunk's reads, and the hits are gathered."""
    dev = resolve_device(device)
    grp = resolve_group(group)
    tw = torch.from_numpy(np.ascontiguousarray(K.words_to_keys(tip_words).T)).to(dev)
    out = np.zeros(store.n, bool)
    # queue every sub-slice of every chunk first, pull afterwards
    futs = []
    for ch in store.chunks:
        if ch.L < k:
            futs.append(None)
            continue
        pc, pn, lengths = ch.device(dev)
        if grp is not None:
            pc, pn, lengths = pc[: ch.n], pn[: ch.n], lengths[: ch.n]
        futs.append(make_sharded_hitter(grp, k, ch.L, sub)(pc, pn, lengths, tw))
    c0 = 0
    for ch, f in zip(store.chunks, futs):
        if f is not None:
            out[c0 : c0 + ch.n] = f.cpu().numpy()[: ch.n]
        c0 += ch.n
    return out
