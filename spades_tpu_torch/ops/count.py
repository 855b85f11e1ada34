"""K-mer counting engine.

The counting pipeline of `spades_tpu.ops.count` on PyTorch: every batch of
reads goes to the device in the packed wire format, the canonical-window
kernel (`ops/cuda_kernels.py`) turns it into int64 sort keys
(`core/kmers.py`), one lexicographic sort plus a run-length pass counts the
batch, and the counted runs merge on the device in a `DeviceRunStack`; the
host pulls one table per k.  Small batches are counted in numpy on the host,
under the same `SPADES_HOST_COUNT_WINDOWS` threshold as the JAX package.
Counterpart of SPAdes' counting pipeline
(`src/common/kmer_index/kmer_mph/kmer_index_builder.hpp:306`: split reads
into buckets, sort + dedup buffers, merge).
"""
from __future__ import annotations

import gc
import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..core import kmers as K
from ..core.reads import PackedChunk, ReadBatch
from ..utils.timetracer import span
from .cuda_kernels import canonical_window_keys


def unpack_batch_device(pc: torch.Tensor, pn: torch.Tensor, L: int):
    """Unpack the ReadBatch.packed() wire format on the tensors' device.

    pc (R, ceil(L/4)) uint8 -> codes (R, L) uint8 in {0..3};
    pn (R, ceil(L/8)) uint8 (little bit order) -> n_mask (R, L) bool."""
    R = pc.shape[0]
    shifts = torch.arange(4, dtype=torch.uint8, device=pc.device) * 2
    codes = ((pc[:, :, None] >> shifts) & 3).reshape(R, 4 * pc.shape[1])[:, :L]
    bits = torch.arange(8, dtype=torch.uint8, device=pn.device)
    n_mask = ((pn[:, :, None] >> bits) & 1).reshape(R, 8 * pn.shape[1])[:, :L].to(torch.bool)
    return codes, n_mask


def _lex_order(keys) -> torch.Tensor:
    """Permutation that sorts the columns of (nK, N) key planes (a tensor or
    a list of nK planes) lexicographically: one sort for one plane, else
    stable sorts from the least significant plane up."""
    order = torch.sort(keys[-1], stable=True).indices
    for j in range(len(keys) - 2, -1, -1):
        order = order[torch.sort(keys[j][order], stable=True).indices]
    return order


def _reduce_sorted(sk: torch.Tensor, counts: torch.Tensor | None):
    """Sorted (nK, N) key planes (sentinel rows last) -> unique rows and
    their summed counts (run lengths when `counts` is None).

    Returns (keys (nK, U) int64, counts (U,) int64), in sorted order."""
    n = sk.shape[1]
    boundary = torch.ones(n, dtype=torch.bool, device=sk.device)
    boundary[1:] = (sk[:, 1:] != sk[:, :-1]).any(0)      # includes the sentinel run
    starts = boundary & (sk != K.KEY_SENTINEL).any(0)
    # each row's next boundary by a reversed cumulative min, as in the JAX
    # package: a run's length (or count sum) is taken at its start row
    pos = torch.arange(n, dtype=torch.int64, device=sk.device)
    bpos = torch.where(boundary, pos, n)
    suffix_min = torch.cummin(bpos.flip(0), 0).values.flip(0)
    next_boundary = torch.cat([suffix_min[1:], suffix_min.new_full((1,), n)])
    if counts is None:
        row_counts = next_boundary - pos
    else:
        csum = torch.zeros(n + 1, dtype=torch.int64, device=sk.device)
        csum[1:] = torch.cumsum(counts, 0)
        row_counts = csum[next_boundary] - csum[pos]
    # a boolean-mask select compacts the unique rows to the front, in order
    return sk[:, starts], row_counts[starts]


def count_batch_device_unique(keys: torch.Tensor):
    """Count one batch on its device: sort the window keys, then take run
    starts and run lengths.  keys (nK, N) int64 with sentinel rows for
    invalid windows.  Returns (unique keys (nK, U), counts (U,) int64)."""
    return _reduce_sorted(keys[:, _lex_order(keys)], None)


def count_batch_packed_unique(pc: torch.Tensor, pn: torch.Tensor,
                              lengths: torch.Tensor, L: int, k: int):
    """Packed wire -> canonical window keys (kernel) -> counted run."""
    keys, _ = canonical_window_keys(pc, pn, lengths, L, k)
    return count_batch_device_unique(keys)


def _words_of_keys(sk: torch.Tensor, W: int) -> torch.Tensor:
    """(nK, ...) int64 sort keys -> (..., W) int64-held uint32 words (the
    sentinel key gives all-0xFFFFFFFF words, the JAX package's sentinel)."""
    from .hll import key_words

    return torch.stack(key_words(sk, W), dim=-1)


def count_batch_device(pc: torch.Tensor, pn: torch.Tensor, lengths: torch.Tensor,
                       L: int, k: int):
    """One device pass over a packed read batch: every canonical window
    sorted, with run-start flags; invalid windows are sentinel rows that
    sort to the end.  Returns (sorted words (N, W) int64, starts (N,) bool,
    n_valid () int64), the JAX package's `count_batch_device` with words as
    int64."""
    keys, valid = canonical_window_keys(pc, pn, lengths, L, k)
    sk = keys[:, _lex_order(keys)]
    starts = torch.ones(sk.shape[1], dtype=torch.bool, device=sk.device)
    starts[1:] = (sk[:, 1:] != sk[:, :-1]).any(0)
    return _words_of_keys(sk, K.kmer_words(k)), starts, valid.sum()


def count_batch_device_tiled(pc: torch.Tensor, pn: torch.Tensor, lengths: torch.Tensor,
                             L: int, k: int, tile: int = 512):
    """Tiled device pass: the canonical windows of a packed read batch cut
    into tiles of `tile` rows (the last padded with sentinel rows), each
    tile sorted on its own: independent sorted runs, as SPAdes' per-thread
    sort buffers (`kmer_splitter.hpp:75-120`); `merge_counts` sums them.
    Returns (sorted words (T, tile, W) int64, starts (T, tile) bool, n_valid
    (T,) int64 count of non-sentinel rows per tile), the JAX package's
    `count_batch_device_tiled` with words as int64."""
    keys, _ = canonical_window_keys(pc, pn, lengths, L, k)
    n = keys.shape[1]
    pad = (-n) % tile
    if pad:
        keys = torch.cat([keys, keys.new_full((keys.shape[0], pad), K.KEY_SENTINEL)], dim=1)
    tiles = keys.reshape(keys.shape[0], -1, tile)
    # stable sorts of every tile at once, from the least significant plane up
    order = torch.sort(tiles[-1], dim=1, stable=True).indices
    for j in range(tiles.shape[0] - 2, -1, -1):
        order = order.gather(1, torch.sort(tiles[j].gather(1, order), dim=1,
                                           stable=True).indices)
    sk = tiles.gather(2, order[None].expand_as(tiles))
    starts = torch.ones(sk.shape[1:], dtype=torch.bool, device=sk.device)
    starts[:, 1:] = (sk[:, :, 1:] != sk[:, :, :-1]).any(0)
    n_valid = (sk != K.KEY_SENTINEL).any(0).sum(1)
    return _words_of_keys(sk, K.kmer_words(k)), starts, n_valid


# ---------------------------------------------------------------------------
# Device-resident run accumulation: per-batch unique runs stay on the device
# and merge there; the host pulls ONE final table per k (SPAdes keeps its
# buckets on disk and merges them once at the end of counting,
# `kmer_index_builder.hpp:306-430`).
# ---------------------------------------------------------------------------


def _pow2ceil(n: int, floor: int = 4096) -> int:
    """Smallest power of two >= max(n, floor): run capacities come from a
    small set of sizes, so the caching allocator reuses their blocks."""
    n = max(int(n), floor)
    return 1 << (n - 1).bit_length()


def _compact_run_device(keys: torch.Tensor, counts: torch.Tensor, nu: int, cap: int):
    """A run at capacity `cap`: columns [0, nu) keep their (sorted unique)
    keys and counts, columns [nu, cap) become sentinel / zero."""
    w = torch.full((keys.shape[0], cap), K.KEY_SENTINEL, dtype=torch.int64,
                   device=keys.device)
    c = torch.zeros(cap, dtype=torch.int64, device=keys.device)
    w[:, :nu] = keys[:, :nu]
    c[:nu] = counts[:nu]
    return w, c


def _merge_runs_device(k1, c1, k2, c2):
    """Merge two device runs (sorted unique + sentinel tail): concatenate,
    sort, sum the counts of equal rows.  Returns (keys, counts), compact."""
    keys = torch.cat([k1, k2], dim=1)
    counts = torch.cat([c1, c2])
    order = _lex_order(keys)
    return _reduce_sorted(keys[:, order], counts[order])


def _oom_retry(fn, attempts: int = 3):
    """Run fn; on a CUDA out-of-memory error, collect garbage, return the
    allocator's cached blocks to the driver and retry."""
    for i in range(attempts):
        try:
            return fn()
        except torch.cuda.OutOfMemoryError:
            if i == attempts - 1:
                raise
            gc.collect()
            torch.cuda.empty_cache()
    raise RuntimeError("unreachable")


class DeviceRunStack:
    """LSM-style stack of device-resident sorted unique runs.

    `push` adds one batch's counted run; runs of equal pow2 capacity merge
    eagerly (binary-counter discipline), so at most one run per level is
    live and device memory stays O(final unique).  `finish` merges the rest
    and returns ONE host KmerCounts — the only bulk device->host transfer.
    """

    def __init__(self, k: int, timings: dict | None = None):
        self.k = k
        self.tm = timings if timings is not None else {}
        self.stack: list[list] = []  # [keys, counts, cap, nu]

    def _compact(self, keys, counts, nu: int):
        cap = _pow2ceil(nu)
        w, c = _compact_run_device(keys, counts, nu, cap)
        return [w, c, cap, nu]

    def _merge_top(self) -> None:
        w2, c2, _, _ = self.stack.pop()
        w1, c1, _, _ = self.stack.pop()
        mk, mc = _oom_retry(lambda: _merge_runs_device(w1, c1, w2, c2))
        self.stack.append(self._compact(mk, mc, mk.shape[1]))

    def push(self, keys: torch.Tensor, counts: torch.Tensor, nu: int) -> None:
        if nu <= 0:
            return
        with span(".merge", into=self.tm, key="merge_s"):
            self.stack.append(self._compact(keys, counts, nu))
            while len(self.stack) >= 2 and self.stack[-1][2] == self.stack[-2][2]:
                self._merge_top()

    def finish_device(self):
        """Merge every run into one; returns its (keys (nK, U), counts (U,))
        on the device, or None when nothing was pushed."""
        if not self.stack:
            return None
        with span(".merge", into=self.tm, key="merge_s"):
            while len(self.stack) >= 2:
                self._merge_top()
        w, c, _, nu = self.stack.pop()
        return w[:, :nu], c[:nu]

    def finish(self) -> KmerCounts:
        W = K.kmer_words(self.k)
        got = self.finish_device()
        if got is None:
            return KmerCounts(k=self.k, words=np.zeros((0, W), np.uint32),
                              counts=np.zeros(0, np.int64))
        w, c = got
        with span(".pull", into=self.tm, key="pull_s"):
            # counts cross to the host as uint16 when they fit (the common case:
            # multiplicities ~ coverage) — 2 bytes/row instead of 8
            if int(c.max()) < 0xFFFF:
                c = c.to(torch.uint16)
            keys = w.T.contiguous().cpu().numpy()
            counts = c.cpu().numpy().astype(np.int64)
        return KmerCounts(k=self.k, words=K.keys_to_words(keys, W), counts=counts)


@dataclass
class KmerCounts:
    """Sorted unique canonical k-mers with multiplicities (host arrays)."""

    k: int
    words: np.ndarray  # (U, W) uint32, lexicographically sorted
    counts: np.ndarray  # (U,) int64

    @property
    def num_unique(self) -> int:
        return int(self.words.shape[0])

    @property
    def total(self) -> int:
        return int(self.counts.sum())

    def merge(self, other: "KmerCounts") -> "KmerCounts":
        assert self.k == other.k
        return merge_counts([self, other])


def _empty_counts(k: int) -> KmerCounts:
    return KmerCounts(k=k, words=np.zeros((0, K.kmer_words(k)), np.uint32),
                      counts=np.zeros(0, np.int64))


def _lexsort_rows(words: np.ndarray) -> np.ndarray:
    """np.lexsort over word columns (word 0 most significant)."""
    return np.lexsort(tuple(words[:, w] for w in range(words.shape[1] - 1, -1, -1)))


def count_batch_host(
    codes: np.ndarray, lengths: np.ndarray, n_mask: np.ndarray, k: int
) -> KmerCounts:
    """Host (numpy) counting of one batch: canonical windows -> sorted
    unique rows with counts.  Small batches (prev-K contigs, tool inputs)
    are counted here, as SPAdes special-cases small inputs onto its plain
    sorting splitter (`kmer_splitters.hpp:139`)."""
    R, L = codes.shape
    if R == 0 or L < k:
        return _empty_counts(k)
    P = L - k + 1
    win = np.lib.stride_tricks.sliding_window_view(
        np.ascontiguousarray(codes), k, axis=1
    ).reshape(-1, k)
    pos = np.tile(np.arange(P), R)
    row = np.repeat(np.arange(R), P)
    bad = np.lib.stride_tricks.sliding_window_view(
        np.ascontiguousarray(n_mask), k, axis=1
    ).any(axis=2).reshape(-1)
    valid = (pos + k <= lengths[row]) & ~bad
    if not valid.any():
        return _empty_counts(k)
    fwd = K.pack(win[valid])
    rc = K.revcomp_words(fwd, k)
    use_rc = K.lex_less(rc, fwd)
    canon = np.where(use_rc[:, None], rc, fwd)
    order = _lexsort_rows(canon)
    s = canon[order]
    new = np.empty(len(s), bool)
    new[0] = True
    new[1:] = np.any(s[1:] != s[:-1], axis=1)
    counts = np.diff(np.append(np.flatnonzero(new), len(s)))
    return KmerCounts(k=k, words=s[new].copy(), counts=counts.astype(np.int64))


def merge_counts(runs: list[KmerCounts]) -> KmerCounts:
    """Merge sorted unique runs on the host, summing counts.

    Native C++ loser tree when available (`native/merge.cpp`, mirroring
    SPAdes' MergeKMers, `kmer_index_builder.hpp:346`); numpy lexsort
    fallback."""
    if not runs:
        raise ValueError("no runs to merge")
    k0 = runs[0].k
    runs = [r for r in runs if r.num_unique > 0]
    if not runs:
        return _empty_counts(k0)
    if len(runs) == 1:
        return runs[0]
    k = runs[0].k
    words = np.concatenate([r.words for r in runs], axis=0)
    counts = np.concatenate([r.counts for r in runs], axis=0)

    from ..native import merge_runs_native

    run_off = np.zeros(len(runs) + 1, np.uint64)
    np.cumsum([r.num_unique for r in runs], out=run_off[1:])
    merged = merge_runs_native(words, counts, run_off)
    if merged is not None:
        return KmerCounts(k=k, words=merged[0], counts=merged[1])

    order = _lexsort_rows(words)
    words, counts = words[order], counts[order]
    new = np.concatenate([[True], np.any(words[1:] != words[:-1], axis=1)])
    seg = np.cumsum(new) - 1
    out_counts = np.zeros(seg[-1] + 1, np.int64)
    np.add.at(out_counts, seg, counts)
    return KmerCounts(k=k, words=words[new], counts=out_counts)


def count_reads(batches, k: int, timings: dict | None = None,
                structure_batches=None, device=None) -> KmerCounts:
    """Count canonical k-mers over an iterable of ReadBatches or PackedChunks.

    Each batch at or above `SPADES_HOST_COUNT_WINDOWS` windows (default
    4,000,000) is counted on `device` and its sorted unique run stays there;
    runs merge through a `DeviceRunStack` and the host pulls one table per
    k.  Smaller batches are counted in numpy on the host.

    structure_batches: batches whose k-mers join the table with count 0 —
    prev-K / trusted contigs, which add graph structure but no coverage
    (SPAdes `stages/construction.cpp:110,233`).

    timings: optional dict accumulating wall seconds per phase: device_s
    (upload + kernel + sort, synchronized), device_first_s (the first such
    batch, which carries the kernel build when it is cold), pull_s (final
    device->host transfer), merge_s (device run merging + host merge),
    host_s (numpy small-batch path), and n_batches (device batches).  Each
    phase is a span (`.count_device`, `.pull`, `.merge`, `.count_host`,
    named after the caller's step: `construction.count_host`).
    """
    dev = resolve_device(device)
    tm = timings if timings is not None else {}
    for key in ("device_s", "device_first_s", "pull_s", "merge_s", "host_s"):
        tm.setdefault(key, 0.0)
    tm.setdefault("n_batches", 0)
    first_device = True
    host_thresh = int(os.environ.get("SPADES_HOST_COUNT_WINDOWS", 4_000_000))
    host_runs: list[KmerCounts] = []
    dstack = DeviceRunStack(k, timings=tm)

    def _process(iterable, zero_counts: bool) -> None:
        nonlocal first_device
        for b in iterable:
            if isinstance(b, PackedChunk):
                if b.L < k or b.n == 0:
                    continue
                small = b.n * (b.L - k + 1) < host_thresh
                hb = b.unpack_host() if small else None
                R, L = b.n, b.L
            elif isinstance(b, ReadBatch):
                if b.codes.shape[0] == 0 or b.codes.shape[1] < k:
                    continue
                R, L = b.codes.shape
                small = R * (L - k + 1) < host_thresh
                hb = b
            else:
                raise TypeError(f"cannot count a {type(b).__name__}")
            if small:
                with span(".count_host", into=tm, key="host_s", reads=int(R)):
                    r = count_batch_host(hb.codes[:R], hb.lengths[:R], hb.n_mask[:R], k)
                if r.num_unique:
                    if zero_counts:
                        r = KmerCounts(k=r.k, words=r.words,
                                       counts=np.zeros_like(r.counts))
                    host_runs.append(r)
                continue
            before = tm["device_s"]
            with span(".count_device", into=tm, key="device_s", reads=int(R)):
                if isinstance(b, PackedChunk):
                    # run-wide read store: uploaded once, reused at every k
                    pc, pn, lengths = b.device(dev)
                else:
                    pc, pn, lengths, L = b.packed()
                    pc, pn, lengths = (torch.from_numpy(a).to(dev) for a in (pc, pn, lengths))
                uk, uc = count_batch_packed_unique(pc, pn, lengths, L, k)
                nu = uk.shape[1]
            if first_device:
                tm["device_first_s"] = tm["device_s"] - before
                first_device = False
            tm["n_batches"] += 1
            if nu:
                dstack.push(uk, torch.zeros_like(uc) if zero_counts else uc, nu)

    _process(batches, zero_counts=False)
    if structure_batches is not None:
        _process(structure_batches, zero_counts=True)
    runs = host_runs
    if dstack.stack:
        runs = runs + [dstack.finish()]
    if not runs:
        return _empty_counts(k)
    with span(".merge", into=tm, key="merge_s"):
        return merge_counts(runs)


def count_sequences(seqs, k: int, batch_size: int = 65536,
                    timings: dict | None = None, device=None) -> KmerCounts:
    """Count canonical k-mers of a list of sequences.

    Long sequences are chopped into window-preserving chunks first so a
    single long contig cannot blow up the padded batch shape."""
    from ..core.reads import batch_iter, chop_sequences

    return count_reads(batch_iter(chop_sequences(seqs, k), batch_size=batch_size), k,
                       timings=timings, device=device)


def _rows_u64(rows: np.ndarray, w0: int, w1: int) -> np.ndarray:
    """Words [w0, w1) of packed rows as one lexicographic uint64 key
    (missing words padded with zero, matching lexicographic order of
    zero-padded rows)."""
    hi = rows[:, w0].astype(np.uint64) << np.uint64(32)
    if w1 - w0 > 1 and rows.shape[1] > w0 + 1:
        hi |= rows[:, w0 + 1].astype(np.uint64)
    return hi


class RowIndex:
    """A sorted unique array of packed k-mer rows with its search keys built
    once, for a caller that looks many batches of rows up in the same array
    (`find` answers as `searchsorted_rows` does)."""

    def __init__(self, haystack: np.ndarray):
        self.haystack = haystack
        self.W = haystack.shape[1]
        self._hb = None
        if haystack.shape[0] == 0:
            return
        if self.W <= 2:
            self.h = _rows_u64(haystack, 0, 2)
        elif self.W <= 4:
            self.h1 = _rows_u64(haystack, 0, 2)
            self.h2 = _rows_u64(haystack, 2, 4)
        else:
            self._bytes()

    def _bytes(self) -> np.ndarray:
        if self._hb is None:
            self._hb = np.ascontiguousarray(
                self.haystack.astype(">u4")).view(f"V{4 * self.W}").ravel()
        return self._hb

    def find(self, needles: np.ndarray) -> np.ndarray:
        """Index of each needle row in the haystack, or -1 where absent."""
        W = self.W
        if self.haystack.shape[0] == 0:
            return np.full(needles.shape[0], -1, np.int64)
        if needles.shape[0] == 0:
            return np.zeros(0, np.int64)
        if W <= 2:
            h = self.h
            n = _rows_u64(needles, 0, 2)
            pos = np.searchsorted(h, n)
            pos_c = np.minimum(pos, len(h) - 1)
            return np.where(h[pos_c] == n, pos_c, -1)
        if W <= 4:
            h1, h2 = self.h1, self.h2
            n1 = _rows_u64(needles, 0, 2)
            n2 = _rows_u64(needles, 2, 4)
            H = len(h1)
            lo = np.searchsorted(h1, n1, side="left")
            out = np.full(len(n1), -1, np.int64)
            # needles whose prefix is present, scanned along their prefix
            # block one row per step (only those still pending)
            rem = np.flatnonzero(h1[np.minimum(lo, H - 1)] == n1)
            j = 0
            while rem.size and j < 256:
                cand = lo[rem] + j
                c = np.minimum(cand, H - 1)
                still = (cand < H) & (h1[c] == n1[rem])
                hit = still & (h2[c] == n2[rem])
                out[rem[hit]] = cand[hit]
                rem = rem[still & ~hit]
                j += 1
            if rem.size:                      # adversarially long prefix blocks
                hb = self._bytes()
                nb = np.ascontiguousarray(needles[rem].astype(">u4")).view(f"V{4*W}").ravel()
                pos = np.searchsorted(hb, nb)
                pc = np.minimum(pos, len(hb) - 1)
                out[rem] = np.where(hb[pc] == nb, pc, -1)
            return out
        hb = self._bytes()
        nb = np.ascontiguousarray(needles.astype(">u4")).view(f"V{4*W}").ravel()
        pos = np.searchsorted(hb, nb)
        pos_c = np.minimum(pos, len(hb) - 1)
        found = hb[pos_c] == nb
        return np.where(found, pos_c, -1)


def searchsorted_rows(haystack: np.ndarray, needles: np.ndarray) -> np.ndarray:
    """Host-side lookup of packed k-mer rows in a sorted unique array.

    Returns index into haystack, or -1 where absent (the index role of
    SPAdes' MPHF `KMerIndex`, `kmer_mph/kmer_index.hpp:29`).

    Rows up to 2 words search as one uint64 key; rows up to 4 words use a
    two-level search (uint64 prefix blocks, then a bounded scan over the
    uint64 suffix within each block).  Wider rows use a void-dtype memcmp
    search.
    """
    return RowIndex(haystack).find(needles)
