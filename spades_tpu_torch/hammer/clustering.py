"""Hamming-distance clustering of counted k-mers (BayesHammer core step).

Capability mirror of SPAdes' `KMerHamClusterer`
(`src/projects/hammer/hamcluster.cpp`): k-mers within Hamming distance tau
of each other are united into clusters, found by sorting on sub-k-mer blocks
— two k-mers at distance <= tau agree exactly on at least one of tau+1
blocks, so candidate pairs only need to be examined inside runs of equal
block value.  The block grouping is a vectorized sort, the distance test
an XOR/popcount over the packed 2-bit words, and the DSU a path-halving
union-find on the host.  Oversized runs (low-complexity / repeat blocks) are
split recursively on sub-blocks of the remaining positions, as SPAdes
sub-clusters large blocks recursively.

The algorithm of the JAX package's `spades_tpu/hammer/clustering.py`, made
cheaper without a change of result: a part's rows sort by one stable argsort
of their packed bases (the permutation of the column lexsort); the blocks
below the cap are tested in one vectorized step per block size
(`_block_matches`), and the matching pairs are put back in the order that
package's per-block loop visits them; `DSU.union_pairs` runs the same unions
in the same order in the native library (`native/hammer.cpp`), else on
Python lists.  The parent array, and so every label, is the same.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..core import kmers as K
from ..native import dsu_union_pairs_native

_POPCNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)


def hamming_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Base-level Hamming distance between packed (N, W) uint32 k-mer rows."""
    d = a ^ b
    # a 2-bit field differs iff either of its bits differs; project onto the
    # low bit of each field then popcount.
    m = (d | (d >> np.uint32(1))) & np.uint32(0x55555555)
    dist = np.zeros(m.shape[:-1], np.int32)
    for w in range(m.shape[-1]):
        x = m[..., w]
        dist += (
            _POPCNT[x & 0xFF]
            + _POPCNT[(x >> 8) & 0xFF]
            + _POPCNT[(x >> 16) & 0xFF]
            + _POPCNT[(x >> 24) & 0xFF]
        ).astype(np.int32)
    return dist


class DSU:
    """Union-find with path halving + union by size (host-side)."""

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)
        self.size = np.ones(n, dtype=np.int64)

    def union_pairs(self, a: np.ndarray, b: np.ndarray) -> None:
        """Unite a[i] and b[i] for every i in order (find with path halving,
        the smaller root under the larger, the first one's on a tie): in the
        native library, else on Python lists."""
        if not len(a) or dsu_union_pairs_native(self.parent, self.size, a, b):
            return
        p = self.parent.tolist()
        s = self.size.tolist()
        for x, y in zip(a.tolist(), b.tolist()):
            while p[x] != x:
                p[x] = p[p[x]]
                x = p[x]
            while p[y] != y:
                p[y] = p[p[y]]
                y = p[y]
            if x == y:
                continue
            if s[x] < s[y]:
                x, y = y, x
            p[y] = x
            s[x] += s[y]
        self.parent = np.array(p, dtype=np.int64)
        self.size = np.array(s, dtype=np.int64)

    def labels(self) -> np.ndarray:
        """Dense cluster ids (0..C-1) for every element.

        Roots found by vectorized pointer doubling (p <- p[p] to fixpoint),
        the same trick the condensation engine uses for list ranking."""
        p = self.parent
        while True:
            pp = p[p]
            if np.array_equal(pp, p):
                break
            p = pp
        self.parent = p
        _, labels = np.unique(p, return_inverse=True)
        return labels


def _runs(key: np.ndarray):
    """Starts and sizes of the runs of equal values in a sorted key."""
    starts = np.flatnonzero(np.concatenate([[True], key[1:] != key[:-1]]))
    return starts, np.append(starts[1:], len(key)) - starts


def _part_order(codes: np.ndarray):
    """The stable lexicographic order of (N, m) base rows and their sorted
    run keys: one stable argsort of the rows packed 2 bits a base (up to 32
    bases; the same permutation as `np.lexsort` over the columns), else the
    lexsort itself with the rows as their own key."""
    if codes.shape[1] <= 32:
        key = np.zeros(len(codes), np.uint64)
        for j in range(codes.shape[1]):
            key = (key << np.uint64(2)) | codes[:, j].astype(np.uint64)
        order = np.argsort(key, kind="stable")
        return order, key[order]
    order = np.lexsort(tuple(codes[:, j] for j in range(codes.shape[1] - 1, -1, -1)))
    s = codes[order]
    return order, np.cumsum(np.concatenate([[True], np.any(s[1:] != s[:-1], axis=1)]))


def _cluster_block(
    idx: np.ndarray,
    words: np.ndarray,
    k: int,
    rest: np.ndarray,
    tau: int,
    cap: int,
    blocks: list,
) -> None:
    """Collect candidate blocks whose all-pairs need a distance test.

    idx: global indices of the block members; rest: remaining base positions
    (the block already agrees on the other positions).  Blocks larger than
    `cap` are split recursively on halves of `rest` (a pair at distance <= tau
    restricted to `rest` still agrees on one half when tau == 1).  Small
    blocks are appended to `blocks`.
    """
    n = len(idx)
    if n < 2:
        return
    if n > cap and len(rest) >= 2 and tau == 1:
        half = len(rest) // 2
        codes = K.unpack(words[idx], k)
        for part in (rest[:half], rest[half:]):
            order, key = _part_order(codes[:, part])
            starts, sizes = _runs(key)
            other = np.setdiff1d(rest, part, assume_unique=True)
            for a, m in zip(starts.tolist(), sizes.tolist()):
                if m >= 2:
                    _cluster_block(idx[order[a : a + m]], words, k, other, tau, cap, blocks)
        return
    blocks.append(idx)


_FIELD_LOW_BITS = np.uint64(0x5555555555555555)


def _uint64_rows(words: np.ndarray) -> np.ndarray:
    """Packed rows of one or two words as one uint64 each, base 0 in the top
    two bits (the 2-bit fields keep their alignment)."""
    key = words[:, 0].astype(np.uint64) << np.uint64(32)
    if words.shape[1] == 2:
        key |= words[:, 1].astype(np.uint64)
    return key


_PAIR_SLOTS = 1 << 22       # pair slots one step of `_block_matches` tests at once


def _block_matches(order: np.ndarray, starts: np.ndarray, sizes: np.ndarray,
                   words: np.ndarray, tau: int):
    """The pairs (a, b) at Hamming distance <= tau inside each block
    `order[starts[b] : starts[b] + sizes[b]]`, block after block and, inside
    a block, in `np.triu_indices` order: the matching pairs of the JAX
    package's per-block loop, in the order it unions them.

    Blocks of one size go through the test together, `_PAIR_SLOTS` pair slots
    at a time, on a thread pool (numpy releases the GIL in the array work); rows of
    at most 64 bits are compared as one uint64 each, wider rows word by word
    (`hamming_distance`)."""
    keys = _uint64_rows(words) if words.shape[1] <= 2 else None
    work = []
    for n in np.unique(sizes).tolist():
        sel = np.flatnonzero(sizes == n)
        step = max(1, _PAIR_SLOTS // (n * (n - 1) // 2))
        work += [(n, sel[c0 : c0 + step]) for c0 in range(0, len(sel), step)]

    def _test(item):
        n, blocks = item
        iu, ju = np.triu_indices(n, 1)
        members = order[starts[blocks][:, None] + np.arange(n)]      # (c, n)
        if keys is not None:
            km = keys[members]
            x = km[:, iu] ^ km[:, ju]
            d = np.bitwise_count((x | (x >> np.uint64(1))) & _FIELD_LOW_BITS)
        else:
            d = hamming_distance(words[members[:, iu]], words[members[:, ju]])
        bi, ri = np.nonzero(d <= tau)
        return blocks[bi], ri, members[bi, iu[ri]], members[bi, ju[ri]]

    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as pool:
        found = list(pool.map(_test, work))
    if not found:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    blk, rank, a, b = (np.concatenate(f) for f in zip(*found))
    by = np.lexsort((rank, blk))        # block after block, triu order inside
    return a[by], b[by]


def _part_sort(words: np.ndarray, k: int, part: np.ndarray):
    """`_part_order` of every row's bases `part` (a contiguous range): for
    k <= 32 shifted straight out of the uint64 rows, else unpacked."""
    if words.shape[1] > 2:
        return _part_order(K.unpack(words, k)[:, part])
    lo, hi = int(part[0]), int(part[-1]) + 1
    key = (_uint64_rows(words) >> np.uint64(64 - 2 * hi)) & np.uint64((1 << (2 * (hi - lo))) - 1)
    order = np.argsort(key, kind="stable")
    return order, key[order]


def cluster_kmers(words: np.ndarray, k: int, tau: int = 1, cap: int = 256) -> np.ndarray:
    """Cluster unique packed k-mers by Hamming distance <= tau.

    Returns dense cluster labels, shape (N,).  tau=1 matches SPAdes' default
    full-pipeline setting (`hamcluster.hpp` SubKMer splitting with tau+1
    parts).
    """
    n = words.shape[0]
    dsu = DSU(n)
    if n >= 2:
        pairs: list = []       # (a, b) matching pairs, in the JAX package's order
        # tau+1 sub-k-mer parts: equal-part runs are the candidate blocks
        parts = np.array_split(np.arange(k), tau + 1)
        for pi, part in enumerate(parts):
            other = np.concatenate([p for qi, p in enumerate(parts) if qi != pi]) if tau else np.arange(0)
            order, key = _part_sort(words, k, part)
            starts, sizes = _runs(key)
            starts, sizes = starts[sizes >= 2], sizes[sizes >= 2]   # one k-mer: no pair
            # runs over `cap` split recursively (`_cluster_block`); the runs
            # between two such are tested in one vectorized step
            split = np.flatnonzero(sizes > cap) if len(other) >= 2 and tau == 1 \
                else np.zeros(0, np.int64)
            lo = 0
            for j in [*split.tolist(), len(starts)]:
                if j > lo:
                    pairs.append(_block_matches(order, starts[lo:j], sizes[lo:j], words, tau))
                if j < len(starts):
                    blocks: list = []
                    a = int(starts[j])
                    _cluster_block(order[a : a + int(sizes[j])], words, k, other, tau, cap,
                                   blocks)
                    if blocks:
                        bs = np.array([len(b) for b in blocks])
                        pairs.append(_block_matches(np.concatenate(blocks),
                                                    np.cumsum(bs) - bs, bs, words, tau))
                lo = j + 1
        if pairs:
            dsu.union_pairs(np.concatenate([a for a, _b in pairs]),
                            np.concatenate([b for _a, b in pairs]))
    return dsu.labels()
