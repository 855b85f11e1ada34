"""Multi-GPU sharded k-mer counting over a process group.

Counterpart of `spades_tpu.parallel.sharded_count` (hpcSPAdes' distributed
construction, `hpcspades/mpi/stages/construction_mpi.cpp:222-700`): each
rank holds a share of the reads, and every canonical k-mer is counted on
exactly one owner rank, chosen by the multiplicative hash of the JAX
package (`kmer_bucket`, the `KMerSegmentPolicy` bucket map of
`kmer_mph/kmer_buckets.hpp:17-56`).  Per batch, each rank

* takes the canonical windows of its reads with the canonical-windows kernel
  (`ops/cuda_kernels.py`) and counts them to unique runs on its device,
* routes those runs, not the raw windows, to their owners with one uneven
  `all_to_all_single` (`parallel/distributed.py:exchange_rows`),
* and the owner sorts what it received and sums the counts of equal k-mers.

The answer is that of routing every window, as the JAX shard body does; a
run stands for all its windows, so at the depth of a real library about a
twentieth of the rows cross between ranks.  Torch has dynamic shapes, so the
JAX package's per-destination capacity, its power-of-two quantization and
its overflow retry have no counterpart: the row counts are exchanged first.
At the end every rank gathers the owners' shards and returns the identical
global `KmerCounts`, lex-sorted as `merge_counts` gives it.

Torch has no unsigned 32-bit arithmetic: the hash carries each uint32 in an
int64 and keeps every product below 2**63 (`_mul32`).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core import kmers as K
from ..core.reads import PackedChunk, ReadBatch
from ..ops.count import (DeviceRunStack, KmerCounts, _lex_order, _reduce_sorted,
                         _words_of_keys)
from ..ops.cuda_kernels import canonical_window_keys
from .distributed import (exchange_rows, gather_rows, process_read_slice, rank_and_size,
                          require_group)

_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for int64-held uint32 h and a 32-bit constant c,
    with no intermediate at or above 2**49: c splits into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3-style 32-bit finalizer (decorrelates k-mer bits from buckets)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def kmer_bucket(words: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """k-mer rows (N, W) of int64-held uint32 words -> owner bucket in
    [0, n_buckets) as int64, the JAX package's bucket: the words folded
    through `_mix32`, then the Lemire-style reduce of the top 16 hash bits
    (below 2**32 in int64)."""
    assert n_buckets < (1 << 16)
    h = torch.zeros(words.shape[:-1], dtype=torch.int64, device=words.device)
    for w in range(words.shape[-1]):
        h = _mix32(h ^ words[..., w])
    return ((h >> 16) * n_buckets) >> 16


def _route_local(keys: torch.Tensor, counts: torch.Tensor, k: int, n_dev: int):
    """A rank's unique runs -> (rows (U, nK + 1): key planes then the count,
    owner (U,)) for `exchange_rows`."""
    owner = kmer_bucket(_words_of_keys(keys, K.kmer_words(k)), n_dev)
    return torch.cat([keys.T, counts[:, None]], dim=1), owner


def _local_runs(pc, pn, lengths, L: int, k: int, dev):
    """This rank's canonical windows counted to unique runs: (keys (nK, U),
    counts (U,)); empty when it holds no window."""
    if pc.shape[0] == 0 or L < k:
        return (torch.zeros((K.key_planes(k), 0), dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.int64, device=dev))
    keys, _ = canonical_window_keys(pc, pn, lengths, L, k)
    order = _lex_order(keys)
    return _reduce_sorted(keys[:, order], None)


def _count_shard_body(pc, pn, lengths, L: int, k: int, group, dev):
    """Per-rank body: local windows -> unique runs -> exchange -> the
    owner's sorted unique keys and summed counts.  Every rank calls it once
    per batch, whatever it holds (the exchange is a collective)."""
    _, world = rank_and_size(group)
    uk, uc = _local_runs(pc, pn, lengths, L, k, dev)
    rows, owner = _route_local(uk, uc, k, world)
    mine = exchange_rows(rows, owner, group)
    nK = uk.shape[0]
    mk = mine[:, :nK].T.contiguous()
    order = _lex_order(mk)
    return _reduce_sorted(mk[:, order], mine[:, nK][order])


def _packed_on(b, dev):
    """(pc, pn, lengths, L) tensors on `dev` of a ReadBatch, a PackedChunk,
    or such a tuple already."""
    if isinstance(b, tuple):
        return b
    if isinstance(b, PackedChunk):
        pc, pn, lengths = b.device(dev)
        return pc, pn, lengths, b.L
    if isinstance(b, ReadBatch):
        pc, pn, lengths, L = b.packed()
        return (*(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                  for a in (pc, pn, lengths)), L)
    raise TypeError(f"cannot count a {type(b).__name__}")


def rank_share(b, rank: int, world: int, device):
    """This rank's `process_read_slice` of a batch's real reads: a
    ReadBatch, or (pc, pn, lengths, L) rows of a PackedChunk on `device`
    (sliced from the chunk's one upload)."""
    if isinstance(b, PackedChunk):
        lo, hi = process_read_slice(b.n, rank, world)
        return tuple(t[lo:hi] for t in b.device(device)) + (b.L,)
    lo, hi = process_read_slice(b.n_seqs if b.n_seqs >= 0 else b.num_reads, rank, world)
    return ReadBatch(codes=b.codes[lo:hi], lengths=b.lengths[lo:hi],
                     n_mask=b.n_mask[lo:hi], n_seqs=hi - lo)


class ShardedCounter:
    """The counting step over a group (the counterpart of the JAX package's
    jitted `make_sharded_counter`), holding this rank's owner shard across
    batches: `push` routes one batch's runs to their owners, which merge
    them in a `DeviceRunStack`; `shard` is this rank's owned k-mers,
    `finish` the global table on every rank (one gather)."""

    def __init__(self, k: int, group, device=None, timings: dict | None = None):
        self.k = k
        self.group = group
        self.dev = resolve_device(device)
        self.stack = DeviceRunStack(k, timings=timings)
        self._shard = None

    def push(self, batch) -> None:
        pc, pn, lengths, L = _packed_on(batch, self.dev)
        keys, counts = _count_shard_body(pc, pn, lengths, L, self.k, self.group, self.dev)
        self.stack.push(keys, counts, keys.shape[1])

    def shard(self):
        """(keys (nK, U), counts (U,)) of the k-mers this rank owns, sorted;
        pushing ends with the first call."""
        if self._shard is None:
            got = self.stack.finish_device()
            if got is None:
                got = (torch.zeros((K.key_planes(self.k), 0), dtype=torch.int64,
                                   device=self.dev),
                       torch.zeros(0, dtype=torch.int64, device=self.dev))
            self._shard = got
        return self._shard

    def finish(self) -> KmerCounts:
        keys, counts = self.shard()
        nK = keys.shape[0]
        rows = gather_rows(torch.cat([keys.T, counts[:, None]], dim=1), self.group)
        allk = rows[:, :nK].T.contiguous()
        order = _lex_order(allk)
        keys = allk[:, order].T.contiguous().cpu().numpy()
        return KmerCounts(k=self.k, words=K.keys_to_words(keys, K.kmer_words(self.k)),
                          counts=rows[:, nK][order].cpu().numpy())


def count_kmers_sharded(batch, k: int, group=None, device=None, share: bool = False,
                        timings: dict | None = None) -> KmerCounts:
    """Count the canonical k-mers of this rank's `batch` (a ReadBatch, a
    PackedChunk, a (pc, pn, lengths, L) tuple of tensors, or an iterable of
    them) across the group; every rank returns the identical global
    KmerCounts.  Ranks may pass batches of different shapes, or none.
    share: every rank was given the same batches, and counts only its
    `rank_share` of each.  timings: a dict that receives the device merge's
    keys (`DeviceRunStack`).  group: None is the default group, which must
    be initialized (`init_distributed`); a group of one process counts
    alone."""
    grp = require_group(group, "count_kmers_sharded")
    rank, world = rank_and_size(grp)
    counter = ShardedCounter(k, grp, device, timings)
    for b in [batch] if isinstance(batch, (tuple, ReadBatch, PackedChunk)) else batch:
        counter.push(rank_share(b, rank, world, counter.dev) if share else b)
    return counter.finish()
