"""Multi-GPU extension-index (in/out mask) build over a process group.

Counterpart of `spades_tpu.parallel.sharded_extension` (hpcSPAdes'
distributed ExtensionIndex fill with its `MPI_BAND` allreduce,
`hpcspades/mpi/stages/construction_mpi.cpp:456`): every rank takes the
canonical (k+1)-mers of its reads (the canonical-windows kernel, counted to
unique runs first: a mask bit is an OR, so one copy of a (k+1)-mer sets what
all its copies would), computes each one's prefix and suffix contributions,
routes them to the owner of their canonical k-mer (`kmer_bucket`, as the
sharded count) with one uneven exchange, and the owner ORs the bits of each
k-mer run.  The payload layout is the JAX package's: out bits in the low
nibble, in bits in the high nibble.  Every rank then gathers the owners'
runs into the same `ExtensionIndex` as the host `build_extension_index`.

Words are int64-held uint32, as everywhere in the port's torch code.  As in
the JAX package, this is the dry run's path; `construct_graph` keeps the
host `build_extension_index`.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core import kmers as K
from ..ops.count import _lex_order, _words_of_keys
from ..ops.extension import ExtensionIndex
from .distributed import exchange_rows, gather_rows, rank_and_size, require_group
from .sharded_count import _M32, _local_runs, _packed_on, kmer_bucket

NT_COMP = (3, 2, 1, 0)


def _mask_tail_j(words: torch.Tensor, k: int) -> torch.Tensor:
    """Zero the bits past base k-1 of (N, W) words."""
    W = words.shape[-1]
    used_last = k - 16 * (W - 1)
    if used_last == 16:
        return words
    out = words.clone()
    out[:, W - 1] &= (_M32 << (32 - 2 * used_last)) & _M32
    return out


def _prefix_kmer_j(p1words: torch.Tensor, k: int) -> torch.Tensor:
    return _mask_tail_j(p1words[:, : K.kmer_words(k)], k)


def _suffix_kmer_j(p1words: torch.Tensor, k: int) -> torch.Tensor:
    shifted = (p1words << 2) & _M32
    shifted[:, :-1] |= p1words[:, 1:] >> 30
    return _mask_tail_j(shifted[:, : K.kmer_words(k)], k)


def _rev2(x: torch.Tensor) -> torch.Tensor:
    """Reverse the sixteen 2-bit fields of int64-held uint32 words."""
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & _M32


def revcomp_words_t(words: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of packed k-mers (N, W), int64-held uint32 words
    (`core/kmers.py:revcomp_words` in torch)."""
    W = words.shape[-1]
    rev = [_rev2(~words[:, W - 1 - w] & _M32) for w in range(W)]
    pad = 32 * W - 2 * k
    if pad:
        rev = [((rev[w] << pad) & _M32) | (rev[w + 1] >> (32 - pad) if w + 1 < W else 0)
               for w in range(W)]
    return torch.stack(rev, dim=-1)


def _canonicalize_j(words: torch.Tensor, k: int):
    rc = revcomp_words_t(words, k)
    use_rc = K.lex_less(rc, words)
    return torch.where(use_rc[:, None], rc, words), use_rc


def keys_of_words(words: torch.Tensor) -> torch.Tensor:
    """(N, W) int64-held uint32 words -> (ceil(W/2), N) sort keys."""
    if words.shape[1] % 2:
        words = torch.cat([words, torch.zeros_like(words[:, :1])], dim=1)
    u = (words[:, 0::2] << 32) | words[:, 1::2]
    return (u ^ torch.iinfo(torch.int64).min).T.contiguous()


def _contributions(s: torch.Tensor, k: int):
    """Unique canonical (k+1)-mer words (N, W1) -> (k-mer words (2N, Wk),
    payload (2N,)): each prefix and suffix with its in/out bits."""
    w_last, j_last = divmod(k, 16)
    last = (s[:, w_last] >> (30 - 2 * j_last)) & 3
    first = s[:, 0] >> 30
    comp = torch.tensor(NT_COMP, dtype=torch.int64, device=s.device)
    pref, pref_rc = _canonicalize_j(_prefix_kmer_j(s, k), k)
    suf, suf_rc = _canonicalize_j(_suffix_kmer_j(s, k), k)
    one = torch.ones_like(last)
    p_out = torch.where(pref_rc, 0, one << last)
    p_in = torch.where(pref_rc, one << comp[last], 0)
    s_in = torch.where(suf_rc, 0, one << first)
    s_out = torch.where(suf_rc, one << comp[first], 0)
    return (torch.cat([pref, suf]),
            torch.cat([p_out | (p_in << 4), s_out | (s_in << 4)]))


def _or_runs(keys: torch.Tensor, pay: torch.Tensor):
    """Sorted (nK, N) keys and their payloads -> (run keys (nK, U), OR of
    each run's payloads (U,)), one max-scatter per payload bit."""
    n = keys.shape[1]
    starts = torch.ones(n, dtype=torch.bool, device=keys.device)
    starts[1:] = (keys[:, 1:] != keys[:, :-1]).any(0)
    seg = torch.cumsum(starts.to(torch.int64), 0) - 1
    u = int(starts.sum())
    orred = torch.zeros(u, dtype=torch.int64, device=keys.device)
    for b in range(8):
        got = torch.zeros(u, dtype=torch.int64, device=keys.device)
        got.scatter_reduce_(0, seg, (pay >> b) & 1, reduce="amax")
        orred |= got << b
    return keys[:, starts], orred


def _route_payload(kmers: torch.Tensor, payload: torch.Tensor, n_dev: int):
    """(k-mer words (N, Wk), payloads (N,)) -> (rows (N, nK + 1): key planes
    then the payload, owner (N,)) for `exchange_rows`."""
    return (torch.cat([keys_of_words(kmers).T, payload[:, None]], dim=1),
            kmer_bucket(kmers, n_dev))


def _ext_shard_body(pc, pn, lengths, L: int, k: int, group, dev):
    """Per rank: (k+1)-windows -> unique runs -> contributions -> exchange
    -> the owner's sorted k-mer runs and OR-ed payloads."""
    _, world = rank_and_size(group)
    uk, _ = _local_runs(pc, pn, lengths, L, k + 1, dev)
    kms, pays = _contributions(_words_of_keys(uk, K.kmer_words(k + 1)), k)
    mine = exchange_rows(*_route_payload(kms, pays, world), group)
    nK = K.key_planes(k)
    mk = mine[:, :nK].T.contiguous()
    order = _lex_order(mk)
    return _or_runs(mk[:, order], mine[:, nK][order])


def extension_shard(batch, k: int, group, device=None):
    """This rank's owned k-mers of its `batch` (a ReadBatch or PackedChunk)
    and every rank's: (keys (nK, U), masks (U,)), sorted."""
    dev = resolve_device(device)
    pc, pn, lengths, L = _packed_on(batch, dev)
    return _ext_shard_body(pc, pn, lengths, L, k, group, dev)


def extension_masks_sharded(batch, k: int, group=None, device=None) -> ExtensionIndex:
    """Build the extension index of this rank's `batch` across the group.

    Returns an ops.extension.ExtensionIndex (host arrays), the same on every
    rank and the same as the host `build_extension_index` of the count of
    every rank's reads.  group: None is the default group, which must be
    initialized (`init_distributed`)."""
    grp = require_group(group, "extension_masks_sharded")
    keys, masks = extension_shard(batch, k, grp, device)
    nK = keys.shape[0]
    rows = gather_rows(torch.cat([keys.T, masks[:, None]], dim=1), grp)
    allk = rows[:, :nK].T.contiguous()
    order = _lex_order(allk)
    words = K.keys_to_words(allk[:, order].T.contiguous().cpu().numpy(), K.kmer_words(k))
    mask = rows[:, nK][order].cpu().numpy()
    return ExtensionIndex(k=k, kmers=words,
                          out_mask=(mask & 0xF).astype(np.uint8),
                          in_mask=((mask >> 4) & 0xF).astype(np.uint8))
