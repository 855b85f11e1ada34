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

Words are int64-held uint32, as everywhere in the port's torch code.  The
contributions and the run OR are `ops/extension.py`'s, which
`build_extension_index_device` also builds with.  As in the JAX package,
this is the dry run's path: under a group every rank holds the whole table,
and `construct_graph` builds its index as on one device.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core import kmers as K
from ..ops.count import _lex_order, _words_of_keys
from ..ops.extension import ExtensionIndex, _contributions, _or_runs, keys_of_words
from .distributed import exchange_rows, gather_rows, rank_and_size, require_group
from .sharded_count import _local_runs, _packed_on, kmer_bucket


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
