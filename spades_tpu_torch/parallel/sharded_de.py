"""Multi-GPU sharded distance estimation over a process group.

Counterpart of `spades_tpu.parallel.sharded_de` (hpcSPAdes'
DistanceEstimationMPI, `hpcspades/mpi/stages/distance_estimation_mpi.cpp`):
the raw (e1, e2, d, w) table is routed by a hash of the (e1, e2) pair, the
JAX package's `((e1 * 0x9E3779B1 + e2) ^ (e1 >> 7)) % n`, so every pair
group lands whole on one rank; each rank clusters its groups as the linkage
clustering of `paired.distance_estimation.estimate_simple`, one vectorized
segmented reduction (sort by (e1, e2, d), a new cluster at a pair change or
a distance gap above `linkage`, float32 weight sums and weighted means,
clusters lighter than `min_weight` dropped), and the cluster rows are
gathered on every rank and lex-sorted.

Every rank passes the same whole table (the JAX function's host input);
rank r routes its `process_read_slice` share of the rows.  e1 and e2 are
exact; the float32 sums add in another order than the JAX package's
`segment_sum`, so dist and weight agree within rtol 1e-5.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..paired.distance_estimation import DEConfig
from ..paired.paired_info import PairedIndex
from .distributed import (all_gather_sizes, exchange_rows, gather_rows, process_read_slice,
                          rank_and_size, resolve_group)


def _de_shard_body(e1, e2, d, w, linkage: int, min_weight: float):
    """Linkage clustering of one rank's rows: e1, e2, d int64, w float32.
    Returns the kept clusters' (e1, e2) int64 and (dist, weight) float32."""
    order = torch.sort(d, stable=True).indices
    for key in (e2, e1):
        order = order[torch.sort(key[order], stable=True).indices]
    e1s, e2s, ds, ws = e1[order], e2[order], d[order], w[order]
    n = e1s.shape[0]
    newc = torch.ones(n, dtype=torch.bool, device=e1.device)
    newc[1:] = (e1s[1:] != e1s[:-1]) | (e2s[1:] != e2s[:-1]) | (ds[1:] - ds[:-1] > linkage)
    seg = torch.cumsum(newc.to(torch.int64), 0) - 1
    n_seg = int(newc.sum())
    wsum = torch.zeros(n_seg, dtype=torch.float32, device=e1.device).index_add_(0, seg, ws)
    dwsum = torch.zeros(n_seg, dtype=torch.float32, device=e1.device).index_add_(
        0, seg, ds.to(torch.float32) * ws)
    cd = dwsum / wsum.clamp_min(1e-30)
    keep = wsum >= min_weight
    starts = newc.nonzero()[:, 0][keep]
    return e1s[starts], e2s[starts], cd[keep], wsum[keep]


def estimate_simple_sharded(pi: PairedIndex, group=None, cfg: DEConfig | None = None,
                            device=None) -> PairedIndex:
    """Sharded linkage clustering; the result of `estimate_simple` (dist and
    weight as float32 sums).  group: None is the default group when one is
    initialized with several processes, else this process clusters alone."""
    cfg = cfg or DEConfig()
    dev = resolve_device(device)
    grp = resolve_group(group)
    n = pi.e1.size
    if n == 0:
        z = np.zeros(0)
        return PairedIndex(z.astype(np.int64), z.astype(np.int64), z, z)
    rank, world = rank_and_size(grp) if grp is not None else (0, 1)
    lo, hi = process_read_slice(n, rank, world)
    e1 = torch.from_numpy(np.ascontiguousarray(pi.e1[lo:hi], np.int64)).to(dev)
    e2 = torch.from_numpy(np.ascontiguousarray(pi.e2[lo:hi], np.int64)).to(dev)
    # the JAX package routes distances as int32 (truncated) and weights as float32
    d = torch.from_numpy(pi.dist[lo:hi].astype(np.int32).astype(np.int64)).to(dev)
    w = torch.from_numpy(pi.weight[lo:hi].astype(np.float32)).to(dev)
    if grp is not None:
        owner = ((e1 * 0x9E3779B1 + e2) ^ (e1 >> 7)) % world
        rows = exchange_rows(torch.stack([e1, e2, d, w.view(torch.int32).to(torch.int64)], 1),
                             owner, grp)
        e1, e2, d = rows[:, 0], rows[:, 1], rows[:, 2]
        w = rows[:, 3].to(torch.int32).view(torch.float32)
    ce1, ce2, cd, cw = _de_shard_body(e1, e2, d, w, int(cfg.linkage_distance),
                                      float(cfg.min_peak_weight))
    ints = torch.stack([ce1, ce2], 1)
    floats = torch.stack([cd, cw], 1)
    if grp is not None:
        sizes = all_gather_sizes(ints.shape[0], grp, dev)
        ints = gather_rows(ints, grp, sizes)
        floats = gather_rows(floats, grp, sizes)
    ints, floats = ints.cpu().numpy(), floats.cpu().numpy()
    e1n, e2n = ints[:, 0], ints[:, 1]
    dd, ww = floats[:, 0].astype(float), floats[:, 1].astype(float)
    o = np.lexsort((dd, e2n, e1n))
    return PairedIndex(e1n[o], e2n[o], dd[o], ww[o])
