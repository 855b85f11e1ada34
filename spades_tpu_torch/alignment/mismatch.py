"""Mismatch correction of edge sequences by read consensus (careful mode).

Capability mirror of SPAdes' MismatchCorrection stage
(`src/projects/spades/mismatch_correction.cpp:119-280`): map all reads back
onto graph edges, tally per-position nucleotide votes, and fix edge-sequence
positions where the read consensus contradicts the stored base.

Mapping is the batched anchor mapper; the vote tally is one scatter-add over
the flat sequence pool (one (pool-length, 4) accumulator instead of SPAdes'
per-edge interesting-position maps), on the device for the store path
(`parallel/sharded_mapping.py:position_votes_sharded`); conjugate edges are
patched symmetrically to keep the RC invariant.  The per-edge fix loop is the
JAX package's `spades_tpu/alignment/mismatch.py` unchanged."""
from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from .. import resolve_device
from ..core import dna
from ..graph.graph import CondensedGraph
from .mapper import EdgeIndex, build_edge_index, map_read_batch

log = logging.getLogger("spades_tpu_torch.mismatch")


class _KOnly:
    """Minimal index stand-in when only `.k` is needed (device vote path
    with a prepared device index)."""

    def __init__(self, k: int):
        self.k = k


@dataclass
class MismatchConfig:
    min_coverage: int = 2       # votes needed at a position to act
    dominance: float = 0.66     # winning base must exceed this vote share
    batch_size: int = 16384


def position_votes(
    g: CondensedGraph, reads: list[str], index: EdgeIndex | None = None,
    batch_size: int = 16384, device=None,
) -> np.ndarray:
    """Per-pool-position base votes from mapped reads: (len(seq_pool), 4)."""
    index = index or build_edge_index(g)
    votes = np.zeros((len(g.seq_pool), 4), np.int32)
    for lo in range(0, len(reads), batch_size):
        chunk = reads[lo : lo + batch_size]
        mappings = map_read_batch(index, g, chunk, device=device)
        flat_idx, flat_base = [], []
        for m, s in zip(mappings, chunk):
            if m is None:
                continue
            codes = dna.encode(s)
            ok = codes < 4
            pos = m.start_offset + np.arange(len(codes))
            inside = (pos >= 0) & (pos < g.e_len[m.edge]) & ok
            if not inside.any():
                continue
            flat_idx.append(g.e_off[m.edge] + pos[inside])
            flat_base.append(codes[inside])
        if flat_idx:
            np.add.at(votes, (np.concatenate(flat_idx), np.concatenate(flat_base)), 1)
    return votes


def correct_mismatches(g: CondensedGraph, reads: list[str] | None = None,
                       index: EdgeIndex | None = None, store=None,
                       engine=None, device=None, group=None) -> int:
    """Fix edge-sequence mismatches by read majority vote.  Returns #bases fixed.

    With `store` (a run-wide packed ReadStore), the mapping and the vote
    tally run on the device (`position_votes_sharded`); `engine` reuses a
    shared MappingEngine's device index (and its device).  The legacy
    string-list path stays for tools and tests.  device: where the device
    work runs (None: the CUDA card, see `resolve_device`).  group: the
    process group the store path's vote runs across (the JAX package's
    `mesh`; None: the engine's group, else the default group of a
    multi-process run): each rank votes with its share of the reads and one
    `all_reduce` sums the tallies, as MismatchCorrectionMPI's vote merge
    (`hpcspades/mpi/stages/mismatch_correction_mpi.hpp`).

    Known divergence of the store path, kept from the JAX package: it does
    not apply the kmer-mapper projection, so reads whose every anchor was
    glued away during simplification cast no votes there (the host path
    would recover a small minority of them via projection).  Votes are a
    consensus over ~coverage-many reads per position, so dropping that
    sliver cannot flip a majority that the dominance threshold accepts."""
    cfg = MismatchConfig()
    dev = engine.device if engine is not None and device is None else resolve_device(device)
    if g.num_edges == 0 or not (reads or store):
        return 0
    if store is not None:
        from ..parallel.sharded_mapping import position_votes_sharded

        # the device path only needs k and the DEVICE index: touching
        # engine.index here would force the host index build
        if engine is not None:
            prep = engine._device_index()
            k = engine._k
            group = group if group is not None else engine.group
        else:
            prep = None
            index = index or build_edge_index(g)
            k = index.k
        votes = position_votes_sharded(
            _KOnly(k) if index is None else index, g, store=store, prep=prep, device=dev,
            group=group,
        )
    else:
        if engine is not None:
            index = engine.index
        else:
            index = index or build_edge_index(g)
        votes = position_votes(g, reads, index, cfg.batch_size, device=dev)

    fixed = 0
    for e in g.canonical_edge_ids():
        o, n = int(g.e_off[e]), int(g.e_len[e])
        v = votes[o : o + n].copy()
        # fold in votes landed on the conjugate's pool slice (reads that
        # mapped in the other orientation), mirrored and complemented
        ec = int(g.e_conj[e])
        oc = int(g.e_off[ec])
        if ec != e:
            v += votes[oc : oc + n][::-1, ::-1]
        total = v.sum(axis=1)
        best = v.argmax(axis=1).astype(np.uint8)
        bestv = v.max(axis=1)
        fixable = (total >= cfg.min_coverage) & (bestv > cfg.dominance * total)
        mism = fixable & (best != g.seq_pool[o : o + n])
        if not mism.any():
            continue
        pos = np.flatnonzero(mism)
        g.seq_pool[o + pos] = best[pos]
        if ec != e:
            g.seq_pool[oc + (n - 1 - pos)] = 3 - best[pos]
        fixed += len(pos)
    if fixed:
        log.info("mismatch correction: fixed %d positions", fixed)
    return fixed
