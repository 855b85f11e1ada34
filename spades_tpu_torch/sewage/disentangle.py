"""Wastewater (sewage) lineage abundance estimation.

Capability mirror of the reference's WastewaterDisentangle stage
(SPAdes `src/projects/spades/wastewater_disentangle.cpp:136-478`):
given an usher-style lineage barcode matrix (lineage x SNP, CSV with mutation
columns like `A123T`) and sequencing reads, map the reads onto the reference
genome, measure the alternative-allele frequency at every barcode position,
and solve for per-lineage abundances -> `lineages.csv`.

On the device (`device=`, default the CUDA card, see `resolve_device`):
the reads are packed once into a ReadStore and mapped onto the reference's
k=21 graph, and the allele votes are one scatter
(`parallel/sharded_mapping.py:position_votes_sharded`), where the JAX
package loops over the reads in Python (`alignment/mismatch.position_votes`);
the votes are integers and equal.  The abundance solve is the reference's
projected-gradient non-negative least squares in float64 on the same
device: its products sum in another order than numpy's, so abundances agree
with the JAX package's within 1e-9."""
from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from .. import resolve_device
from ..graph.graph import CondensedGraph

log = logging.getLogger("spades_tpu_torch.sewage")

_MUT = re.compile(r"^([ACGT])(\d+)([ACGT])$")


@dataclass
class Barcodes:
    lineages: list[str]
    positions: np.ndarray   # (S,) 0-based reference positions
    ref_base: np.ndarray    # (S,) uint8 codes
    alt_base: np.ndarray    # (S,) uint8 codes
    matrix: np.ndarray      # (L, S) floats in [0, 1]


def read_barcodes_csv(path: str) -> Barcodes:
    """Parse the usher barcode CSV: header ,A123T,G456C,...; rows lineage,0,1..."""
    with open(path) as fh:
        header = fh.readline().strip().split(",")
        muts = header[1:]
        pos, ref, alt, keep = [], [], [], []
        for i, m in enumerate(muts):
            mm = _MUT.match(m.strip())
            if mm:
                keep.append(i)
                ref.append("ACGT".index(mm.group(1)))
                pos.append(int(mm.group(2)) - 1)  # CSV is 1-based
                alt.append("ACGT".index(mm.group(3)))
        lineages, rows = [], []
        for line in fh:
            t = line.strip().split(",")
            if len(t) < 2:
                continue
            lineages.append(t[0])
            vals = np.array([float(x) if x else 0.0 for x in t[1:]])
            rows.append(vals[keep])
    return Barcodes(
        lineages=lineages,
        positions=np.array(pos, np.int64),
        ref_base=np.array(ref, np.uint8),
        alt_base=np.array(alt, np.uint8),
        matrix=np.vstack(rows) if rows else np.zeros((0, len(pos))),
    )


def allele_votes(reference: str, reads, device=None) -> tuple[CondensedGraph, np.ndarray]:
    """The reference as a k=21 graph and the (pool, 4) int32 base votes of
    the reads mapped onto it, on `device`: the index built and the reads
    mapped and tallied there (`position_votes_sharded`)."""
    from ..core.reads import ReadStore
    from ..parallel.sharded_mapping import build_index_device, position_votes_sharded

    dev = resolve_device(device)
    g = CondensedGraph.from_sequences([reference], k=21)
    prep = build_index_device(g, 21, dev)
    store = ReadStore.build(reads)
    # the index's k is all that position_votes_sharded reads of a host index
    votes = position_votes_sharded(SimpleNamespace(k=21), g, store=store, prep=prep,
                                   device=dev)
    return g, votes


def alt_frequencies(
    reference: str, reads: list[str], bc: Barcodes, device=None
) -> tuple[np.ndarray, np.ndarray]:
    """Map reads to the reference, return (alt_freq (S,), coverage (S,))."""
    g, votes = allele_votes(reference, reads, device)
    e = int(g.canonical_edge_ids()[0])
    o = int(g.e_off[e])
    n = int(g.e_len[e])
    v = votes[o : o + n].astype(float)
    # orientation: from_sequences may store the reverse complement
    if g.edge_seq(e) != reference:
        v = v[::-1, ::-1]
    total = v.sum(axis=1)
    S = len(bc.positions)
    freq = np.zeros(S)
    cov = np.zeros(S)
    inb = bc.positions < n
    p = bc.positions[inb]
    cov[inb] = total[p]
    with np.errstate(invalid="ignore", divide="ignore"):
        f = v[p, bc.alt_base[inb]] / np.maximum(total[p], 1.0)
    freq[inb] = np.where(total[p] > 0, f, 0.0)
    return freq, cov


def nnls_abundances(
    matrix: np.ndarray, freq: np.ndarray, weights: np.ndarray, iters: int = 2000,
    device=None,
) -> np.ndarray:
    """Weighted NNLS via projected gradient: min ||W(B^T x - f)||^2, x >= 0,
    in float64 on `device`; the step is 1 / the largest singular value of
    B^T B (`torch.linalg.matrix_norm(ord=2)`)."""
    dev = resolve_device(device)
    L = matrix.shape[0]
    if L == 0:
        return np.zeros(0)
    B = torch.from_numpy(np.ascontiguousarray(matrix.T * weights[:, None], np.float64)).to(dev)
    f = torch.from_numpy(np.ascontiguousarray(freq * weights, np.float64)).to(dev)
    x = torch.full((L,), 1.0 / L, dtype=torch.float64, device=dev)
    lr = 1.0 / max(float(torch.linalg.matrix_norm(B.T @ B, ord=2)), 1e-9)
    for _ in range(iters):
        grad = B.T @ (B @ x - f)
        x = torch.clamp_min(x - lr * grad, 0.0)
    return x.cpu().numpy()


def estimate_abundances(
    reference: str, reads: list[str], bc: Barcodes, min_coverage: int = 3, device=None
) -> list[tuple[str, float]]:
    """Per-lineage abundance estimates, descending; drops ~zero lineages.
    device: where the votes and the solve run (None: the CUDA card)."""
    dev = resolve_device(device)
    freq, cov = alt_frequencies(reference, reads, bc, dev)
    weights = (cov >= min_coverage).astype(float)
    if weights.sum() == 0:
        log.warning("no barcode position has coverage >= %d", min_coverage)
        return []
    x = nnls_abundances(bc.matrix, freq, weights, device=dev)
    total = x.sum()
    if total > 1.0:
        x = x / total
    out = [(l, float(a)) for l, a in zip(bc.lineages, x) if a > 1e-3]
    out.sort(key=lambda t: -t[1])
    return out
