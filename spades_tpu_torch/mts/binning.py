"""Abundance-profile binning (canopy-style clustering).

SPAdes delegates binning to external tools (CONCOCT / canopy / maxbin,
`src/projects/mts/Snakefile` binner rules and `binners/`);
this module provides the built-in equivalent: canopy clustering of contig
abundance profiles under Pearson-correlation distance — the algorithm of the
canopy binner the MTS workflow wraps.

Vectorized: each canopy round scores ALL unassigned contigs against the
current center in one correlation computation; centers are recomputed as
member medians until stable.
"""
from __future__ import annotations

import numpy as np


def _corr_to_center(x: np.ndarray, center: np.ndarray) -> np.ndarray:
    """Pearson correlation of each row of x with `center` (S >= 2)."""
    xc = x - x.mean(axis=1, keepdims=True)
    cc = center - center.mean()
    denom = np.sqrt((xc * xc).sum(axis=1) * (cc * cc).sum())
    with np.errstate(invalid="ignore", divide="ignore"):
        r = (xc @ cc) / denom
    return np.where(np.isfinite(r), r, 0.0)


def canopy_bins(
    profiles: np.ndarray,
    merge_threshold: float = 0.9,
    max_rounds: int = 100,
) -> np.ndarray:
    """Cluster (C, S) abundance profiles; returns (C,) bin labels (-1 = unbinned).

    Canopy procedure: seed with the highest-total unassigned profile, absorb
    all profiles with correlation >= merge_threshold, re-center on the member
    median until the center stabilizes, repeat."""
    C, S = profiles.shape
    labels = np.full(C, -1, np.int64)
    if C == 0:
        return labels
    if S < 2:
        # single sample: bin by abundance magnitude (correlation undefined)
        order = np.argsort(-profiles[:, 0])
        labels[order] = 0
        return labels
    unassigned = np.ones(C, bool)
    next_bin = 0
    totals = profiles.sum(axis=1)
    for _ in range(max_rounds):
        if not unassigned.any():
            break
        seed = int(np.flatnonzero(unassigned)[np.argmax(totals[unassigned])])
        center = profiles[seed].astype(np.float64)
        members = None
        for _ in range(20):
            r = _corr_to_center(profiles, center)
            new_members = unassigned & (r >= merge_threshold)
            new_members[seed] = True
            if members is not None and np.array_equal(new_members, members):
                break
            members = new_members
            center = np.median(profiles[members], axis=0)
        labels[members] = next_bin
        unassigned &= ~members
        next_bin += 1
    return labels
