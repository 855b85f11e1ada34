"""Contig abundance profiles from multi-sample k-mer multiplicities.

Capability mirror of SPAdes' `src/projects/mts/contig_abundance.cpp`:
per sample, a contig's abundance is a robust point estimate over the
multiplicities of its k-mers — median + MAD (:36-45) or winsorized mean +
variance (:53-84); contigs whose k-mers are mostly absent from the profile
table get no estimate (TrivialClusterAnalyzer behavior).

Vectorized: one packed-window extraction per contig batch, one table lookup,
then per-sample median/percentile reductions over the (n_kmers, S) matrix.
"""
from __future__ import annotations

import numpy as np

from ..core import dna
from ..core import kmers as K
from ..ops.extension import canonicalize
from .multiplicity import KmerProfiles


def _contig_kmer_profiles(profiles: KmerProfiles, seq: str) -> np.ndarray:
    """(n_windows, S) multiplicity rows for every valid window of `seq`."""
    k = profiles.k
    codes = dna.encode(seq)
    if len(codes) < k:
        return np.zeros((0, profiles.num_samples), np.uint16)
    wins = np.lib.stride_tricks.sliding_window_view(codes, k)
    valid = np.lib.stride_tricks.sliding_window_view(codes < 4, k).all(axis=1)
    packed = K.pack(np.ascontiguousarray(np.where(wins >= 4, 0, wins)))
    canon, _ = canonicalize(packed, k)
    return profiles.lookup(canon[valid])


def median_mad(mpls: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-sample median and median-absolute-deviation (contig_abundance.cpp:36)."""
    med = np.median(mpls, axis=0)
    mad = np.median(np.abs(mpls.astype(np.int64) - med), axis=0)
    return med, mad


def winsorized_mean_var(mpls: np.ndarray, frac: float = 0.05) -> tuple[np.ndarray, np.ndarray]:
    """Per-sample winsorized mean and variance (contig_abundance.cpp:53-84)."""
    x = np.sort(mpls.astype(np.float64), axis=0)
    n = x.shape[0]
    cut = int(n * frac)
    if cut > 0:
        x[:cut] = x[cut]
        x[n - cut:] = x[n - cut - 1]
    mean = x.mean(axis=0)
    var = (x * x).mean(axis=0) - mean * mean
    return mean, var


def contig_profiles(
    profiles: KmerProfiles,
    contigs: list[str],
    min_earmark_frac: float = 0.7,
    estimator: str = "median",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Abundance profiles for a contig list.

    Returns (abundance (C, S), dispersion (C, S), ok (C,) bool); `ok` is False
    when fewer than `min_earmark_frac` of a contig's k-mers are present in the
    profile table (no reliable estimate)."""
    C, S = len(contigs), profiles.num_samples
    ab = np.zeros((C, S), np.float64)
    disp = np.zeros((C, S), np.float64)
    ok = np.zeros(C, bool)
    for i, seq in enumerate(contigs):
        m = _contig_kmer_profiles(profiles, seq)
        if m.shape[0] == 0:
            continue
        present = (m.sum(axis=1) > 0).mean()
        if present < min_earmark_frac:
            continue
        if estimator == "median":
            ab[i], disp[i] = median_mad(m)
        else:
            ab[i], disp[i] = winsorized_mean_var(m)
        ok[i] = True
    return ab, disp, ok
