"""Distance estimation: raw pair histograms -> clustered point estimates.

Capability mirror of SPAdes' estimator family
(`src/common/paired_info/distance_estimation.hpp:107`
`DistanceEstimator`, `weighted_distance_estimation.hpp`,
`smoothing_distance_estimation.hpp:20` `SmoothingDistanceEstimator` with its
`data_divider.hpp` / `peak_finder.hpp` machinery): for every (e1, e2) edge
pair the raw (distance, weight) histogram collected from read pairs is
clustered into one or more point estimates used by repeat resolution and
scaffolding.

Array shape: histograms live as one flat sorted (e1, e2, d, w) table;
estimation is a host-side segmented pass (the per-pair histograms are tiny —
SPAdes also runs this part on the CPU side of its OpenMP loop).  The
smoothing estimator convolves each histogram with a triangular kernel and
keeps local maxima, the vectorized analog of SPAdes' peak finder."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .paired_info import PairedIndex


@dataclass
class DEConfig:
    linkage_distance: int = 10     # merge raw points closer than this (simple)
    max_distance_error: int = 15   # smoothing: half-width of the peak window
    min_peak_weight: float = 2.0   # drop estimated points lighter than this
    smoothing_bandwidth: int = 7   # triangular kernel half-width


def _iter_groups(pi: PairedIndex):
    """Yield (lo, hi) slices of one (e1, e2) group in the sorted table."""
    n = pi.e1.size
    i = 0
    while i < n:
        j = i
        while j < n and pi.e1[j] == pi.e1[i] and pi.e2[j] == pi.e2[i]:
            j += 1
        yield i, j
        i = j


def _rebuild(pi: PairedIndex, rows) -> PairedIndex:
    if not rows:
        z = np.zeros(0)
        return PairedIndex(z.astype(np.int64), z.astype(np.int64), z, z)
    e1, e2, d, w = map(np.array, zip(*rows))
    return PairedIndex(e1.astype(np.int64), e2.astype(np.int64), d.astype(float), w.astype(float))


def estimate_simple(pi: PairedIndex, cfg: DEConfig | None = None) -> PairedIndex:
    """Linkage clustering + weighted mean per cluster (DistanceEstimator)."""
    cfg = cfg or DEConfig()
    rows = []
    for i, j in _iter_groups(pi):
        ds, ws = pi.dist[i:j], pi.weight[i:j]
        start = 0
        for t in range(1, len(ds) + 1):
            if t == len(ds) or ds[t] - ds[t - 1] > cfg.linkage_distance:
                cw = ws[start:t].sum()
                if cw >= cfg.min_peak_weight:
                    cd = float((ds[start:t] * ws[start:t]).sum() / cw)
                    rows.append((pi.e1[i], pi.e2[i], cd, cw))
                start = t
    return _rebuild(pi, rows)


def estimate_weighted(pi: PairedIndex, cfg: DEConfig | None = None) -> PairedIndex:
    """Like simple, but clusters are scored by their weight share so weak
    side-lobes next to a dominant cluster are dropped
    (weighted_distance_estimation.hpp semantics)."""
    cfg = cfg or DEConfig()
    rows = []
    for i, j in _iter_groups(pi):
        ds, ws = pi.dist[i:j], pi.weight[i:j]
        clusters = []
        start = 0
        for t in range(1, len(ds) + 1):
            if t == len(ds) or ds[t] - ds[t - 1] > cfg.linkage_distance:
                cw = ws[start:t].sum()
                cd = float((ds[start:t] * ws[start:t]).sum() / cw)
                clusters.append((cd, cw))
                start = t
        if not clusters:
            continue
        wmax = max(cw for _, cw in clusters)
        for cd, cw in clusters:
            if cw >= cfg.min_peak_weight and cw >= 0.2 * wmax:
                rows.append((pi.e1[i], pi.e2[i], cd, cw))
    return _rebuild(pi, rows)


def estimate_smoothing(pi: PairedIndex, cfg: DEConfig | None = None) -> PairedIndex:
    """Convolution-smoothed peak finding for wide mate-pair histograms
    (SmoothingDistanceEstimator + peak_finder.hpp)."""
    cfg = cfg or DEConfig()
    bw = cfg.smoothing_bandwidth
    kernel = 1.0 - np.abs(np.arange(-bw, bw + 1)) / (bw + 1.0)  # triangular
    rows = []
    for i, j in _iter_groups(pi):
        ds = pi.dist[i:j].astype(np.int64)
        ws = pi.weight[i:j]
        lo, hi = int(ds.min()) - bw, int(ds.max()) + bw
        hist = np.zeros(hi - lo + 1)
        np.add.at(hist, ds - lo, ws)
        sm = np.convolve(hist, kernel, mode="same")
        # local maxima of the smoothed histogram
        peaks = np.flatnonzero(
            (sm >= np.roll(sm, 1)) & (sm >= np.roll(sm, -1)) & (sm > 0)
        )
        if peaks.size == 0:
            continue
        # suppress shoulder peaks: keep peaks >= 30% of the max peak
        keep = peaks[sm[peaks] >= 0.3 * sm[peaks].max()]
        for p in keep:
            # mass within the peak window as the cluster weight
            a = max(0, p - cfg.max_distance_error)
            b = min(len(hist), p + cfg.max_distance_error + 1)
            cw = hist[a:b].sum()
            if cw < cfg.min_peak_weight:
                continue
            centre = np.arange(a, b)
            m = hist[a:b]
            cd = float((centre * m).sum() / m.sum()) + lo
            rows.append((pi.e1[i], pi.e2[i], cd, cw))
    return _rebuild(pi, rows)


def estimate_distances(
    pi: PairedIndex, lib_type: str = "paired-end", cfg: DEConfig | None = None
) -> PairedIndex:
    """Dispatch by library type as `distance_estimation_utils.cpp` does:
    mate-pairs get the smoothing estimator, paired-end the simple one."""
    if lib_type in ("mate-pairs", "hq-mate-pairs"):
        return estimate_smoothing(pi, cfg)
    return estimate_simple(pi, cfg)
