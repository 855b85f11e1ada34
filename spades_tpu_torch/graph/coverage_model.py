"""Coverage-model threshold estimation: error/genomic mixture fit.

Capability mirror of SPAdes' `KMerCoverageModel::Fit`
(`src/common/modules/coverage_model/kmer_coverage_model.cpp:1-379`,
interface `kmer_coverage_model.hpp:16-29`, consumed by
`stages/genomic_info_filler.cpp:44-71`): the k-mer multiplicity histogram is
decomposed into an error component (discretized generalized-Pareto,
`perr` :42-45) and a genomic component (zeta-weighted mixture of skew-normal
copy-number peaks, `pgood` :47-57), fit by EM — the E-step computes
per-multiplicity posterior error probabilities `z` (:152-166), the M-step
re-optimizes the six distribution parameters by Nelder-Mead (SPAdes
uses nlopt LN_NELDERMEAD :282-296; here scipy's Nelder-Mead).  Thresholds
come from the posterior scan (:330-345): the erroneous-coverage bound is the
first multiplicity whose posterior error probability drops below
`probability_threshold` (0.05), the low/trusted bound the last one above
`strong_probability_threshold` (0.999); both clamped against the valley, the
bound adjusted to at most halfway from valley to mean (:355-360), and the
genome size estimated as the k-mer mass above the threshold (:371-376; we do
NOT halve it — multiplicities here are per canonical k-mer already).

The pre-fit moment estimates mirror `Fit()` exactly: Tukey-style repeated
running-median smoothing for the valley (`EstimateValley` :169-186, using
math/smooth.hpp 3RS3R; here the 3R core), max-after-valley + median
refinement for the coverage estimate (:195-216), MAD for its spread
(:222-237).

The valley heuristic survives as the degenerate-histogram fallback (the
reference fatals on <=10 bins, `Fit()` :188; we degrade gracefully), and
`find_uneven_threshold` mirrors the uneven-depth (meta/MDA) branch of
GenomicInfoFiller (`ErroneousConnectionThresholdFinder`,
`modules/simplification/ec_threshold_finder.hpp:25-150`) that estimates the
bound from short-edge coverages instead of the k-mer histogram.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils import timetracer

MAX_COPY = 10  # copy-number mixture components (kmer_coverage_model.cpp:35)


@dataclass
class GenomicInfo:
    ec_bound: float          # coverage below this is considered erroneous
    trusted_bound: float     # coverage above this is trusted genomic
    estimated_mean: float    # estimated genomic k-mer coverage
    genome_size: int         # estimated genome size in k-mers
    estimated_sd: float = 0.0
    converged: bool = True


# ---------------------------------------------------------------------------
# mixture components
# ---------------------------------------------------------------------------

def _dzeta(copy: np.ndarray, zp: float) -> np.ndarray:
    """Zipf copy-number prior: copy^-(zp+1) / zeta(zp+1) (dzeta :37-39)."""
    from scipy.special import zeta

    return np.power(copy, -zp - 1.0) / zeta(zp + 1.0)


def _perr(i: np.ndarray, scale: float, shape: float) -> np.ndarray:
    """Discretized generalized-Pareto error density over multiplicity i>=1.
    Out-of-support parameter corners (negative base under the power) yield
    density 0 instead of NaN."""
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        a = np.power(1.0 + shape * (i - 1.0) / scale, -1.0 / shape)
        b = np.power(1.0 + shape * i / scale, -1.0 / shape)
        out = a - b
    return np.where(np.isfinite(out), out, 0.0)


def _skew_normal_pdf(x: np.ndarray, loc, omega, alpha) -> np.ndarray:
    """Guarded like SPAdes' numeric clamps (kmer_coverage_model.cpp):
    a degenerate omega or overflowing tail must yield density 0, not NaN —
    the EM explores such corners before converging."""
    from scipy.special import erf

    omega = np.maximum(np.asarray(omega, np.float64), 1e-300)
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        t = (x - loc) / omega
        phi = np.exp(-0.5 * t * t) / np.sqrt(2.0 * np.pi)
        Phi = 0.5 * (1.0 + erf(alpha * t / np.sqrt(2.0)))
        out = 2.0 / omega * phi * Phi
    return np.where(np.isfinite(out), out, 0.0)


def _pgood(i: np.ndarray, zp: float, u: float, sd: float, shape2: float,
           mixprobs: np.ndarray | None = None) -> np.ndarray:
    """Genomic density: zeta-weighted skew-normal copy peaks (pgood :47-57)."""
    copies = np.arange(1, MAX_COPY + 1, dtype=np.float64)
    w = mixprobs if mixprobs is not None else _dzeta(copies, zp)
    x = np.asarray(i, np.float64)[:, None]
    pdf = _skew_normal_pdf(
        x, copies[None, :] * u, sd * np.sqrt(copies)[None, :], shape2
    )
    return pdf @ w


def _estep(x: np.ndarray, p: float, n: int) -> np.ndarray:
    """Posterior error probability per multiplicity bin (EStep :152-166)."""
    zp, shape, u, sd, scale, shape2 = x
    i = np.arange(1, n + 1, dtype=np.float64)
    pe = p * _perr(i, scale, shape)
    z = pe / (pe + (1.0 - p) * _pgood(i, zp, u, sd, shape2))
    return np.where(np.isfinite(z), z, 1.0)


# |a| from which scipy's erf(a) is +-1.0 exactly (it is from 5.9216 on)
_ERF_SATURATED = 6.0
_SQRT_2PI = np.sqrt(2.0 * np.pi)
_SQRT_2 = np.sqrt(2.0)


def _em_objective(cov: np.ndarray, z: np.ndarray):
    """The M-step's objective: minus the weighted complete-data
    log-likelihood (CovModelLogLikeEM :100-146) of the six parameters, as one
    closure; the bins where ``cov`` is 0 add nothing.

    What does not depend on the six parameters (the bins, the copy numbers,
    the non-empty bins' counts and weights) is computed once per M-step; the
    grid is laid out copies x bins, so that each ufunc runs along the bins;
    and erf runs only where |a| < 6: the fit's skewness drives most of the
    grid past that, where erf is the sign of a.  Each value is the one that
    the plain formulas give, bit for bit (the same ufuncs on the same
    values, the same BLAS product on a bins x copies copy), so Nelder-Mead
    takes the same path.  The caller sets numpy's error state."""
    from scipy.special import erf, zeta

    n = len(cov)
    i = np.arange(1, n + 1, dtype=np.float64)
    i0 = np.arange(0, n + 1, dtype=np.float64)  # i - 1 and i share their tail
    copies = np.arange(1, MAX_COPY + 1, dtype=np.float64)
    col = copies[:, None]
    sqrt_col = np.sqrt(copies)[:, None]
    nz = cov > 0
    if nz.all():
        nz = slice(None)
    cn, zn = cov[nz], z[nz]
    omz = 1.0 - zn
    isfinite, where, log = np.isfinite, np.where, np.log
    grids = (np.empty((MAX_COPY, n)), np.empty((MAX_COPY, n)), np.empty((MAX_COPY, n)),
             np.empty((MAX_COPY, n), bool))

    def objective(x: np.ndarray) -> float:
        zp, shape, u, sd, scale, shape2 = x
        if (zp <= 1 or shape <= 0 or sd <= 0 or u <= 0 or scale <= 0
                or not isfinite(x).all()):
            return np.inf
        t, phi, erfs, live = grids
        # _perr
        pw = np.power(1.0 + shape * i0 / scale, -1.0 / shape)
        pe = pw[:-1] - pw[1:]
        le = log(where(isfinite(pe), pe, 0.0))
        # _skew_normal_pdf over copies x bins, weighted by _dzeta
        w = np.power(copies, -zp - 1.0) / zeta(zp + 1.0)
        omega = np.maximum(sd * sqrt_col, 1e-300)
        np.subtract(i, col * u, out=t)
        t /= omega
        np.multiply(t, -0.5, out=phi)
        phi *= t
        np.exp(phi, out=phi)
        phi /= _SQRT_2PI
        t *= shape2
        t /= _SQRT_2
        np.less(np.abs(t, out=erfs), _ERF_SATURATED, out=live)
        np.sign(t, out=erfs)
        at = np.flatnonzero(live)
        erfs.ravel()[at] = erf(t.ravel()[at])
        erfs += 1.0
        erfs *= 0.5
        phi *= 2.0 / omega
        phi *= erfs
        pdf = np.ascontiguousarray(phi.T)
        g = pdf @ w
        if not isfinite(g).all():
            g = where(isfinite(pdf), pdf, 0.0) @ w
        lg = log(g)
        lg = where(isfinite(lg), lg, -1000.0)
        le = where(isfinite(le), le, -1000.0)
        return -float((cn * (zn * le[nz] + omz * lg[nz])).sum())

    return objective


# ---------------------------------------------------------------------------
# pre-fit moment estimates
# ---------------------------------------------------------------------------

def _smooth_3r(y: np.ndarray, max_rounds: int = 30) -> np.ndarray:
    """Repeated running median of 3 until fixpoint (the 3R core of the
    reference's Tukey 3RS3R smoother, math/smooth.hpp:171)."""
    y = y.astype(np.float64).copy()
    for _ in range(max_rounds):
        if len(y) < 3:
            break
        m = y.copy()
        stacked = np.stack([y[:-2], y[1:-1], y[2:]])
        m[1:-1] = np.median(stacked, axis=0)
        if np.array_equal(m, y):
            break
        y = m
    return y


def _estimate_valley(hist: np.ndarray) -> int:
    """First local minimum of the smoothed histogram (EstimateValley)."""
    s = _smooth_3r(hist)
    valley = s[0]
    idx = 1
    while idx < len(s) and s[idx] < valley:
        valley = s[idx]
        idx += 1
    return idx - 1


# ---------------------------------------------------------------------------
# public fits
# ---------------------------------------------------------------------------

def _em_host(good_cov: np.ndarray, x: np.ndarray, err_prob: float, total: float):
    """The EM on the host (Fit :257-306): E-step, error probability, and
    scipy's Nelder-Mead for the M-step, until the error probability moves by
    at most 1e-8 or after 100 rounds.  Returns (x, err_prob, rounds,
    evaluations of the objective)."""
    from scipy.optimize import minimize

    prev_p = 2.0
    it = 1
    evals = 0
    while abs(prev_p - err_prob) > 1e-8 and it <= 100:
        z = _estep(x, err_prob, len(good_cov))
        prev_p = err_prob
        err_prob = float(np.sum(z * good_cov)) / total
        last_iter = abs(prev_p - err_prob) <= 1e-8
        with np.errstate(all="ignore"):
            res = minimize(
                _em_objective(good_cov, z),
                x,
                method="Nelder-Mead",
                options={
                    "maxfev": None if last_iter else 5 * 6 * it,
                    "xatol": 1e-8,
                    "fatol": 1e-8,
                },
            )
        evals += res.nfev
        if np.all(np.isfinite(res.x)):
            x = res.x
        it += 1
    return x, err_prob, it - 1, evals


def fit_coverage_model(
    multiplicities: np.ndarray,
    probability_threshold: float = 0.05,
    strong_probability_threshold: float = 0.999,
    device=None,
) -> GenomicInfo:
    """Fit the error/genomic mixture to k-mer multiplicities.

    ``multiplicities`` is the count per unique canonical k-mer; the histogram
    bin i (0-based) holds the number of k-mers of multiplicity i+1, matching
    SPAdes' ``cov_`` indexing.

    ``device`` is where the EM runs.  None or the CPU: on the host, scipy's
    Nelder-Mead over numpy, the JAX package's arithmetic bit for bit.  A CUDA
    device: one launch of the kernel of `ops/coverage_em.py`, whose objective
    differs from numpy's in the last digits, so the float fields differ there
    too (on a histogram with several modes the fit may end in another basin);
    the thresholds are read from its result by the same host code.  The
    span `coverage_fit.em` around the EM records its `path` ("device" or
    "host"), `rounds`, `evals` and `bins`."""
    m = np.asarray(multiplicities)
    if m.size == 0:
        return GenomicInfo(0.0, 0.0, 0.0, 0, converged=False)
    cap = int(min(m.max(), 5000))
    hist = np.bincount(
        np.minimum(m, cap).astype(np.int64), minlength=cap + 1
    ).astype(np.float64)[1:]  # bin i ↔ multiplicity i+1
    if len(hist) <= 10:
        return _fit_valley_fallback(m, hist)

    valley = _estimate_valley(hist)

    # first coverage estimate: maximum after the valley, median-refined
    max_cov = valley + 1 + int(np.argmax(hist[valley + 1:]))
    second_valley = min(2 * max_cov - valley, len(hist))
    after_valley = float(hist[valley + 1:second_valley].sum())
    ccov = np.cumsum(hist[valley + 1:second_valley])
    over = np.flatnonzero(ccov > after_valley / 2)
    if over.size:
        max_cov = max(valley + 1 + int(over[0]), max_cov)

    # MAD spread around the peak (Fit :222-237)
    half = min(max_cov - valley, len(hist) - max_cov)
    mvals = np.empty(max(half, 1))
    mvals[0] = hist[max_cov - 1] if max_cov - 1 < len(hist) else 0.0
    for i in range(1, half):
        mvals[i] = hist[max_cov + i - 1] + hist[max_cov - i - 1]
    tmad = mvals[:half].sum() if half else 0.0
    cov_sd = np.sqrt(5.0 * max_cov)
    cm = np.cumsum(mvals[:half]) if half else np.zeros(0)
    over = np.flatnonzero(cm > tmad / 2)
    if over.size:
        cov_sd = float(over[0])
    cov_sd *= 1.4826

    total = float(hist.sum())
    err_prob = float(hist[: valley + 1].sum()) / total
    err_prob = min(1 - 1e-3, max(1e-3, err_prob))

    # EM with Nelder-Mead M-step (Fit :257-306)
    x = np.array([3.0, 3.0, float(max_cov), cov_sd, 1.0, 0.0])
    good_cov = hist[: min(len(hist), 5 * MAX_COPY * max_cov // 4)]
    converged = True
    on_card = device is not None and torch.device(device).type == "cuda"
    with timetracer.span("coverage_fit.em", path="device" if on_card else "host",
                         bins=len(good_cov)) as sp:
        if on_card:
            from ..ops.coverage_em import coverage_em

            x, err_prob, rounds, evals = coverage_em(
                torch.from_numpy(np.ascontiguousarray(good_cov)).to(device), x, err_prob, total)
        else:
            x, err_prob, rounds, evals = _em_host(good_cov, x, err_prob, total)
        sp.set(rounds=rounds, evals=evals)

    zp, shape, u, sd, scale, shape2 = x
    delta = shape2 / np.sqrt(1 + shape2 * shape2)
    mean_cov = u + sd * delta * np.sqrt(2 / np.pi)
    sd_cov = sd * np.sqrt(1 - 2 * delta * delta / np.pi)
    if not (np.all(np.isfinite(x)) and np.isfinite(err_prob)):
        converged = False

    # valley sanity (Fit :323-327)
    if converged and valley > u > 2:
        valley = int(round(u / 2.0))

    error_threshold = 0
    low_threshold = 0
    if converged:
        z = _estep(x, err_prob, len(good_cov))
        converged = False
        for i in range(len(z)):
            if z[i] > strong_probability_threshold:
                low_threshold = min(i + 1, valley)
            elif z[i] < probability_threshold:
                error_threshold = max(i + 1, valley)
                converged = True
                break

    if converged:
        if valley < mean_cov:
            error_threshold = min(
                valley + int(mean_cov - valley) // 2, error_threshold
            )
        else:
            error_threshold = valley
    else:
        error_threshold = valley
        low_threshold = 1

    genome_size = int(hist[max(error_threshold - 1, 0):].sum())
    return GenomicInfo(
        ec_bound=float(error_threshold),
        trusted_bound=float(max(low_threshold, 1)),
        estimated_mean=float(mean_cov if converged else max_cov),
        genome_size=genome_size,
        estimated_sd=float(sd_cov if converged else cov_sd),
        converged=converged,
    )


def _fit_valley_fallback(m: np.ndarray, hist: np.ndarray) -> GenomicInfo:
    """Valley heuristic for degenerate histograms (<=10 bins, where the
    reference refuses to fit)."""
    if len(hist) == 0:
        return GenomicInfo(0.0, 0.0, 0.0, 0, converged=False)
    sm = _smooth_3r(hist)
    valley = 0
    for i in range(1, len(sm) - 1):
        if sm[i] <= sm[i - 1] and sm[i] <= sm[i + 1]:
            valley = i + 1  # bin i ↔ multiplicity i+1
            break
    if valley == 0:
        valley = max(2, int(np.quantile(m, 0.1)))
    peak = valley + int(np.argmax(sm[valley - 1:])) if valley - 1 < len(sm) else valley
    genomic = m[m > valley]
    mean = float(peak) if peak > valley else float(np.median(genomic) if genomic.size else valley)
    return GenomicInfo(
        ec_bound=float(valley),
        trusted_bound=float(max(valley + 1, mean * 0.25)),
        estimated_mean=mean,
        genome_size=int(genomic.size),
        converged=False,
    )


def find_uneven_threshold(g) -> float:
    """Uneven-depth (meta/MDA) EC bound from short-edge coverages: the
    reference's GenomicInfoFiller uneven branch
    (`genomic_info_filler.cpp:36-44`): min(average edge coverage, bucket-slope
    threshold of the short-bridged-edge coverage histogram)
    (`ec_threshold_finder.hpp:110-137`)."""
    ids = g.alive_edge_ids()
    if ids.size == 0:
        return 0.0
    lens = g.edge_kmer_lengths()
    cov = g.coverage()
    # average coverage weighted by length
    avg = float(np.sum(cov[ids] * lens[ids]) / max(np.sum(lens[ids]), 1))
    # interesting edges: short (<= k+1) and bridged on both sides
    outd = g.out_degrees()
    ind = g.in_degrees()
    s, e = g.e_start[ids], g.e_end[ids]
    interesting = (
        (lens[ids] <= g.k + 1) & (outd[s] >= 2) & (ind[e] >= 2)
    )
    cvals = np.floor(cov[ids][interesting]).astype(np.int64)
    if cvals.size == 0:
        return avg
    size = int(cvals.max()) + 1
    hist = np.bincount(cvals, minlength=size).astype(np.float64)
    bucket = int(0.3 * avg + 5)
    # triangular-window weight per position (weight() :51-57)
    w = np.convolve(
        hist, np.minimum(np.arange(1, bucket + 1), bucket - np.arange(bucket))[::-1],
        mode="full",
    )[bucket - 1: bucket - 1 + size]
    rising = np.zeros(size, bool)
    rising[1:] = w[1:] > w[:-1]
    cnt = np.cumsum(rising)
    # count of rising positions in the trailing window of width `bucket`
    window = cnt - np.concatenate([np.zeros(bucket, np.int64), cnt[:-bucket]])
    hit = np.flatnonzero(2 * window >= bucket)
    gthr = float(hit[0]) if hit.size else 0.1 * avg
    return min(avg, gthr)
