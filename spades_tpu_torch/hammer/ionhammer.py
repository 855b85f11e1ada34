"""IonTorrent homopolymer-space read correction (ionhammer equivalent).

Capability mirror of SPAdes' `spades-ionhammer`
(`src/projects/ionhammer/main.cpp:279`, `hkmer.hpp` HK-mers =
homopolymer-run k-mers, `gamma_poisson_model.{hpp,cpp}` count + run-length
error model, `read_corrector_new.hpp` flow-space correction): IonTorrent's
dominant error mode is homopolymer run-length miscalls, so correction happens
in homopolymer-compressed (flow) space.

Host numpy, the JAX package's `spades_tpu/hammer/ionhammer.py` unchanged
(that package runs it on the host too), over this package's own
`ops/extension.canonicalize`, `ops/count._lexsort_rows` and
`searchsorted_rows`.  The model:

* HK-mer contexts are counted over the compressed bases (a host sort);
  each solid context keeps the full run-length histogram
  of its center base.
* A two-component **Poisson-Gamma (negative-binomial) mixture** over context
  counts — genomic Gamma(a_g, b_g) vs noise Gamma(a_n, b_n) priors on the
  Poisson rate — is fit by EM *on the count histogram* (vectorized over
  distinct count values, so the fit is O(support) per step rather than
  O(#kmers) as in SPAdes' per-kmer OpenMP loops,
  `gamma_poisson_model.hpp` TClusterModelEstimator).  The posterior
  P(genomic | count) replaces the fixed multiplicity cutoff as the
  solidness criterion.
* **Per-run-length error rates** alpha[len] are estimated from
  count-weighted disagreements between observations and their context
  consensus, smoothed toward a monotone prior exactly in the style of SPAdes'
  TRunErrorStats::EstimateAlphas (error mass grows with run
  length; rates are Bayesian-smoothed with a pseudo-count prior).
* Correction is a **Bayesian posterior decision per run**: for observed run
  o in a solid context with histogram h, the corrected length is
  argmax_t [ ln p_ctx(t | h) + ln p_obs(o | t) ] where
  ln p_obs(o|t) = |o-t| * ln alpha(t) for miscalls and ln(1-alpha(t)) on the
  diagonal — the same |delta|*ln(err) geometric penalty as SPAdes'
  ParametricClusterModel::ExpectedErrorRate.  All windows of all reads are
  scored in one vectorized pass (chunked), not per-read Python.
"""
from __future__ import annotations

import logging
import math
from dataclasses import dataclass

import numpy as np

from ..core import dna
from ..core import kmers as K
from ..ops.count import searchsorted_rows

log = logging.getLogger("spades_tpu_torch.ionhammer")


@dataclass
class IonHammerConfig:
    k: int = 13                 # HK-mer length (compressed space)
    max_run: int = 31
    p_genomic: float = 0.5      # posterior P(genomic|count) to trust a context
    min_solid: int = 3          # count floor (guards the tiny-input regime)
    em_iters: int = 25
    # pseudo-count prior anchors for alpha[len] (error prob of a length-len
    # run), monotone in len; 100 pseudo-observations as in SPAdes
    alpha_prior_size: float = 100.0


def hp_compress(seq: str) -> tuple[str, np.ndarray]:
    """Homopolymer-compress: 'AAACCG' -> ('ACG', [3, 2, 1])."""
    if not seq:
        return "", np.zeros(0, np.int64)
    codes = dna.encode(seq)
    change = np.concatenate([[True], codes[1:] != codes[:-1]])
    starts = np.flatnonzero(change)
    runs = np.diff(np.append(starts, len(codes)))
    return dna.decode(codes[starts]), runs


def hp_expand(bases: str, runs: np.ndarray) -> str:
    return "".join(b * int(r) for b, r in zip(bases, runs))


# ---------------------------------------------------------------------------
# Poisson-Gamma count mixture (negative binomial), fit by EM on the histogram


def _lgamma_vec(x: np.ndarray) -> np.ndarray:
    """lgamma over a (small) float array without a scipy dependency."""
    flat = np.asarray(x, np.float64).ravel()
    out = np.array([math.lgamma(max(v, 1e-12)) for v in flat])
    return out.reshape(np.shape(x))


def _nb_loglik(c: np.ndarray, a: float, b: float) -> np.ndarray:
    """ln P(count=c) under Poisson(rate), rate ~ Gamma(shape=a, rate=b)
    (SPAdes' PoissonGammaDistribution::LogLikelihood)."""
    c = np.asarray(c, np.float64)
    return (
        a * math.log(b)
        - (a + c) * math.log(b + 1.0)
        + _lgamma_vec(a + c)
        - _lgamma_vec(c + 1.0)
        - math.lgamma(a)
    )


@dataclass
class GammaPoissonMixture:
    a_g: float
    b_g: float
    a_n: float
    b_n: float
    w_g: float

    def genomic_posterior(self, counts: np.ndarray) -> np.ndarray:
        """P(genomic | count), vectorized over distinct count values."""
        lg = _nb_loglik(counts, self.a_g, self.b_g) + math.log(max(self.w_g, 1e-12))
        ln = _nb_loglik(counts, self.a_n, self.b_n) + math.log(
            max(1.0 - self.w_g, 1e-12)
        )
        m = np.maximum(lg, ln)
        return np.exp(lg - m) / (np.exp(lg - m) + np.exp(ln - m))


def _gamma_moments(mean: float, var: float) -> tuple[float, float]:
    """Method-of-moments Gamma prior for a Poisson-Gamma with observed
    mean/var: mean = a/b, var = a/b + a/b^2  =>  b = mean/(var-mean)."""
    ex = max(var - mean, mean * 1e-3)
    b = min(max(mean / ex, 1e-3), 1e3)
    a = max(mean * b, 1e-3)
    return a, b


def fit_count_mixture(counts: np.ndarray, iters: int = 25) -> GammaPoissonMixture:
    """EM fit of the 2-component Poisson-Gamma mixture over k-mer counts.

    `counts` = one multiplicity per distinct HK-mer context.  The E/M steps
    run over the *histogram support* (distinct count values), so cost is
    independent of the number of k-mers."""
    counts = np.asarray(counts, np.int64)
    vals, freq = np.unique(counts, return_counts=True)
    vals = vals.astype(np.float64)
    freq = freq.astype(np.float64)
    if len(vals) < 2:
        return GammaPoissonMixture(4.0, 0.2, 1.0, 1.0, 0.5)
    # init: noise = counts at/below median, genomic = above
    med = np.median(counts)
    hi = vals > med
    if not hi.any() or hi.all():
        hi = vals > vals.min()
    w = freq / freq.sum()

    def _wstats(resp):
        z = resp * freq
        tot = z.sum()
        if tot <= 0:
            return 1.0, 2.0, 0.0
        m = float((z * vals).sum() / tot)
        v = float((z * (vals - m) ** 2).sum() / tot)
        return m, v, tot

    resp = hi.astype(np.float64)
    m_g, v_g, _ = _wstats(resp)
    m_n, v_n, _ = _wstats(1.0 - resp)
    a_g, b_g = _gamma_moments(max(m_g, 2.0), max(v_g, m_g * 1.5))
    a_n, b_n = _gamma_moments(max(m_n, 0.5), max(v_n, m_n * 1.5))
    w_g = float((w * resp).sum())
    for _ in range(iters):
        lg = _nb_loglik(vals, a_g, b_g) + math.log(max(w_g, 1e-12))
        ln = _nb_loglik(vals, a_n, b_n) + math.log(max(1.0 - w_g, 1e-12))
        mx = np.maximum(lg, ln)
        resp = np.exp(lg - mx) / (np.exp(lg - mx) + np.exp(ln - mx))
        m_g, v_g, t_g = _wstats(resp)
        m_n, v_n, t_n = _wstats(1.0 - resp)
        if t_g <= 0 or t_n <= 0:
            break
        # keep the components ordered (genomic = the heavier-count one)
        if m_g < m_n:
            m_g, m_n, v_g, v_n, t_g, t_n = m_n, m_g, v_n, v_g, t_n, t_g
            resp = 1.0 - resp
        a_g, b_g = _gamma_moments(m_g, v_g)
        a_n, b_n = _gamma_moments(m_n, v_n)
        w_g = min(max(float(t_g / (t_g + t_n)), 1e-6), 1.0 - 1e-6)
    return GammaPoissonMixture(a_g, b_g, a_n, b_n, w_g)


# ---------------------------------------------------------------------------
# run-length error rates


def estimate_run_error_rates(
    hist: np.ndarray, totals: np.ndarray, cfg: IonHammerConfig
) -> np.ndarray:
    """alpha[len] = P(a true length-len run is miscalled), len 0..max_run.

    Count-weighted disagreement of observations vs. their context consensus,
    accumulated per consensus length, Bayesian-smoothed with a monotone
    pseudo-count prior (SPAdes' EstimateAlphas shape:
    (err + prior*N) / (total + N))."""
    R = hist.shape[1]
    consensus = hist.argmax(axis=1)
    agree = hist[np.arange(len(hist)), consensus].astype(np.float64)
    err = (totals - agree).astype(np.float64)
    tot_by_len = np.zeros(R)
    err_by_len = np.zeros(R)
    np.add.at(tot_by_len, consensus, totals.astype(np.float64))
    np.add.at(err_by_len, consensus, err)
    # monotone prior: short runs are called well, long runs poorly
    lens = np.arange(R, dtype=np.float64)
    prior = np.clip(0.002 * (1.0 + lens) ** 1.8, 0.002, 0.25)
    n0 = cfg.alpha_prior_size
    alpha = (err_by_len + prior * n0) / (tot_by_len + n0)
    return np.clip(alpha, 1e-4, 0.45)


# ---------------------------------------------------------------------------
# context table + correction


def _hk_windows(compressed, cfg: IonHammerConfig):
    """All HK-mer windows of all reads as one flat batch.

    Returns (canon_rows, center_runs, read_row, center_pos) arrays."""
    from ..ops.extension import canonicalize

    k = cfg.k
    half = k // 2
    rows, cruns, rids, cpos = [], [], [], []
    for rid, (bases, runs) in enumerate(compressed):
        n = len(bases)
        if n < k:
            continue
        codes = dna.encode(bases)
        if (codes >= 4).any():
            continue
        wins = np.lib.stride_tricks.sliding_window_view(codes, k)
        packed = K.pack(np.ascontiguousarray(wins))
        canon, _rc = canonicalize(packed, k)
        nw = wins.shape[0]
        rows.append(canon)
        cruns.append(np.minimum(runs[half : half + nw], cfg.max_run))
        rids.append(np.full(nw, rid, np.int64))
        cpos.append(half + np.arange(nw, dtype=np.int64))
    if not rows:
        return None
    return (
        np.concatenate(rows),
        np.concatenate(cruns).astype(np.int64),
        np.concatenate(rids),
        np.concatenate(cpos),
    )


def correct_ion_reads(
    seqs: list[str], cfg: IonHammerConfig | None = None
) -> tuple[list[str], int]:
    """Correct homopolymer run-length errors.  Returns (reads, runs changed)."""
    cfg = cfg or IonHammerConfig()
    compressed = [hp_compress(s) for s in seqs]
    wins = _hk_windows(compressed, cfg)
    if wins is None:
        return list(seqs), 0
    rows, cruns, rids, cpos = wins
    from ..ops.count import _lexsort_rows

    order = _lexsort_rows(rows)
    srows, slens = rows[order], cruns[order]
    new = np.concatenate([[True], np.any(srows[1:] != srows[:-1], axis=1)])
    seg = np.cumsum(new) - 1
    n_ctx = int(seg[-1]) + 1
    R = cfg.max_run + 1
    hist = np.zeros((n_ctx, R), np.int64)
    np.add.at(hist, (seg, slens), 1)
    totals = hist.sum(axis=1)
    ctx_kmers = srows[new]

    # ---- model fit ----
    # each (context, center-length) pair IS an HK-mer; its multiplicity is a
    # histogram bin.  The count mixture is fit over those HK-mer counts, so
    # P(genomic | count) plays SPAdes' per-kmer posterior role.
    bin_counts = hist[hist > 0]
    mix = fit_count_mixture(bin_counts, cfg.em_iters)
    post_of_count = np.zeros(int(hist.max()) + 1)
    if len(post_of_count) > 1:
        post_of_count[1:] = mix.genomic_posterior(
            np.arange(1, len(post_of_count))
        )
    # a context is usable if some center length is confidently genomic
    post = post_of_count[hist.max(axis=1)]
    solid = (post >= cfg.p_genomic) & (totals >= cfg.min_solid)
    alphas = estimate_run_error_rates(hist[solid], totals[solid], cfg) \
        if solid.any() else estimate_run_error_rates(hist, totals, cfg)
    log.info(
        "ionhammer model: %d contexts, %d solid (P(genomic)>=%.2f), "
        "mixture a_g=%.2f b_g=%.2f a_n=%.2f b_n=%.2f w_g=%.3f, "
        "alpha[1..4]=%s",
        n_ctx, int(solid.sum()), cfg.p_genomic,
        mix.a_g, mix.b_g, mix.a_n, mix.b_n, mix.w_g,
        np.round(alphas[1:5], 4),
    )

    # ---- vectorized posterior correction over all windows ----
    idx = searchsorted_rows(ctx_kmers, rows)
    ok = (idx >= 0) & solid[np.maximum(idx, 0)]
    idx, obs, rids, cpos = idx[ok], cruns[ok], rids[ok], cpos[ok]
    changed = 0
    # per-true-length observation penalty pieces
    ln_alpha = np.log(alphas)                      # (R,)
    ln_stay = np.log1p(-alphas)                    # (R,)
    tgrid = np.arange(R, dtype=np.int64)
    new_run = np.empty(len(idx), np.int64)
    CH = 1 << 18
    for s in range(0, len(idx), CH):
        sl = slice(s, min(s + CH, len(idx)))
        hraw = hist[idx[sl]]                       # (W, R) int
        # genomic-weighted support: bins whose count looks like noise under
        # the mixture contribute ~nothing (the per-kmer posterior gate)
        h = hraw * post_of_count[hraw]
        tot = h.sum(axis=1, keepdims=True)
        lp_ctx = np.log((h + 0.05) / (tot + 0.05 * R))
        d = np.abs(obs[sl, None] - tgrid[None, :])  # (W, R)
        lp_obs = np.where(d == 0, ln_stay[None, :], d * ln_alpha[None, :])
        new_run[sl] = np.argmax(lp_ctx + lp_obs, axis=1)
    # apply: one window per center position, so writes never conflict
    diff = new_run != obs
    for rid, pos, t in zip(rids[diff], cpos[diff], new_run[diff]):
        compressed[rid][1][pos] = t
        changed += 1
    out = []
    for bases, runs in compressed:
        keep = runs > 0                            # run deleted entirely
        if keep.all():
            out.append(hp_expand(bases, runs))
        else:
            out.append(hp_expand("".join(np.array(list(bases))[keep]), runs[keep]))
    log.info("ionhammer: %d homopolymer runs corrected", changed)
    return out, changed
