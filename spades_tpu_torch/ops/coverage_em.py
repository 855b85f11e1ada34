"""GenomicInfoFiller's coverage EM on the card, and its plain PyTorch version.

`coverage_em` runs the loop of `graph/coverage_model.py:fit_coverage_model`
over its rounds: the E-step, the update of the error probability and the
M-step, scipy's Nelder-Mead on `_em_objective`, until the error probability
moves by at most 1e-8 or after 100 rounds.  On a CUDA tensor it launches the
hand-written kernel `csrc/coverage_em.cu` (built with the others by
`ops/cuda_kernels.py:build`) once per fit, or raises; on a CPU tensor it
computes `coverage_em_plain`, a float64 torch objective and the same
Nelder-Mead written out in Python.

The kernel replaces no TPU kernel: the JAX package fits on the host.  It
was added because the host spends about 110 us of interpreter and call
overhead on each of a fit's some 30,000 objective evaluations while the card
waits.  What bounds it is float64 work per evaluation on the one SM its block
uses, the evaluations one after another (each simplex step needs the last).
Neither version equals numpy bit for bit (other exp, erf, pow, log and zeta,
other orders of summation), so `fit_coverage_model` keeps scipy on the host
path, the one the JAX package's parity tests hold.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

MAX_COPY = 10
MAX_BINS = 5000          # the histogram's cap in fit_coverage_model
MAX_ROUNDS = 100
TOL = 1e-8               # xatol, fatol and the rounds' |dp|
DEFAULT_EVALS = 200 * 6  # scipy's maxfev and maxiter where neither is given
_SQRT_2PI = math.sqrt(2.0 * math.pi)
_SQRT_2 = math.sqrt(2.0)


def nelder_mead(f, x0: np.ndarray, maxfev: int, maxiter: int):
    """scipy's `_minimize_neldermead` (adaptive=False, no bounds) with a
    stable sort of the simplex: the path the kernel takes.  Returns (x,
    nfev, nit).  scipy itself is not that path wherever vertices tie (several
    infinite ones, from the validity test): its `np.argsort` is numpy's
    default sort, which on a CPU with AVX-512 orders float64 ties unstably
    (numpy 2's vectorised sort), so its path there depends on the host."""
    rho, chi, psi, sigma = 1, 2, 0.5, 0.5
    N = len(x0)
    sim = np.empty((N + 1, N))
    sim[0] = x0
    for k in range(N):
        y = np.array(x0, copy=True)
        y[k] = (1 + 0.05) * y[k] if y[k] != 0 else 0.00025
        sim[k + 1] = y
    fsim = np.full(N + 1, np.inf)
    calls = 0

    def call(p):
        nonlocal calls
        if calls >= maxfev:
            return None
        calls += 1
        return f(p)

    def sort(sim, fsim):
        ind = np.argsort(fsim, kind="stable")
        return np.take(sim, ind, 0), np.take(fsim, ind, 0)

    def step(sim, fsim) -> bool:
        """One iteration, in place; False where the budget ran out in it."""
        xbar = np.add.reduce(sim[:-1], 0) / N
        xr = (1 + rho) * xbar - rho * sim[-1]
        fxr = call(xr)
        if fxr is None:
            return False
        if fxr < fsim[0]:
            xe = (1 + rho * chi) * xbar - rho * chi * sim[-1]
            fxe = call(xe)
            if fxe is None:
                return False
            sim[-1], fsim[-1] = (xe, fxe) if fxe < fxr else (xr, fxr)
            return True
        if fxr < fsim[-2]:
            sim[-1], fsim[-1] = xr, fxr
            return True
        if fxr < fsim[-1]:
            p = (1 + psi * rho) * xbar - psi * rho * sim[-1]
            fp = call(p)
            if fp is None:
                return False
            shrink = not fp <= fxr
        else:
            p = (1 - psi) * xbar + psi * sim[-1]
            fp = call(p)
            if fp is None:
                return False
            shrink = not fp < fsim[-1]
        if not shrink:
            sim[-1], fsim[-1] = p, fp
            return True
        for j in range(1, N + 1):
            # set before the call that may find the budget spent, as scipy does
            sim[j] = sim[0] + sigma * (sim[j] - sim[0])
            v = call(sim[j])
            if v is None:
                return False
            fsim[j] = v
        return True

    for k in range(N + 1):
        v = call(sim[k])
        if v is None:
            break
        fsim[k] = v
    sim, fsim = sort(sim, fsim)
    iterations = 1
    while calls < maxfev and iterations < maxiter:
        if (np.max(np.abs(sim[1:] - sim[0])) <= TOL
                and np.max(np.abs(fsim[0] - fsim[1:])) <= TOL):
            break
        if step(sim, fsim):
            iterations += 1
        sim, fsim = sort(sim, fsim)
    return sim[0].copy(), calls, iterations


def _mixture(x, i: torch.Tensor):
    """The error density (0 where it is not finite) and the genomic density
    of one parameter vector at the multiplicities i."""
    zp, shape, u, sd, scale, shape2 = (float(v) for v in x)
    f64 = torch.float64
    with np.errstate(all="ignore"):
        e = float(np.float64(-1.0) / np.float64(shape))
    pe = torch.pow(1.0 + shape * (i - 1.0) / scale, e) - torch.pow(1.0 + shape * i / scale, e)
    pe = torch.where(torch.isfinite(pe), pe, torch.zeros((), dtype=f64))
    copies = torch.arange(1, MAX_COPY + 1, dtype=f64)[:, None]
    w = copies.pow(-zp - 1.0) / torch.special.zeta(torch.tensor(zp + 1.0, dtype=f64), 1.0)
    omega = (sd * copies.sqrt()).clamp_min(1e-300)
    t = (i[None, :] - copies * u) / omega
    phi = torch.exp(-0.5 * t * t) / _SQRT_2PI
    Phi = 0.5 * (1.0 + torch.erf(shape2 * t / _SQRT_2))
    pdf = 2.0 / omega * phi * Phi
    pdf = torch.where(torch.isfinite(pdf), pdf, torch.zeros((), dtype=f64))
    return pe, (pdf * w).sum(0)


def _objective(i: torch.Tensor, cov: torch.Tensor, z: torch.Tensor):
    """`_em_objective` over the non-empty bins, in float64 torch."""
    f64 = torch.float64
    floor = torch.full((), -1000.0, dtype=f64)

    def objective(x) -> float:
        zp, shape, u, sd, scale, _shape2 = x
        if (zp <= 1 or shape <= 0 or sd <= 0 or u <= 0 or scale <= 0
                or not np.isfinite(x).all()):
            return np.inf
        pe, g = _mixture(x, i)
        le, lg = torch.log(pe), torch.log(g)
        le = torch.where(torch.isfinite(le), le, floor)
        lg = torch.where(torch.isfinite(lg), lg, floor)
        return -float((cov * (z * le + (1.0 - z) * lg)).sum())

    return objective


def coverage_em_plain(cov: torch.Tensor, x0, err_prob: float, total: float):
    """Plain PyTorch version of the coverage_em kernel: (x, err_prob,
    rounds, evaluations)."""
    nz = cov > 0
    c = cov[nz]
    i = torch.nonzero(nz).flatten().to(torch.float64) + 1.0
    x = np.array(x0, np.float64)
    prev_p, it, evals = 2.0, 1, 0
    while abs(prev_p - err_prob) > TOL and it <= MAX_ROUNDS:
        pe, g = _mixture(x, i)
        pe = err_prob * pe
        z = pe / (pe + (1.0 - err_prob) * g)
        z = torch.where(torch.isfinite(z), z, torch.ones((), dtype=torch.float64))
        prev_p = err_prob
        err_prob = float((z * c).sum()) / total
        last = abs(prev_p - err_prob) <= TOL
        budget = DEFAULT_EVALS if last else 5 * 6 * it
        r, nfev, _nit = nelder_mead(_objective(i, c, z), x, budget,
                                    DEFAULT_EVALS if last else 2**31 - 1)
        evals += nfev
        if np.all(np.isfinite(r)):
            x = r
        it += 1
    return x, err_prob, it - 1, evals


def coverage_em(cov: torch.Tensor, x0, err_prob: float, total: float):
    """The EM of `fit_coverage_model` from x0 = (zp, shape, u, sd, scale,
    shape2) and err_prob, over cov (n,) float64, the histogram's first n
    bins (good_cov), total being the whole histogram's count.  Returns (x
    (6,) float64 numpy, err_prob, rounds, evaluations of the objective).
    One launch of csrc/coverage_em.cu on a CUDA tensor; the plain version
    on a CPU tensor."""
    from . import cuda_kernels as CK

    if cov.dtype != torch.float64:
        raise TypeError("cov must be float64")
    if cov.dim() != 1 or not 1 <= cov.shape[0] <= MAX_BINS:
        raise ValueError(f"cov must be 1-D with 1 to {MAX_BINS} bins, got {tuple(cov.shape)}")
    x0 = np.asarray(x0, np.float64)
    if x0.shape != (6,):
        raise ValueError(f"x0 must hold 6 parameters, got {x0.shape}")
    if cov.device.type == "cpu":
        return coverage_em_plain(cov, x0, err_prob, total)
    if cov.device.type != "cuda":
        raise ValueError(f"unsupported device {cov.device}")
    if not cov.is_contiguous():
        raise ValueError("cov must be contiguous")
    CK.build()
    out = torch.empty(9, dtype=torch.float64, device=cov.device)
    init = (ctypes.c_double * 8)(*x0.tolist(), float(err_prob), float(total))
    with torch.cuda.device(cov.device):
        stream = torch.cuda.current_stream(cov.device).cuda_stream
        rc = CK._lib.spades_coverage_em(cov.data_ptr(), cov.shape[0], init, out.data_ptr(),
                                        stream)
    if rc != 0:
        msg = CK._lib.spades_coverage_em_error_string(rc).decode()
        raise RuntimeError(f"coverage_em kernel launch failed: {msg} ({rc})")
    coverage_em.launches += 1
    o = out.cpu().numpy()
    return o[:6].copy(), float(o[6]), int(o[7]), int(o[8])


coverage_em.launches = 0
