"""The coverage EM's CUDA kernel, compiled as host code, and its plain
PyTorch version, against the host fit.

`spades_tpu_torch/csrc/coverage_em.cu` builds only where nvcc is; its
minimiser, compaction, block sums and round loop are plain C++ behind
`csrc/emulation/`'s stand-ins (a block is a group of host threads).  Its
Nelder-Mead is held bit for bit against scipy's on objectives that both
compute with the same float64 steps; the whole EM, emulated and in plain
PyTorch, against `fit_coverage_model`'s scipy path, whose thresholds must
come out equal and whose float fields close.
"""
import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch
from scipy.optimize import minimize

from spades_tpu_torch.graph import coverage_model as cm
from spades_tpu_torch.ops import coverage_em as E
from spades_tpu_torch.ops import cuda_kernels as CK
from spades_tpu_torch.utils import timetracer
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401
from tests.test_torch_simplify import _converged_hist, _hist_counts

CSRC = CK._PKG + "/csrc"
COEF = np.array([1.0, 0.5, 2.0, 0.25, 4.0, 1.5])
CENTER = np.array([1.5, -0.75, 2.25, 0.5, 3.0, 0.0])
INT_MAX = 2**31 - 1


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    so = tmp_path_factory.mktemp("emu") / "libcoverage_em_emulated.so"
    subprocess.run(
        ["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread", "-DSPADES_EM_THREADS=64",
         "-I", f"{CSRC}/emulation", "-o", str(so), f"{CSRC}/emulation/emulate_coverage_em.cpp"],
        check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.spades_nelder_mead_quadratic.restype = ci
    lib.spades_nelder_mead_quadratic.argtypes = [vp, vp, ci, cd, vp, ci, ci, vp, vp]
    lib.spades_coverage_em.restype = ci
    lib.spades_coverage_em.argtypes = CK.EM_ARGTYPES
    return lib


def _quadratic(axis, bound):
    """What `Quadratic` of emulate_coverage_em.cpp computes, step for step."""
    def f(x):
        if axis >= 0 and x[axis] > bound:
            return np.inf
        s = 0.0
        for j in range(6):
            d = x[j] - CENTER[j]
            s = s + COEF[j] * (d * d)
        return s
    return f


def _emulated_nm(lib, x0, maxfev, axis, bound):
    x = np.zeros(6)
    counts = np.zeros(2, np.int32)
    mf, mi = (E.DEFAULT_EVALS, E.DEFAULT_EVALS) if maxfev is None else (maxfev, INT_MAX)
    assert lib.spades_nelder_mead_quadratic(
        COEF.ctypes.data, CENTER.ctypes.data, axis, bound, np.asarray(x0, np.float64).ctypes.data,
        mf, mi, x.ctypes.data, counts.ctypes.data) == 0
    return x, int(counts[0]), int(counts[1])


def _iteration_ends(f, x0):
    """The evaluation counts at which scipy's unbudgeted run ends an
    iteration."""
    calls, ends = [0], []

    def counted(x):
        calls[0] += 1
        return f(x)
    minimize(counted, x0, method="Nelder-Mead", callback=lambda *_: ends.append(calls[0]),
             options={"xatol": 1e-8, "fatol": 1e-8})
    return set(ends)


@pytest.mark.parametrize("axis, bound, x0", [
    (-1, 0.0, [0.5, 0.0, 1.0, 2.0, -1.0, 0.25]),     # a zero coordinate: zdelt
    (0, 1.2, [0.5, 0.0, 1.0, 2.0, -1.0, 0.25]),      # the minimum behind an inf wall
    (0, 1.2, [1.18, 0.0, 1.0, 2.0, -1.0, 0.25]),     # a first vertex beyond it
], ids=["quadratic", "inf_region", "inf_vertex"])
def test_emulated_nelder_mead_follows_scipy(emulated, axis, bound, x0):
    """x, nfev and nit bit for bit, unbudgeted (scipy's 1,200 evaluations and
    iterations) and under budgets that run out at an iteration's end and in
    its middle (in an expansion, a contraction or a shrink)."""
    f = _quadratic(axis, bound)
    ends = _iteration_ends(f, x0)
    budgets = [None, 6, 7] + list(range(30, 60)) + [97, 150, 211]
    kinds = set()
    for m in budgets:
        ref = minimize(f, x0, method="Nelder-Mead",
                       options={"maxfev": m, "xatol": 1e-8, "fatol": 1e-8})
        x, nfev, nit = _emulated_nm(emulated, x0, m, axis, bound)
        assert np.array_equal(x, ref.x) and (nfev, nit) == (ref.nfev, ref.nit), m
        if m is not None and m < ref.nfev + 1 and ref.nit > 1:
            kinds.add(m in ends)
        # the plain version's minimiser takes the same path
        px, pnfev, pnit = E.nelder_mead(f, np.asarray(x0, np.float64),
                                        *((E.DEFAULT_EVALS,) * 2 if m is None else (m, INT_MAX)))
        assert np.array_equal(px, ref.x) and (pnfev, pnit) == (ref.nfev, ref.nit), m
    assert kinds == {True, False}


def _em_inputs(counts):
    """The host fit's result and the arguments its EM was called with."""
    seen = {}
    host_em = cm._em_host

    def spy(*args):
        seen["args"] = args
        return host_em(*args)
    cm._em_host = spy
    try:
        ref = cm.fit_coverage_model(counts)
    finally:
        cm._em_host = host_em
    return ref, seen["args"]


def _info_from(counts, em_result, monkeypatch):
    """fit_coverage_model with its EM's result replaced."""
    with monkeypatch.context() as m:
        m.setattr(cm, "_em_host", lambda *_: em_result)
        return cm.fit_coverage_model(counts)


def _assert_close(got, ref):
    for f in ("ec_bound", "trusted_bound", "genome_size", "converged"):
        assert getattr(got, f) == getattr(ref, f), f
    assert abs(got.estimated_mean - ref.estimated_mean) <= 1e-3 * abs(ref.estimated_mean)
    assert abs(got.estimated_sd - ref.estimated_sd) <= 1e-2 * abs(ref.estimated_sd)


def test_plain_em_matches_the_host_fit(monkeypatch):
    counts = _hist_counts(_converged_hist())
    ref, (good_cov, x0, p0, total) = _em_inputs(counts)
    assert ref.converged
    res = E.coverage_em(torch.from_numpy(good_cov.copy()), x0, p0, total)
    assert res[2] > 5 and res[3] > 1000
    _assert_close(_info_from(counts, res, monkeypatch), ref)


def test_emulated_em_matches_the_plain_version(emulated, monkeypatch):
    counts = _hist_counts(_converged_hist())
    ref, (good_cov, x0, p0, total) = _em_inputs(counts)
    cov = np.ascontiguousarray(good_cov, np.float64).copy()
    cov[3] = 0.0                 # an empty bin inside the compacted range
    out = np.full(9, np.nan)
    init = (ctypes.c_double * 8)(*x0.tolist(), p0, total)
    assert emulated.spades_coverage_em(cov.ctypes.data, len(cov), init, out.ctypes.data,
                                       None) == 0
    plain = E.coverage_em(torch.from_numpy(cov), x0, p0, total)
    assert out[7] == plain[2] and abs(out[8] - plain[3]) <= 0.05 * plain[3]
    assert abs(out[6] - plain[1]) <= 1e-9
    assert np.allclose(out[2:4], plain[0][2:4], rtol=1e-5)     # the peak's u and sd
    emu = (out[:6].copy(), float(out[6]), int(out[7]), int(out[8]))
    _assert_close(_info_from(counts, emu, monkeypatch), ref)


def test_coverage_em_rejects_bad_input(emulated):
    x0 = np.array([3.0, 3.0, 40.0, 9.0, 1.0, 0.0])
    with pytest.raises(TypeError):
        E.coverage_em(torch.ones(10, dtype=torch.float32), x0, 0.1, 10.0)
    for bad in (torch.ones(0, dtype=torch.float64), torch.ones(5001, dtype=torch.float64),
                torch.ones(2, 3, dtype=torch.float64)):
        with pytest.raises(ValueError):
            E.coverage_em(bad, x0, 0.1, 10.0)
    with pytest.raises(ValueError):
        E.coverage_em(torch.ones(10, dtype=torch.float64), x0[:5], 0.1, 10.0)
    init = (ctypes.c_double * 8)(*x0.tolist(), 0.1, 10.0)
    cov, out = np.ones(5001), np.zeros(9)
    for n in (0, 5001):
        assert emulated.spades_coverage_em(cov.ctypes.data, n, init, out.ctypes.data, None) != 0
    assert emulated.spades_coverage_em(None, 10, init, out.ctypes.data, None) != 0


def test_fit_on_the_cpu_is_the_host_path():
    """device="cpu" is the scipy path (bit-equal to device=None), and the EM's
    span says so with its counts."""
    counts = _hist_counts(_converged_hist())
    ref, (good_cov, *_rest) = _em_inputs(counts)
    timetracer.enable()
    try:
        got = cm.fit_coverage_model(counts, device="cpu")
        events = [e for e in timetracer.events() if e["name"] == "coverage_fit.em"]
    finally:
        timetracer.disable()
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert len(events) == 1
    args = events[0]["args"]
    assert args["path"] == "host" and args["rounds"] == 16 and args["evals"] == 4068
    assert args["bins"] == len(good_cov) == 70
