"""ctypes bindings for the native (C++) host components.

The device path is PyTorch/CUDA; the host runtime around it — the read
loader (fastx.cpp), the sorted-run merger (merge.cpp), the graph
construction engine (graph.cpp), the simplification engines (simplify.cpp,
bulge.cpp) and the union-find of read error correction (hammer.cpp) — is
native C++, built on first use with
`make -C spades_tpu_torch/native` into `libstbr.so` beside the sources.
Every caller must handle `None` from `lib()` and fall back to numpy.  The
loader, merger and construction fallbacks give identical results; the numpy
simplification loop is a different engine and need not give the same graph
as `simplify_native`.
"""
from __future__ import annotations

import ctypes
import fcntl
import logging
import os
import subprocess

import numpy as np

log = logging.getLogger("spades_tpu_torch.native")

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libstbr.so")
_lib = None
_tried = False
build_log = ""


class _StbrExt(ctypes.Structure):
    _fields_ = [
        ("U", ctypes.c_int64),
        ("kmers", ctypes.POINTER(ctypes.c_uint32)),
        ("in_mask", ctypes.POINTER(ctypes.c_uint8)),
        ("out_mask", ctypes.POINTER(ctypes.c_uint8)),
        ("pref_idx", ctypes.POINTER(ctypes.c_int64)),
        ("suf_idx", ctypes.POINTER(ctypes.c_int64)),
        ("pref_rc", ctypes.POINTER(ctypes.c_uint8)),
        ("suf_rc", ctypes.POINTER(ctypes.c_uint8)),
    ]


class _StbrGraph(ctypes.Structure):
    _fields_ = [
        ("E", ctypes.c_int64),
        ("V", ctypes.c_int64),
        ("pool", ctypes.c_int64),
        ("e_start", ctypes.POINTER(ctypes.c_int64)),
        ("e_end", ctypes.POINTER(ctypes.c_int64)),
        ("e_conj", ctypes.POINTER(ctypes.c_int64)),
        ("e_off", ctypes.POINTER(ctypes.c_int64)),
        ("e_len", ctypes.POINTER(ctypes.c_int64)),
        ("e_cov", ctypes.POINTER(ctypes.c_double)),
        ("seq_pool", ctypes.POINTER(ctypes.c_uint8)),
        ("v_conj", ctypes.POINTER(ctypes.c_int64)),
        ("error", ctypes.c_int32),
    ]


class _StbrReads(ctypes.Structure):
    _fields_ = [
        ("seq", ctypes.POINTER(ctypes.c_uint8)),
        ("seq_off", ctypes.POINTER(ctypes.c_uint64)),
        ("names", ctypes.POINTER(ctypes.c_uint8)),
        ("name_off", ctypes.POINTER(ctypes.c_uint64)),
        ("n_reads", ctypes.c_uint64),
        ("error", ctypes.c_int32),
    ]


class _StbrSimpOut(ctypes.Structure):
    _fields_ = [
        ("n_edges", ctypes.c_int64),
        ("n_arcs_total", ctypes.c_int64),
        ("chain_off", ctypes.POINTER(ctypes.c_int64)),
        ("chain_arcs", ctypes.POINTER(ctypes.c_int64)),
        ("e_start", ctypes.POINTER(ctypes.c_int64)),
        ("e_end", ctypes.POINTER(ctypes.c_int64)),
        ("e_conj", ctypes.POINTER(ctypes.c_int64)),
        ("e_klen", ctypes.POINTER(ctypes.c_int64)),
        ("e_cov", ctypes.POINTER(ctypes.c_double)),
        ("pool_size", ctypes.c_int64),
        ("seq_pool", ctypes.POINTER(ctypes.c_uint8)),
        ("e_off", ctypes.POINTER(ctypes.c_int64)),
        ("n_glues", ctypes.c_int64),
        ("glue_arm_off", ctypes.POINTER(ctypes.c_int64)),
        ("glue_arm_arcs", ctypes.POINTER(ctypes.c_int64)),
        ("glue_keep_off", ctypes.POINTER(ctypes.c_int64)),
        ("glue_keep_arcs", ctypes.POINTER(ctypes.c_int64)),
        ("tips", ctypes.c_int64),
        ("bulges", ctypes.c_int64),
        ("ec", ctypes.c_int64),
        ("isolated", ctypes.c_int64),
        ("iterations", ctypes.c_int64),
        ("error", ctypes.c_int32),
    ]


def lib():
    """The loaded native library, building it if needed; None if unavailable
    (then `build_log` holds what the build printed)."""
    global _lib, _tried, build_log
    if _lib is not None or _tried:
        return _lib
    _tried = True
    srcs = [f for f in os.listdir(_DIR) if f.endswith(".cpp")]
    stale = not os.path.exists(_SO) or any(
        os.path.getmtime(os.path.join(_DIR, f)) > os.path.getmtime(_SO) for f in srcs
    )
    if stale:
        if not srcs:
            return None
        try:
            # one build at a time: ranks of a multi-process run start together,
            # and make writes the library in place
            with open(os.path.join(_DIR, ".build.lock"), "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                res = subprocess.run(
                    ["make", "-C", _DIR], check=True, capture_output=True, text=True,
                    timeout=120,
                )
            build_log = res.stdout + res.stderr
        except (OSError, subprocess.SubprocessError) as e:
            build_log = f"{e}\n{getattr(e, 'stdout', '') or ''}{getattr(e, 'stderr', '') or ''}"
            log.debug("native build failed: %s", build_log)
            if not os.path.exists(_SO):
                return None
    try:
        l = ctypes.CDLL(_SO)
        p64 = ctypes.POINTER(ctypes.c_int64)
        pu32 = ctypes.POINTER(ctypes.c_uint32)
        pu8 = ctypes.POINTER(ctypes.c_uint8)
        l.stbr_read_fastx.restype = ctypes.POINTER(_StbrReads)
        l.stbr_read_fastx.argtypes = [ctypes.c_char_p]
        l.stbr_free_reads.restype = None
        l.stbr_free_reads.argtypes = [ctypes.POINTER(_StbrReads)]
        l.stbr_dsu_union_pairs.restype = None
        l.stbr_dsu_union_pairs.argtypes = [p64, p64, p64, p64, ctypes.c_int64]
        l.stbr_merge_runs.restype = ctypes.c_int64
        l.stbr_merge_runs.argtypes = [
            pu32, p64, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int32, ctypes.c_int32, pu32, p64,
        ]
        l.stbr_build_ext.restype = ctypes.POINTER(_StbrExt)
        l.stbr_build_ext.argtypes = [
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, pu32,
        ]
        l.stbr_free_ext.restype = None
        l.stbr_free_ext.argtypes = [ctypes.POINTER(_StbrExt)]
        l.stbr_condense.restype = ctypes.POINTER(_StbrGraph)
        l.stbr_condense.argtypes = [
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            pu32, pu8, pu8,
            ctypes.c_int64, ctypes.c_int32, pu32, p64,
            p64, pu8, p64, pu8,
        ]
        l.stbr_free_graph.restype = None
        l.stbr_free_graph.argtypes = [ctypes.POINTER(_StbrGraph)]
        pf = ctypes.POINTER(ctypes.c_double)
        l.stbr_lookup_rows.restype = ctypes.c_int64
        l.stbr_lookup_rows.argtypes = [
            ctypes.c_int64, ctypes.c_int32, pu32, ctypes.c_int64, pu32, p64,
        ]
        l.stbr_bulge_pass.restype = ctypes.c_int64
        l.stbr_bulge_pass.argtypes = [
            ctypes.c_int64, ctypes.c_int64, p64, p64, p64, p64, pf, pf, pu8, p64,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ]
        l.stbr_simplify.restype = ctypes.POINTER(_StbrSimpOut)
        l.stbr_simplify.argtypes = [
            ctypes.c_int64, ctypes.c_int64, p64, p64, p64, p64, pf, p64,
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int32, ctypes.c_int64, ctypes.c_double,
            ctypes.c_double, ctypes.c_double,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_double,
            ctypes.c_int32, ctypes.c_int32,
            pu8, p64, ctypes.c_int32, ctypes.c_int32,
        ]
        l.stbr_free_simp.restype = None
        l.stbr_free_simp.argtypes = [ctypes.POINTER(_StbrSimpOut)]
        _lib = l
    except (OSError, AttributeError) as e:
        log.debug("native load failed: %s", e)
    return _lib


def _arr(ptr, shape, dtype):
    return np.ctypeslib.as_array(ptr, shape=shape).copy().astype(dtype, copy=False)


def build_ext_native(p1_words: np.ndarray, k: int):
    """Extension-index build with inverse indices (native).

    p1_words: (P, W1) uint32 unique canonical (k+1)-mers.  Returns
    (kmers (U, W), in_mask, out_mask, pref_idx, pref_rc, suf_idx, suf_rc)
    or None when the native library is unavailable.  Mirror of
    `BuildExtensionIndexFromKPOMers`
    (`src/common/kmer_index/extension_index/
    kmer_extension_index_builder.hpp:83-108` in SPAdes)."""
    l = lib()
    if l is None:
        return None
    p1_words = np.ascontiguousarray(p1_words, np.uint32)
    P, W1 = p1_words.shape
    ep = l.stbr_build_ext(
        np.int64(P), np.int32(W1), np.int32(k),
        p1_words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    if not ep:
        return None
    try:
        e = ep.contents
        U = int(e.U)
        W = (k + 15) // 16
        if U == 0:
            z = np.zeros(0, np.int64)
            zb = np.zeros(0, np.uint8)
            return (np.zeros((0, W), np.uint32), zb.copy(), zb.copy(),
                    z.copy(), zb.copy(), z.copy(), zb.copy())
        kmers = _arr(e.kmers, (U, W), np.uint32)
        in_mask = _arr(e.in_mask, (U,), np.uint8)
        out_mask = _arr(e.out_mask, (U,), np.uint8)
        if P:
            pref_idx = _arr(e.pref_idx, (P,), np.int64)
            suf_idx = _arr(e.suf_idx, (P,), np.int64)
            pref_rc = _arr(e.pref_rc, (P,), np.uint8)
            suf_rc = _arr(e.suf_rc, (P,), np.uint8)
        else:
            pref_idx = suf_idx = np.zeros(0, np.int64)
            pref_rc = suf_rc = np.zeros(0, np.uint8)
        return kmers, in_mask, out_mask, pref_idx, pref_rc, suf_idx, suf_rc
    finally:
        l.stbr_free_ext(ep)


def condense_native(
    kmers: np.ndarray,
    in_mask: np.ndarray,
    out_mask: np.ndarray,
    k: int,
    p1_words: np.ndarray,
    p1_counts: np.ndarray | None,
    pref_idx: np.ndarray,
    pref_rc: np.ndarray,
    suf_idx: np.ndarray,
    suf_rc: np.ndarray,
):
    """Condensation with zero lookups (native).

    Returns the CondensedGraph column tuple or None when unavailable /
    inconsistent.  Mirror of `UnbranchingPathExtractor` +
    `FastGraphFromSequencesConstructor`
    (`src/common/assembly_graph/construction/
    debruijn_graph_constructor.hpp:184-574` in SPAdes)."""
    l = lib()
    if l is None:
        return None
    kmers = np.ascontiguousarray(kmers, np.uint32)
    p1_words = np.ascontiguousarray(p1_words, np.uint32)
    U, W = kmers.shape
    P, W1 = p1_words.shape
    pu32 = ctypes.POINTER(ctypes.c_uint32)
    pu8 = ctypes.POINTER(ctypes.c_uint8)
    p64 = ctypes.POINTER(ctypes.c_int64)
    # keep every converted buffer referenced until the native call returns
    in_mask = np.ascontiguousarray(in_mask, np.uint8)
    out_mask = np.ascontiguousarray(out_mask, np.uint8)
    pref_idx = np.ascontiguousarray(pref_idx, np.int64)
    pref_rc = np.ascontiguousarray(pref_rc, np.uint8)
    suf_idx = np.ascontiguousarray(suf_idx, np.int64)
    suf_rc = np.ascontiguousarray(suf_rc, np.uint8)
    if p1_counts is not None:
        p1_counts = np.ascontiguousarray(p1_counts, np.int64)
        counts_ptr = p1_counts.ctypes.data_as(p64)
    else:
        counts_ptr = ctypes.cast(None, p64)
    gp = l.stbr_condense(
        np.int64(U), np.int32(W), np.int32(k),
        kmers.ctypes.data_as(pu32),
        in_mask.ctypes.data_as(pu8),
        out_mask.ctypes.data_as(pu8),
        np.int64(P), np.int32(W1),
        p1_words.ctypes.data_as(pu32),
        counts_ptr,
        pref_idx.ctypes.data_as(p64),
        pref_rc.ctypes.data_as(pu8),
        suf_idx.ctypes.data_as(p64),
        suf_rc.ctypes.data_as(pu8),
    )
    if not gp:
        return None
    try:
        g = gp.contents
        if g.error != 0:
            return None
        E, V, pool = int(g.E), int(g.V), int(g.pool)
        if E == 0:
            z = np.zeros(0, np.int64)
            return (z.copy(), z.copy(), z.copy(), z.copy(), z.copy(),
                    np.zeros(0, np.float64), np.zeros(0, np.uint8),
                    np.zeros(0, np.int64))
        return (
            _arr(g.e_start, (E,), np.int64),
            _arr(g.e_end, (E,), np.int64),
            _arr(g.e_conj, (E,), np.int64),
            _arr(g.e_off, (E,), np.int64),
            _arr(g.e_len, (E,), np.int64),
            _arr(g.e_cov, (E,), np.float64),
            _arr(g.seq_pool, (pool,), np.uint8) if pool else np.zeros(0, np.uint8),
            _arr(g.v_conj, (V,), np.int64) if V else np.zeros(0, np.int64),
        )
    finally:
        l.stbr_free_graph(gp)


def dsu_union_pairs_native(parent: np.ndarray, size: np.ndarray, a: np.ndarray,
                           b: np.ndarray) -> bool:
    """`union(a[i], b[i])` in order, path halving and union by size, on the
    int64 arrays `parent` and `size` in place (hammer/clustering.py's DSU).
    Returns False, touching nothing, when the native library is
    unavailable."""
    l = lib()
    if l is None:
        return False
    assert parent.dtype == size.dtype == np.int64 and parent.flags.c_contiguous \
        and size.flags.c_contiguous
    a = np.ascontiguousarray(a, dtype=np.int64)
    b = np.ascontiguousarray(b, dtype=np.int64)
    p64 = ctypes.POINTER(ctypes.c_int64)
    l.stbr_dsu_union_pairs(parent.ctypes.data_as(p64), size.ctypes.data_as(p64),
                           a.ctypes.data_as(p64), b.ctypes.data_as(p64), len(a))
    return True


def merge_runs_native(words: np.ndarray, counts: np.ndarray, run_off: np.ndarray):
    """K-way merge of sorted unique runs with count summation (loser tree).

    words: (total, W) uint32 concatenated run rows; counts: (total,) int64;
    run_off: (n_runs+1,) uint64 row offsets.  Each run must be sorted and
    unique.  Returns (merged_words, merged_counts) or None when the native
    library is unavailable.  Mirrors `MergeKMers`
    (`src/common/kmer_index/kmer_mph/kmer_index_builder.hpp:346` in SPAdes).
    """
    l = lib()
    if l is None:
        return None
    words = np.ascontiguousarray(words, dtype=np.uint32)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    run_off = np.ascontiguousarray(run_off, dtype=np.uint64)
    total, W = words.shape
    n_runs = len(run_off) - 1
    out_w = np.empty((total, W), np.uint32)
    out_c = np.empty(total, np.int64)
    n = l.stbr_merge_runs(
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        run_off.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        np.int32(n_runs),
        np.int32(W),
        out_w.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        out_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if n < 0:
        return None
    return out_w[:n].copy(), out_c[:n].copy()


def lookup_rows_native(haystack: np.ndarray, needles: np.ndarray):
    """Hash-table row lookup (native): position of each needle in haystack,
    -1 when absent.  Fast path of ops/count.py searchsorted_rows."""
    l = lib()
    if l is None:
        return None
    haystack = np.ascontiguousarray(haystack, np.uint32)
    needles = np.ascontiguousarray(needles, np.uint32)
    U, W = haystack.shape
    N = needles.shape[0]
    out = np.empty(N, np.int64)
    pu32 = ctypes.POINTER(ctypes.c_uint32)
    rc = l.stbr_lookup_rows(
        np.int64(U), np.int32(W),
        haystack.ctypes.data_as(pu32),
        np.int64(N), needles.ctypes.data_as(pu32),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        return None
    return out


def bulge_pass_native(
    e_start: np.ndarray,
    e_end: np.ndarray,
    e_conj: np.ndarray,
    lens: np.ndarray,
    avg_cov: np.ndarray,
    e_cov: np.ndarray,
    alive: np.ndarray,
    cand: np.ndarray,
    n_vertices: int,
    max_len: int,
    max_delta: float,
    max_rel_delta: float,
    max_rel_cov: float,
):
    """Sequential bounded-Dijkstra bulge removal (native).

    Mutates ``e_cov`` and ``alive`` in place; returns the number of oriented
    edges removed, or None when the native library is unavailable.  Mirror of
    BulgeRemover + bounded Dijkstra
    (`src/common/modules/simplification/bulge_remover.hpp:346`).
    """
    l = lib()
    if l is None:
        return None
    e_start = np.ascontiguousarray(e_start, np.int64)
    e_end = np.ascontiguousarray(e_end, np.int64)
    e_conj = np.ascontiguousarray(e_conj, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    avg_cov = np.ascontiguousarray(avg_cov, np.float64)
    cand = np.ascontiguousarray(cand, np.int64)
    # both are mutated in place through their pointers: no silent copy
    if e_cov.dtype != np.float64 or not e_cov.flags.c_contiguous:
        raise ValueError("e_cov must be a C-contiguous float64 array")
    if alive.dtype != np.uint8 or not alive.flags.c_contiguous:
        raise ValueError("alive must be a C-contiguous uint8 array")
    p64 = ctypes.POINTER(ctypes.c_int64)
    pf = ctypes.POINTER(ctypes.c_double)
    return int(
        l.stbr_bulge_pass(
            np.int64(len(e_start)),
            np.int64(n_vertices),
            e_start.ctypes.data_as(p64),
            e_end.ctypes.data_as(p64),
            e_conj.ctypes.data_as(p64),
            lens.ctypes.data_as(p64),
            avg_cov.ctypes.data_as(pf),
            e_cov.ctypes.data_as(pf),
            alive.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            cand.ctypes.data_as(p64),
            np.int64(len(cand)),
            np.int64(max_len),
            np.float64(max_delta),
            np.float64(max_rel_delta),
            np.float64(max_rel_cov),
        )
    )


def simplify_native(
    a_start: np.ndarray,
    a_end: np.ndarray,
    a_conj: np.ndarray,
    a_klen: np.ndarray,
    a_cov: np.ndarray,
    v_conj: np.ndarray,
    *,
    cycle_iter_count: int,
    tip_len_1: int,
    tip_len_2: int,
    tip_cb1: float,
    auto_cb: float,
    rctc: float,
    br_enabled: bool,
    br_max_len: int,
    max_delta: float,
    max_rel_delta: float,
    max_rel_cov: float,
    ec_len: int,
    rel_cov_enabled: bool,
    rel_cov_ratio: float,
    record_glue: bool,
    retrigger: bool = True,
    arc_seq_pool: np.ndarray | None = None,
    arc_seq_off: np.ndarray | None = None,
    k: int = 0,
):
    """Full simplification schedule on the chain-merging engine (native).

    Inputs describe the alive oriented edges ("arcs"); returns a dict with
    the final chain decomposition (chain_off/chain_arcs over arc indices),
    per-edge columns, bulge glue records, and pass statistics — or None when
    the native library is unavailable.  Mirror of SPAdes' schedule
    (`src/common/stages/simplification.cpp:405-429`) run as
    native code like `modules/simplification/parallel_simplification_algorithms.hpp`.
    """
    l = lib()
    if l is None:
        return None
    a_start = np.ascontiguousarray(a_start, np.int64)
    a_end = np.ascontiguousarray(a_end, np.int64)
    a_conj = np.ascontiguousarray(a_conj, np.int64)
    a_klen = np.ascontiguousarray(a_klen, np.int64)
    a_cov = np.ascontiguousarray(a_cov, np.float64)
    v_conj = np.ascontiguousarray(v_conj, np.int64)
    A = len(a_start)
    V = len(v_conj)
    p64 = ctypes.POINTER(ctypes.c_int64)
    pf = ctypes.POINTER(ctypes.c_double)
    pu8 = ctypes.POINTER(ctypes.c_uint8)
    want_seq = arc_seq_pool is not None and arc_seq_off is not None
    if want_seq:
        arc_seq_pool = np.ascontiguousarray(arc_seq_pool, np.uint8)
        arc_seq_off = np.ascontiguousarray(arc_seq_off, np.int64)
    op = l.stbr_simplify(
        np.int64(A), np.int64(V),
        a_start.ctypes.data_as(p64), a_end.ctypes.data_as(p64),
        a_conj.ctypes.data_as(p64), a_klen.ctypes.data_as(p64),
        a_cov.ctypes.data_as(pf), v_conj.ctypes.data_as(p64),
        np.int32(cycle_iter_count), np.int64(tip_len_1), np.int64(tip_len_2),
        np.float64(tip_cb1), np.float64(auto_cb), np.float64(rctc),
        np.int32(br_enabled), np.int64(br_max_len), np.float64(max_delta),
        np.float64(max_rel_delta), np.float64(max_rel_cov),
        np.int64(ec_len), np.int32(rel_cov_enabled), np.float64(rel_cov_ratio),
        np.int32(record_glue), np.int32(retrigger),
        arc_seq_pool.ctypes.data_as(pu8) if want_seq else ctypes.cast(None, pu8),
        arc_seq_off.ctypes.data_as(p64) if want_seq else ctypes.cast(None, p64),
        np.int32(k), np.int32(want_seq),
    )
    if not op:
        return None
    try:
        o = op.contents
        if o.error != 0:
            return None
        E = int(o.n_edges)
        T = int(o.n_arcs_total)
        G = int(o.n_glues)
        z = np.zeros(0, np.int64)
        return {
            "chain_off": _arr(o.chain_off, (E + 1,), np.int64),
            "chain_arcs": _arr(o.chain_arcs, (T,), np.int64) if T else z.copy(),
            "e_start": _arr(o.e_start, (E,), np.int64) if E else z.copy(),
            "e_end": _arr(o.e_end, (E,), np.int64) if E else z.copy(),
            "e_conj": _arr(o.e_conj, (E,), np.int64) if E else z.copy(),
            "e_klen": _arr(o.e_klen, (E,), np.int64) if E else z.copy(),
            "e_cov": _arr(o.e_cov, (E,), np.float64) if E else np.zeros(0),
            "e_off": (
                _arr(o.e_off, (E,), np.int64)
                if want_seq and E
                else np.zeros(0, np.int64)
            ) if want_seq else None,
            "seq_pool": (
                _arr(o.seq_pool, (int(o.pool_size),), np.uint8)
                if want_seq and o.pool_size
                else np.zeros(0, np.uint8)
            ) if want_seq else None,
            "glue_arm_off": _arr(o.glue_arm_off, (G + 1,), np.int64),
            "glue_arm_arcs": (
                _arr(o.glue_arm_arcs, (int(o.glue_arm_off[G]),), np.int64)
                if G and o.glue_arm_off[G] else z.copy()
            ),
            "glue_keep_off": _arr(o.glue_keep_off, (G + 1,), np.int64),
            "glue_keep_arcs": (
                _arr(o.glue_keep_arcs, (int(o.glue_keep_off[G]),), np.int64)
                if G and o.glue_keep_off[G] else z.copy()
            ),
            "tips": int(o.tips),
            "bulges": int(o.bulges),
            "ec": int(o.ec),
            "isolated": int(o.isolated),
            "iterations": int(o.iterations),
        }
    finally:
        l.stbr_free_simp(op)


def read_fastx_native(path: str):
    """Parse FASTA/FASTQ(.gz) natively.

    Returns (names: list[str], seq_pool: np.uint8 array, offsets: np.uint64
    array of n+1 entries) or None if the native library is unavailable or
    parsing failed."""
    l = lib()
    if l is None:
        return None
    rp = l.stbr_read_fastx(os.fsencode(path))
    if not rp:
        return None
    r = rp.contents
    try:
        if r.error != 0:
            return None
        n = int(r.n_reads)
        if n == 0:
            return [], np.zeros(0, np.uint8), np.zeros(1, np.uint64)
        soff = np.ctypeslib.as_array(r.seq_off, shape=(n + 1,)).copy()
        noff = np.ctypeslib.as_array(r.name_off, shape=(n + 1,)).copy()
        total = int(soff[-1])
        seq = (
            np.ctypeslib.as_array(r.seq, shape=(total,)).copy()
            if total
            else np.zeros(0, np.uint8)
        )
        ntotal = int(noff[-1])
        names_buf = (
            np.ctypeslib.as_array(r.names, shape=(ntotal,)).copy().tobytes()
            if ntotal
            else b""
        )
        names = [
            names_buf[noff[i] : noff[i + 1]].decode("ascii", "replace")
            for i in range(n)
        ]
        return names, seq, soff
    finally:
        l.stbr_free_reads(rp)
