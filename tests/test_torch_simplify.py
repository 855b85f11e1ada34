"""Port parity for the simplification slice: `graph/{compress,coverage_model,
dijkstra,flanking,simplify,simplify_complex}.py` and the native engines'
wrappers.

The same numpy inputs (made from a seed) go through `spades_tpu` and
`spades_tpu_torch`; every result must be exactly equal (tolerance 0): the
port's modules are the same numpy and the same C++, so floats agree to the
bit.  The native simplification engine and the numpy loop need not give the
same graph, so `simplify` is held per engine: once with each package's native
library, once with the native engine refused in both.
"""
import copy
import dataclasses

import numpy as np
import pytest

from spades_tpu import native as j_native
from spades_tpu.alignment.kmer_mapper import KmerMapper as JKmerMapper
from spades_tpu.graph import compress as j_compress
from spades_tpu.graph import coverage_model as j_cov
from spades_tpu.graph import dijkstra as j_dijkstra
from spades_tpu.graph import flanking as j_flanking
from spades_tpu.graph import simplify as j_simplify
from spades_tpu.graph import simplify_complex as j_complex
from spades_tpu.graph.graph import CondensedGraph as JGraph
from spades_tpu.graph.synthetic import synthetic_tangled_graph
from spades_tpu_torch import convert
from spades_tpu_torch import native as t_native
from spades_tpu_torch.alignment.kmer_mapper import KmerMapper as TKmerMapper
from spades_tpu_torch.graph import compress as t_compress
from spades_tpu_torch.graph import coverage_model as t_cov
from spades_tpu_torch.graph import dijkstra as t_dijkstra
from spades_tpu_torch.graph import flanking as t_flanking
from spades_tpu_torch.graph import simplify as t_simplify
from spades_tpu_torch.graph import simplify_complex as t_complex
from spades_tpu_torch.pipeline.construction import construct_graph as t_construct
from spades_tpu_torch.tools import synthetic

K = 21
ACGT = np.frombuffer(b"ACGT", np.uint8)
GRAPH_FIELDS = ("e_start", "e_end", "e_conj", "e_off", "e_len", "e_cov", "alive",
                "seq_pool", "v_conj")


def both(g):
    """Independent copies of one graph state, one per package."""
    d = dataclasses.asdict(g)          # deep-copies the arrays
    return JGraph(**copy.deepcopy(d)), convert.graph_from_arrays(d)


def assert_same_graph(jg, tg, spelled=True):
    """spelled=False for hand-built graphs whose random edge sequences do not
    overlap at the vertices: their merged sequences mean nothing."""
    assert jg.k == tg.k
    for f in GRAPH_FIELDS:
        a, b = getattr(jg, f), getattr(tg, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    if spelled:
        tg.check_invariants()


def mapper_rows(m):
    m._materialize()
    if m._sorted_src is None:
        return np.zeros((0, 1), np.uint32), np.zeros((0, 1), np.uint32)
    return m._sorted_src, m._sorted_dst


@pytest.fixture(scope="module")
def raw():
    """The raw k=21 graph of a small isolate with 1 % read errors (tips,
    bulges and chimeric low-coverage edges), built by the port, and its
    (k+1)-mer table."""
    _genome, r1, r2 = synthetic.make_e2e_dataset(12_000, 30, 100, 0.01, seed=11,
                                                 insert_mean=250, insert_sd=20)
    reads = [ACGT[r].tobytes().decode() for r in np.concatenate([r1, r2])]
    res = t_construct(reads, K, device="cpu")
    assert res.graph.num_edges > 2000
    return res.graph, res.p1_counts


@pytest.fixture(scope="module")
def info(raw):
    return t_cov.fit_coverage_model(raw[1].counts)


def test_compress_matches(raw):
    g = raw[0]
    low = g.alive_edge_ids()[g.coverage()[g.alive_edge_ids()] < 3.0]
    jg, tg = both(g)
    assert jg.kill_edges(low) == tg.kill_edges(low) > 100
    jc, tc = j_compress.compress(jg), t_compress.compress(tg)
    assert tc.num_edges < g.num_edges
    assert_same_graph(jc, tc)


def _hist_counts(hist):
    return np.repeat(np.arange(len(hist)), hist)


def _converged_hist():
    rng = np.random.default_rng(3)
    good = rng.poisson(40, 60_000)
    err = np.minimum(rng.zipf(2.2, 40_000), 12)
    return np.bincount(np.concatenate([good, err]), minlength=120)


def _uneven_hist():
    rng = np.random.default_rng(4)
    mix = np.concatenate([rng.poisson(12, 30_000), rng.poisson(90, 20_000),
                          np.minimum(rng.zipf(2.0, 25_000), 8)])
    return np.bincount(mix)


@pytest.mark.parametrize("name, hist, converged", [
    ("converged", _converged_hist(), True),
    ("valley_fallback", np.array([0, 50, 20, 5, 2, 8, 30, 12, 3]), False),
    ("uneven", _uneven_hist(), None),
])
def test_fit_coverage_model_matches(name, hist, converged):
    counts = _hist_counts(hist)
    ref = j_cov.fit_coverage_model(counts)
    got = t_cov.fit_coverage_model(counts)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert convert.genomic_info_from_dict(dataclasses.asdict(ref)) == got
    if converged is not None:
        assert got.converged is converged


@pytest.mark.parametrize("name, hist", [
    ("converged", _converged_hist()), ("uneven", _uneven_hist())])
def test_em_objective_equals_the_plain_loglike(name, hist):
    """The M-step's objective, bit for bit, at the points a fit visits and at
    corners that are out of support, overflow or make the weights NaN; over
    every bin, and with empty bins left out."""
    from scipy.special import erf

    rng = np.random.default_rng(7)
    cov = np.asarray(hist[1:], np.float64)
    z = rng.random(len(cov))
    holed = cov.copy()
    holed[rng.random(len(cov)) < 0.2] = 0.0
    xs = [np.array([3.0, 3.0, 40.0, 9.0, 1.0, 0.0]), np.array([3.0, 1.5, 40.0, 15.0, 2.0, -7.7]),
          np.array([1.5, 0.2, 1e307, 1e-305, 1e-300, 4.0]), np.array([0.5, 3.0, 40.0, 9.0, 1.0, 0.0]),
          np.array([3.0, 3.0, np.inf, 9.0, 1.0, 0.0]), np.array([400.0, 1e-9, 3.0, 2.0, 1e-9, 0.0])]
    for _ in range(400):
        x = np.array([rng.uniform(0.8, 6), rng.uniform(-0.2, 5), rng.uniform(-1, 150),
                      rng.uniform(-1, 30), rng.uniform(-0.2, 5), rng.uniform(-12, 12)])
        if rng.random() < 0.2:
            x[rng.integers(6)] *= 10.0 ** rng.integers(-300, 300)
        xs.append(x)
    for c in (cov, holed):
        objective = t_cov._em_objective(c, z)
        with np.errstate(all="ignore"):
            got = np.array([objective(x) for x in xs])
            ref = np.array([-j_cov._em_loglike(x, c, z) for x in xs])
        assert np.array_equal(got, ref, equal_nan=True)
    # the premise of computing erf only below |a| = 6
    a = np.concatenate([np.linspace(6.0, 40.0, 5000), np.geomspace(40.0, 1e308, 200), [np.inf]])
    assert (erf(a) == 1.0).all() and (erf(-a) == -1.0).all()


def test_fit_on_the_raw_graph_and_uneven_threshold(raw, info):
    g, p1 = raw
    assert dataclasses.asdict(info) == dataclasses.asdict(
        j_cov.fit_coverage_model(p1.counts))
    jg, tg = both(g)
    assert t_cov.find_uneven_threshold(tg) == j_cov.find_uneven_threshold(jg)


@pytest.mark.parametrize("direction, length, max_vertices", [
    ("fwd", "kmer", None), ("bwd", "nt", None), ("fwd", "unit", 5),
])
def test_bounded_dijkstra_matches(raw, direction, length, max_vertices):
    jg, tg = both(raw[0])
    rng = np.random.default_rng(7)
    sources = rng.choice(tg.num_vertices, 40, replace=False)
    mask = rng.random(len(tg.alive)) < 0.9
    bound = 12 if length == "unit" else 400
    ref = j_dijkstra.bounded_dijkstra(jg, sources, bound, direction, length, mask,
                                      max_vertices)
    got = t_dijkstra.bounded_dijkstra(tg, sources, bound, direction, length, mask,
                                      max_vertices)
    assert len(got.rows) > len(sources)
    for f in ("rows", "vertices", "dists", "parent_edge", "truncated"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f


def test_shortest_path_matches(raw):
    jg, tg = both(raw[0])
    ids = tg.alive_edge_ids()
    rng = np.random.default_rng(8)
    found = 0
    for e in rng.choice(ids, 60, replace=False):
        v0 = int(tg.e_start[e])
        reach = t_dijkstra.reached_vertices(tg, v0, 300)
        assert reach == j_dijkstra.reached_vertices(jg, v0, 300)
        for v1 in list(reach)[:4]:
            ref = j_dijkstra.shortest_path(jg, v0, v1, 300, skip_edges=(int(e),))
            got = t_dijkstra.shortest_path(tg, v0, v1, 300, skip_edges=(int(e),))
            assert got == ref
            found += got is not None
    assert found > 20


def test_build_flanking_matches(raw):
    g, p1 = raw
    jg, tg = both(g)
    ref = j_flanking.build_flanking(jg, p1.words, p1.counts)
    got = t_flanking.build_flanking(tg, p1.words, p1.counts)
    assert got.averaging_range == ref.averaging_range
    assert got.raw.dtype == ref.raw.dtype and np.array_equal(got.raw, ref.raw)
    assert (got.raw > 0).sum() > 1000
    ids = tg.alive_edge_ids()[:50]
    assert np.array_equal(got.cov_of_end(tg, ids), ref.cov_of_end(jg, ids))


def _flank(mod, g, p1):
    return mod.build_flanking(g, p1.words, p1.counts)


PASSES = {
    "clip_tips": lambda S, F, g, p1, cfg: S.clip_tips(g, 60, cov_bound=1e6, rctc=2.0),
    "remove_bulges": lambda S, F, g, p1, cfg: S.remove_bulges(g, cfg),
    "remove_bulges_dijkstra": lambda S, F, g, p1, cfg: S.remove_bulges_dijkstra(g, cfg),
    "remove_low_cov_ec": lambda S, F, g, p1, cfg: S.remove_low_cov_ec(g, 31, 4.0),
    "disconnect_relative_coverage":
        lambda S, F, g, p1, cfg: S.disconnect_relative_coverage(
            g, 3.0, 155, flanking=_flank(F, g, p1)),
    "disconnect_relative_coverage_whole_edge":
        lambda S, F, g, p1, cfg: S.disconnect_relative_coverage(g, 3.0, 155),
    "remove_isolated": lambda S, F, g, p1, cfg: S.remove_isolated(g, 150),
}


@pytest.mark.parametrize("name", list(PASSES))
def test_single_pass_matches(raw, name):
    """Each pass of the numpy schedule alone, on the raw graph with its
    tips clipped and compressed first (so that bulges are parallel edges)."""
    g0, p1 = raw
    jg, tg = both(g0)
    if name not in ("clip_tips", "remove_low_cov_ec"):
        for _ in range(2):
            assert j_simplify.clip_tips(jg, 60) == t_simplify.clip_tips(tg, 60)
            jg, tg = j_compress.compress(jg), t_compress.compress(tg)
    if name == "remove_isolated":
        # cut low-coverage edges loose so that short isolated edges exist
        j_simplify.remove_low_cov_ec(jg, 31, 6.0)
        t_simplify.remove_low_cov_ec(tg, 31, 6.0)
        jg, tg = j_compress.compress(jg), t_compress.compress(tg)
    ref = PASSES[name](j_simplify, j_flanking, jg, p1, j_simplify.SimplifyConfig())
    got = PASSES[name](t_simplify, t_flanking, tg, p1, t_simplify.SimplifyConfig())
    assert got == ref
    assert got > 0, f"{name} removed nothing: the fixture does not exercise it"
    assert_same_graph(jg, tg)


def test_remove_bulges_records_the_same_glue(raw):
    jg, tg = both(raw[0])
    for _ in range(2):
        j_simplify.clip_tips(jg, 60), t_simplify.clip_tips(tg, 60)
        jg, tg = j_compress.compress(jg), t_compress.compress(tg)
    jm, tm = JKmerMapper(k=K), TKmerMapper(k=K)
    assert (j_simplify.remove_bulges(jg, j_simplify.SimplifyConfig(), jm)
            == t_simplify.remove_bulges(tg, t_simplify.SimplifyConfig(), tm))
    assert tm.size == jm.size > 0
    for a, b in zip(mapper_rows(jm), mapper_rows(tm)):
        assert np.array_equal(a, b)


CONFIGS = {
    "full": dict(read_length=100),
    "raw": dict(read_length=100, cycle_iter_count=2, br_enabled=False,
                rel_cov_enabled=False, ier_enabled=False),
    "rel_cov": dict(read_length=100, rel_cov_enabled=True, rel_cov_ratio=3.0),
    "complex": dict(read_length=100, cbr_enabled=True, complex_tc_enabled=True,
                    mfec_enabled=True),
}


@pytest.mark.parametrize("engine", ["native", "refused"])
@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_simplify_matches(raw, info, monkeypatch, engine, cfg_name):
    """The whole schedule, per engine, with a KmerMapper recording the glue.
    `rel_cov` with a flanking callable takes the numpy loop in either case."""
    g0, p1 = raw
    if engine == "native":
        assert j_native.lib() is not None and t_native.lib() is not None
    else:
        monkeypatch.setattr(j_simplify, "_simplify_loop_native", lambda *a, **k: None)
        monkeypatch.setattr(t_simplify, "_simplify_loop_native", lambda *a, **k: None)
    jg, tg = both(g0)
    jcfg = j_simplify.SimplifyConfig(**CONFIGS[cfg_name])
    tcfg = convert.simplify_config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jinfo = j_cov.GenomicInfo(**dataclasses.asdict(info))
    jm, tm = JKmerMapper(k=K), TKmerMapper(k=K)
    jfl = tfl = None
    if cfg_name == "rel_cov":
        jfl = lambda g: j_flanking.build_flanking(g, p1.words, p1.counts)
        tfl = lambda g: t_flanking.build_flanking(g, p1.words, p1.counts)
    jout, jstats = j_simplify.simplify(jg, jinfo, jcfg, kmer_mapper=jm, flanking=jfl)
    tout, tstats = t_simplify.simplify(tg, info, tcfg, kmer_mapper=tm, flanking=tfl)
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    assert tstats.tips > 0 and tstats.ec > 0
    if cfg_name != "raw":
        assert tstats.bulges > 0
    assert tout.num_edges < g0.num_edges // 4
    assert_same_graph(jout, tout)
    jm.normalize(), tm.normalize()
    for a, b in zip(mapper_rows(jm), mapper_rows(tm)):
        assert np.array_equal(a, b)


def _plain_flank_sums(g, p1, averaging_range=50):
    """Each alive edge's raw flank sum by a loop: its first min(len, range)
    (k+1)-mers, each canonicalised and looked up in a dict of the table."""
    k1 = g.k + 1
    cols = [(p1.words[:, j // 16] >> np.uint32(30 - 2 * (j % 16))) & 3 for j in range(k1)]
    codes = np.stack(cols, axis=1).astype(np.uint8)
    table = dict(zip(map(bytes, codes), p1.counts.tolist()))
    raw = np.zeros(g.alive.shape[0])
    for e in np.flatnonzero(g.alive):
        seq = g.seq_pool[g.e_off[e]: g.e_off[e] + g.e_len[e]]
        for i in range(min(int(g.e_len[e]) - g.k, averaging_range)):
            fwd = seq[i: i + k1]
            rc = (3 - fwd)[::-1]
            raw[e] += table.get(min(bytes(fwd), bytes(rc)), 0)
    return raw


@pytest.mark.parametrize("path", ["host", "torch_cpu"])
def test_kept_flanking_equals_a_fresh_build(raw, info, monkeypatch, path):
    """A meta schedule on the numpy loop with a `FlankingTable`: after every
    compress the sums it carries equal a fresh `build_flanking`'s, each
    refresh equals a fresh build and a plain loop over the windows, later
    refreshes recompute few edges, and the schedule's graph, stats and
    KmerMapper rows equal the JAX package's numpy loop with a full rebuild."""
    import torch

    from spades_tpu_torch.utils import timetracer

    g0, p1 = raw
    device = None if path == "host" else torch.device("cpu")
    table = t_flanking.FlankingTable(p1.words, p1.counts, device=device)
    seen = {"compress": 0, "refresh": 0}
    inner_compress, inner_refresh = t_simplify._compress, table.refresh

    def compress(g, tab=None):
        gn = inner_compress(g, tab)
        if tab is not None and tab._raw is not None:
            # (before the first refresh the table holds nothing to carry)
            seen["compress"] += 1
            fresh = t_flanking.build_flanking(gn, p1.words, p1.counts).raw
            known = ~np.isnan(tab._raw)
            assert tab._graph is gn and known.sum() > 0
            assert np.array_equal(tab._raw[known], fresh[known])
        return gn

    def refresh(g):
        fl = inner_refresh(g)
        seen["refresh"] += 1
        assert np.array_equal(fl.raw, t_flanking.build_flanking(g, p1.words, p1.counts).raw)
        assert np.array_equal(fl.raw, _plain_flank_sums(g, p1))
        return fl

    monkeypatch.setattr(t_simplify, "_compress", compress)
    monkeypatch.setattr(table, "refresh", refresh)
    jg, tg = both(g0)
    jcfg = j_simplify.SimplifyConfig(**CONFIGS["rel_cov"])
    tcfg = convert.simplify_config_from_dict(dataclasses.asdict(jcfg))
    jinfo = j_cov.GenomicInfo(**dataclasses.asdict(info))
    jm, tm = JKmerMapper(k=K), TKmerMapper(k=K)
    jfl = lambda g: j_flanking.build_flanking(g, p1.words, p1.counts)
    timetracer.enable()
    try:
        tout, tstats = t_simplify.simplify(tg, info, tcfg, kmer_mapper=tm, flanking=table)
        events = timetracer.events()
    finally:
        timetracer.disable()
    jout, jstats = j_simplify.simplify(jg, jinfo, jcfg, kmer_mapper=jm, flanking=jfl)
    assert seen["compress"] >= 2 and seen["refresh"] == tstats.iterations >= 2
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    assert_same_graph(jout, tout)
    jm.normalize(), tm.normalize()
    for a, b in zip(mapper_rows(jm), mapper_rows(tm)):
        assert np.array_equal(a, b)
    flank = [e["args"] for e in events if e["args"]["detail"] == "simplification.flanking"]
    assert len(flank) == seen["refresh"]
    assert all(a["path"] == ("host" if device is None else "device") for a in flank)
    assert flank[0]["recomputed"] == flank[0]["edges"] > 0 and flank[0]["windows"] > 0
    assert all(a["recomputed"] < a["edges"] for a in flank[1:])
    names = {e["args"]["detail"] for e in events}
    assert {"simplification.loop", "simplification.compress", "simplification.tail"} <= names
    [loop] = [e["args"] for e in events if e["args"]["detail"] == "simplification.loop"]
    assert loop["engine"] == "numpy" and loop["iterations"] == tstats.iterations


def test_flanking_table_on_torch_equals_the_host(raw):
    """The table's torch path (the canonical-windows kernel's plain version
    and `device_searchsorted_rows` under CPU torch) against its host path on
    the raw graph, in slices smaller than the graph."""
    import torch

    g, p1 = raw
    host = t_flanking.FlankingTable(p1.words, p1.counts).refresh(g)
    dev = t_flanking.FlankingTable(p1.words, p1.counts, device=torch.device("cpu"))
    ids = g.alive_edge_ids()
    sums = dev._device_sums(g, ids[:5])
    assert np.array_equal(sums, host.raw[ids[:5]])
    old = t_flanking.DEVICE_EDGES
    try:
        t_flanking.DEVICE_EDGES = 777
        got = dev.refresh(g)
    finally:
        t_flanking.DEVICE_EDGES = old
    assert np.array_equal(got.raw, host.raw) and (host.raw > 0).sum() > 1000


def test_simplify_native_on_a_tangled_graph():
    """The native engine on the JAX package's synthetic tangle (sequence-free
    arcs), retrigger on and off."""
    g0 = synthetic_tangled_graph(20_000, k=21, seed=1)
    jinfo = j_cov.GenomicInfo(ec_bound=5.0, trusted_bound=10.0, estimated_mean=30.0,
                              genome_size=10**6)
    tinfo = convert.genomic_info_from_dict(dataclasses.asdict(jinfo))
    for retrigger in (True, False):
        jg, tg = both(g0)
        jout, js = j_simplify.simplify(jg, jinfo, j_simplify.SimplifyConfig(retrigger=retrigger))
        tout, ts = t_simplify.simplify(tg, tinfo, t_simplify.SimplifyConfig(retrigger=retrigger))
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
        for f in GRAPH_FIELDS:
            assert np.array_equal(getattr(jout, f), getattr(tout, f)), f


# -- simplify_complex: the four entry points on hand-built graphs -------------

def _empty(cls, k):
    z = lambda dt: np.zeros(0, dt)
    return cls(k=k, e_start=z(np.int64), e_end=z(np.int64), e_conj=z(np.int64),
               e_off=z(np.int64), e_len=z(np.int64), e_cov=z(np.float64),
               alive=z(bool), seq_pool=z(np.uint8), v_conj=z(np.int64))


def _hand_graph(edges, n_vertices, k=5, seed=0):
    """A graph of conjugate vertex pairs 0..n-1 and (from, to, length, cov)
    edges with random sequences."""
    rng = np.random.default_rng(seed)
    g = _empty(JGraph, k)
    vs = []
    for _ in range(n_vertices):
        v = len(g.v_conj)
        g.v_conj = np.append(g.v_conj, [v + 1, v])
        vs.append(v)
    for a, b, n, cov in edges:
        g.add_edge_pair(vs[a], vs[b], rng.integers(0, 4, n).astype(np.uint8), cov_sum=cov)
    return g


def _dominated_bulge_graph():
    rng = np.random.default_rng(2)
    rnd = lambda n: ACGT[rng.integers(0, 4, n)].tobytes().decode()
    P, Q, T = rnd(300), rnd(300), rnd(400)
    A, B, C = rnd(80), rnd(90), rnd(170)
    seqs = [P + A + B + Q] * 3 + [P + C + Q] + [P + A + T] * 2
    return t_construct(seqs, 21, device="cpu").graph


COMPLEX = {
    "collapse_superbubbles": (
        lambda: _hand_graph([(0, 1, 20, 100.0), (0, 2, 22, 10.0), (1, 3, 20, 100.0),
                             (2, 3, 18, 10.0)], 4),
        lambda M, g: M.collapse_superbubbles(g, max_length=200)),
    "clip_complex_tips": (
        lambda: _hand_graph([(0, 1, 60, 2000.0), (1, 2, 60, 2000.0), (1, 3, 15, 5.0),
                             (3, 4, 15, 5.0)], 5),
        lambda M, g: M.clip_complex_tips(g, relative_coverage=2.0, max_edge_len=20,
                                         max_path_len=50)),
    "max_flow_ec_remover": (
        lambda: _hand_graph([(0, 1, 3000, 100.0), (1, 2, 500, 100.0), (1, 2, 30, 3.0),
                             (2, 3, 3000, 100.0)], 4),
        lambda M, g: M.max_flow_ec_remover(g, max_length=100, uniqueness_length=1500,
                                           plausibility_length=200)),
    "remove_complex_bulges": (
        _dominated_bulge_graph,
        lambda M, g: M.remove_complex_bulges(g, max_length=205, length_diff=5)),
}


@pytest.mark.parametrize("name", list(COMPLEX))
def test_simplify_complex_matches(name):
    make, run = COMPLEX[name]
    jg, tg = both(make())
    ref, got = run(j_complex, jg), run(t_complex, tg)
    assert got == ref > 0
    spelled = name == "remove_complex_bulges"
    assert_same_graph(jg, tg, spelled)
    jc, tc = j_compress.compress(jg), t_compress.compress(tg)
    assert_same_graph(jc, tc, spelled)


def test_find_superbubble_matches():
    jg, tg = both(COMPLEX["collapse_superbubbles"][0]())
    ref, got = j_complex.find_superbubble(jg, 0, max_length=200), \
        t_complex.find_superbubble(tg, 0, max_length=200)
    assert got is not None and dataclasses.asdict(got) == dataclasses.asdict(ref)


# -- the three native wrappers --------------------------------------------------

def test_lookup_rows_native_matches():
    rng = np.random.default_rng(5)
    hay = np.unique(rng.integers(0, 2**32, (4000, 2), dtype=np.uint64).astype(np.uint32),
                    axis=0)
    needles = np.concatenate([hay[::3], rng.integers(0, 2**32, (500, 2),
                                                     dtype=np.uint64).astype(np.uint32)])
    ref = j_native.lookup_rows_native(hay, needles)
    got = t_native.lookup_rows_native(hay, needles)
    assert got is not None and np.array_equal(got, ref)
    assert (got >= 0).sum() >= len(hay[::3]) and (got < 0).sum() > 400
    assert np.array_equal(hay[got[got >= 0]], needles[got >= 0])


def test_bulge_pass_native_matches(raw):
    jg, tg = both(raw[0])
    for _ in range(2):
        j_simplify.clip_tips(jg, 60), t_simplify.clip_tips(tg, 60)
        jg, tg = j_compress.compress(jg), t_compress.compress(tg)
    outs = []
    for mod, g in ((j_native, jg), (t_native, tg)):
        ids = g.alive_edge_ids()
        lens = g.edge_kmer_lengths()
        cov = g.coverage()
        cand = ids[lens[ids] <= 150]
        cand = cand[np.argsort(cov[cand], kind="stable")]
        e_cov = g.e_cov.copy()
        alive = g.alive.astype(np.uint8)
        n = mod.bulge_pass_native(g.e_start, g.e_end, g.e_conj, lens, cov, e_cov, alive,
                                  cand, g.num_vertices, 150, 3.0, 0.1, 1.1)
        outs.append((n, e_cov, alive))
    assert outs[0][0] == outs[1][0] > 0
    assert np.array_equal(outs[0][1], outs[1][1]) and np.array_equal(outs[0][2], outs[1][2])
    with pytest.raises(ValueError):
        t_native.bulge_pass_native(tg.e_start, tg.e_end, tg.e_conj, lens, cov, e_cov,
                                   tg.alive, cand, tg.num_vertices, 150, 3.0, 0.1, 1.1)


def test_simplify_native_matches(raw):
    g = raw[0]
    ids = g.alive_edge_ids()
    pos = np.full(len(g.alive), -1, np.int64)
    pos[ids] = np.arange(len(ids))
    seq_off = np.concatenate([[0], np.cumsum(g.e_len[ids])]).astype(np.int64)
    pool = np.concatenate([g.edge_codes(int(e)) for e in ids])
    kw = dict(cycle_iter_count=10, tip_len_1=73, tip_len_2=210, tip_cb1=1e6, auto_cb=4.0,
              rctc=2.0, br_enabled=True, br_max_len=163, max_delta=3.0, max_rel_delta=0.1,
              max_rel_cov=1.1, ec_len=31, rel_cov_enabled=False, rel_cov_ratio=5.0,
              record_glue=True, retrigger=True, arc_seq_pool=pool, arc_seq_off=seq_off, k=K)
    args = (g.e_start[ids], g.e_end[ids], pos[g.e_conj[ids]], g.edge_kmer_lengths()[ids],
            g.e_cov[ids], g.v_conj)
    ref = j_native.simplify_native(*args, **kw)
    got = t_native.simplify_native(*args, **kw)
    assert got is not None and got.keys() == ref.keys()
    assert got["tips"] > 0 and got["bulges"] > 0 and len(got["e_start"]) < len(ids) // 4
    for key, val in ref.items():
        if isinstance(val, np.ndarray):
            assert val.dtype == got[key].dtype and np.array_equal(val, got[key]), key
        else:
            assert val == got[key], key

