"""Port parity for pair info and distance estimation: `paired/paired_info.py`,
`paired/distance_estimation.py` and `paired/pair_info_improver.py`.

The same inputs, made from a seed with numpy, go through `spades_tpu` and
`spades_tpu_torch`; every index column must be equal with its dtype
(tolerance 0: both sides run the same numpy float64 arithmetic).  Graphs are
built by the JAX package and carried into the port with `convert.py`; reads
are mapped by each package's own mapper.  The fixtures are those of
the array tests of `tests/test_mapper_paired.py`,
`tests/test_distance_estimation.py` and `tests/test_pair_info_improver.py`.
"""
import dataclasses

import numpy as np
import pytest

from spades_tpu.alignment import mapper as j_mapper
from spades_tpu.core import dna as j_dna
from spades_tpu.graph.graph import CondensedGraph as JGraph
from spades_tpu.paired import distance_estimation as j_de
from spades_tpu.paired import pair_info_improver as j_imp
from spades_tpu.paired import paired_info as j_pi
from spades_tpu.pipeline.construction import construct_graph
from spades_tpu_torch import convert
from spades_tpu_torch.alignment import mapper as t_mapper
from spades_tpu_torch.paired import distance_estimation as t_de
from spades_tpu_torch.paired import pair_info_improver as t_imp
from spades_tpu_torch.paired import paired_info as t_pi
from tests.conftest import random_dna

COLUMNS = ("e1", "e2", "dist", "weight")


def to_port_graph(jg):
    return convert.graph_from_arrays(dataclasses.asdict(jg))


def to_port_index(pi):
    return convert.paired_index_from_arrays(dataclasses.asdict(pi))


def assert_same_index(j, t):
    for c in COLUMNS:
        a, b = getattr(j, c), getattr(t, c)
        assert a.dtype == b.dtype, c
        assert np.array_equal(a, b), c


def revcomp(s):
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


# -- insert size and the raw index from mapped pairs -----------------------------

def _mapped_pairs(seed):
    """The fixture of test_mapper_paired.py's array tests: 300 FR pairs
    (100 bp, insert 400) of a 3,000-nt genome, mapped by both packages onto
    its k=21 graph."""
    rng = np.random.default_rng(seed)
    genome = random_dna(rng, 3000)
    jg = construct_graph([genome], 21).graph
    tg = to_port_graph(jg)
    rl, isize = 100, 400
    r1s, r2s = [], []
    for _ in range(300):
        a = int(rng.integers(0, len(genome) - isize))
        r1s.append(genome[a : a + rl])
        r2s.append(revcomp(genome[a + isize - rl : a + isize]))
    jidx, tidx = j_mapper.build_edge_index(jg), t_mapper.build_edge_index(tg)
    jm = [j_mapper.map_read_batch(jidx, jg, r) for r in (r1s, r2s)]
    tm = [t_mapper.map_read_batch(tidx, tg, r, device="cpu") for r in (r1s, r2s)]
    for a, b in zip(jm, tm):
        assert [None if m is None else dataclasses.astuple(m) for m in a] == \
            [None if m is None else dataclasses.astuple(m) for m in b]
    return jg, tg, jm, tm, rl


def _arrays(ms):
    e = np.array([m.edge if m else -1 for m in ms], np.int64)
    s = np.array([m.start_offset if m else 0 for m in ms], np.int64)
    return e, s


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("form", ["list", "arrays"])
def test_insert_size_and_raw_index_match(seed, form):
    jg, tg, (jm1, jm2), (tm1, tm2), rl = _mapped_pairs(seed)
    if form == "list":
        js = j_pi.estimate_insert_size(jg, jm1, jm2, [rl] * len(jm1), [rl] * len(jm2))
        ts = t_pi.estimate_insert_size(tg, tm1, tm2, [rl] * len(tm1), [rl] * len(tm2))
        jr = j_pi.build_paired_index(jg, jm1, jm2, [rl] * len(jm2), js.median)
        tr = t_pi.build_paired_index(tg, tm1, tm2, [rl] * len(tm2), ts.median)
    else:
        (e1, s1), (e2, s2) = _arrays(jm1), _arrays(jm2)
        js = j_pi.estimate_insert_size_arrays(jg, e1, s1, e2, s2)
        ts = t_pi.estimate_insert_size_arrays(tg, e1, s1, e2, s2)
        jr = j_pi.build_paired_index_arrays(jg, e1, s1, e2, s2, js.median)
        tr = t_pi.build_paired_index_arrays(tg, e1, s1, e2, s2, ts.median)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert abs(ts.median - 400) < 10 and ts.count > 100
    assert_same_index(jr, tr)
    assert tr.e1.size > 0
    lo, hi = tr.e1.searchsorted(tr.e1[0], "left"), tr.e1.searchsorted(tr.e1[0], "right")
    for a, b in zip(tr.pairs_from(int(tr.e1[0])), jr.pairs_from(int(jr.e1[0]))):
        assert np.array_equal(a, b) and len(a) == hi - lo


def test_index_functions_with_nothing_mapped():
    jg = construct_graph([random_dna(np.random.default_rng(3), 500)], 21).graph
    tg = to_port_graph(jg)
    e = np.full(5, -1, np.int64)
    s = np.zeros(5, np.int64)
    assert dataclasses.asdict(t_pi.estimate_insert_size_arrays(tg, e, s, e, s)) == \
        dataclasses.asdict(j_pi.estimate_insert_size_arrays(jg, e, s, e, s))
    assert_same_index(j_pi.build_paired_index_arrays(jg, e, s, e, s, 300.0),
                      t_pi.build_paired_index_arrays(tg, e, s, e, s, 300.0))
    assert_same_index(j_pi.build_paired_index(jg, [None], [None], [100], 300.0),
                      t_pi.build_paired_index(tg, [None], [None], [100], 300.0))


# -- merging, clustering and the estimators ------------------------------------

def _random_raw(rng, n_pairs=40, n_edges=12, max_points=30, spread=60):
    """A raw index as `build_paired_index` leaves it: sorted (e1, e2, d)
    keys, int64 distances, float64 weights."""
    rows = {}
    for _ in range(n_pairs):
        e1, e2 = (int(x) for x in rng.integers(0, n_edges, 2))
        centre = int(rng.integers(-50, 3000))
        for d in centre + rng.integers(-spread, spread + 1, int(rng.integers(1, max_points))):
            rows[(e1, e2, int(d))] = rows.get((e1, e2, int(d)), 0.0) + float(rng.integers(1, 4))
    keys = sorted(rows)
    e1, e2, d = (np.array(c, np.int64) for c in zip(*keys))
    return j_pi.PairedIndex(e1, e2, d, np.array([rows[k] for k in keys], float))


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_paired_indices_matches(seed):
    rng = np.random.default_rng(seed)
    parts = [_random_raw(rng) for _ in range(3)]
    z = np.zeros(0)
    parts.append(j_pi.PairedIndex(z.astype(np.int64), z.astype(np.int64), z, z))
    for chosen in (parts, parts[:1], parts[3:], []):
        jm = j_pi.merge_paired_indices(chosen)
        tm = t_pi.merge_paired_indices([to_port_index(p) for p in chosen])
        assert_same_index(jm, tm)


@pytest.mark.parametrize("max_delta", [0, 10, 40])
def test_cluster_distances_matches(max_delta):
    raw = _random_raw(np.random.default_rng(4))
    assert_same_index(j_pi.cluster_distances(raw, max_delta),
                      t_pi.cluster_distances(to_port_index(raw), max_delta))


def _de_fixture_rows():
    """The histograms of tests/test_distance_estimation.py."""
    rng = np.random.default_rng(0)
    wide = np.clip(np.round(rng.normal(500, 20, 200)), 400, 600).astype(int)
    return [
        [(1, 2, 100, 3.0), (1, 2, 104, 1.0), (1, 2, 300, 4.0)],
        [(1, 2, 100, 0.5), (1, 2, 300, 5.0)],
        [(1, 2, 100, 50.0), (1, 2, 200, 2.5)],
        [(1, 2, 100, 10.0), (1, 2, 200, 9.0)],
        [(3, 4, int(d), 1.0) for d in wide],
        [(1, 2, d, 5.0) for d in (100, 101, 102, 400, 401, 402)],
    ]


def _pi_from_rows(rows):
    rows = sorted(rows)
    e1, e2, d, w = zip(*rows)
    pi = j_pi.PairedIndex(np.array(e1, np.int64), np.array(e2, np.int64),
                          np.array(d, float), np.array(w, float))
    return j_pi.merge_paired_indices([pi, pi])      # duplicates summed


@pytest.mark.parametrize("name", ["estimate_simple", "estimate_weighted",
                                  "estimate_smoothing"])
def test_estimators_match(name):
    rng = np.random.default_rng(7)
    inputs = [_pi_from_rows(r) for r in _de_fixture_rows()] + \
        [_random_raw(rng) for _ in range(3)]
    cfgs = [(None, None),
            (j_de.DEConfig(linkage_distance=3, min_peak_weight=1.0, smoothing_bandwidth=3),
             t_de.DEConfig(linkage_distance=3, min_peak_weight=1.0, smoothing_bandwidth=3))]
    assert dataclasses.asdict(t_de.DEConfig()) == dataclasses.asdict(j_de.DEConfig())
    n_out = 0
    for pi in inputs:
        for jc, tc in cfgs:
            jo = getattr(j_de, name)(pi, jc)
            to = getattr(t_de, name)(to_port_index(pi), tc)
            assert_same_index(jo, to)
            n_out += to.e1.size
    assert n_out > 0


@pytest.mark.parametrize("lib_type", ["paired-end", "mate-pairs", "hq-mate-pairs",
                                      "single"])
def test_estimate_distances_dispatch_matches(lib_type):
    raw = _random_raw(np.random.default_rng(9), spread=200)
    assert_same_index(j_de.estimate_distances(raw, lib_type),
                      t_de.estimate_distances(to_port_index(raw), lib_type))


# -- the pair-info improver ------------------------------------------------------

def _chain_graph(rng, seg_lens, k=5):
    """tests/test_pair_info_improver.py's chain: v0 -e0-> v1 -e1-> ..."""
    z = np.zeros(0, np.int64)
    g = JGraph(k=k, e_start=z, e_end=z, e_conj=z, e_off=z, e_len=z,
               e_cov=np.zeros(0), alive=np.zeros(0, bool),
               seq_pool=np.zeros(0, np.uint8), v_conj=z)
    vs = [g.add_vertex_pair()[0] for _ in range(len(seg_lens) + 1)]
    es = []
    for i, L in enumerate(seg_lens):
        e, _ = g.add_edge_pair(vs[i], vs[i + 1], j_dna.encode(random_dna(rng, L + k)),
                               50.0 * (L + 1))
        es.append(e)
    return g, es


def _symmetric(g, rows):
    e1, e2, d, w = map(np.array, zip(*rows))
    lens = g.edge_kmer_lengths()
    ce1, ce2 = g.e_conj[e2.astype(np.int64)], g.e_conj[e1.astype(np.int64)]
    cd = d + lens[e1.astype(np.int64)] - lens[e2.astype(np.int64)]
    E1 = np.concatenate([e1, ce1]).astype(np.int64)
    E2 = np.concatenate([e2, ce2]).astype(np.int64)
    D = np.concatenate([d, cd]).astype(float)
    W = np.concatenate([w, w]).astype(float)
    order = np.lexsort((D, E2, E1))
    return j_pi.PairedIndex(E1[order], E2[order], D[order], W[order])


def _improver_case(case):
    rng = np.random.default_rng(17)
    g, (base, A, B) = _chain_graph(rng, [8000, 30, 40])
    kw = dict(insert_size=200.0, is_var=10.0, max_repeat_length=5000, var=5.0)
    if case == "contradictory":
        x0, _ = g.add_vertex_pair()
        x1, _ = g.add_vertex_pair()
        X, _ = g.add_edge_pair(x0, x1, j_dna.encode(random_dna(rng, 45)), 100.0)
        rows = [(base, A, 8000.0, 10.0), (base, B, 8030.0, 10.0), (base, X, 8010.0, 1.0)]
    elif case == "consistent":
        rows = [(base, A, 8000.0, 10.0), (base, B, 8030.0, 10.0)]
    else:                                   # fill-missing: only (base, B) known
        rows = [(base, B, 8030.0, 7.0)]
        kw.update(insert_size=300.0, is_var=20.0)
    return g, _symmetric(g, rows), kw


@pytest.mark.parametrize("case", ["contradictory", "consistent", "fill_missing"])
def test_improve_paired_info_matches(case):
    g, pi, kw = _improver_case(case)
    jo, js = j_imp.improve_paired_info(g, pi, **kw)
    to, ts = t_imp.improve_paired_info(to_port_graph(g), to_port_index(pi), **kw)
    assert_same_index(jo, to)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert (ts.removed, ts.added) != (0, 0) or case == "consistent"


def test_improve_paired_info_on_a_mapped_repeat_graph():
    """A clustered index from real pairs over a graph with a repeat, with the
    improver's defaults but a short `max_repeat_length` so the removal pass
    has long base edges to visit."""
    from tests.test_path_extend import repeat_genome

    rng = np.random.default_rng(11)
    genome, _ = repeat_genome(rng, 21, a=900, r=60, b=700, c=900)
    jg = construct_graph([genome], 21).graph
    idx = j_mapper.build_edge_index(jg)
    starts = range(0, len(genome) - 300, 2)
    r1s = [genome[p : p + 60] for p in starts]
    r2s = [revcomp(genome[p + 240 : p + 300]) for p in starts]
    m1, m2 = j_mapper.map_read_batch(idx, jg, r1s), j_mapper.map_read_batch(idx, jg, r2s)
    st = j_pi.estimate_insert_size(jg, m1, m2, [60] * len(r1s), [60] * len(r2s))
    raw = j_pi.build_paired_index(jg, m1, m2, [60] * len(r2s), st.median)
    clustered = j_de.estimate_distances(raw)
    assert clustered.e1.size > 4
    for mrl in (100, 7500):
        jo, js = j_imp.improve_paired_info(jg, clustered, st.median, max(st.mad, 1.0),
                                           max_repeat_length=mrl)
        to, ts = t_imp.improve_paired_info(to_port_graph(jg), to_port_index(clustered),
                                           st.median, max(st.mad, 1.0), max_repeat_length=mrl)
        assert_same_index(jo, to)
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
