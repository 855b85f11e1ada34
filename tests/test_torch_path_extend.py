"""Port parity for path extension and scaffolding: `paired/path_extend.py`
and `aux_graphs/scaffold_graph.py`.

Each case builds its graph and pair info with the JAX package (from a seeded
numpy generator), carries them into the port with `convert.py`, and runs the
same function in both packages; the resulting paths (edges and gaps), counts
and scores must be equal (tolerance 0).  The cases are those of
`tests/test_path_extend.py`, `tests/test_composite_extenders.py` and
`tests/test_gap_analyzer.py`.
"""
import dataclasses

import numpy as np
import pytest

from spades_tpu.alignment.mapper import build_edge_index, map_read_batch
from spades_tpu.core import dna as j_dna
from spades_tpu.graph.graph import CondensedGraph as JGraph
from spades_tpu.paired import path_extend as j_pe
from spades_tpu.paired.paired_info import PairedIndex, build_paired_index, estimate_insert_size
from spades_tpu.pipeline.construction import construct_graph
from spades_tpu_torch import convert
from spades_tpu_torch.aux_graphs import ScaffoldGraph as TScaffoldGraph
from spades_tpu_torch.paired import path_extend as t_pe
from tests.conftest import random_dna
from tests.test_condense import clean_random_dna
from tests.test_gap_analyzer import _overlap_fixture
from tests.test_mapper_paired import make_fr_pairs
from tests.test_path_extend import repeat_genome


def port_graph(jg):
    return convert.graph_from_arrays(dataclasses.asdict(jg))


def port_index(pi):
    return convert.paired_index_from_arrays(dataclasses.asdict(pi))


def rows(paths):
    return [(list(map(int, p.edges)), list(map(int, p.gaps))) for p in paths]


def port_paths(paths):
    return convert.paths_from_lists(rows(paths))


def empty_pi():
    z = np.zeros(0)
    return PairedIndex(z.astype(np.int64), z.astype(np.int64), z, z)


def both_cfgs(**kw):
    jc, tc = j_pe.PEConfig(**kw), t_pe.PEConfig(**kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def _mapped_index(g, genome, rl, isize, rng, step):
    idx = build_edge_index(g)
    r1s, r2s = make_fr_pairs(genome, 0, rl, isize, rng, step=step)
    m1, m2 = map_read_batch(idx, g, r1s), map_read_batch(idx, g, r2s)
    st = estimate_insert_size(g, m1, m2, [rl] * len(r1s), [rl] * len(r2s))
    return build_paired_index(g, m1, m2, [rl] * len(r2s), st.median), st


# -- weight counters ---------------------------------------------------------------

def test_weight_counters_match():
    rng = np.random.default_rng(1)
    for _ in range(200):
        l1, l2 = (int(x) for x in rng.integers(1, 3000, 2))
        d = int(rng.integers(-4000, 4000))
        args = (l1, l2, d, int(rng.integers(150, 600)), int(rng.integers(50, 150)), 21)
        assert t_pe.ideal_pair_count(*args) == j_pe.ideal_pair_count(*args)
    L1, L2, D = (rng.integers(-100, 3000, (40, 30)) for _ in range(3))
    a = j_pe.ideal_pair_counts_vec(L1, L2, D, 400, 100, 55)
    b = t_pe.ideal_pair_counts_vec(L1, L2, D, 400, 100, 55)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("normalize", [True, False])
def test_candidate_weights_match(normalize):
    rng = np.random.default_rng(11)
    genome, _ = repeat_genome(rng, 21)
    g = construct_graph([genome], 21).graph
    pi, st = _mapped_index(g, genome, 50, 200, rng, 2)
    jc, tc = both_cfgs(insert_size=st.median, is_var=max(st.mad, 10.0),
                       normalize_weight=normalize)
    tg, tpi = port_graph(g), port_index(pi)
    n_scored = 0
    for e in g.canonical_edge_ids():
        e = int(e)
        cands = [int(c) for c in g.out_edges_of(int(g.e_end[e]))]
        if not cands:
            continue
        jp, tp = j_pe.Path([e]), t_pe.Path([e])
        pos = j_pe.path_positions(g, jp)
        assert np.array_equal(pos, t_pe.path_positions(tg, tp))
        cand_pos = int(pos[-1]) + int(g.e_len[e]) - g.k
        jw, jn = j_pe.candidate_weights(g, pi, jp, pos, cands, cand_pos, jc)
        tw, tn = t_pe.candidate_weights(tg, tpi, tp, pos, cands, cand_pos, tc)
        assert jn == tn and jw.dtype == tw.dtype and np.array_equal(jw, tw)
        n_scored += int(np.count_nonzero(tw))
    assert n_scored > 0


# -- repeat resolution -------------------------------------------------------------

@pytest.mark.parametrize("case", ["arbrc_with_pairs", "arbrc_no_pairs", "cross_no_pairs"])
def test_resolve_repeats_matches(case):
    k = 21
    if case == "cross_no_pairs":
        rng = np.random.default_rng(12)
        A, R, B, C, D = (clean_random_dna(rng, n, k) for n in (150, 60, 150, 150, 150))
        g = construct_graph([A + R + B, C + R + D], k).graph
        pi, kw = empty_pi(), {}
    else:
        rng = np.random.default_rng(11 if case == "arbrc_with_pairs" else 12)
        genome, _ = repeat_genome(rng, k)
        g = construct_graph([genome], k).graph
        if case == "arbrc_with_pairs":
            pi, st = _mapped_index(g, genome, 50, 200, rng, 2)
            kw = dict(insert_size=st.median, is_var=max(st.mad, 10.0))
        else:
            pi, kw = empty_pi(), {}
    jc, tc = both_cfgs(**kw)
    tg = port_graph(g)
    jpaths = j_pe.resolve_repeats(g, pi, jc)
    tpaths = t_pe.resolve_repeats(tg, port_index(pi), tc)
    assert rows(tpaths) == rows(jpaths)
    assert [t_pe.path_sequence(tg, p) for p in tpaths] == \
        [j_pe.path_sequence(g, p) for p in jpaths]
    assert [t_pe.path_coverage(tg, p) for p in tpaths] == \
        [j_pe.path_coverage(g, p) for p in jpaths]
    if case != "cross_no_pairs":
        best = max((j_pe.path_sequence(g, p) for p in jpaths), key=len)
        assert best in (genome, j_dna.revcomp_str(genome))


def _empty_graph(k=5):
    z = np.zeros(0, np.int64)
    return JGraph(k=k, e_start=z, e_end=z, e_conj=z, e_off=z, e_len=z,
                  e_cov=np.zeros(0), alive=np.zeros(0, bool),
                  seq_pool=np.zeros(0, np.uint8), v_conj=z)


def _edge(g, rng, a, b, nt, cov=50.0):
    return g.add_edge_pair(a, b, j_dna.encode(random_dna(rng, nt)), cov * nt)[0]


def _x_junction(rng, long_repeat=False):
    g = _empty_graph()
    a1, a2, m0, m1, b1, b2 = (g.add_vertex_pair()[0] for _ in range(6))
    n_in, n_rep = (600, 800) if long_repeat else (300, 60)
    es = (_edge(g, rng, a1, m0, n_in, 100.0), _edge(g, rng, a2, m0, n_in, 10.0),
          _edge(g, rng, m0, m1, n_rep, 110.0), _edge(g, rng, m1, b1, n_in, 100.0),
          _edge(g, rng, m1, b2, n_in, 10.0))
    return g, es


class _LongReads:
    """Storage stub: `LongReadChooser` asks it for next-edge votes only."""

    def __init__(self, votes):
        self.votes = votes

    def next_edge_votes(self, last):
        return self.votes.get(last, {})


@pytest.mark.parametrize("chain", ["pe_only", "coverage", "mate_pair", "long_reads"])
def test_extension_step_with_chooser_chains_matches(chain):
    rng = np.random.default_rng(5)
    g, (e_in1, e_in2, e_rep, e_out1, e_out2) = _x_junction(rng, chain == "mate_pair")
    tg = port_graph(g)
    jc, tc = both_cfgs(insert_size=250.0, is_var=30.0)
    if chain == "mate_pair":
        lens = g.edge_kmer_lengths()
        pi = PairedIndex(np.array([e_in1], np.int64), np.array([e_out1], np.int64),
                         np.array([float(lens[e_in1] + lens[e_rep])]), np.array([40.0]))
        kw = dict(insert_size=2000.0, is_var=200.0, min_path_edge_nt=200)
        jchain = [j_pe.PEChooser(empty_pi()), j_pe.PEChooser(pi, **kw)]
        tchain = [t_pe.PEChooser(port_index(empty_pi())), t_pe.PEChooser(port_index(pi), **kw)]
    elif chain == "coverage":
        ss = np.zeros(g.alive.shape[0])
        for e, c in ((e_in1, 100.0), (e_in2, 10.0), (e_rep, 110.0), (e_out1, 100.0),
                     (e_out2, 10.0)):
            ss[e], ss[g.e_conj[e]] = c, 0.5
        jchain = [j_pe.PEChooser(empty_pi()), j_pe.CoverageChooser(ss)]
        tchain = [t_pe.PEChooser(port_index(empty_pi())), t_pe.CoverageChooser(ss.copy())]
    elif chain == "long_reads":
        lr = _LongReads({e_rep: {e_out2: 5, e_out1: 1}})
        jchain = [j_pe.LongReadChooser(lr), j_pe.PEChooser(empty_pi())]
        tchain = [t_pe.LongReadChooser(lr), t_pe.PEChooser(port_index(empty_pi()))]
    else:
        jchain = [j_pe.PEChooser(empty_pi())]
        tchain = [t_pe.PEChooser(port_index(empty_pi()))]
    extended = []
    for start in (e_in1, e_in2):
        jp, tp = j_pe.Path([start, e_rep]), t_pe.Path([start, e_rep])
        extended.append(j_pe._extend_step(g, jp, jc, jchain))
        assert t_pe._extend_step(tg, tp, tc, tchain) == extended[-1]
        assert rows([tp]) == rows([jp])
    assert extended == {"pe_only": [False, False], "coverage": [True, True],
                        "mate_pair": [True, False], "long_reads": [True, True]}[chain]


def test_make_chooser_chain_matches():
    st = type("S", (), {"median": 300.0, "mad": 20.0, "count": 100})()
    lr = _LongReads({})
    for mode, ss in (("rna", np.zeros(4)), ("multicell", None), ("isolate", None)):
        chains = [m.make_chooser_chain(
            pair_libs=[("paired-end", pi, st), ("mate-pairs", pi, st)],
            long_reads=lr, ss_cov=ss, mode=mode, merged_pi=pi)
            for m, pi in ((j_pe, empty_pi()), (t_pe, port_index(empty_pi())))]
        kinds = [[(type(c).__name__, {k: v for k, v in vars(c).items()
                                      if isinstance(v, (int, float, bool, str, type(None)))})
                  for c in ch] for ch in chains]
        assert kinds[0] == kinds[1]
        assert len(kinds[1]) >= 3


# -- loops, cycles, overlaps -------------------------------------------------------

def _loop_component(rng, two_entrances):
    g = _empty_graph()
    a0, a1, c0, c1, b0, b1, x0 = (g.add_vertex_pair()[0] for _ in range(7))
    e_A = _edge(g, rng, a0, a1, 2000)
    e_A2 = _edge(g, rng, x0, c0, 2000) if two_entrances else None
    e_start = _edge(g, rng, a1, c0, 100)
    _edge(g, rng, c0, c1, 80)
    _edge(g, rng, c1, c0, 90)
    e_end = _edge(g, rng, c1, b0, 100)
    e_B = _edge(g, rng, b0, b1, 2000)
    paths = [j_pe.Path([e_A, e_start]), j_pe.Path([e_end, e_B])]
    if two_entrances:
        paths.insert(1, j_pe.Path([e_A2]))
    return g, paths


@pytest.mark.parametrize("two_entrances", [False, True])
def test_traverse_loops_matches(two_entrances):
    g, jpaths = _loop_component(np.random.default_rng(3), two_entrances)
    tpaths = port_paths(jpaths)
    jc, tc = both_cfgs()
    n = t_pe.traverse_loops(port_graph(g), tpaths, tc)
    assert n == j_pe.traverse_loops(g, jpaths, jc) == (0 if two_entrances else 1)
    assert rows(tpaths) == rows(jpaths)


def _three_canonical_edges(seed):
    rng = np.random.default_rng(seed)
    genome, _ = repeat_genome(rng, 21)
    g = construct_graph([genome], 21).graph
    es = sorted({min(int(e), int(g.e_conj[e])) for e in g.alive_edge_ids()})
    return g, es[:3]


@pytest.mark.parametrize("case", ["shared_run", "conjugate_prefix", "no_trim"])
def test_trim_end_overlaps_matches(case):
    g, (a, b, c) = _three_canonical_edges({"shared_run": 21, "conjugate_prefix": 22,
                                           "no_trim": 23}[case])
    if case == "shared_run":
        jpaths = [j_pe.Path([a, b, c], [0, 0, 0]), j_pe.Path([b, c, a], [0, 0, 100])]
    elif case == "conjugate_prefix":
        jpaths = [j_pe.Path([a, b, c], [0, 0, 0]), j_pe.conj_path(g, j_pe.Path([b, c, a]))]
    else:
        jpaths = [j_pe.Path([a, b]), j_pe.Path([c, b])]
    tpaths = port_paths(jpaths)
    assert t_pe.trim_end_overlaps(port_graph(g), tpaths) == j_pe.trim_end_overlaps(g, jpaths)
    assert rows(tpaths) == rows(jpaths)


def test_cycles_containment_and_conjugates_match():
    g, (a, b, c) = _three_canonical_edges(21)
    tg = port_graph(g)
    cyc = [e for e in g.alive_edge_ids() if int(g.e_end[e]) == int(g.e_start[e])]
    lists = [([a], [0]), ([a, b], [0, 0]), ([b, c, a], [0, 5, 0]), ([c], [0]),
             ([int(g.e_conj[b])], [0])]
    if cyc:
        lists.append(([int(cyc[0])] * 3, [0, 0, 0]))
    jpaths = [j_pe.Path(list(e), list(x)) for e, x in lists]
    tpaths = port_paths(jpaths)
    assert t_pe.trim_cyclic_periods(tg, tpaths) == j_pe.trim_cyclic_periods(g, jpaths)
    assert rows(tpaths) == rows(jpaths)
    assert rows(t_pe.remove_contained(tg, tpaths)) == rows(j_pe.remove_contained(g, jpaths))
    assert rows([t_pe.conj_path(tg, p) for p in tpaths]) == \
        rows([j_pe.conj_path(g, p) for p in jpaths])
    assert [t_pe.path_to_string(tg, p) for p in tpaths] == \
        [j_pe.path_to_string(g, p) for p in jpaths]


# -- scaffolding, polishing, gap analysis ------------------------------------------

def _gap_scaffold_case():
    """tests/test_path_extend.py::TestScaffolding: two unique regions
    separated by an unsequenced 40-nt gap, spanned by pairs."""
    rng = np.random.default_rng(13)
    k = 21
    left, right = clean_random_dna(rng, 300, k), clean_random_dna(rng, 300, k)
    genome = left + random_dna(rng, 40) + right
    reads = [genome[i : i + 60] for i in range(0, 240, 3)]
    reads += [genome[i : i + 60] for i in range(340, len(genome) - 60, 3)]
    g = construct_graph(reads, k).graph
    idx = build_edge_index(g)
    r1s, r2s = make_fr_pairs(genome, 0, 60, 250, rng, step=3)
    m1, m2 = map_read_batch(idx, g, r1s), map_read_batch(idx, g, r2s)
    return g, build_paired_index(g, m1, m2, [60] * len(r2s), 250.0)


def test_scaffold_and_polish_match():
    g, pi = _gap_scaffold_case()
    tg, tpi = port_graph(g), port_index(pi)
    jc, tc = both_cfgs(insert_size=250.0, is_var=10.0)
    jpaths = j_pe.resolve_repeats(g, pi, jc)
    tpaths = t_pe.resolve_repeats(tg, tpi, tc)
    assert rows(tpaths) == rows(jpaths)
    js, ts = j_pe.scaffold_paths(g, pi, jpaths, jc), t_pe.scaffold_paths(tg, tpi, tpaths, tc)
    assert rows(ts) == rows(js)
    assert any(x > 0 for p in ts for x in p.gaps)           # an N gap was placed
    jpol, tpol = j_pe.polish_paths(g, js, jc), t_pe.polish_paths(tg, ts, tc)
    assert rows(tpol) == rows(jpol)
    jref, tref = j_pe.refine_scaffold_gaps(g, jpol, jc), t_pe.refine_scaffold_gaps(tg, tpol, tc)
    assert rows(tref) == rows(jref)
    assert [t_pe.path_sequence(tg, p) for p in tref] == [j_pe.path_sequence(g, p) for p in jref]


def test_polish_fills_and_re_estimates_gaps():
    """Gaps between edges that a graph path joins: one connection fills the
    gap, none keeps it, several re-estimate it (PathPolisher)."""
    rng = np.random.default_rng(11)
    genome, _ = repeat_genome(rng, 21)
    g = construct_graph([genome], 21).graph
    tg = port_graph(g)
    ids = [int(e) for e in g.alive_edge_ids()]
    jpaths = [j_pe.Path([a, b], [0, 17]) for a in ids[:6] for b in ids[:6] if a != b]
    jc, tc = both_cfgs(insert_size=200.0, is_var=10.0)
    jpol, tpol = j_pe.polish_paths(g, jpaths, jc), t_pe.polish_paths(tg, port_paths(jpaths), tc)
    assert rows(tpol) == rows(jpol)
    assert rows(jpol) != rows(jpaths)
    for v_from, v_to in ((0, 1), (1, 0), (2, 3)):
        assert t_pe.find_paths_bounded(tg, v_from, v_to, 400) == \
            j_pe.find_paths_bounded(g, v_from, v_to, 400)


@pytest.mark.parametrize("est_gap", [15, 500, -20, -150, 3])
def test_analyze_gap_matches(est_gap):
    g, eL, eR, _left, _right = _overlap_fixture(np.random.default_rng(7), ov=37)
    jc, tc = both_cfgs(insert_size=250.0, is_var=30.0, read_length=100)
    assert t_pe.analyze_gap(port_graph(g), eL, eR, est_gap, tc) == \
        j_pe.analyze_gap(g, eL, eR, est_gap, jc)


def test_overlap_align_and_refine_match():
    rng = np.random.default_rng(1)
    for _ in range(20):
        a = j_dna.encode(random_dna(rng, int(rng.integers(20, 80))))
        b = np.concatenate([a[-int(rng.integers(5, 20)):],
                            j_dna.encode(random_dna(rng, int(rng.integers(5, 60))))])
        b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 4))
        assert t_pe.overlap_align(a, b) == j_pe.overlap_align(a, b)
    g, eL, eR, left, right = _overlap_fixture(np.random.default_rng(8), ov=37)
    jc, tc = both_cfgs(insert_size=250.0, is_var=30.0, read_length=100)
    jq = j_pe.refine_scaffold_gaps(g, [j_pe.Path([eL, eR], [0, 15])], jc)
    tq = t_pe.refine_scaffold_gaps(port_graph(g), [t_pe.Path([eL, eR], [0, 15])], tc)
    assert rows(tq) == rows(jq) == [([eL, eR], [0, -37])]
    assert t_pe.path_sequence(port_graph(g), tq[0]) == left + right[37:]


def test_conjugate_scaffold_join_matches():
    rng = np.random.default_rng(31)
    left, right = random_dna(rng, 200), random_dna(rng, 200)
    g = construct_graph([left, right], 21).graph
    eL = next(int(e) for e in g.alive_edge_ids() if g.edge_seq(int(e)) == left)
    eR = next(int(e) for e in g.alive_edge_ids() if g.edge_seq(int(e)) == right)
    cR = int(g.e_conj[eR])
    pi = PairedIndex(np.array([eL], np.int64), np.array([cR], np.int64),
                     np.array([int(g.e_len[eL]) - g.k + 50], np.int64), np.array([5.0]))
    jc, tc = both_cfgs(insert_size=250.0, is_var=30.0, read_length=100)
    js = j_pe.scaffold_paths(g, pi, [j_pe.Path([eL]), j_pe.Path([eR])], jc)
    ts = t_pe.scaffold_paths(port_graph(g), port_index(pi),
                             [t_pe.Path([eL]), t_pe.Path([eR])], tc)
    assert rows(ts) == rows(js) == [([eL, cR], [0, 50])]


# -- the mate-pair scaffold graph (scaffolder2015) ---------------------------------

@pytest.mark.parametrize("case", ["join", "ambiguous", "dominant", "dominant_strict"])
def test_scaffold_graph_2015_matches(case):
    rng = np.random.default_rng(42)
    g = JGraph.from_sequences([random_dna(rng, 800) for _ in range(3)], 21)
    tg = port_graph(g)
    eA, eB, eC = 0, 2, 4
    if case == "join":
        pi = PairedIndex(np.array([eA, eA, eB], np.int64), np.array([eB, eC, eC], np.int64),
                         np.array([2000, 4000, 2000], np.int64), np.array([9.0, 1.0, 8.0]))
    else:
        pi = PairedIndex(np.array([eA, eA], np.int64), np.array([eB, eC], np.int64),
                         np.array([2000, 2000], np.int64),
                         np.array([9.0, 9.0 if case == "ambiguous" else 2.0]))
    kw = {"relative_cutoff": 5.0} if case == "dominant_strict" else {}
    jsg = j_pe.build_scaffold_graph_2015(g, pi, min_edge_length=100, min_weight=2.0)
    tsg = t_pe.build_scaffold_graph_2015(tg, port_index(pi), min_edge_length=100,
                                         min_weight=2.0)
    assert isinstance(tsg, TScaffoldGraph)
    assert tsg.vertices == jsg.vertices
    for col in ("src", "dst", "weight", "length", "lib"):
        a, b = getattr(jsg, col), getattr(tsg, col)
        assert a.dtype == b.dtype and np.array_equal(a, b), col
    jc, tc = both_cfgs()
    paths = [[eA], [eB], [eC]]
    jj = j_pe.scaffold_with_graph_2015(g, jsg, [j_pe.Path(p) for p in paths], jc, **kw)
    tj = t_pe.scaffold_with_graph_2015(tg, tsg, [t_pe.Path(p) for p in paths], tc, **kw)
    assert rows(tj) == rows(jj)
    assert len(tj) == {"join": 1, "ambiguous": 3, "dominant": 2, "dominant_strict": 3}[case]


def test_scaffold_graph_methods_match():
    from spades_tpu.aux_graphs.scaffold_graph import ScaffoldGraph as JScaffoldGraph

    rng = np.random.default_rng(2)
    src, dst = rng.integers(0, 8, 30), rng.integers(0, 8, 30)
    w, L = rng.random(30) * 5, rng.integers(0, 900, 30)
    graphs = []
    for cls in (JScaffoldGraph, TScaffoldGraph):
        sg = cls()
        sg.add_vertex(99)
        sg.add_edges(src, dst, w, L, lib=1)
        sg.add_edge(3, 4, 2.5, 10, 2)
        f = sg.filter_by_weight(1.5)
        f.dedup()
        graphs.append((sg, f))
    (js, jf), (ts, tf) = graphs
    for a, b in ((js, ts), (jf, tf)):
        assert a.vertices == b.vertices and a.num_edges == b.num_edges
        for col in ("src", "dst", "weight", "length", "lib"):
            assert np.array_equal(getattr(a, col), getattr(b, col)), col
        assert a.out_degrees() == b.out_degrees() and a.in_degrees() == b.in_degrees()
        assert np.array_equal(a.out_edges_of(3), b.out_edges_of(3))
        assert np.array_equal(a.in_edges_of(4), b.in_edges_of(4))
