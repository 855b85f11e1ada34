"""Port parity for the long-read slice: `alignment/edit.py` (Myers bit-vector
edit distance, banded alignment, medoid, consensus), `alignment/long_read.py`
(anchoring, clustering, chaining, path storage, hybrid gap closing), the
long-read checkpoint (`save_long_reads` / `load_long_reads`) and
`run_assembly(long_reads=)`.

Inputs are made from seeds with numpy and go through `spades_tpu` and
`spades_tpu_torch` alike; results must be equal exactly (tolerance 0: the
work is integer and string), alignments field by field and the storage's
paths in their dict order, which the long-read chooser of repeat resolution
reads.  The cases are those of `tests/test_edit.py` and
`tests/test_long_read.py`, plus a hypothesis property over random strings.
"""
import dataclasses
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from spades_tpu.alignment import edit as j_edit
from spades_tpu.alignment import long_read as j_lr
from spades_tpu.core import dna as j_dna
from spades_tpu.graph import serialize as j_ser
from spades_tpu.graph.graph import CondensedGraph as JGraph
from spades_tpu.pipeline import run as j_run
from spades_tpu.pipeline.construction import construct_graph as j_construct
from spades_tpu_torch import convert
from spades_tpu_torch.alignment import edit as t_edit
from spades_tpu_torch.alignment import long_read as t_lr
from spades_tpu_torch.graph import serialize as t_ser
from spades_tpu_torch.pipeline import run as t_run
from spades_tpu_torch.pipeline import spades_stages as t_stages
from spades_tpu_torch.tools import synthetic
from tests.test_torch_pipeline import (OUTPUTS, THRESHOLDS, assert_same_file, assert_same_graph,
                                       one_torch_thread)

K = 21


def _rand(n, rng):
    return j_dna.decode(rng.integers(0, 4, n).astype(np.uint8))


def _noisy(s, rate, rng):
    """Insertions, deletions and substitutions at `rate` in all (the
    generator of `tests/test_edit.py`)."""
    out = []
    for ch in s:
        r = rng.random()
        if r < rate / 3:
            continue
        if r < 2 * rate / 3:
            out.append("ACGT"[rng.integers(0, 4)])
            out.append(ch)
        elif r < rate:
            out.append("ACGT"[rng.integers(0, 4)])
        else:
            out.append(ch)
    return "".join(out)


def _subs(seq, rate, seed):
    rng = np.random.default_rng(seed)
    c = j_dna.encode(seq).copy()
    flip = rng.random(len(c)) < rate
    c[flip] = (c[flip] + rng.integers(1, 4, flip.sum())) % 4
    return j_dna.decode(c)


def _tile(genome, lo, hi, read_len=100, step=7):
    reads = [genome[s : s + read_len] for s in range(lo, hi - read_len + 1, step)]
    reads.append(genome[hi - read_len : hi])
    return reads


def _both_graphs(reads, k=K):
    jg = j_construct(reads, k).graph
    return jg, convert.graph_from_arrays(dataclasses.asdict(jg))


def _assert_same_alignments(ja, ta):
    assert len(ja) == len(ta)
    for a, b in zip(ja, ta):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


# -- edit.py ---------------------------------------------------------------------

def test_edit_distances_across_word_boundaries():
    rng = np.random.default_rng(1)
    for m in [0, 1, 2, 63, 64, 65, 128, 130]:
        for _ in range(5):
            a = _rand(m, rng)
            texts = [_rand(int(rng.integers(0, 2 * m + 2)), rng) for _ in range(4)]
            got = t_edit.edit_distances(a, texts)
            assert got.dtype == np.int64
            assert np.array_equal(got, j_edit.edit_distances(a, texts))
            assert t_edit.edit_distance(a, texts[0]) == j_edit.edit_distance(a, texts[0])
    assert t_edit.edit_distances("ACGT", []).shape == (0,)
    for a, b in (("", "ACGT"), ("ACGT", ""), ("", ""), ("ACNT", "ACGT")):
        assert t_edit.edit_distance(a, b) == j_edit.edit_distance(a, b)


def test_peq_words_match():
    rng = np.random.default_rng(7)
    pat = rng.integers(0, 5, 200).astype(np.uint8)
    got = t_edit._peq(pat, 4)
    assert got.dtype == np.uint64 and np.array_equal(got, j_edit._peq(pat, 4))


@settings(max_examples=60, deadline=None)
@given(st.text("ACGT", max_size=150), st.lists(st.text("ACGTN", max_size=200), max_size=6))
def test_edit_distances_property(query, texts):
    assert np.array_equal(t_edit.edit_distances(query, texts),
                          j_edit.edit_distances(query, texts))


def test_banded_align_and_widening():
    rng = np.random.default_rng(3)
    cases = [(_rand(int(rng.integers(1, 120)), rng), _rand(int(rng.integers(1, 120)), rng))
             for _ in range(30)]
    a = "ACGT" * 30
    cases += [(a, a[:60] + "T" * 50 + a[60:]), ("", "ACG"), ("ACG", "")]
    for a, b in cases:
        ea, eb = j_dna.encode(a), j_dna.encode(b)
        jd, jai, jbi = j_edit.banded_align(ea, eb)
        td, tai, tbi = t_edit.banded_align(ea, eb)
        assert td == jd and np.array_equal(tai, jai) and np.array_equal(tbi, jbi)
        assert tai.dtype == jai.dtype == np.int64
    # one band too narrow for the optimum, which `banded_align` would widen
    a, b = j_dna.encode(_rand(40, rng)), j_dna.encode(_rand(40, rng))
    d, cols = t_edit._banded_core(a, b, 4)
    jd, jcols = j_edit._banded_core(a, b, 4)
    assert d == jd and all(np.array_equal(x, y) for x, y in zip(cols, jcols))


def test_medoid_and_consensus():
    rng = np.random.default_rng(4)
    truth = _rand(300, rng)
    copies = [_noisy(truth, 0.12, rng) for _ in range(15)]
    assert t_edit.consensus(copies) == j_edit.consensus(copies)
    many = [_noisy(truth[:120], 0.1, rng) for _ in range(40)]       # past max_copies
    assert t_edit.consensus(many) == j_edit.consensus(many)
    truth = _rand(200, rng)
    seqs = [_noisy(truth, 0.25, rng), truth, _noisy(truth, 0.25, rng)]
    assert t_edit.medoid(seqs) == j_edit.medoid(seqs) == 1
    for seqs in ([], ["ACGT"], ["ACGT"] * 3, ["", "ACGT", "ACCT"]):
        assert t_edit.consensus(seqs) == j_edit.consensus(seqs)


# -- long_read.py ------------------------------------------------------------------

def test_aligner_cases_match():
    """The cases of `tests/test_long_read.py::TestAligner`: a clean read on
    one edge, a noisy read, its reverse complement, junk, a read across a
    gap (anchors, clusters, chain, gap records)."""
    g1 = _rand(1200, np.random.default_rng(1))
    g6 = _rand(1400, np.random.default_rng(6))
    cases = [
        ([g1], [g1[200:900], _subs(g1[100:1100], 0.08, 3), j_dna.revcomp_str(g1[100:800]),
                _rand(500, np.random.default_rng(99)), ""]),
        (_tile(g6, 0, 650) + _tile(g6, 750, 1400), [g6[300:1100], g6[250:1150]]),
    ]
    for reads, longs in cases:
        jg, tg = _both_graphs(reads)
        ja = j_lr.align_long_reads(jg, longs)
        ta = t_lr.align_long_reads(tg, longs)
        _assert_same_alignments(ja, ta)
        assert [a.edges for a in ta] == [a.edges for a in ja]
        assert any(a.path for a in ta)
    jidx = j_lr.build_edge_index(jg, 13)
    tidx = t_lr.build_edge_index(tg, 13)
    ja = j_lr._anchors(jidx, jg, g6[300:1100], 13)
    assert np.array_equal(t_lr._anchors(tidx, tg, g6[300:1100], 13), ja) and len(ja) > 0


def test_aligner_clusters_on_noisy_reads_match():
    """Noisy long reads (indels too) on a repeat-rich graph: many clusters
    per read, spurious anchors, the cluster cap and the chaining DP."""
    genome, r1, r2, _gaps = synthetic.make_gapped_dataset(30_000, 20, 100, 0.003, 4, 4)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    reads = [acgt[r].tobytes().decode() for r in np.concatenate([r1, r2])]
    jg, tg = _both_graphs(reads, 33)
    longs = synthetic.sample_long_reads(genome, 4, 4000, 800, 0.04, 0.03, 0.03, 6)
    cfg = j_lr.AlignerConfig(max_clusters_per_read=8)
    tcfg = t_lr.AlignerConfig(max_clusters_per_read=8)
    for jc, tc in ((None, None), (cfg, tcfg)):
        _assert_same_alignments(j_lr.align_long_reads(jg, longs, jc),
                                t_lr.align_long_reads(tg, longs, tc))


def test_storage_and_gap_closing_match():
    """`build_long_read_storage` (paths and their dict order, conjugates
    after each path), `next_edge_votes`, and `close_gaps_with_long_reads`
    on the cases of `tests/test_long_read.py` and the noisy consensus case
    of `tests/test_edit.py`: the graphs after the splices are equal."""
    g7 = _rand(1400, np.random.default_rng(7))
    reads7 = _tile(g7, 0, 650) + _tile(g7, 750, 1400)
    rng = np.random.default_rng(6)
    left, gap, right = _rand(400, rng), _rand(250, rng), _rand(400, rng)
    noisy = [_noisy((left + gap + right)[300:750], 0.12, rng) for _ in range(12)]
    j_from_seqs = lambda: JGraph.from_sequences([left, right], K)
    cases = [
        (lambda: j_construct(reads7, K).graph, [g7[250:1150], g7[300:1200], g7[200:1100]], 2),
        (lambda: j_construct(reads7, K).graph, [g7[300:1100]], 2),                  # no support
        (j_from_seqs, noisy, 3),
    ]
    for make, longs, support in cases:
        jg = make()
        tg = convert.graph_from_arrays(dataclasses.asdict(jg))
        ja, ta = j_lr.align_long_reads(jg, longs), t_lr.align_long_reads(tg, longs)
        js, ts = j_lr.build_long_read_storage(jg, ja), t_lr.build_long_read_storage(tg, ta)
        assert list(ts.paths.items()) == list(js.paths.items())
        for e in range(len(jg.e_len)):
            assert ts.next_edge_votes(e) == js.next_edge_votes(e)
        jn = j_lr.close_gaps_with_long_reads(jg, ja, min_support=support)
        tn = t_lr.close_gaps_with_long_reads(tg, ta, min_support=support)
        assert tn == jn
        assert_same_graph(jg, tg)
    assert tn == 1


def test_long_read_checkpoint_round_trip(tmp_path):
    """`save_long_reads` / `load_long_reads` keep every path, its count and
    the dict order, and each package reads the other's archive."""
    st = t_lr.LongReadStorage()
    for p in ([4, 2, 9], [1, 3], [4, 2, 9], [7, 7, 7, 7], [0, 5]):
        st.add(p)
    st.add([3])                                    # one edge: not stored
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    t_ser.save_long_reads(tpath, st)
    back = t_ser.load_long_reads(tpath)
    assert list(back.paths.items()) == list(st.paths.items()) == \
        [((4, 2, 9), 2), ((1, 3), 1), ((7, 7, 7, 7), 1), ((0, 5), 1)]
    assert list(j_ser.load_long_reads(tpath).paths.items()) == list(st.paths.items())
    js = j_lr.LongReadStorage(paths=dict(st.paths))
    j_ser.save_long_reads(jpath, js)
    assert list(t_ser.load_long_reads(jpath).paths.items()) == list(st.paths.items())
    t_ser.save_long_reads(tpath, t_lr.LongReadStorage())
    assert t_ser.load_long_reads(tpath).paths == {}


# -- run_assembly(long_reads=) -----------------------------------------------------

@pytest.fixture(scope="module")
def lowered():
    """Both packages count, index and map on their device paths."""
    with pytest.MonkeyPatch.context() as mp:
        for name, value in THRESHOLDS.items():
            mp.setenv(name, value)
        yield mp


@pytest.fixture(scope="module")
def hybrid(tmp_path_factory, lowered):
    """A 60 kb genome thinned at 10 positions, its pairs at 30x and noisy
    long reads at 8x (10 +- 2 kb, 4 % substitutions, 3 % insertions, 3 %
    deletions), through both packages at K=55 with every checkpoint."""
    genome, r1, r2, _gaps = synthetic.make_gapped_dataset(60_000, 30, 150, 0.003, 3, 10)
    longs = synthetic.sample_long_reads(genome, 8, 10_000, 2_000, 0.04, 0.03, 0.03, 5)
    lefts, rights = list(r1), list(r2)
    tmp = tmp_path_factory.mktemp("hybrid")
    t_stages.MODE_STATS.clear()
    kw = dict(paired_libs=[(lefts, rights)], read_length=150, long_reads=longs,
              checkpoints="all")
    jres = j_run.run_assembly(lefts + rights, [55], str(tmp / "j"), **kw)
    tres = t_run.run_assembly(lefts + rights, [55], str(tmp / "t"), device="cpu", **kw)
    return str(tmp / "j"), str(tmp / "t"), jres, tres, list(t_stages.MODE_STATS)


@pytest.mark.parametrize("sub", ["", "K55"])
@pytest.mark.parametrize("name", OUTPUTS)
def test_hybrid_files_match(hybrid, sub, name):
    jdir, tdir = hybrid[:2]
    assert_same_file(os.path.join(jdir, sub, name), os.path.join(tdir, sub, name))


def test_hybrid_run_matches(hybrid):
    jdir, tdir, jres, tres, stats = hybrid
    assert_same_graph(jres.graph, tres.graph)
    [(k, sid, st)] = stats
    assert (k, sid) == (55, "hybrid_aligning")
    assert st["aligned"] == st["reads"] > 0 and st["paths"] > 0 and st["closed"] > 0
    # the long-read paths went through the checkpoints of the later stages
    for stage in ("hybrid_aligning", "repeat_resolving"):
        jp, tp = (os.path.join(d, "K55", "saves", stage, "long_reads.npz") for d in (jdir, tdir))
        assert list(t_ser.load_long_reads(tp).paths.items()) == \
            list(j_ser.load_long_reads(jp).paths.items())
        assert len(t_ser.load_long_reads(tp).paths) == st["paths"]


def test_hybrid_restart_reads_the_long_read_checkpoint(hybrid, tmp_path, lowered):
    """A restart at PairInfoCount loads HybridAligning's checkpoint, long-read
    paths included, and writes the same files again."""
    import shutil

    jdir, tdir = hybrid[:2]
    again = str(tmp_path / "again")
    shutil.copytree(tdir, again)
    for name in OUTPUTS:
        os.remove(os.path.join(again, "K55", name))
    genome, r1, r2, _gaps = synthetic.make_gapped_dataset(60_000, 30, 150, 0.003, 3, 10)
    longs = synthetic.sample_long_reads(genome, 8, 10_000, 2_000, 0.04, 0.03, 0.03, 5)
    lefts, rights = list(r1), list(r2)
    t_run.run_assembly(lefts + rights, [55], again, paired_libs=[(lefts, rights)],
                       read_length=150, long_reads=longs, checkpoints="all", device="cpu",
                       restart_from="k55:pair_info_count")
    for name in OUTPUTS:
        assert_same_file(os.path.join(jdir, "K55", name), os.path.join(again, "K55", name))
