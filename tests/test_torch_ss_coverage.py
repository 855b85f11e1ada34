"""Port parity for strand-specific coverage and the SS edge splitter:
`alignment/ss_coverage.py` and the SSEdgeSplit stage (rnaSPAdes' `--ss`).

The cases are those of `tests/test_ss_coverage.py`.  The same graph and
reads (made from seeds with numpy) go through `spades_tpu`, which maps with
the host `map_read_batch(build_edge_index(g), ...)`, and through the port,
which maps one packed `ReadStore` on the device path of a `MappingEngine`
(`device="cpu"`: the kernels' plain versions).  Spans, coverage arrays,
bins, split positions and the split graphs must be exactly equal (tolerance
0: the work is integer and the float code is the same numpy).
"""
import dataclasses

import numpy as np
import pytest

from spades_tpu.alignment import ss_coverage as j_ss
from spades_tpu.alignment.mapper import build_edge_index as j_index
from spades_tpu.core import dna as j_dna
from spades_tpu.graph.graph import CondensedGraph as JGraph
from spades_tpu.pipeline import spades_stages as j_stages
from spades_tpu.pipeline.stages import AssemblyContext as JContext
from spades_tpu_torch import convert
from spades_tpu_torch.alignment import ss_coverage as t_ss
from spades_tpu_torch.alignment.mapper import MappingEngine
from spades_tpu_torch.pipeline import spades_stages as t_stages
from spades_tpu_torch.pipeline.stages import AssemblyContext as TContext
from tests.test_torch_pipeline import assert_same_graph, one_torch_thread

K = 21


def _seq(n, seed):
    return j_dna.decode(np.random.default_rng(seed).integers(0, 4, n).astype(np.uint8))


def _reads(seq, n, rlen, seed):
    rng = np.random.default_rng(seed)
    return [seq[s : s + rlen] for s in rng.integers(0, max(1, len(seq) - rlen), n)]


def _graphs(seqs, k=K):
    jg = JGraph.from_sequences(seqs, k)
    return jg, convert.graph_from_arrays(dataclasses.asdict(jg))


def _convergent(seed, n=600, a_end=350, b_start=250, reads=400):
    """Two transcripts meeting tail-to-tail on one edge: A, the forward strand
    of s[:a_end], and B, the reverse strand of s[b_start:]."""
    s = _seq(n, seed)
    ta, tb = s[:a_end], j_dna.revcomp_str(s[b_start:])
    return s, _reads(ta, reads, 60, seed + 1) + _reads(tb, reads, 60, seed + 2)


@pytest.mark.parametrize("rf", [False, True])
def test_mapped_spans_match_the_reference_map_read_batch(rf):
    """Device-engine spans = the reference's host-mapped spans, with reads
    shorter than k, reads with N, reads off the graph, and several edges."""
    a, b = _seq(500, 3), _seq(300, 4)
    jg, tg = _graphs([a, a[:200] + b])
    reads = _reads(a, 150, 60, 5) + _reads(b, 60, 45, 6) + [a[10:25], _seq(80, 7)]
    reads += [r[:20] + "N" + r[21:] for r in _reads(a, 20, 70, 8)]
    reads += [j_dna.revcomp_str(r) for r in _reads(a, 40, 90, 9)]
    je, jl, jh = j_ss._mapped_spans(jg, reads, j_index(jg), rf=rf)
    te, tl, th = t_ss._mapped_spans(tg, t_ss.read_store(reads, rf=rf), device="cpu")
    assert je.size > 100
    for x, y in ((je, te), (jl, tl), (jh, th)):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("rf", [False, True])
@pytest.mark.parametrize("symmetric", [False, True])
def test_fill_ss_coverage_matches(rf, symmetric):
    s = _seq(400, 11)
    jg, tg = _graphs([s])
    fwd = _reads(s, 200, 60, 12)
    jc = j_ss.fill_ss_coverage(jg, fwd, symmetric=symmetric, rf=rf)
    tc = t_ss.fill_ss_coverage(tg, t_ss.read_store(fwd, rf=rf), symmetric=symmetric,
                               device="cpu")
    assert tc.dtype == jc.dtype and np.array_equal(tc, jc)
    if symmetric:
        assert tc[0] == tc[1] > 0
    else:                       # one strand sees the reads, its conjugate none
        assert tc[int(rf)] > 10 and tc[1 - int(rf)] == 0


def test_engine_is_reused_across_passes():
    s = _seq(400, 13)
    _jg, tg = _graphs([s])
    store = t_ss.read_store(_reads(s, 100, 60, 14))
    engine = MappingEngine(tg, device="cpu")
    a = t_ss.fill_ss_coverage(tg, store, engine=engine)
    prep = engine._prep
    b = t_ss.fill_ss_coverage(tg, store, engine=engine)
    assert engine._prep is prep and np.array_equal(a, b)


def test_split_edge_matches():
    s = _seq(300, 15)
    jg, tg = _graphs([s])
    for at in ("middle", "first", "last"):
        ids = jg.alive_edge_ids()
        e = int(ids[np.argmax(jg.e_len[ids])])
        span = int(jg.e_len[e]) - K
        pos = {"middle": span // 2, "first": 1, "last": span - 1}[at]
        j1 = j_ss.split_edge(jg, e, pos)
        t1 = t_ss.split_edge(tg, e, pos)
        assert j1 == t1
        assert_same_graph(jg, tg)
        tg.check_invariants()


@pytest.mark.parametrize("bin_size, min_edge_len", [(50, 150), (30, 90), (7, 21)])
def test_binned_fill_and_split_match(bin_size, min_edge_len):
    """The vectorized bin fill against the reference's per-read loop, then
    detection and splitting, on a tail-to-tail pair and a uniform edge."""
    s, reads = _convergent(17)
    u = _seq(600, 19)
    reads += _reads(u, 300, 60, 20) + [j_dna.revcomp_str(r) for r in _reads(u, 300, 60, 21)]
    reads += _reads(s, 30, 100, 22) + _reads(u, 30, 23, 23)
    jg, tg = _graphs([s, u])
    kw = dict(bin_size=bin_size, min_edge_len=min_edge_len, min_edge_coverage=0.0,
              coverage_margin=3.0, min_flanking_coverage=1.0)
    js, ts = j_ss.SSCoverageSplitter(jg, **kw), t_ss.SSCoverageSplitter(tg, **kw)
    assert list(ts.bins) == list(js.bins)
    js.fill(reads)
    ts.fill(t_ss.read_store(reads), device="cpu")
    for e in js.bins:
        assert np.array_equal(ts.bins[e], js.bins[e]), e
    assert sum(v.sum() for v in ts.bins.values()) > 0
    for e in js.bins:
        assert ts.detect_split(e) == js.detect_split(e)
    assert ts.split_edges() == js.split_edges() >= 1
    assert_same_graph(jg, tg)
    tg.check_invariants()


def test_no_split_on_uniform_coverage():
    s = _seq(600, 25)
    reads = _reads(s, 300, 60, 26) + [j_dna.revcomp_str(r) for r in _reads(s, 300, 60, 27)]
    _jg, tg = _graphs([s])
    ts = t_ss.SSCoverageSplitter(tg, bin_size=50, min_edge_len=150, min_edge_coverage=0.0)
    ts.fill(t_ss.read_store(reads), device="cpu")
    assert ts.split_edges() == 0


@pytest.mark.parametrize("ss", ["fr", "rf"])
def test_stage_matches_on_planted_convergent_pairs(ss):
    """SSEdgeSplit with its defaults on three convergent pairs (single-end
    stranded reads, deep enough to pass its coverage gates): the split graph,
    `ss_cov`, and the mapping engine left for PairInfoCount."""
    seqs, reads = [], []
    for i in range(3):
        s, r = _convergent(30 + 3 * i, n=900, a_end=550, b_start=400, reads=900)
        seqs.append(s)
        reads += r
    if ss == "rf":
        reads = [j_dna.revcomp_str(r) for r in reads]
    jg, tg = _graphs(seqs)
    cov = (jg.e_len - K) * 40.0
    jg.e_cov[:] = cov
    tg.e_cov[:] = cov
    jctx = JContext(k=K, output_dir="", reads=list(reads), read_length=60, mode="rna")
    tctx = TContext(k=K, output_dir="", reads=list(reads), read_length=60, mode="rna",
                    device="cpu")
    jctx.graph, tctx.graph = jg, tg
    stale = tctx.mapping_engine()
    j_stages.SSEdgeSplit(ss).run(jctx)
    t_stages.MODE_STATS.clear()
    t_stages.SSEdgeSplit(ss).run(tctx)
    assert_same_graph(jctx.graph, tctx.graph)
    assert np.array_equal(tctx.ss_cov, jctx.ss_cov)
    [(_k, sid, st)] = t_stages.MODE_STATS
    assert sid == "ss_edge_split" and st["edges_split"] == 3
    assert stale._prep is None and tctx._me is not stale     # the split dropped it
    assert tctx.mapping_engine() is tctx._me                  # still valid for PairInfoCount
    # a store packed once for the run gives the same result
    _jg2, tg2 = _graphs(seqs)
    tg2.e_cov[:] = cov
    ctx2 = TContext(k=K, output_dir="", reads=list(reads), read_length=60, mode="rna",
                    device="cpu")
    ctx2.graph = tg2
    t_stages.SSEdgeSplit(ss, store=t_ss.read_store(reads, rf=ss == "rf")).run(ctx2)
    assert_same_graph(tctx.graph, ctx2.graph)
    assert np.array_equal(tctx.ss_cov, ctx2.ss_cov)
