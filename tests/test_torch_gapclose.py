"""Port parity for the gap closer (`alignment/gap_closer.py`): the cases of
`tests/test_gapclose_mismatch.py` `TestGapCloser` and
`TestStorePathEquivalence`, each run through `spades_tpu` and
`spades_tpu_torch` on the same graph and reads.

Closed counts and every graph array must be exactly equal (tolerance 0: the
work is integer, coverage sums are added in the same order).  The store path
runs with the device thresholds lowered, so both packages build the index
and map on their device path (the port on CPU tensors).
"""
import copy
import dataclasses

import numpy as np
import pytest

from spades_tpu.alignment import gap_closer as j_gc
from spades_tpu.alignment.mapper import MappingEngine as JEngine
from spades_tpu.core.reads import ReadStore as JStore
from spades_tpu.graph.graph import CondensedGraph as JGraph
from spades_tpu_torch import convert
from spades_tpu_torch.alignment import gap_closer as t_gc
from spades_tpu_torch.alignment.mapper import MappingEngine as TEngine
from spades_tpu_torch.core import dna
from spades_tpu_torch.core.reads import ReadStore as TStore
from spades_tpu_torch.pipeline.construction import construct_graph as t_construct

K = 21
GRAPH_FIELDS = ("e_start", "e_end", "e_conj", "e_off", "e_len", "e_cov", "alive",
                "seq_pool", "v_conj")


def _genome(n, seed):
    return dna.decode(np.random.default_rng(seed).integers(0, 4, n).astype(np.uint8))


def _tile(genome, lo, hi, read_len=100, step=7):
    reads = [genome[s : s + read_len] for s in range(lo, hi - read_len + 1, step)]
    reads.append(genome[hi - read_len : hi])
    return reads


def _pairs(genome, lo, hi, read_len=100, insert=220, step=5):
    r1 = [genome[s : s + read_len] for s in range(lo, hi - insert, step)]
    r2 = [dna.revcomp_str(genome[s + insert - read_len : s + insert])
          for s in range(lo, hi - insert, step)]
    return r1, r2


def _graph(reads):
    return t_construct(reads, K, min_count=1, device="cpu").graph


def both(g):
    d = dataclasses.asdict(g)
    return JGraph(**copy.deepcopy(d)), convert.graph_from_arrays(d)


def assert_same_graph(jg, tg):
    for f in GRAPH_FIELDS:
        assert np.array_equal(getattr(jg, f), getattr(tg, f)), f
    tg.check_invariants()


@pytest.fixture
def device_path(monkeypatch):
    monkeypatch.setenv("SPADES_DEVICE_MAP_READS", "1")
    monkeypatch.setenv("SPADES_DEVICE_INDEX_POOL", "1")
    monkeypatch.setenv("SPADES_MAP_SUBCHUNK", "256")
    monkeypatch.setenv("SPADES_HOST_COUNT_WINDOWS", "1")


def _gapped(seed, corrupt=()):
    """Left and right part overlap by k-1 nt only, so the graph breaks into
    two edges with a tip-to-tip junction; `corrupt` flips bases of the left
    part's copy."""
    genome = _genome(1000, seed)
    bad = list(genome)
    for pos in corrupt:
        bad[pos] = {"A": "C", "C": "G", "G": "T", "T": "A"}[bad[pos]]
    reads = _tile("".join(bad), 0, 520) + _tile(genome, 500, len(genome))
    return genome, _graph(reads)


def _case_supported():
    genome, g = _gapped(1)
    return g, [_pairs(genome, 300, 800)], 1, genome


def _case_overlap_errors():
    genome, g = _gapped(7, corrupt=(505, 512))
    return g, [_pairs(genome, 300, 800)], 1, genome


def _case_no_pairs():
    _genome_, g = _gapped(2)
    return g, [], 0, None


def _case_unsupported():
    genome, g = _gapped(3)
    return g, [_pairs(genome, 0, 450)], 0, None


def _case_single_edge():
    genome = _genome(600, 4)
    return _graph(_tile(genome, 0, 600)), [(["A" * 50], ["T" * 50])], 0, None


def _case_short_overlap():
    """Two fragments overlapping by 12 nt (< k, >= the minimal
    intersection of 10): the closer must splice them."""
    rng = np.random.default_rng(42)
    gen = dna.decode(rng.integers(0, 4, 700).astype(np.uint8))
    greads = [gen[s : s + 80] for s in range(0, 271, 5)]
    greads += [gen[s : s + 80] for s in range(338, 621, 5)]
    r1 = [gen[s : s + 70] for s in range(150, 470, 5)]
    r2 = [dna.revcomp_str(gen[s + 150 : s + 220]) for s in range(150, 470, 5)]
    return _graph(greads), [(r1, r2)], 1, None


def _case_far_from_tips():
    gen = _genome(2000, 9)
    r1 = [gen[s : s + 70] for s in range(800, 1000, 10)]
    r2 = [dna.revcomp_str(gen[s + 150 : s + 220]) for s in range(800, 1000, 10)]
    return _graph([gen]), [(r1, r2)], 0, None


CASES = {
    "closes_supported_gap": _case_supported,
    "corrects_overlap_errors_on_close": _case_overlap_errors,
    "no_pairs_no_close": _case_no_pairs,
    "unsupported_junction_not_closed": _case_unsupported,
    "single_edge_graph_noop": _case_single_edge,
    "store_fixture_short_overlap": _case_short_overlap,
    "prefilter_no_candidates_no_close": _case_far_from_tips,
}


@pytest.mark.parametrize("name", list(CASES))
def test_legacy_path_matches(name):
    g, paired, expect, genome = CASES[name]()
    jg, tg = both(g)
    stats = {}
    ref = j_gc.close_gaps(jg, paired)
    got = t_gc.close_gaps(tg, paired, device="cpu", stats=stats)
    assert got == ref == expect
    assert stats["closed"] == got
    assert_same_graph(jg, tg)
    if genome is not None:
        ids = tg.canonical_edge_ids()
        assert len(ids) == 1
        assert tg.edge_seq(int(ids[0])) in (genome, dna.revcomp_str(genome))


@pytest.mark.parametrize("name", [n for n in CASES if n != "no_pairs_no_close"])
def test_store_path_matches(name, device_path):
    """The packed-store path (prefilter on tip regions, candidate-only device
    mapping) closes the same gaps as the JAX package's store path and as the
    port's legacy path."""
    g, paired, expect, _genome_ = CASES[name]()
    r1, r2 = paired[0]
    jg, tg = both(g)
    _unused, t_legacy = both(g)
    ref = j_gc.close_gaps(
        jg, engine=JEngine(jg),
        paired_stores=[(JStore.build(r1, chunk_reads=32),
                        JStore.build(r2, rc=True, chunk_reads=32), "paired-end")])
    stats = {}
    engine = TEngine(tg, device="cpu")
    got = t_gc.close_gaps(
        tg, engine=engine,
        paired_stores=[(TStore.build(r1, chunk_reads=32),
                        TStore.build(r2, rc=True, chunk_reads=32), "paired-end")],
        stats=stats)
    assert got == ref == expect
    assert_same_graph(jg, tg)
    assert t_gc.close_gaps(t_legacy, paired, device="cpu") == got
    assert sorted(t_legacy.edge_seq(int(e)) for e in t_legacy.canonical_edge_ids()) \
        == sorted(tg.edge_seq(int(e)) for e in tg.canonical_edge_ids())
    if expect:
        assert 0 < stats["candidates"] <= stats["pairs"] == len(r1)
        # the index of the graph before the splice was built on the device path
        assert engine.index_timings.get("index_rows", 0) > 0
    if name == "prefilter_no_candidates_no_close":
        assert stats["candidates"] == 0 and stats["map_s"] == 0.0


def test_store_path_without_engine_builds_one(device_path):
    g, paired, expect, _genome_ = _case_supported()
    r1, r2 = paired[0]
    stores = [(TStore.build(r1), TStore.build(r2, rc=True), "paired-end")]
    assert t_gc.close_gaps(g, paired_stores=stores, device="cpu") == expect


def test_join_with_correction_matches():
    rng = np.random.default_rng(5)
    jcfg, tcfg = j_gc.GapCloserConfig(), t_gc.GapCloserConfig()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    poly_tail = np.concatenate([rng.integers(0, 4, 100).astype(np.uint8), np.zeros(20, np.uint8)])
    poly_head = np.concatenate([np.zeros(20, np.uint8), rng.integers(0, 4, 100).astype(np.uint8)])
    assert t_gc._join_with_correction(poly_tail, poly_head, K, tcfg) is None
    assert j_gc._join_with_correction(poly_tail, poly_head, K, jcfg) is None
    seq = rng.integers(0, 4, 400).astype(np.uint8)
    n_joined = 0
    for overlap in (8, 10, 15, 20):
        for n_err in (0, 1, 2, 3):
            tail, head = seq[:200].copy(), seq[200 - overlap :].copy()
            for j in range(n_err):
                tail[200 - overlap + 2 + 2 * j] ^= 1
            ref = j_gc._join_with_correction(tail, head, K, jcfg)
            got = t_gc._join_with_correction(tail, head, K, tcfg)
            assert (got is None) == (ref is None)
            if got is not None:
                assert np.array_equal(got, ref)
                n_joined += 1
    assert n_joined >= 6


def test_engine_release_drops_the_device_index(device_path):
    g = _case_supported()[0]
    engine = TEngine(g, device="cpu")
    assert engine._device_index() is not None and engine._prep is not None
    engine.release()
    assert engine._prep is None
    assert engine._device_index() is not None      # built again on demand
