"""Port parity for the early clippers: `ops/early_clip.py`, the
`ExtensionIndex` deletion API and `construct_graph(early_at_clip=,
early_tip_clip=)`.

The cases are those of `tests/test_early_clip.py`.  Each builds one
extension index with `spades_tpu`, hands a copy to the port
(`convert.ext_index_from_arrays`), runs the same clipper in both packages
and compares the masks and the removal counts (tolerance 0: the work is
integer numpy).  Whole constructions with clipping run on inputs with poly-A
tails through both of the port's counting branches (the fused structure
table, `min_count=1` with extra sequences, and the merge branch,
`min_count=2`), at a lowered `SPADES_HOST_COUNT_WINDOWS` so the port counts
on its device path; their graphs must equal the reference's array for array.
"""
import dataclasses

import numpy as np
import pytest

from spades_tpu.ops import early_clip as j_ec
from spades_tpu.ops.count import count_sequences as j_count
from spades_tpu.ops.extension import build_extension_index as j_build
from spades_tpu.pipeline.construction import construct_graph as j_construct
from spades_tpu_torch import convert, native
from spades_tpu_torch.core import kmers as t_kmers
from spades_tpu_torch.ops import early_clip as t_ec
from spades_tpu_torch.pipeline.construction import construct_graph as t_construct
from tests.test_early_clip import clean_random_dna, mutate, tile_reads
from tests.test_torch_pipeline import THRESHOLDS, assert_same_graph, one_torch_thread


@pytest.fixture(scope="module")
def rng():
    """This file's own draws, from the session fixture's seed: its sets do
    not depend on which test files ran before it in the same worker."""
    return np.random.default_rng(42)


def _pair(seqs, k):
    """One index built by the reference, and the port's copy of it."""
    j_index = j_build(j_count(seqs, k + 1))
    return j_index, convert.ext_index_from_arrays(dataclasses.asdict(j_index))


def _same_masks(j_index, t_index):
    assert np.array_equal(j_index.in_mask, t_index.in_mask)
    assert np.array_equal(j_index.out_mask, t_index.out_mask)


def _tip_set(rng, k, n=400, at=50, pos_from_end=4):
    genome = clean_random_dna(rng, n, k)
    reads = tile_reads(genome, 3 * k, 3)
    bad = mutate(genome[at : at + 3 * k], 3 * k - pos_from_end, rng)
    return reads + [bad]


def _polya_set(rng, k, n=300):
    """A genome's reads, two reads running off into poly-A / poly-T and two
    into A-rich tails with sporadic other bases (tips, not self-loops)."""
    genome = clean_random_dna(rng, n, k)
    reads = tile_reads(genome, 3 * k, 3)
    rich = ["".join(c if rng.random() < 0.85 else str(rng.choice(list("CGT")))
                    for c in "A" * 40) for _ in range(2)]
    return reads + [genome[30:60] + "A" * 25, genome[200:240] + "T" * 30,
                    genome[100:130] + rich[0], genome[260:290] + rich[1]]


# -- the mask-level deletion API -------------------------------------------------

@pytest.mark.parametrize("method", ["delete_outgoing", "delete_incoming"])
@pytest.mark.parametrize("rc", [False, True])
def test_deletion_api_matches(rng, method, rc):
    k = 11
    j_index, t_index = _pair([clean_random_dna(rng, 60, k)], k)
    rows = np.flatnonzero((j_index.out_mask | j_index.in_mask) > 0)[:6]
    o = np.full(rows.size, rc)
    c = np.arange(rows.size, dtype=np.uint8) % 4
    # repeat a row: the batched update must be duplicate-safe in both
    rows, o, c = np.append(rows, rows[0]), np.append(o, o[0]), np.append(c, (c[0] + 1) % 4)
    getattr(j_index, method)(rows, o, c)
    getattr(t_index, method)(rows, o, c)
    _same_masks(j_index, t_index)


def test_isolate_matches(rng):
    k = 11
    j_index, t_index = _pair([clean_random_dna(rng, 40, k)], k)
    rows = np.arange(0, j_index.num_kmers, 3)
    j_index.isolate(rows)
    t_index.isolate(rows)
    _same_masks(j_index, t_index)
    t_index.isolate(np.arange(t_index.num_kmers))
    assert not t_index.in_mask.any() and not t_index.out_mask.any()


def test_fix_forward_links_matches(rng):
    k = 11
    j_index, t_index = _pair(_tip_set(rng, k), k)
    rows = np.flatnonzero(j_index.out_mask > 0)[:20]
    j_ec.isolate_rows(j_index, rows[::2])
    t_ec.isolate_rows(t_index, rows[::2])
    o = np.zeros(rows.size, bool)
    assert t_ec.fix_forward_links(t_index, rows, o) == j_ec.fix_forward_links(j_index, rows, o)
    _same_masks(j_index, t_index)


# -- the early tip clipper ---------------------------------------------------------

@pytest.mark.parametrize("k, bound, chunk", [(11, 22, 1 << 18), (21, 42, 1 << 18),
                                             (11, 3, 1 << 18), (15, 30, 8)])
def test_clip_tips_early_matches(rng, k, bound, chunk):
    seqs = _tip_set(rng, k, n=600)
    seqs += [mutate(seqs[0][:3 * k], 5, rng)]                  # a branch longer than 3
    j_index, t_index = _pair(seqs, k)
    n = t_ec.clip_tips_early(t_index, bound, chunk_branches=chunk)
    assert n == j_ec.clip_tips_early(j_index, bound, chunk_branches=chunk)
    _same_masks(j_index, t_index)
    if bound > 3:
        assert n > 0


def test_equal_length_tips_both_kept_as_in_the_reference(rng):
    k = 11
    j_index, t_index = _pair(_tip_set(rng, k, n=200), k)
    assert t_ec.clip_tips_early(t_index, 2 * k) == j_ec.clip_tips_early(j_index, 2 * k)
    _same_masks(j_index, t_index)


# -- the early A/T clipper ---------------------------------------------------------

def test_base_counts_match():
    words = t_kmers.pack(np.random.default_rng(5).integers(0, 4, (64, 37)).astype(np.uint8))
    for k in (11, 21, 37):
        w = words[:, : t_kmers.kmer_words(k)]
        assert np.array_equal(t_ec.base_counts(w, k), j_ec.base_counts(w, k))


@pytest.mark.parametrize("ratio", [0.8, 0.5])
def test_remove_at_edges_matches(rng, ratio):
    k = 11
    j_index, t_index = _pair(_polya_set(rng, k), k)
    assert t_ec.remove_at_edges(t_index, ratio) == j_ec.remove_at_edges(j_index, ratio)
    _same_masks(j_index, t_index)


@pytest.mark.parametrize("k, chunk", [(11, 1 << 18), (21, 1 << 18), (11, 4)])
def test_remove_at_tips_matches(rng, k, chunk):
    j_index, t_index = _pair(_polya_set(rng, k, n=400), k)
    n = t_ec.remove_at_tips(t_index, chunk_branches=chunk)
    assert n == j_ec.remove_at_tips(j_index, chunk_branches=chunk)
    assert n > 0
    _same_masks(j_index, t_index)


def test_high_complexity_tip_survives_the_at_clipper(rng):
    k = 11
    j_index, t_index = _pair(_tip_set(rng, k, n=300), k)
    before = t_index.out_mask.copy(), t_index.in_mask.copy()
    assert t_ec.remove_at_edges(t_index) == j_ec.remove_at_edges(j_index) == 0
    assert t_ec.remove_at_tips(t_index) == j_ec.remove_at_tips(j_index) == 0
    assert np.array_equal(before[0], t_index.out_mask)
    assert np.array_equal(before[1], t_index.in_mask)


# -- construct_graph with the clippers, on both counting branches ------------------

@pytest.fixture(scope="module")
def lowered():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPADES_HOST_COUNT_WINDOWS", THRESHOLDS["SPADES_HOST_COUNT_WINDOWS"])
        yield mp


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "no_native"])
@pytest.mark.parametrize("min_count", [1, 2])
@pytest.mark.parametrize("clip", [{"early_at_clip": True},
                                  {"early_tip_clip": True, "early_tc_length_bound": 30},
                                  {"early_tip_clip": True, "read_length": 45},
                                  {"early_at_clip": True, "early_tip_clip": True}])
def test_construct_graph_with_clipping_matches(rng, lowered, monkeypatch, min_count, clip,
                                               use_native):
    """Reads with poly-A/T tails and error tips; the previous K's contigs as
    extra sequences take the fused branch at min_count 1 and the merge
    branch at 2.  Without the native library the clipped index condenses
    through the torch pair from its masks."""
    if not use_native:
        monkeypatch.setattr(native, "lib", lambda: None)
    k = 15
    genome = clean_random_dna(rng, 900, k)
    reads = tile_reads(genome, 45, 2) * min_count
    reads += [genome[100:140] + "A" * 30, genome[500:530] + "T" * 28] * min_count
    reads += [mutate(genome[p : p + 45], 40, rng) for p in (60, 300, 700)] * min_count
    extras = [genome[:400], genome[350:]]
    jr = j_construct(reads, k, min_count=min_count, extra_sequences=extras, **clip)
    tr = t_construct(reads, k, min_count=min_count, extra_sequences=extras, device="cpu",
                     **clip)
    assert_same_graph(jr.graph, tr.graph)
    _same_masks(jr.index, tr.index)
    assert "early_clip_s" in tr.timings
    plain = t_construct(reads, k, min_count=min_count, extra_sequences=extras, device="cpu")
    assert plain.graph.num_edges > tr.graph.num_edges


def test_early_at_clip_cleans_the_poly_a_tip_as_the_reference(rng, lowered):
    k = 11
    genome = clean_random_dna(rng, 300, k)
    reads = tile_reads(genome, 3 * k, 3) + [genome[30:60] + "A" * 25]
    jg = j_construct(reads, k, early_at_clip=True).graph
    tg = t_construct(reads, k, early_at_clip=True, device="cpu").graph
    assert_same_graph(jg, tg)
    tg.check_invariants()
    assert len(tg.canonical_edge_ids()) == 1
