"""Port parity for careful mode: `alignment/mismatch.py`, the device vote
`parallel/sharded_mapping.py:position_votes_sharded` and the
MismatchCorrection stage, against `spades_tpu`, exactly.

Graphs are built from seeded reads of a random genome at k=21, and some of
their edge bases are then flipped (on both strands) so that the read
consensus has something to fix.  The port runs with `device="cpu"`; the JAX
package votes on its 8-device virtual mesh.  The last test assembles a
30,000-nt `make_e2e_dataset` genome at K=55 with `careful=True` in both
packages, device thresholds lowered, and holds every output file equal.
"""
import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from spades_tpu.alignment import mapper as j_mapper
from spades_tpu.alignment import mismatch as j_mm
from spades_tpu.core.reads import ReadStore as JStore
from spades_tpu.graph.graph import CondensedGraph as JGraph
from spades_tpu.parallel import sharded_mapping as j_sm
from spades_tpu.pipeline import run as j_run
from spades_tpu_torch import convert
from spades_tpu_torch.alignment import mapper as t_mapper
from spades_tpu_torch.alignment import mismatch as t_mm
from spades_tpu_torch.core.reads import ReadBatch as TBatch
from spades_tpu_torch.core.reads import ReadStore as TStore
from spades_tpu_torch.ops.count import unpack_batch_device
from spades_tpu_torch.parallel import sharded_mapping as t_sm
from spades_tpu_torch.pipeline import run as t_run
from spades_tpu_torch.pipeline import spades_stages as t_stages
from spades_tpu_torch.pipeline import stages as t_stage_rt
from spades_tpu_torch.pipeline.construction import construct_graph as t_construct
from spades_tpu_torch.tools import synthetic
from tests.test_torch_pipeline import GRAPH_FIELDS, THRESHOLDS, assert_same_file, one_torch_thread

K = 21
ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(21)
    genome = rng.integers(0, 4, 6000).astype(np.uint8)
    starts = rng.integers(0, len(genome) - 100, 1500)
    r = genome[starts[:, None] + np.arange(100)]
    rc = rng.random(len(r)) < 0.5
    r[rc] = (3 - r[rc])[:, ::-1]
    em = rng.random(r.shape) < 0.004
    r[em] = (r[em] + 1) & 3
    seqs = [s.tobytes().decode() for s in ACGT[r]]
    seqs[5] = seqs[5][:30] + "N" + seqs[5][31:]
    return seqs


def _corrupted_graph(reads, n_flips=12, seed=3):
    """The k=21 graph of the reads with `n_flips` edge bases flipped (and
    their conjugate bases), as (JAX graph, port graph, flipped pool rows)."""
    g = t_construct(reads, K, min_count=2, device="cpu").graph
    rng = np.random.default_rng(seed)
    ids = g.canonical_edge_ids()
    long_ = ids[g.e_len[ids] > 200]
    flipped = []
    for e in rng.choice(long_, min(n_flips, len(long_)), replace=False):
        o, n, ec = int(g.e_off[e]), int(g.e_len[e]), int(g.e_conj[e])
        p = int(rng.integers(K, n - K))
        g.seq_pool[o + p] = (g.seq_pool[o + p] + 1) & 3
        if ec != e:
            g.seq_pool[int(g.e_off[ec]) + n - 1 - p] = 3 - g.seq_pool[o + p]
        flipped.append(o + p)
    d = dataclasses.asdict(g)
    return JGraph(**copy.deepcopy(d)), convert.graph_from_arrays(d), np.array(flipped)


def _assert_same_graph(jg, tg):
    for f in GRAPH_FIELDS:
        assert np.array_equal(getattr(jg, f), getattr(tg, f)), f
    tg.check_invariants()


def test_position_votes_match(reads):
    jg, tg, flipped = _corrupted_graph(reads)
    got = t_mm.position_votes(tg, reads, device="cpu")
    ref = j_mm.position_votes(jg, reads)
    assert got.dtype == np.int32 and np.array_equal(got, ref)
    assert got[flipped].sum() > 0


@pytest.mark.parametrize("source", ["store", "batch", "store_small_slices"])
def test_position_votes_sharded_match(reads, source, monkeypatch):
    jg, tg, _f = _corrupted_graph(reads)
    t_index, j_index = t_mapper.build_edge_index(tg), j_mapper.build_edge_index(jg)
    if source == "batch":
        tb = TBatch.from_sequences(reads)
        got = t_sm.position_votes_sharded(t_index, tg, batch=tb, device="cpu")
        from spades_tpu.core.reads import ReadBatch as JBatch

        ref = j_sm.position_votes_sharded(j_index, jg, batch=JBatch.from_sequences(reads))
    else:
        ts, js = TStore.build(reads, chunk_reads=512), JStore.build(reads, chunk_reads=512)
        if source == "store_small_slices":
            monkeypatch.setattr(t_sm, "VOTE_SUBCHUNK", 64)
        got = t_sm.position_votes_sharded(t_index, tg, store=ts, device="cpu")
        ref = j_sm.position_votes_sharded(j_index, jg, store=js)
    assert got.dtype == np.int32 and got.shape == (len(tg.seq_pool), 4)
    assert np.array_equal(got, ref) and got.sum() > 0
    # the scatter against its plain numpy version, from the same mappings
    b = TBatch.from_sequences(reads)
    pc, pn, lengths, L = (torch.from_numpy(a) if not isinstance(a, int) else a
                          for a in b.packed())
    prep = t_sm.prepare_index_device(t_index, tg, "cpu")
    edge, start, _v = t_sm._map_shard_body(pc, pn, lengths, *prep, k=K, L=L)
    codes, n_mask = unpack_batch_device(pc, pn, L)
    plain = t_sm.votes_plain(codes.numpy(), n_mask.numpy(), lengths.numpy(), edge.numpy(),
                             start.numpy(), tg.e_len, tg.e_off, len(tg.seq_pool))
    dev = t_sm._votes_shard_body(pc, pn, lengths, *prep,
                                 torch.from_numpy(tg.e_off.astype(np.int32)), k=K, L=L,
                                 pool_len=len(tg.seq_pool))
    assert np.array_equal(dev.numpy(), plain) and np.array_equal(plain, ref)


def test_vote_halves_its_slice_on_out_of_memory_only(reads, monkeypatch):
    _jg, tg, _f = _corrupted_graph(reads)
    index = t_mapper.build_edge_index(tg)
    ts = TStore.build(reads * 12, chunk_reads=1 << 16)       # one chunk of 32,768 rows
    ref = t_sm.position_votes_sharded(index, tg, store=ts, device="cpu")
    calls = []
    real = t_sm._votes_shard_body

    def oom_above(limit):
        def body(pc, *a, **kw):
            calls.append(pc.shape[0])
            if pc.shape[0] > limit:
                raise torch.cuda.OutOfMemoryError("test")
            return real(pc, *a, **kw)
        return body

    monkeypatch.setattr(t_sm, "VOTE_SUBCHUNK", 1 << 15)
    monkeypatch.setattr(t_sm, "_votes_shard_body", oom_above(8192))
    got = t_sm.position_votes_sharded(index, tg, store=ts, device="cpu")
    assert np.array_equal(got, ref) and calls == [32768, 16384, 8192, 8192, 8192, 8192]
    calls.clear()
    monkeypatch.setattr(t_sm, "_votes_shard_body", oom_above(100))
    with pytest.raises(torch.cuda.OutOfMemoryError):        # 8,192 is the floor
        t_sm.position_votes_sharded(index, tg, store=ts, device="cpu")
    assert calls == [32768, 16384, 8192]

    def fails(*a, **kw):
        raise RuntimeError("not a memory error")

    monkeypatch.setattr(t_sm, "_votes_shard_body", fails)
    with pytest.raises(RuntimeError, match="not a memory error"):
        t_sm.position_votes_sharded(index, tg, store=ts, device="cpu")


def test_store_narrower_than_k_casts_no_vote(reads):
    _jg, tg, _f = _corrupted_graph(reads)
    short = TStore.build([r[:12] for r in reads[:50]])
    assert short.chunks[0].L < K
    got = t_sm.position_votes_sharded(t_mapper.build_edge_index(tg), tg, store=short,
                                      device="cpu")
    assert got.shape == (len(tg.seq_pool), 4) and not got.any()


@pytest.mark.parametrize("path", ["legacy", "store", "store_engine"])
def test_correct_mismatches_matches(reads, path, monkeypatch):
    jg, tg, flipped = _corrupted_graph(reads)
    before = tg.seq_pool[flipped].copy()
    if path == "legacy":
        got = t_mm.correct_mismatches(tg, reads, device="cpu")
        ref = j_mm.correct_mismatches(jg, reads)
    else:
        ts, js = TStore.build(reads, chunk_reads=700), JStore.build(reads, chunk_reads=700)
        if path == "store_engine":
            monkeypatch.setenv("SPADES_DEVICE_INDEX_POOL", "1")
            eng = t_mapper.MappingEngine(tg, device="cpu")
            got = t_mm.correct_mismatches(tg, store=ts, engine=eng)
            assert eng._index is None           # the device vote needs no host index
            ref = j_mm.correct_mismatches(jg, store=js, engine=j_mapper.MappingEngine(jg))
        else:
            got = t_mm.correct_mismatches(tg, store=ts, device="cpu")
            ref = j_mm.correct_mismatches(jg, store=js)
    assert got == ref >= len(flipped) // 2
    assert (tg.seq_pool[flipped] != before).sum() >= len(flipped) // 2
    _assert_same_graph(jg, tg)


def test_correct_mismatches_needs_a_card_unless_asked_for_the_cpu(reads, monkeypatch):
    _jg, tg, _f = _corrupted_graph(reads)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_mm.correct_mismatches(tg, reads)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_sm.position_votes_sharded(t_mapper.build_edge_index(tg), tg,
                                    store=TStore.build(reads))


# -- careful mode in the assembly ----------------------------------------------------

@pytest.fixture(scope="module")
def careful_runs(tmp_path_factory):
    _g, r1, r2 = synthetic.make_e2e_dataset(30_000, 30, 100, 0.004, seed=4,
                                            insert_mean=300, insert_sd=20)
    lefts = [s.tobytes().decode() for s in ACGT[r1]]
    rights = [s.tobytes().decode() for s in ACGT[r2]]
    out = tmp_path_factory.mktemp("careful")
    with pytest.MonkeyPatch.context() as mp:
        for name, value in THRESHOLDS.items():
            mp.setenv(name, value)
        jres = j_run.run_assembly(lefts + rights, [55], str(out / "j"),
                                  paired_libs=[(lefts, rights)], read_length=100,
                                  careful=True, checkpoints="all")
        t_stage_rt.STAGE_TIMES.clear()
        t_stages.MISMATCH_STATS.clear()
        tres = t_run.run_assembly(lefts + rights, [55], str(out / "t"),
                                  paired_libs=[(lefts, rights)], read_length=100,
                                  careful=True, checkpoints="all", device="cpu")
    trails = ([s for _k, s, _t in t_stage_rt.STAGE_TIMES], list(t_stages.MISMATCH_STATS))
    return str(out / "j"), str(out / "t"), jres, tres, trails


@pytest.mark.parametrize("name", ["contigs.fasta", "scaffolds.fasta", "contigs.paths",
                                  "scaffolds.paths", "assembly_graph.fastg",
                                  "assembly_graph_with_scaffolds.gfa"])
def test_careful_run_files_match(careful_runs, name):
    jdir, tdir = careful_runs[:2]
    for sub in ("", "K55"):
        assert_same_file(os.path.join(jdir, sub, name), os.path.join(tdir, sub, name))


def test_careful_run_graph_and_stages(careful_runs):
    jdir, tdir, jres, tres, (stages, mm) = careful_runs
    _assert_same_graph(jres.graph, tres.graph)
    assert stages.index("mismatch_correction") == stages.index("pair_info_count") - 1
    assert len(mm) == 1 and mm[0][0] == 55
    saved = os.path.join(tdir, "K55", "saves", "mismatch_correction")
    assert os.path.isdir(saved) and os.path.isdir(
        os.path.join(jdir, "K55", "saves", "mismatch_correction"))
