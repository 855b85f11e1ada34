"""Port parity for the group paths of read mapping
(`spades_tpu_torch.parallel.sharded_mapping`, `alignment/mapper.py`).

The port maps, votes and prefilters a small isolate's reads on 2 gloo CPU
ranks (each rank its share of every chunk, the index replicated; mappings
and hits gathered, votes summed), on 1 rank of a group, and on one device
without a group; the JAX package does the same on its 8-device virtual mesh.
Every result must be equal.  The store's chunks hold 256 reads, so the
ranks' shares of the last chunk differ in size.  The string path of
`close_gaps` under the 2-rank group (mapping through `map_reads_sharded`)
must close the same gaps as the JAX package's `close_gaps(mesh=)`, with
equal graph arrays.
"""
import dataclasses

import numpy as np
import pytest

from spades_tpu.alignment import gap_closer as j_gc
from spades_tpu.alignment import mapper as j_mapper
from spades_tpu.core.reads import ReadBatch as JBatch
from spades_tpu.core.reads import ReadStore as JStore
from spades_tpu.graph.graph import CondensedGraph as JGraph
from spades_tpu.parallel import sharded_count as j_sc
from spades_tpu.parallel import sharded_mapping as j_sm
from spades_tpu_torch.alignment import mapper as t_mapper
from spades_tpu_torch.core import dna
from spades_tpu_torch.parallel.dryrun import GRAPH_FIELDS, RankPool, gap_task, mapping_task
from spades_tpu_torch.pipeline.construction import construct_graph
from spades_tpu_torch.tools import synthetic
from tests.test_torch_gapclose import CASES, both
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

K = 21
ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    d = tmp_path_factory.mktemp("store")
    made = {w: RankPool(w, "cpu", "gloo", f"file://{d}/w{w}", timeout_s=300) for w in (1, 2)}
    yield made
    for p in made.values():
        p.close()


@pytest.fixture(scope="module")
def case():
    _genome, r1, r2 = synthetic.make_e2e_dataset(6000, 10, 100, 0.004, seed=23,
                                                 insert_mean=250, insert_sd=20)
    reads = [ACGT[r].tobytes().decode() for r in np.concatenate([r1, r2])]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPADES_HOST_COUNT_WINDOWS", "1")
        g = construct_graph(reads, K, device="cpu").graph
    reads = reads[:701]
    reads[3] = reads[3][:40] + "NN" + reads[3][42:]
    reads[5] = reads[5][:15]                        # shorter than k
    reads[7] = dna.revcomp_str(reads[7])
    # corrupt a base of the pool so that the votes disagree with the graph
    g.seq_pool[50] = (g.seq_pool[50] + 1) % 4
    index = t_mapper.build_edge_index(g)
    tips = index.kmers[::9].copy()
    return g, index, reads, tips


def _jax(g, reads, tips):
    jg = JGraph(**dataclasses.asdict(g))
    jindex = j_mapper.build_edge_index(jg)
    mesh = j_sc.make_mesh(8)
    js = JStore.build(reads, chunk_reads=256)
    mapped = j_sm.map_reads_sharded(jindex, jg, JBatch.from_sequences(reads), mesh)
    votes = j_sm.position_votes_sharded(jindex, jg, store=js, mesh=mesh)
    hits = j_sm.hit_filter_store(js, tips, K, mesh=mesh)
    return [np.asarray(a) for a in mapped], votes, hits


def _assert_equal(got, ref):
    (me, ms, mv), (ee, es, ev), votes, hits = got
    (je, js, jv), jvotes, jhits = ref
    n = len(je)
    for a, b in ((me, je), (ms, js), (mv, jv)):
        assert np.array_equal(np.asarray(a)[:n].astype(np.int64), b.astype(np.int64))
    # the engine's map_store of the same reads: the batch's decisions
    assert np.array_equal(ee, je.astype(np.int64)) and np.array_equal(es, js.astype(np.int64))
    assert np.array_equal(votes, jvotes)
    assert np.array_equal(hits, jhits)


@pytest.mark.parametrize("where", ["one_device", "group_of_1", "group_of_2"])
def test_map_votes_hits_match_jax(pools, case, where):
    g, index, reads, tips = case
    ref = _jax(g, reads, tips)
    assert (ref[0][0] >= 0).sum() > 0.9 * len(reads) and ref[1].sum() > 0 and ref[2].any()
    if where == "one_device":
        results = [mapping_task(index, g, reads, tips, "cpu")]
    else:
        results = pools[int(where[-1])].run(mapping_task, index, g, reads, tips, "cpu",
                                            group="world")
    for got in results:
        _assert_equal(got, ref)


@pytest.mark.parametrize("name", [n for n in CASES if n != "no_pairs_no_close"])
def test_close_gaps_string_path_under_group_matches_jax(pools, name):
    g, paired, expect, _genome = CASES[name]()
    jg, _tg = both(g)
    ref = j_gc.close_gaps(jg, paired, mesh=j_sc.make_mesh(8))
    assert ref == expect
    for closed, arrays in pools[2].run(gap_task, g, paired, "cpu", group="world"):
        assert closed == ref
        for f in GRAPH_FIELDS:
            assert np.array_equal(arrays[f], getattr(jg, f)), f
