"""Port parity for the read-mapping slice: the edge index (host and device
builds), the multi-plane search, the per-read vote, `MappingEngine`,
`map_read_batch`, the tip prefilter and `KmerMapper`.

The same numpy inputs (made from a seed) go through `spades_tpu` and
`spades_tpu_torch`; results must be exactly equal (integer work, tolerance
0).  Under tests/conftest.py JAX sees 8 virtual devices, so the JAX package
maps on an 8-way mesh; the port's single-device results must still equal it.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spades_tpu.alignment import kmer_mapper as j_kmapper
from spades_tpu.alignment import mapper as j_mapper
from spades_tpu.core import reads as JR
from spades_tpu.graph.graph import CondensedGraph as JGraph
from spades_tpu.parallel import sharded_mapping as JM
from spades_tpu_torch import convert
from spades_tpu_torch.alignment import kmer_mapper as t_kmapper
from spades_tpu_torch.alignment import mapper as t_mapper
from spades_tpu_torch.core import dna
from spades_tpu_torch.core import kmers as TK
from spades_tpu_torch.core import reads as TR
from spades_tpu_torch.graph.graph import CondensedGraph as TGraph
from spades_tpu_torch.parallel import sharded_mapping as TM
from spades_tpu_torch.pipeline.construction import construct_graph as t_construct
from spades_tpu_torch.tools import synthetic

K_MAP = 21
ACGT = np.frombuffer(b"ACGT", np.uint8)


def _str(codes):
    return ACGT[codes].tobytes().decode()


def _jgraph(g):
    return JGraph(**dataclasses.asdict(g))


def _keys_t(words):
    """(N, W) uint32 words -> (nK, N) int64 key planes as a tensor."""
    return torch.from_numpy(np.ascontiguousarray(TK.words_to_keys(words).T))


@pytest.fixture(scope="module")
def assembled():
    """A graph built by the port's construct_graph on a small synthetic
    isolate (many edges, junction k-mers shared between edges), plus two
    longer isolated edges so that every index row tier is used, and the reads
    (with an N and a short read among them)."""
    genome, r1, r2 = synthetic.make_e2e_dataset(5000, 12, 100, 0.004, seed=17,
                                                insert_mean=250, insert_sd=20)
    reads = [_str(r) for r in np.concatenate([r1, r2])]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPADES_HOST_COUNT_WINDOWS", "1")
        g = t_construct(reads, K_MAP, device="cpu").graph
    rng = np.random.default_rng(5)
    for n in (1000, 9000):
        long_edge = rng.integers(0, 4, n).astype(np.uint8)
        v0 = g.num_vertices
        g.v_conj = np.append(g.v_conj, [v0 + 2, v0 + 3, v0, v0 + 1])
        g.add_edge_pair(v0, v0 + 1, long_edge)
    reads = reads[:600] + [_str(long_edge[a : a + 100]) for a in (0, 4000, 8900)]
    reads[3] = reads[3][:40] + "NN" + reads[3][42:]
    reads[5] = reads[5][:15]                    # shorter than k
    reads[7] = dna.revcomp_str(reads[7])
    return g, reads


@pytest.fixture
def device_path(monkeypatch):
    monkeypatch.setenv("SPADES_DEVICE_MAP_READS", "1")
    monkeypatch.setenv("SPADES_DEVICE_INDEX_POOL", "1")
    monkeypatch.setenv("SPADES_MAP_SUBCHUNK", "256")


def _j_prep_np(prep):
    """The JAX package's device index tuple as numpy, pow2 pad rows dropped
    and duplicate k-mers reduced to their first row."""
    words, edge, off, strand, conj, e_len = (np.asarray(a) for a in prep)
    real = ~np.all(words == 0xFFFFFFFF, axis=1)
    first = np.concatenate([[True], np.any(words[1:] != words[:-1], axis=1)])
    keep = real & first
    return words[keep], edge[keep], off[keep], strand[keep], conj, e_len


def _t_prep_np(prep, W):
    keys, edge, off, strand, conj, e_len = (a.numpy() for a in prep)
    return (TK.keys_to_words(np.ascontiguousarray(keys.T), W), edge, off, strand,
            conj, e_len)


@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_device_searchsorted_rows_matches_jax(W):
    rng = np.random.default_rng(W)
    hay = np.unique(rng.integers(0, 2**32, (500, W), dtype=np.uint64).astype(np.uint32),
                    axis=0)
    hay[100:120, : max(W - 1, 1)] = hay[100, : max(W - 1, 1)]   # long shared prefixes
    hay = np.concatenate([hay, hay[40:60], hay[40:45],          # duplicate rows
                          np.full((8, W), 0xFFFFFFFF, np.uint32)])   # sentinel tail
    hay = hay[np.lexsort(tuple(hay[:, w] for w in range(W - 1, -1, -1)))]
    needles = np.concatenate([
        hay[::7], rng.integers(0, 2**32, (50, W), dtype=np.uint64).astype(np.uint32),
        np.full((2, W), 0xFFFFFFFF, np.uint32), np.zeros((1, W), np.uint32),
        hay[:1], hay[-9:-7],
    ])
    ref = np.asarray(JM.device_searchsorted_rows(jnp.asarray(hay), jnp.asarray(needles)))
    got = TM.device_searchsorted_rows(_keys_t(hay), _keys_t(needles))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)
    assert (ref >= 0).sum() > 70 and (ref < 0).sum() > 40
    # an empty table answers -1 everywhere
    empty = TM.device_searchsorted_rows(_keys_t(hay[:0]), _keys_t(needles))
    assert (empty.numpy() == -1).all()


def test_build_edge_index_matches_jax(assembled):
    g, _ = assembled
    for k in (K_MAP, 15):
        ref = j_mapper.build_edge_index(_jgraph(g), k)
        got = t_mapper.build_edge_index(g, k)
        assert got.k == ref.k == k
        for f in ("kmers", "edge", "offset", "strand"):
            a, b = getattr(got, f), getattr(ref, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    back = convert.edge_index_from_arrays(dataclasses.asdict(ref))
    assert np.array_equal(back.kmers, got.kmers) and back.k == 15
    empty = t_mapper.build_edge_index(TGraph.from_sequences([], K_MAP))
    assert empty.kmers.shape == (0, 2)


@pytest.mark.parametrize("k", [K_MAP, 55])
def test_index_device_builds_match_each_other_and_jax(assembled, k):
    """`build_index_device` equals `prepare_index_device(build_edge_index)`
    array for array, and both answer like the JAX package's two builds."""
    g, _ = assembled
    W = TK.kmer_words(k)
    index = t_mapper.build_edge_index(g, k)
    prep = TM.prepare_index_device(index, g, "cpu")
    built = TM.build_index_device(g, k, "cpu")
    assert len(prep) == len(built) == 6
    for a, b in zip(prep, built):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert prep[0].dtype == torch.int64 and prep[1].dtype == torch.int32
    lens = g.e_len[g.canonical_edge_ids()]       # all three row tiers are used
    assert (lens <= 256).any() and ((lens > 256) & (lens <= 2048)).any() and (lens > 2048).any()
    jg = _jgraph(g)
    j_prep = _j_prep_np(JM.prepare_index_device(j_mapper.build_edge_index(jg, k), jg))
    j_built = _j_prep_np(JM.build_index_device(jg, k))
    E = len(g.e_conj)
    for ref in (j_prep, j_built):
        for a, b in zip(_t_prep_np(built, W)[:4], ref[:4]):
            assert np.array_equal(a, b)
        assert np.array_equal(built[4].numpy(), ref[4][:E])
        assert np.array_equal(built[5].numpy(), ref[5][:E])
    # a graph without an edge of k bases gives an empty index
    tiny = TGraph.from_sequences(["ACGTTGCATGCATGGATCCATG"], K_MAP)
    assert TM.build_index_device(tiny, 25, "cpu")[0].shape == (1, 0)


def _chimera_reads(rng, genome):
    """Reads on a one-edge graph: forward, reverse-strand, with N, ragged,
    unmappable, and chimeras whose two halves tie at 10 windows each."""
    reads = []
    for i in range(40):
        a = int(rng.integers(0, len(genome) - 60))
        r = genome[a : a + int(rng.integers(30, 61))]
        reads.append(r if i % 2 == 0 else dna.revcomp_str(r))
    reads[4] = reads[4][:25] + "N" + reads[4][26:]
    reads.append(_str(rng.integers(0, 4, 60).astype(np.uint8)))      # maps nowhere
    for a, b in ((100, 300), (350, 40), (200, 420)):                 # ties: 10 vs 10
        reads.append(genome[a : a + 30] + genome[b : b + 30])
    reads.append(dna.revcomp_str(genome[120:150]) + genome[310:340])
    return reads


def test_map_shard_core_matches_jax_with_ties_and_reverse_strand():
    rng = np.random.default_rng(3)
    genome = _str(rng.integers(0, 4, 600).astype(np.uint8))
    g = TGraph.from_sequences([genome], K_MAP)
    jg = _jgraph(g)
    reads = _chimera_reads(rng, genome)
    batch = TR.ReadBatch.from_sequences(reads)
    j_prep = JM.prepare_index_device(j_mapper.build_edge_index(jg), jg)
    ref = JM._map_shard_core(jnp.asarray(batch.codes), jnp.asarray(batch.lengths),
                             jnp.asarray(batch.n_mask), *j_prep, k=K_MAP, axis="d")
    prep = TM.prepare_index_device(t_mapper.build_edge_index(g), g, "cpu")
    pc, pn, ln, L = batch.packed()
    got = TM._map_shard_body(*(torch.from_numpy(a) for a in (pc, pn, ln)), *prep,
                             k=K_MAP, L=L)
    for a, b in zip(got, ref):
        assert a.dtype == torch.int32
        assert np.array_equal(a.numpy(), np.asarray(b))
    edge, start, votes = (a.numpy() for a in got)
    n = len(reads)
    assert (edge[:40] >= 0).all() and edge[40] == -1 and votes[40] == 0
    assert set(edge[:40].tolist()) == {0, 1}             # both strands were hit
    assert (votes[41:n] == 10).all()                      # the tied chimeras
    # the tie goes to the first run in (edge, start) order
    assert edge[41] == 0 and start[41] == 100 and start[42] == 10 and start[43] == 200
    # the same through the public wrappers, index uploaded by the call
    e2, s2, v2 = TM.map_reads_sharded(t_mapper.build_edge_index(g), g, batch, "cpu")
    je, js, jv = JM.map_reads_sharded(j_mapper.build_edge_index(jg), jg, batch)
    assert np.array_equal(e2, je) and np.array_equal(s2, js) and np.array_equal(v2, jv)
    # an empty index maps nothing
    none = TM._map_shard_body(*(torch.from_numpy(a) for a in (pc, pn, ln)),
                              *TM._empty_index(K_MAP, torch.device("cpu")), *prep[4:],
                              k=K_MAP, L=L)
    assert (none[0].numpy() == -1).all() and (none[2].numpy() == 0).all()


def test_pair_info_matches_jax():
    rng = np.random.default_rng(9)
    genome = _str(rng.integers(0, 4, 700).astype(np.uint8))
    g = TGraph.from_sequences([genome], K_MAP)
    ins, rlen = 200, 60
    starts = rng.integers(0, len(genome) - ins, 32)
    b1 = TR.ReadBatch.from_sequences([genome[a : a + rlen] for a in starts])
    b2 = TR.ReadBatch.from_sequences(
        [dna.revcomp_str(genome[a + ins - rlen : a + ins]) for a in starts])
    index = t_mapper.build_edge_index(g)
    e1, s1, _ = TM.map_reads_sharded(index, g, b1, "cpu")
    e2, s2, _ = TM.map_reads_sharded(index, g, b2, "cpu")
    got = TM.pair_info_sharded(g, e1, s1, e2, s2, insert_size=ins)
    ref = JM.pair_info_sharded(_jgraph(g), e1, s1, e2, s2, insert_size=ins)
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)
    assert len(got[0]) == 32 and (got[0] == got[1]).all() and np.abs(got[2]).max() <= 2


def _stores(reads, chunk_reads):
    return (TR.ReadStore.build(reads, chunk_reads=chunk_reads),
            JR.ReadStore.build(reads, chunk_reads=chunk_reads))


@pytest.mark.parametrize("index_on_device", [True, False])
def test_map_store_device_path_matches_jax(assembled, device_path, monkeypatch,
                                           index_on_device):
    g, reads = assembled
    if not index_on_device:
        monkeypatch.setenv("SPADES_DEVICE_INDEX_POOL", str(10**9))
    ts, js = _stores(reads, 512)
    eng = t_mapper.MappingEngine(g, device="cpu")
    got = eng.map_store(ts)
    ref = j_mapper.MappingEngine(_jgraph(g)).map_store(js)
    assert (eng._index is None) == index_on_device      # the device build needs no host index
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype == np.int64 and np.array_equal(a, b)
    edge, _, votes = got
    assert (edge >= 0).mean() > 0.95 and edge[5] == -1 and votes[3] > 0
    assert (edge[-3:] == len(g.e_conj) - 2).all()       # the long edge's reads


def test_map_store_host_path_and_residue_match_jax(assembled, monkeypatch):
    g, reads = assembled
    ts, js = _stores(reads[:80], 64)
    got = t_mapper.MappingEngine(g, device="cpu").map_store(ts)   # below the threshold
    ref = j_mapper.MappingEngine(_jgraph(g)).map_store(js)
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)
    # device path with a kmer-mapper: the unmapped residue re-runs on the host
    monkeypatch.setenv("SPADES_DEVICE_MAP_READS", "1")
    variant = reads[10][:50] + ("A" if reads[10][50] != "A" else "C") + reads[10][51:]
    kmappers = []
    for mod in (t_kmapper, j_kmapper):
        m = mod.KmerMapper(k=K_MAP)
        m.remap_sequences(variant[30:71], reads[10][30:71])
        kmappers.append(m)
    only = [variant[30:71]]       # every window holds the variant base
    ts, js = _stores(only, 64)
    got = t_mapper.MappingEngine(g, device="cpu").map_store(ts, kmer_mapper=kmappers[0])
    ref = j_mapper.MappingEngine(_jgraph(g)).map_store(js, kmer_mapper=kmappers[1])
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)
    plain = t_mapper.MappingEngine(g, device="cpu").map_store(ts)
    assert got[2][0] > plain[2][0]


@pytest.mark.parametrize("index_on_device, sub", [(True, 131072), (False, 7)])
def test_residue_pass_equals_the_host_pass_and_jax(assembled, device_path, monkeypatch,
                                                    index_on_device, sub):
    """Many reads whose every window holds a glued base, on both strands, at
    several lengths, with Ns, shorter than k, or not glued at all: the
    residue pass on the device index maps each as `map_read_batch`'s host
    path does, and the whole store as the JAX package does."""
    g, reads = assembled
    if not index_on_device:
        monkeypatch.setenv("SPADES_DEVICE_INDEX_POOL", str(10**9))
    rng = np.random.default_rng(21)
    swap = {"A": "C", "C": "G", "G": "T", "T": "A", "N": "N"}
    kmappers = [mod.KmerMapper(k=K_MAP) for mod in (t_kmapper, j_kmapper)]
    residue = []
    for i in rng.choice(600, 60, replace=False):
        orig = reads[i]
        if len(orig) < 60 or "N" in orig:
            continue
        var = list(orig)
        for p in range(int(rng.integers(0, 12)), len(var), 15):
            var[p] = swap[var[p]]
        var = "".join(var)
        if len(residue) % 5 != 4:               # every fifth stays unglued
            for m in kmappers:
                m.remap_sequences(var, orig)
        cut = int(rng.integers(K_MAP, len(var) + 1))
        residue.append(var[:cut] if len(residue) % 3 == 1 else var)
    residue[1] = dna.revcomp_str(residue[1])
    residue[2] = residue[2][:30] + "N" + residue[2][31:]
    residue[3] = residue[3][: K_MAP - 1]         # shorter than k
    store_reads = reads[:200] + residue
    ts, js = _stores(store_reads, 64)
    eng = t_mapper.MappingEngine(g, device="cpu")
    monkeypatch.setenv("SPADES_MAP_SUBCHUNK", str(sub))
    got = eng.map_store(ts, kmer_mapper=kmappers[0])
    ref = j_mapper.MappingEngine(_jgraph(g)).map_store(js, kmer_mapper=kmappers[1])
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)
    stats = t_mapper.RESIDUE_STATS[-1]
    assert stats["rerun"] > 50 and 0 < stats["recovered"] < stats["rerun"]
    # read for read against the host path on the residue alone
    host = t_mapper.map_read_batch(eng.index, g, residue, kmer_mapper=kmappers[0],
                                   _force_host=True)
    e, s, v = eng._map_residue([dna.encode(r) for r in residue], kmappers[0])
    assert e.tolist() == [m.edge if m else -1 for m in host]
    assert s.tolist() == [m.start_offset if m else 0 for m in host]
    assert v.tolist() == [m.n_hits if m else 0 for m in host]


def test_map_read_batch_matches_jax(assembled, monkeypatch):
    g, reads = assembled
    jg = _jgraph(g)
    t_index, j_index = t_mapper.build_edge_index(g), j_mapper.build_edge_index(jg)
    got_host = t_mapper.map_read_batch(t_index, g, reads, device="cpu")
    ref_host = j_mapper.map_read_batch(j_index, jg, reads)
    assert [dataclasses.astuple(m) if m else None for m in got_host] == \
           [dataclasses.astuple(m) if m else None for m in ref_host]
    # above the threshold both packages take their device path
    monkeypatch.setenv("SPADES_DEVICE_MAP_READS", "1")
    got = t_mapper.map_read_batch(t_index, g, reads, device="cpu")
    ref = j_mapper.map_read_batch(j_index, jg, reads)
    assert [dataclasses.astuple(m) if m else None for m in got] == \
           [dataclasses.astuple(m) if m else None for m in ref]
    # device and host verdicts agree wherever the vote is not tied
    agree = sum(1 for a, b in zip(got, got_host)
                if (a is None) == (b is None) and (a is None or a.edge == b.edge))
    assert agree >= 0.98 * len(reads)
    assert t_mapper.map_read_batch(t_index, g, ["ACGT"], device="cpu") == [None]


def test_device_path_hides_no_failure(assembled, device_path, monkeypatch):
    """Only a CUDA out-of-memory error is caught on the device path, to
    halve the sub-slice; any other error escapes (the JAX package falls back
    to the host on every exception)."""
    g, reads = assembled
    ts, _ = _stores(reads, 512)
    ref = t_mapper.MappingEngine(g, device="cpu").map_store(ts)
    real = TM.map_packed_async
    calls = []

    def oom_above_64(prep, k, pc, pn, lengths, L, device=None):
        calls.append(pc.shape[0])
        if pc.shape[0] > 64:
            raise torch.cuda.OutOfMemoryError("simulated")
        return real(prep, k, pc, pn, lengths, L, device)

    monkeypatch.setenv("SPADES_MAP_SUBCHUNK", str(8192 * 4))
    monkeypatch.setattr(TM, "map_packed_async", oom_above_64)
    with pytest.raises(torch.cuda.OutOfMemoryError):      # 8,192 is the floor
        t_mapper.MappingEngine(g, device="cpu").map_store(ts)
    assert calls[:3] == [512, 512, 512]

    def oom_above_16384(prep, k, pc, pn, lengths, L, device=None):
        if getattr(oom_above_16384, "sub", 10**9) > 16384:
            oom_above_16384.sub = 16384
            raise torch.cuda.OutOfMemoryError("simulated")
        return real(prep, k, pc, pn, lengths, L, device)

    monkeypatch.setattr(TM, "map_packed_async", oom_above_16384)
    got = t_mapper.MappingEngine(g, device="cpu").map_store(ts)
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)

    def broken(*a, **kw):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(TM, "map_packed_async", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        t_mapper.MappingEngine(g, device="cpu").map_store(ts)
    monkeypatch.setattr(TM, "prepare_index_device", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        t_mapper.map_read_batch(t_mapper.build_edge_index(g), g, reads, device="cpu")


def test_hit_filter_store_matches_jax(assembled):
    g, reads = assembled
    ts, js = _stores(reads, 256)
    index = t_mapper.build_edge_index(g)
    rng = np.random.default_rng(2)
    tips = index.kmers[np.sort(rng.choice(len(index.kmers), 300, replace=False))]
    got = TM.hit_filter_store(ts, tips, K_MAP, device="cpu", sub=100)
    ref = JM.hit_filter_store(js, tips, K_MAP, sub=128)
    assert got.dtype == bool and np.array_equal(got, ref)
    assert 0 < got.sum() < len(reads)
    none = TM.hit_filter_store(ts, tips[:0], K_MAP, device="cpu")
    assert not none.any()


def test_stores_narrower_than_k_hold_no_window(assembled, device_path):
    """A deliberate divergence: the JAX package raises on a chunk whose
    padded length is below k (its window extraction refuses it); the port
    answers that no read hits or maps."""
    g, _ = assembled
    short = ["ACGTACGTACGTAC", "GGGTTTAAACC"]
    ts, js = _stores(short, 64)
    assert ts.chunks[0].L < K_MAP
    tips = t_mapper.build_edge_index(g).kmers[:10]
    with pytest.raises(ValueError):
        JM.hit_filter_store(js, tips, K_MAP)
    assert not TM.hit_filter_store(ts, tips, K_MAP, device="cpu").any()
    edge, start, votes = t_mapper.MappingEngine(g, device="cpu").map_store(ts)
    assert (edge == -1).all() and not start.any() and not votes.any()


def _snp(s, i):
    return s[:i] + {"A": "C", "C": "G", "G": "T", "T": "A"}[s[i]] + s[i + 1:]


def _pack_canon(seq, k):
    from spades_tpu_torch.ops.extension import canonicalize

    wins = np.lib.stride_tricks.sliding_window_view(dna.encode(seq), k)
    return canonicalize(TK.pack(np.ascontiguousarray(wins)), k)[0]


def _same_mapper(t, j):
    t._materialize()
    j._materialize()
    assert t.size == j.size
    if t._sorted_src is None:
        assert j._sorted_src is None
    else:
        assert np.array_equal(t._sorted_src, j._sorted_src)
        assert np.array_equal(t._sorted_dst, j._sorted_dst)


@pytest.mark.parametrize("case", ["remap_substitute", "identical_noop", "chain_normalization"])
def test_kmer_mapper_matches_jax(case):
    rng = np.random.default_rng(11)
    k = 21
    t, j = t_kmapper.KmerMapper(k=k), j_kmapper.KmerMapper(k=k)
    a = _str(rng.integers(0, 4, 60).astype(np.uint8))
    if case == "remap_substitute":
        new = _snp(a, 30)
        for m in (t, j):
            m.remap_sequences(a, new)
        _same_mapper(t, j)
        out = t.substitute(_pack_canon(a, k).copy())
        assert np.array_equal(out, j.substitute(_pack_canon(a, k).copy()))
        new_set = {tuple(w) for w in _pack_canon(new, k)}
        assert t.size > 0 and all(tuple(w) in new_set for w in out)
    elif case == "identical_noop":
        for m in (t, j):
            m.remap_sequences(a, a)
            m.remap_sequences(a[:10], a)         # shorter than k: nothing to map
        assert t.size == j.size == 0
        words = _pack_canon(a, k)
        assert t.substitute(words) is words
    else:
        b = _snp(a, 20)
        c = _snp(b, 25)
        for m in (t, j):
            m.remap_sequences(a, b)
            m.remap_sequences(dna.encode(b), dna.encode(c))    # code arrays too
            m.normalize()
        _same_mapper(t, j)
        out = t.substitute(_pack_canon(a, k).copy())
        assert np.array_equal(out, j.substitute(_pack_canon(a, k).copy()))
        b_only = {tuple(w) for w in _pack_canon(b, k)} - {tuple(w) for w in _pack_canon(c, k)}
        assert all(tuple(w) not in b_only for w in out)


def test_kmer_mapper_keeps_glued_bulge_reads_mappable():
    """Reads spelling a removed bulge arm still map through the mapper; the
    glue comes from the JAX package's bulge remover (simplification is not
    ported yet), recorded by each package's own KmerMapper."""
    from spades_tpu.graph.simplify import SimplifyConfig, remove_bulges

    rng = np.random.default_rng(21)
    k = 21
    left, right = (_str(rng.integers(0, 4, 60).astype(np.uint8)) for _ in range(2))
    arm_a = left[-k:] + _str(rng.integers(0, 4, 3).astype(np.uint8)) + right[:k]
    arm_b = _snp(arm_a, k + 1)
    out = {}
    for name, kmod in (("t", t_kmapper), ("j", j_kmapper)):
        g = JGraph.from_sequences([], k)
        g.v_conj = np.array([1, 0, 3, 2], np.int64)
        e_a, _ = g.add_edge_pair(0, 2, dna.encode(arm_a), cov_sum=100.0)
        e_b, _ = g.add_edge_pair(0, 2, dna.encode(arm_b), cov_sum=10.0)
        mapper = kmod.KmerMapper(k=k)
        assert remove_bulges(g, SimplifyConfig(), kmer_mapper=mapper) >= 1
        assert g.alive[e_a] and not g.alive[e_b] and mapper.size > 0
        out[name] = (g, mapper, e_a)
    _same_mapper(out["t"][1], out["j"][1])
    jg, j_map, e_a = out["j"]
    tg = convert.graph_from_arrays(dataclasses.asdict(out["t"][0]))
    t_index = t_mapper.build_edge_index(tg)
    j_index = j_mapper.build_edge_index(jg)
    plain = t_mapper.map_read_batch(t_index, tg, [arm_b], device="cpu")
    mapped = t_mapper.map_read_batch(t_index, tg, [arm_b], kmer_mapper=out["t"][1],
                                     device="cpu")
    ref = j_mapper.map_read_batch(j_index, jg, [arm_b], kmer_mapper=j_map)
    assert dataclasses.astuple(mapped[0]) == dataclasses.astuple(ref[0])
    assert mapped[0].edge in (e_a, int(tg.e_conj[e_a]))
    assert plain[0] is None or mapped[0].n_hits >= plain[0].n_hits


@pytest.mark.parametrize("chunk_reads", [64, 1000])
def test_subset_store_matches_jax(assembled, chunk_reads):
    _, reads = assembled
    ts, js = _stores(reads[:300], 128)
    idx = np.sort(np.random.default_rng(chunk_reads).choice(300, 90, replace=False))
    got = TR.subset_store(ts, idx, chunk_reads=chunk_reads)
    ref = JR.subset_store(js, idx, chunk_reads=chunk_reads)
    assert got.n == ref.n == 90 and len(got.chunks) == len(ref.chunks)
    for a, b in zip(got.chunks, ref.chunks):
        assert (a.L, a.n) == (b.L, b.n)
        for f in ("pc", "pn", "lengths"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert got.chunks[0].unpack_host().sequences()[:2] == [reads[idx[0]], reads[idx[1]]]
    assert TR.subset_store(ts, np.zeros(0, np.int64)).n == 0
