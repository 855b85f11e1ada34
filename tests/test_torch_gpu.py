"""Card tests of the PyTorch/CUDA port: the CUDA kernel against its plain
PyTorch version (with and without the strand plane), and the CUDA path of
counting, construction and read mapping against the port's CPU path (which
tests/test_torch_*.py hold to the JAX package).

Run on a machine with an NVIDIA card:  python -m pytest -m gpu tests/test_torch_gpu.py
Without a card every test here skips.
"""
import numpy as np
import pytest
import torch

from spades_tpu_torch.core import kmers as K
from spades_tpu_torch.core.reads import ReadBatch, ReadStore
from spades_tpu_torch.ops import count as C
from spades_tpu_torch.ops import cuda_kernels as CK
from spades_tpu_torch.ops.condense import condense
from spades_tpu_torch.ops.extension import ExtensionIndex, build_extension_index
from spades_tpu_torch.pipeline.construction import construct_graph

pytestmark = pytest.mark.gpu

GRAPH_FIELDS = ("e_start", "e_end", "e_conj", "e_off", "e_len", "e_cov",
                "alive", "seq_pool", "v_conj")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _random_batch(seed, R, L, k, n_rate=0.03):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (R, L)).astype(np.uint8)
    lengths = rng.integers(k, L + 1, R).astype(np.int32)
    lengths[: R // 8] = L
    n_mask = rng.random((R, L)) < n_rate
    pos = np.arange(L)[None, :]
    codes[pos >= lengths[:, None]] = 0
    n_mask &= pos < lengths[:, None]
    return ReadBatch(codes=codes, lengths=lengths, n_mask=n_mask)


def _reads(seed, G=4000, n=400, rl=100, err=0.01):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, G).astype(np.uint8)
    starts = rng.integers(0, G - rl, n)
    r = genome[starts[:, None] + np.arange(rl)]
    flip = rng.random(n) < 0.5
    r[flip] = (3 - r[flip])[:, ::-1]
    em = rng.random(r.shape) < err
    r[em] = (r[em] + rng.integers(1, 4, int(em.sum()))) & 3
    acgt = np.frombuffer(b"ACGT", np.uint8)
    return [acgt[row].tobytes().decode() for row in r], acgt[genome].tobytes().decode()


@pytest.mark.parametrize("k", [13, 22, 33, 56, 128])
def test_kernel_matches_plain(cuda, k):
    pc, pn, lengths, L = _random_batch(k, 64, 160, k).packed()
    args = [torch.from_numpy(a) for a in (pc, pn, lengths)]
    ref_keys, ref_valid = CK.canonical_window_keys_plain(*args, L, k)
    before = CK.canonical_window_keys.launches
    keys, valid = CK.canonical_window_keys(*(a.to(cuda) for a in args), L, k)
    torch.cuda.synchronize()
    assert CK.canonical_window_keys.launches == before + 1
    assert keys.shape == (K.key_planes(k), 64 * (L - k + 1))
    assert torch.equal(keys.cpu(), ref_keys)
    assert torch.equal(valid.cpu(), ref_valid)


@pytest.mark.parametrize("k", [13, 21, 33, 55, 64, 128])
def test_strand_kernel_matches_plain(cuda, k):
    """The strand plane, on odd shapes and on rows that start off a 16-byte
    line (a slice of a larger batch)."""
    pc, pn, lengths, L = _random_batch(k, 67, 157, k).packed()
    args = [torch.from_numpy(a) for a in (pc, pn, lengths)]
    for lo in (0, 3):
        ref = CK.canonical_window_keys_plain(*(a[lo:] for a in args), L, k, strand=True)
        before = CK.canonical_window_keys.launches
        got = CK.canonical_window_keys(*(a.to(cuda)[lo:] for a in args), L, k, strand=True)
        torch.cuda.synchronize()
        assert CK.canonical_window_keys.launches == before + 1
        assert len(got) == 3 and got[2].dtype == torch.bool
        for a, b in zip(got, ref):
            assert torch.equal(a.cpu(), b)
        assert got[2].any() and not (got[2] & ~got[1]).any()


def test_kernel_rejects_bad_input(cuda):
    pc, pn, lengths, L = _random_batch(0, 8, 64, 21).packed()
    pc, pn, lengths = (torch.from_numpy(a).to(cuda) for a in (pc, pn, lengths))
    with pytest.raises(TypeError):
        CK.canonical_window_keys(pc, pn, lengths.to(torch.int64), L, 21)
    with pytest.raises(ValueError):
        CK.canonical_window_keys(pc[:, :-1], pn, lengths, L, 21)
    with pytest.raises(ValueError):
        CK.canonical_window_keys(pc, pn, lengths, L, 129)


@pytest.mark.parametrize("k", [22, 56])
def test_count_reads_cuda_matches_cpu(cuda, monkeypatch, k):
    monkeypatch.setenv("SPADES_HOST_COUNT_WINDOWS", "1")
    reads, genome = _reads(k)
    extra = [genome[:1500]]
    store = ReadStore.build(reads, chunk_reads=128)
    ref = C.count_reads(store.chunks, k, device="cpu",
                        structure_batches=[ReadBatch.from_sequences(extra)])
    got = C.count_reads(store.chunks, k, device=cuda,
                        structure_batches=[ReadBatch.from_sequences(extra)])
    assert np.array_equal(got.words, ref.words)
    assert np.array_equal(got.counts, ref.counts)
    assert (got.counts == 0).any()   # the zero-count structure rows arrived


@pytest.mark.parametrize("k", [21, 55])
def test_construct_graph_cuda_matches_cpu(cuda, monkeypatch, k):
    monkeypatch.setenv("SPADES_HOST_COUNT_WINDOWS", "1")
    reads, genome = _reads(100 + k)
    extra = [genome[200:2200]]
    ref = construct_graph(reads, k, extra_sequences=extra, batch_size=128, device="cpu")
    before = CK.canonical_window_keys.launches
    got = construct_graph(reads, k, extra_sequences=extra, batch_size=128, device=cuda)
    assert CK.canonical_window_keys.launches > before
    for f in GRAPH_FIELDS:
        assert np.array_equal(getattr(got.graph, f), getattr(ref.graph, f)), f


def test_condense_ranking_on_cuda(cuda):
    reads, _ = _reads(7)
    p1 = C.count_sequences(reads, 22, device="cpu")
    full = build_extension_index(p1)
    # no inverse indices: the vectorized path with the torch chain ranking
    idx = ExtensionIndex(k=full.k, kmers=full.kmers, in_mask=full.in_mask,
                         out_mask=full.out_mask)
    ref = condense(idx, p1, device="cpu")
    got = condense(idx, p1, device=cuda)
    for f in GRAPH_FIELDS:
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f


def test_mapping_cuda_matches_cpu(cuda, monkeypatch):
    """Device index build, search and vote, and the tip prefilter: the card
    against the port's CPU path, exactly."""
    from spades_tpu_torch.alignment.mapper import MappingEngine, build_edge_index
    from spades_tpu_torch.parallel import sharded_mapping as SM

    monkeypatch.setenv("SPADES_HOST_COUNT_WINDOWS", "1")
    monkeypatch.setenv("SPADES_DEVICE_MAP_READS", "1")
    monkeypatch.setenv("SPADES_DEVICE_INDEX_POOL", "1")
    monkeypatch.setenv("SPADES_MAP_SUBCHUNK", "256")
    reads, _ = _reads(31, G=6000, n=900)
    reads[3] = reads[3][:40] + "NN" + reads[3][42:]
    reads[5] = reads[5][:15]
    for k in (21, 55):
        g = construct_graph(reads, k, batch_size=256, device="cpu").graph
        store = ReadStore.build(reads, chunk_reads=512)
        cpu = MappingEngine(g, device="cpu")
        ref = cpu.map_store(store)
        before = CK.canonical_window_keys.launches
        eng = MappingEngine(g, device=cuda)
        got = eng.map_store(store)
        assert CK.canonical_window_keys.launches > before and eng._index is None
        for a, b in zip(eng._device_index(), cpu._device_index()):
            assert torch.equal(a.cpu(), b)
        for a, b in zip(got, ref):
            assert np.array_equal(a, b)
        assert (got[0] >= 0).mean() > 0.9
        tips = build_edge_index(g).kmers[::7]
        assert np.array_equal(SM.hit_filter_store(store, tips, k, device=cuda),
                              SM.hit_filter_store(store, tips, k, device="cpu"))


@pytest.mark.parametrize("k_list", [[21, 33, 55], [55]])
def test_run_assembly_cuda_matches_cpu(cuda, monkeypatch, tmp_path, k_list):
    """Reads to contigs without repeat resolution, with gaps to close: the
    card's graph and files equal the CPU path's, and the kernel was launched
    by counting, the prefilter and the mapper."""
    import collections
    import filecmp

    from spades_tpu_torch.pipeline.run import run_assembly
    from spades_tpu_torch.pipeline.spades_stages import GAP_CLOSER_STATS
    from spades_tpu_torch.tools import synthetic

    for name, value in (("SPADES_HOST_COUNT_WINDOWS", "1"), ("SPADES_DEVICE_MAP_READS", "1"),
                        ("SPADES_DEVICE_INDEX_POOL", "1"), ("SPADES_MAP_SUBCHUNK", "4096")):
        monkeypatch.setenv(name, value)
    _genome, r1, r2, _gaps = synthetic.make_gapped_dataset(100_000, 40, 150, 0.003, 2, 10)
    lefts, rights = list(r1), list(r2)
    out = {}
    for dev in ("cuda", "cpu"):
        GAP_CLOSER_STATS.clear()
        CK.canonical_window_keys.launches = 0
        CK.canonical_window_keys.launch_shapes = collections.Counter()
        res = run_assembly(lefts + rights, k_list, str(tmp_path / dev),
                           paired_libs=[(lefts, rights)], disable_rr=True, read_length=150,
                           device=dev, checkpoints="none")
        shapes = CK.canonical_window_keys.launch_shapes
        CK.canonical_window_keys.launch_shapes = None
        out[dev] = (res, [(k, s, st["candidates"], st["closed"]) for k, s, st in GAP_CLOSER_STATS],
                    CK.canonical_window_keys.launches, shapes)
    assert out["cpu"][2] == 0 and out["cuda"][2] > 0
    kinds = {(k % 2 == 0, strand) for (_R, _L, k, strand) in out["cuda"][3]}
    assert kinds >= {(True, False), (False, False), (False, True)}
    assert out["cuda"][1] == out["cpu"][1]
    assert sum(row[3] for row in out["cuda"][1]) > 0
    for f in GRAPH_FIELDS:
        assert np.array_equal(getattr(out["cuda"][0].graph, f), getattr(out["cpu"][0].graph, f)), f
    for name in ("contigs.fasta", "scaffolds.fasta", "assembly_graph_with_scaffolds.gfa",
                 "assembly_graph.fastg", "contigs.paths"):
        assert filecmp.cmp(tmp_path / "cuda" / name, tmp_path / "cpu" / name, shallow=False)


def test_meta_run_assembly_cuda_matches_cpu(cuda, monkeypatch, tmp_path):
    """metaSPAdes' two-step repeat resolution on the card: a small mock
    community (four genomes at four depths, two sharing a segment) through
    `run_assembly(mode="meta")` at K = 21, 33, 55, equal to the CPU path file
    for file (`first_pe_contigs.fasta` included), with both PairInfoCount
    passes mapping every read through the kernel."""
    import collections
    import filecmp
    import os

    from spades_tpu_torch.pipeline.run import run_assembly
    from spades_tpu_torch.pipeline.spades_stages import RR_STATS
    from spades_tpu_torch.tools import synthetic

    for name, value in (("SPADES_HOST_COUNT_WINDOWS", "1"), ("SPADES_DEVICE_MAP_READS", "1"),
                        ("SPADES_DEVICE_INDEX_POOL", "1"), ("SPADES_MAP_SUBCHUNK", "4096")):
        monkeypatch.setenv(name, value)
    _g, r1, r2, _origin = synthetic.make_community([24_000, 18_000, 12_000, 6_000],
                                                   [60, 25, 12, 6], 150, 0.003, 3, shared=2_000)
    lefts, rights = list(r1), list(r2)
    shapes = {}
    for dev in ("cuda", "cpu"):
        RR_STATS.clear()
        CK.canonical_window_keys.launches = 0
        CK.canonical_window_keys.launch_shapes = collections.Counter()
        run_assembly(lefts + rights, [21, 33, 55], str(tmp_path / dev), mode="meta",
                     paired_libs=[(lefts, rights)], read_length=150, device=dev,
                     checkpoints="none")
        shapes[dev] = CK.canonical_window_keys.launch_shapes
        CK.canonical_window_keys.launch_shapes = None
        assert [s for _k, s, _st in RR_STATS][::3] == ["pair_info_count_preliminary",
                                                       "pair_info_count"]
    assert sum(shapes["cpu"].values()) == 0
    assert any(strand for (_R, _L, _k, strand) in shapes["cuda"])
    names = []
    for d, _dirs, files in os.walk(tmp_path / "cpu"):
        names += [os.path.relpath(os.path.join(d, f), tmp_path / "cpu") for f in files]
    assert os.path.join("K55", "first_pe_contigs.fasta") in names
    for rel in names:
        assert filecmp.cmp(tmp_path / "cuda" / rel, tmp_path / "cpu" / rel, shallow=False), rel


@pytest.mark.parametrize("with_quals", [False, True])
def test_correct_reads_cuda_matches_cpu(cuda, monkeypatch, with_quals):
    from spades_tpu_torch.hammer import hammer as H

    monkeypatch.setenv("SPADES_HOST_COUNT_WINDOWS", "1")
    reads, _genome = _reads(31, G=6000, n=2400, err=0.005)
    rng = np.random.default_rng(32)
    quals = ["".join(chr(33 + q) for q in rng.integers(2, 41, len(r))) for r in reads]
    q = quals if with_quals else None
    tm_g, tm_c = {}, {}
    got = H.correct_reads(reads, H.HammerConfig(batch_size=512), quals=q, device=cuda,
                          record=tm_g)
    ref = H.correct_reads(reads, H.HammerConfig(batch_size=512), quals=q, device="cpu",
                          record=tm_c)
    assert got[0] == ref[0] and got[1] == ref[1] and got[1].bases_changed > 0
    assert np.array_equal(tm_g["labels"], tm_c["labels"])
    if with_quals:
        assert tm_g["pos_log_err"].tobytes() == tm_c["pos_log_err"].tobytes()
        assert len(tm_g["quality_ms"]) == len(tm_g["vote_ms"]) > 1


def test_mismatch_votes_cuda_match_plain(cuda, monkeypatch):
    from spades_tpu_torch.alignment.mapper import build_edge_index
    from spades_tpu_torch.alignment.mismatch import correct_mismatches
    from spades_tpu_torch.parallel import sharded_mapping as SM

    reads, _genome = _reads(33, G=5000, n=1200)
    g = construct_graph(reads, 21, min_count=2, device="cpu").graph
    store = ReadStore.build(reads, chunk_reads=512)
    index = build_edge_index(g)
    monkeypatch.setattr(SM, "VOTE_SUBCHUNK", 256)
    got = SM.position_votes_sharded(index, g, store=store, device=cuda)
    ref = SM.position_votes_sharded(index, g, store=store, device="cpu")
    assert np.array_equal(got, ref) and got.sum() > 0
    g2 = construct_graph(reads, 21, min_count=2, device="cpu").graph
    assert correct_mismatches(g, store=store, device=cuda) == \
        correct_mismatches(g2, store=store, device="cpu")
    assert np.array_equal(g.seq_pool, g2.seq_pool)
