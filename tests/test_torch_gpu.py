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


def test_construct_graph_device_pair_over_the_k_ladder_matches_cpu(cuda, monkeypatch):
    """An isolate-shaped sample at K = 21, 33, 55 and 77, each K with the
    previous K's unitigs as prev-K contigs: the extension index and the
    condensation on the card (`build_extension_index_device`,
    `condense_device`) against the CPU path (native), graph and index array
    for array, and the spans say where each ran."""
    from spades_tpu_torch.io.contigs import extract_contigs
    from spades_tpu_torch.tools import synthetic
    from spades_tpu_torch.utils import timetracer

    monkeypatch.setenv("SPADES_HOST_COUNT_WINDOWS", "1")
    _genome, r1, r2 = synthetic.make_e2e_dataset(60_000, 30, 150, 0.003, seed=77,
                                                 insert_mean=400, insert_sd=30)
    store = ReadStore.build(list(r1) + list(r2), chunk_reads=2048)
    extra: list[str] = []
    paths = []
    timetracer.enable()
    try:
        for k in (21, 33, 55, 77):
            ref = construct_graph(None, k, read_store=store, extra_sequences=extra,
                                  device="cpu")
            got = construct_graph(None, k, read_store=store, extra_sequences=extra,
                                  device=cuda)
            assert (got.timings["ext_device"], ref.timings["ext_device"]) == (1, 0)
            for f in GRAPH_FIELDS:
                assert np.array_equal(getattr(got.graph, f), getattr(ref.graph, f)), (k, f)
            for f in ("kmers", "in_mask", "out_mask", "pref_idx", "pref_rc", "suf_idx",
                      "suf_rc"):
                assert np.array_equal(getattr(got.index, f), getattr(ref.index, f)), (k, f)
            extra = [c.seq for c in extract_contigs(ref.graph, 2 * k)]
            assert extra
        events = timetracer.events()
    finally:
        timetracer.disable()
    for e in events:
        if e["name"] in ("ext_build", "condense"):
            paths.append(e["args"]["path"])
            assert e["args"]["kmers"] > 0 and e["args"]["arcs"] > 0
    assert paths == ["host", "host", "device", "device"] * 4


@pytest.mark.parametrize("clip", [{"early_tip_clip": True}, {"early_at_clip": True},
                                  {"early_tip_clip": True, "early_at_clip": True}],
                         ids=["tip", "at", "both"])
def test_construct_graph_early_clip_on_card_matches_cpu(cuda, clip):
    """Under the early clippers (tips; the A/T clipper of `--rna` and
    `--rnaviral`; both) the index is built on the card and pulled for the
    clipper: `.ext_build` runs on the device and `.condense` on the host,
    and the graph and the clipped masks equal the CPU's."""
    from spades_tpu_torch.utils import timetracer

    reads, genome = _reads(41, G=20000, n=2000)
    # poly-A / poly-T tails and a poly-A prev-K contig give the A/T clipper work
    reads = [r[:70] + "A" * 30 if i % 7 == 0 else r[:70] + "T" * 30 if i % 7 == 1 else r
             for i, r in enumerate(reads)]
    extra = [genome[:3000] + "A" * 60]
    ref = construct_graph(reads, 33, read_length=100, extra_sequences=extra, device="cpu",
                          **clip)
    plain = construct_graph(reads, 33, extra_sequences=extra, device="cpu")
    assert ref.graph.num_edges < plain.graph.num_edges
    timetracer.enable()
    try:
        got = construct_graph(reads, 33, read_length=100, extra_sequences=extra, device=cuda,
                              **clip)
        events = timetracer.events()
    finally:
        timetracer.disable()
    paths = [(e["name"], e["args"]["path"]) for e in events
             if e["name"] in ("ext_build", "condense")]
    assert paths == [("ext_build", "device"), ("condense", "host")]
    assert got.timings["ext_device"] == 1
    for f in GRAPH_FIELDS:
        assert np.array_equal(getattr(got.graph, f), getattr(ref.graph, f)), f
    for f in ("kmers", "in_mask", "out_mask"):
        assert np.array_equal(getattr(got.index, f), getattr(ref.index, f)), f


def test_condense_ranking_on_cuda(cuda):
    reads, _ = _reads(7)
    p1 = C.count_sequences(reads, 22, device="cpu")
    full = build_extension_index(p1)
    # no inverse indices: the torch pair from the masks, on the card and the CPU
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


@pytest.mark.parametrize("k", [21, 33, 55, 127])
def test_hll_registers_cuda_match_cpu(cuda, k):
    """The HLL registers on the card (the kernel's windows) equal the plain
    version's on the CPU, tolerance 0; the kernel is launched once."""
    from spades_tpu_torch.ops import hll

    pc, pn, lengths, L = _random_batch(11 + k, 512, 152, k).packed()
    cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in (pc, pn, lengths)]
    want = hll.hll_registers(*cpu, L, k)
    before = CK.canonical_window_keys.launches
    got = hll.hll_registers(*(a.to(cuda) for a in cpu), L, k)
    assert CK.canonical_window_keys.launches == before + 1
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("k", [21, 55])
def test_read_median_coverage_cuda_matches_cpu(cuda, monkeypatch, k):
    from spades_tpu_torch.tools import read_filter
    from spades_tpu_torch.tools.read_filter import read_median_coverage

    monkeypatch.setenv("SPADES_HOST_COUNT_WINDOWS", "1")
    reads, genome = _reads(5 + k)
    reads = reads + [genome[:k], genome[:k - 1], "N" * 50, genome[100:180] + "R" + genome[181:240],
                     genome[300:400].lower()]
    kc = C.count_sequences(reads, k, device=cuda)
    want = read_median_coverage(reads, k, C.count_sequences(reads, k, device="cpu"),
                                device="cpu")
    before = CK.canonical_window_keys.launches
    monkeypatch.setattr(read_filter, "_BATCH_NT", 10_000)
    got = read_median_coverage(reads, k, kc, device=cuda)
    assert CK.canonical_window_keys.launches > before
    assert np.array_equal(got, want) and want.max() > 0


def test_kmer_tools_cuda_match_cpu(cuda, monkeypatch, tmp_path, capsys):
    """kmercount, kmer_estimating and read_filter with --device cuda write and
    print what --device cpu does."""
    from spades_tpu_torch.tools import kmer_estimating, kmercount, read_filter

    monkeypatch.setenv("SPADES_HOST_COUNT_WINDOWS", "1")
    reads, _genome = _reads(3, n=800)
    paths = [str(tmp_path / "r1.fa"), str(tmp_path / "r2.fa")]
    for path, part in zip(paths, (reads[:400], reads[400:])):
        with open(path, "w") as fh:
            fh.writelines(f">r{i}\n{s}\n" for i, s in enumerate(part))
    out = {}
    for dev in ("cuda", "cpu"):
        wd = str(tmp_path / dev)
        assert kmercount.main(paths + ["-k", "55", "--counts", "-w", wd, "--device", dev]) == 0
        assert kmer_estimating.main(paths + ["-k", "55", "--device", dev]) == 0
        assert read_filter.main(["-1", paths[0], "-2", paths[1], "-k", "21", "-c", "2", "-o",
                                 wd + "_rf", "--device", dev]) == 0
        files = [open(p, "rb").read() for p in (
            f"{wd}/final_kmers", f"{wd}/final_kmers.counts", f"{wd}_rf/filtered_1.fasta",
            f"{wd}_rf/filtered_2.fasta")]
        out[dev] = (files, capsys.readouterr().out.replace(wd, "<out>"))
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("k", [21, 55])
def test_fill_positions_cuda_matches_cpu(cuda, monkeypatch, k):
    """Edge positions: the device index, the kernel's windows in several row
    batches and the search on the card, against the CPU path."""
    from spades_tpu_torch.core import dna
    from spades_tpu_torch.graph import positions as TP

    monkeypatch.setattr(TP, "ROW_BASES", 512)
    monkeypatch.setattr(TP, "ROWS_PER_BATCH", 3)
    reads, genome = _reads(40 + k, G=6000, n=900, err=0.0)
    g = construct_graph(reads, k, device="cpu").graph
    seqs = {"g": genome, "rc": dna.revcomp_str(genome[500:4000]),
            "masked": genome[:900] + "N" * 10 + genome[910:2000].lower()}
    before = CK.canonical_window_keys.launches
    got = TP.fill_positions(g, seqs, device=cuda)
    assert CK.canonical_window_keys.launches > before
    want = TP.fill_positions(g, seqs, device="cpu")
    assert {e: [vars(p) for p in ps] for e, ps in got.by_edge.items()} == \
        {e: [vars(p) for p in ps] for e, ps in want.by_edge.items()}
    assert want.by_edge


def test_barcode_index_cuda_matches_cpu(cuda):
    """SPlitteR's barcode index: every read mapped in one pass through the
    device index at mapping_k = 31 of a k = 55 graph, on the card and the CPU."""
    from spades_tpu_torch.aux_graphs.barcode_index import build_barcode_index

    reads, _genome = _reads(61, G=6000, n=1500, err=0.002)
    g = construct_graph(reads, 55, device="cpu").graph
    named = [(f"r{i} BX:Z:B{i % 40}-1", s) for i, s in enumerate(reads)]
    before = CK.canonical_window_keys.launches
    got = build_barcode_index(g, named, mapping_k=31, frame_size=500, device=cuda)
    assert CK.canonical_window_keys.launches > before
    want = build_barcode_index(g, named, mapping_k=31, frame_size=500, device="cpu")
    for f in ("edge", "barcode", "count", "left_pos", "right_pos", "covered"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.barcode_names == want.barcode_names and got.num_entries > 0


def test_sewage_votes_and_abundances_cuda_match_cpu(cuda):
    """Allele votes (B8 scatter) equal on the card; the float64 NNLS within
    1e-9 of the CPU's."""
    from spades_tpu_torch.sewage import disentangle as S

    reads, genome = _reads(77, G=3000, n=3000, err=0.003)
    reads += ["N" * 30, genome[:10]]
    before = CK.canonical_window_keys.launches
    g, votes = S.allele_votes(genome, reads, device=cuda)
    assert CK.canonical_window_keys.launches > before
    assert np.array_equal(votes, S.allele_votes(genome, reads, device="cpu")[1])
    rng = np.random.default_rng(3)
    matrix = (rng.random((200, 300)) < 0.1).astype(float)
    freq = np.clip(matrix.T @ rng.dirichlet(np.ones(200)) + rng.normal(0, 0.01, 300), 0, 1)
    w = (rng.random(300) < 0.9).astype(float)
    got = S.nnls_abundances(matrix, freq, w, device=cuda)
    assert np.abs(got - S.nnls_abundances(matrix, freq, w, device="cpu")).max() <= 1e-9


@pytest.mark.parametrize("k,tile", [(21, 512), (55, 512), (77, 100)])
def test_count_batch_device_tiled_cuda_matches_cpu(cuda, k, tile):
    batch = _random_batch(90 + k, 300, 160, k)
    pc, pn, lengths, L = batch.packed()
    host = [torch.from_numpy(np.ascontiguousarray(a)) for a in (pc, pn, lengths)]
    dev = [t.to(cuda) for t in host]
    for fn, kw in ((C.count_batch_device, {}), (C.count_batch_device_tiled, {"tile": tile})):
        before = CK.canonical_window_keys.launches
        got = fn(*dev, L, k, **kw)
        assert CK.canonical_window_keys.launches == before + 1
        want = fn(*host, L, k, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


def test_kernel_on_row_slices_matches_plain(cuda):
    """A rank's share of a chunk is a row slice starting at any row: the
    kernel reads from the 16-byte line holding a slice's first byte."""
    pc, pn, lengths, L = _random_batch(120, 1001, 152, 55).packed()
    pc, pn, lengths = (torch.from_numpy(np.ascontiguousarray(a)) for a in (pc, pn, lengths))
    on_card = [t.to(cuda) for t in (pc, pn, lengths)]
    for lo, hi in ((1, 500), (333, 1001), (7, 8), (500, 500)):
        got = CK.canonical_window_keys(*(t[lo:hi] for t in on_card), L, 55, strand=True)
        want = CK.canonical_window_keys_plain(*(t[lo:hi] for t in (pc, pn, lengths)), L, 55,
                                              strand=True)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b), (lo, hi)


@pytest.mark.parametrize("k", [21, 55])
def test_sharded_paths_nccl_world_size_1_match_cpu(cuda, tmp_path, k):
    """NCCL at world size 1: the sharded count, extension masks and
    construct_graph under the group equal the CPU's single-device results."""
    from spades_tpu_torch.parallel.dryrun import (RankPool, count_task, extension_task,
                                                  graph_task)

    reads, _ = _reads(130 + k, G=6000, n=800)
    with RankPool(1, "cuda", "nccl", f"file://{tmp_path}/s", timeout_s=300) as pool:
        (kc, _shard), = pool.run(count_task, reads, k, "cuda", group="world")
        (ei, _), = pool.run(extension_task, reads, k, "cuda", group="world")
        (gr,) = pool.run(graph_task, reads, k, "cuda", group="world")
    ref = C.count_sequences(reads, k, device="cpu")
    assert np.array_equal(kc.words, ref.words) and np.array_equal(kc.counts, ref.counts)
    ref_ei = build_extension_index(C.count_sequences(reads, k + 1, device="cpu"))
    for f in ("kmers", "in_mask", "out_mask"):
        assert np.array_equal(getattr(ei, f), getattr(ref_ei, f))
    res = construct_graph(reads, k, device="cpu")
    assert np.array_equal(gr["words"], res.p1_counts.words)
    for f in GRAPH_FIELDS:
        assert np.array_equal(gr[f], getattr(res.graph, f)), f


def test_group_paths_two_gloo_ranks_on_one_card_match_cpu(cuda, tmp_path):
    """Two ranks on one card under gloo (which takes the card's tensors):
    count, graph, mapping, votes and hits equal the CPU's."""
    from spades_tpu_torch.alignment.mapper import build_edge_index
    from spades_tpu_torch.parallel.dryrun import (RankPool, count_task, dryrun_multigpu,
                                                  graph_task, mapping_task)

    reads, _ = _reads(140, G=6000, n=1001)
    g = construct_graph(reads, 21, device="cpu").graph
    index = build_edge_index(g)
    tips = index.kmers[::9].copy()
    ref_map = mapping_task(index, g, reads, tips, "cpu")
    ref = C.count_sequences(reads, 21, device="cpu")
    with RankPool(2, "cuda", "gloo", f"file://{tmp_path}/s", timeout_s=300) as pool:
        counts = pool.run(count_task, reads, 21, "cuda", group="world")
        graphs = pool.run(graph_task, reads, 21, "cuda", group="world")
        maps = pool.run(mapping_task, index, g, reads, tips, "cuda", group="world")
    for (kc, _), gr, got in zip(counts, graphs, maps):
        assert np.array_equal(kc.words, ref.words) and np.array_equal(kc.counts, ref.counts)
        for f in GRAPH_FIELDS:
            assert np.array_equal(gr[f], getattr(g, f)), f
        for a, b in zip(got[0] + got[1], ref_map[0] + ref_map[1]):
            assert np.array_equal(a, b)
        assert np.array_equal(got[2], ref_map[2]) and np.array_equal(got[3], ref_map[3])
    assert dryrun_multigpu(2, "cuda", "gloo")["world_size"] == 2


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_distance_clusters_on_card_match_cpu(cuda, tmp_path, backend):
    """`estimate_simple_sharded` on the card (NCCL at world size 1, or two
    gloo ranks on one card): e1 and e2 exact, dist and weight within rtol
    1e-5 of the port's CPU result (CUDA's `index_add_` sums float32 in
    another order).  Heavy groups of many rows make the sums long."""
    from spades_tpu_torch.paired.paired_info import PairedIndex
    from spades_tpu_torch.parallel.dryrun import RankPool
    from spades_tpu_torch.parallel.sharded_de import estimate_simple_sharded

    rng = np.random.default_rng(11)
    n = 200_000
    e1 = rng.integers(0, 300, n)
    e2 = rng.integers(0, 30, n)
    d = rng.integers(0, 2000, n)
    o = np.lexsort((d, e2, e1))
    pi = PairedIndex(e1[o], e2[o], d[o], (rng.integers(1, 50, n) / 7.0)[o])
    ref = estimate_simple_sharded(pi, device="cpu")
    world = 1 if backend == "nccl" else 2
    with RankPool(world, "cuda", backend, f"file://{tmp_path}/s", timeout_s=300) as pool:
        got = pool.run(estimate_simple_sharded, pi, group="world", device="cuda")
    assert ref.e1.size > 1000
    for res in got:
        assert np.array_equal(res.e1, ref.e1) and np.array_equal(res.e2, ref.e2)
        np.testing.assert_allclose(res.dist, ref.dist, rtol=1e-5)
        np.testing.assert_allclose(res.weight, ref.weight, rtol=1e-5)


# -- the user paths of chip_smoke.py phase 19, at small size ---------------------

NOT_COMPARED = {"params.txt", "run_spades.sh", "spades.log", "checkpoint.json"}
SMALL_PATHS = (("SPADES_HOST_COUNT_WINDOWS", "1"), ("SPADES_DEVICE_MAP_READS", "1"),
               ("SPADES_DEVICE_INDEX_POOL", "1"), ("SPADES_MAP_SUBCHUNK", "4096"))


# the checkpointed fit on the card against the CPU's: the mean within the
# fit's own tolerance (tests of the kernel below), every other field exact
FIT_RTOL = {"estimated_mean": 1e-3}


def _assert_same_dirs(a, b, fit_rtol=None):
    """Every file the two runs wrote is equal, but the logs and time stamps.
    With `fit_rtol` (field -> relative tolerance) a checkpoint's state.json
    is compared as JSON, exactly but for those fields of the coverage fit:
    the card's fit (graph/coverage_model.py:fit_coverage_model) differs from
    the host's in the last digits of its float fields."""
    import filecmp
    import json
    import os

    def names(root):
        return {os.path.relpath(os.path.join(d, n), root) for d, _dirs, files in os.walk(root)
                for n in files if n not in NOT_COMPARED}

    def state(path):
        with open(path) as fh:
            return json.load(fh)

    assert names(a) == names(b)
    for rel in names(a):
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if fit_rtol and os.path.basename(rel) == "state.json":
            sa, sb = state(pa), state(pb)
            ga, gb = sa.pop("genomic_info", {}), sb.pop("genomic_info", {})
            assert sa == sb, rel
            assert ga.keys() == gb.keys(), (rel, ga, gb)
            for f in ga:
                tol = fit_rtol.get(f, 0.0) * abs(gb[f])
                assert abs(ga[f] - gb[f]) <= tol, (rel, f, ga, gb)
        else:
            assert filecmp.cmp(pa, pb, shallow=False), rel
    return names(a)


def _community(seed, G=30_000, cov=30):
    from spades_tpu_torch.tools import synthetic

    genomes, r1, r2, _origin = synthetic.make_community([G], [cov], 150, 0.003, seed)
    return genomes[0], r1, r2


def test_iontorrent_cli_cuda_matches_cpu(cuda, monkeypatch, tmp_path):
    """`--iontorrent -k 21,33` on reads with homopolymer-length errors: the
    corrected reads, contigs and every other file of the card's run equal
    the CPU's, and the card's run launched the kernel."""
    import chip_smoke
    from spades_tpu_torch.pipeline import main as t_main

    for name, value in SMALL_PATHS:
        monkeypatch.setenv(name, value)
    _genome, r1, r2 = _community(61)
    paths = []
    for mate, codes in ((1, r1), (2, r2)):
        reads, changed = chip_smoke.homopolymer_errors(codes, 0.01, 62 + mate)
        assert changed > 0
        paths.append(chip_smoke.write_reads(str(tmp_path / f"ion_{mate}.fq"), reads, mate,
                                             "ion"))
    launches = {}
    for dev in ("cuda", "cpu"):
        CK.canonical_window_keys.launches = 0
        assert t_main.main(["-1", paths[0], "-2", paths[1], "--iontorrent", "-k", "21,33",
                            "-o", str(tmp_path / dev), "--device", dev]) == 0
        launches[dev] = CK.canonical_window_keys.launches
    assert launches["cuda"] > 0 and launches["cpu"] == 0
    names = _assert_same_dirs(str(tmp_path / "cuda"), str(tmp_path / "cpu"), FIT_RTOL)
    assert {"corrected/lib1_1.cor.fasta", "contigs.fasta"} <= names


def test_mate_pairs_with_a_coverage_cutoff_cuda_match_cpu(cuda, monkeypatch, tmp_path):
    """A paired-end and an RF mate-pair library, `min_count=2` over K = 21,
    33 (the two-pass structure count at 33): the card's files equal the
    CPU's, and the mate pairs reach DistanceEstimation on both."""
    from spades_tpu_torch.io.libraries import SequencingLibrary
    from spades_tpu_torch.pipeline import spades_stages as S
    from spades_tpu_torch.pipeline.run import run_assembly
    from spades_tpu_torch.tools import synthetic

    for name, value in SMALL_PATHS:
        monkeypatch.setenv(name, value)
    genome, r1, r2 = _community(63)
    m1, m2 = synthetic.make_mate_pairs(genome, 8, 150, 0.003, 64)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    pe_l, pe_r, mp_l, mp_r = ([acgt[row].tobytes().decode() for row in r]
                              for r in (r1, r2, m1, m2))
    trails = {}
    for dev in ("cuda", "cpu"):
        S.CONSTRUCT_PHASES.clear()
        S.RR_STATS.clear()
        libs = [SequencingLibrary(type="paired-end", left=pe_l, right=pe_r),
                SequencingLibrary(type="mate-pairs", left=mp_l, right=mp_r)]
        run_assembly(pe_l + pe_r + mp_l + mp_r, [21, 33], str(tmp_path / dev), paired_libs=libs,
                     read_length=150, min_count=2, device=dev, checkpoints="none")
        trails[dev] = ([k for k, tm in S.CONSTRUCT_PHASES if "extra_count_s" in tm],
                       [(s, st.get("lib_type"), st.get("mp_entries")) for _k, s, st in S.RR_STATS])
    assert trails["cuda"] == trails["cpu"] and trails["cuda"][0] == [33]
    assert [row for row in trails["cuda"][1] if row[0] == "pair_info_count"] == [
        ("pair_info_count", "paired-end", None), ("pair_info_count", "mate-pairs", None)]
    [de] = [row for row in trails["cuda"][1] if row[0] == "distance_estimation"]
    assert de[2] > 0
    _assert_same_dirs(str(tmp_path / "cuda"), str(tmp_path / "cpu"))


def _simplified(tmp_path, k=33):
    """A small genome's raw reads (lefts + rights), and their graph after
    Simplification at K = k with its kmer-mapper, from the CPU path."""
    import chip_smoke

    _genome, r1, r2 = _community(65)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    reads = [acgt[row].tobytes().decode() for r in (r1, r2) for row in r]
    graph, km = chip_smoke.after_simplification(reads, k, str(tmp_path / "run"), "cpu")
    return reads, graph, km


def test_kmer_mapper_residue_pass_cuda_matches_cpu(cuda, tmp_path):
    """`map_store` with the kmer-mapper, reads of removed bulge arms among a
    small genome's: on the card and on the CPU the residue pass re-runs the reads
    the device left unmapped (at least 1 %) and recovers some; the mappings
    are equal."""
    import copy

    from spades_tpu_torch.alignment import mapper as MR
    from spades_tpu_torch.graph.serialize import save_kmer_mapper

    reads, graph, km = _simplified(tmp_path)
    save_kmer_mapper(str(tmp_path / "km.npz"), km)
    src = np.load(tmp_path / "km.npz")["src"]            # the removed arms' k-mers
    acgt = np.frombuffer(b"ACGT", np.uint8)
    arms = [acgt[row].tobytes().decode() for row in K.unpack(src[::3], 33)]
    store = ReadStore.build(reads + arms)
    got = {}
    for dev in ("cuda", "cpu"):
        MR.RESIDUE_STATS.clear()
        g, km_ = copy.deepcopy((graph, km))
        got[dev] = (MR.MappingEngine(g, device=dev).map_store(store, kmer_mapper=km_,
                                                              force_device=True),
                    list(MR.RESIDUE_STATS))
    for a, b in zip(got["cuda"][0], got["cpu"][0]):
        assert np.array_equal(a, b)
    assert got["cuda"][1] == got["cpu"][1]
    [st] = got["cuda"][1]
    assert st["device"] and st["unmapped"] >= store.n // 100
    assert st["rerun"] == st["unmapped"] and st["recovered"] > 0


def test_mismatch_string_path_cuda_matches_cpu(cuda, monkeypatch, tmp_path):
    """`correct_mismatches(g, reads)` (the string path, mapping on the device)
    on a small genome's graph with planted substitutions: the fixed count and
    the graph equal the CPU's, and every planted base is restored."""
    import copy

    from spades_tpu_torch.alignment.mismatch import correct_mismatches

    reads, g0, _km = _simplified(tmp_path)
    rng = np.random.default_rng(66)
    planted = {}
    for e in rng.choice([int(e) for e in g0.canonical_edge_ids() if g0.e_len[e] >= 500], 40):
        p = int(rng.integers(33, g0.e_len[e] - 33))
        planted[int(g0.e_off[e] + p)] = (int(g0.e_off[g0.e_conj[e]] + g0.e_len[e] - 1 - p),
                                         int(g0.seq_pool[g0.e_off[e] + p]))
    monkeypatch.setenv("SPADES_DEVICE_MAP_READS", "1")
    out = {}
    for dev in ("cuda", "cpu"):
        g = copy.deepcopy(g0)
        for pos, (conj_pos, base) in planted.items():
            g.seq_pool[pos] = (base + 1) & 3
            g.seq_pool[conj_pos] = 3 - g.seq_pool[pos]
        CK.canonical_window_keys.launches = 0
        out[dev] = (correct_mismatches(g, reads, device=dev), g,
                    CK.canonical_window_keys.launches)
    assert out["cuda"][0] == out["cpu"][0] >= len(planted)
    assert np.array_equal(out["cuda"][1].seq_pool, out["cpu"][1].seq_pool)
    assert all(int(out["cuda"][1].seq_pool[p]) == b for p, (_c, b) in planted.items())
    assert out["cuda"][2] > 0 and out["cpu"][2] == 0


def test_meta_flanking_on_the_card_matches_cpu(cuda, monkeypatch, tmp_path):
    """`--meta --only-assembler` on a small four-genome community: at every
    K the flanking index is looked up on the card (`path` "device") and its
    sums at each refresh equal the CPU path's, and every file of the card's
    run equals the CPU's, contigs and scaffolds included."""
    import chip_smoke
    from spades_tpu_torch.graph import flanking as FL
    from spades_tpu_torch.pipeline import main as t_main
    from spades_tpu_torch.tools import synthetic

    for name, value in SMALL_PATHS:
        monkeypatch.setenv(name, value)
    _genomes, r1, r2, _origin = synthetic.make_community(
        [40_000, 30_000, 20_000, 10_000], [60, 30, 16, 8], 150, 0.003, 67)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    paths = [chip_smoke.write_reads(str(tmp_path / f"meta_{m}.fq"),
                                    [acgt[row].tobytes().decode() for row in r], m, "m")
             for m, r in ((1, r1), (2, r2))]
    seen = {}
    inner = FL.FlankingTable.refresh

    def refresh(self, g):
        fl = inner(self, g)
        seen.setdefault(run, []).append((g.k, self.path, fl.raw.copy()))
        return fl

    monkeypatch.setattr(FL.FlankingTable, "refresh", refresh)
    for run in ("cuda", "cpu"):
        assert t_main.main(["-1", paths[0], "-2", paths[1], "--meta", "--only-assembler",
                            "-o", str(tmp_path / run), "--device", run]) == 0
    assert {k for k, _p, _r in seen["cuda"]} == {21, 33, 55, 77}
    assert {p for _k, p, _r in seen["cuda"]} == {"device"}
    assert {p for _k, p, _r in seen["cpu"]} == {"host"}
    assert len(seen["cuda"]) == len(seen["cpu"])
    for (ka, _pa, a), (kb, _pb, b) in zip(seen["cuda"], seen["cpu"]):
        assert ka == kb and np.array_equal(a, b)
    names = _assert_same_dirs(str(tmp_path / "cuda"), str(tmp_path / "cpu"), FIT_RTOL)
    assert {"contigs.fasta", "scaffolds.fasta"} <= names


# ---------------------------------------------------------------------------
# the coverage EM kernel (csrc/coverage_em.cu)
# ---------------------------------------------------------------------------

def _corpus_hists():
    """The histograms of tests/test_torch_simplify.py: one peak over a
    Zipf error tail (the fit converges), and two peaks (it does not)."""
    rng = np.random.default_rng(3)
    good = rng.poisson(40, 60_000)
    err = np.minimum(rng.zipf(2.2, 40_000), 12)
    converged = np.bincount(np.concatenate([good, err]), minlength=120)
    rng = np.random.default_rng(4)
    mix = np.concatenate([rng.poisson(12, 30_000), rng.poisson(90, 20_000),
                          np.minimum(rng.zipf(2.0, 25_000), 8)])
    return {"converged": np.repeat(np.arange(len(converged)), converged),
            "uneven": np.repeat(np.arange(mix.max() + 1), np.bincount(mix))}


@pytest.fixture(scope="module")
def fit_inputs():
    """Multiplicities to fit: the corpus, and the (K+1)-mer counts of the
    reads at K = 21, 33, 55, 77 of the sample of job 0 of `isolate.asm` under
    benchmark seed 3,160,000,711 (1.26 Mb at 50x, 2 x 150 bp FR pairs, 0.3 %
    substitutions; the job's seed as bench_gpu/harness.py:job_seed derives
    it), and at K = 21 of the same sample drawn with 3,160,000,711 itself,
    counted on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from spades_tpu_torch.ops.count import count_sequences
    from spades_tpu_torch.tools import synthetic

    out = _corpus_hists()
    acgt = np.frombuffer(b"ACGT", np.uint8)
    job_seed = int(np.random.SeedSequence([3_160_000_711, 1]).generate_state(1, np.uint32)[0])
    for name, seed, ks in (("isolate", job_seed, (21, 33, 55, 77)),
                           ("isolate_straight_seed", 3_160_000_711, (21,))):
        _g, r1, r2 = synthetic.make_e2e_dataset(1_260_000, 50, 150, 0.003, seed=seed,
                                                insert_mean=400, insert_sd=30)
        reads = [acgt[row].tobytes().decode() for row in np.concatenate([r1, r2])]
        for k in ks:
            out[f"{name}_k{k}"] = count_sequences(reads, k + 1, device="cuda").counts
    return out


def _em_call(counts):
    """The CPU fit and the arguments of its EM."""
    from spades_tpu_torch.graph import coverage_model as cm

    seen = {}
    host_em = cm._em_host

    def spy(*args):
        seen["args"] = args
        return host_em(*args)
    cm._em_host = spy
    try:
        ref = cm.fit_coverage_model(counts)
    finally:
        cm._em_host = host_em
    return ref, seen["args"]


def _assert_fit_close(got, ref):
    for f in ("ec_bound", "trusted_bound", "genome_size", "converged"):
        assert getattr(got, f) == getattr(ref, f), f
    assert abs(got.estimated_mean - ref.estimated_mean) <= 1e-3 * abs(ref.estimated_mean)
    assert abs(got.estimated_sd - ref.estimated_sd) <= 1e-2 * abs(ref.estimated_sd)


@pytest.mark.parametrize("name", ["converged", "uneven", "isolate_k21", "isolate_k33",
                                  "isolate_k55", "isolate_k77"])
def test_coverage_em_kernel_matches_plain_and_host(cuda, monkeypatch, fit_inputs, name):
    """The fit on the card against the CPU path (scipy) and the kernel's
    plain version: thresholds, genome size and convergence equal, mean
    within 1e-3 and sd within 1e-2; one launch per fit; two launches equal
    bit for bit."""
    from spades_tpu_torch.graph import coverage_model as cm
    from spades_tpu_torch.ops import coverage_em as E
    from spades_tpu_torch.utils import timetracer

    counts = fit_inputs[name]
    ref, (good_cov, x0, p0, total) = _em_call(counts)
    before = E.coverage_em.launches
    timetracer.enable()
    try:
        got = cm.fit_coverage_model(counts, device=cuda)
        spans = [e["args"] for e in timetracer.events() if e["name"] == "coverage_fit.em"]
    finally:
        timetracer.disable()
    assert E.coverage_em.launches == before + 1
    assert [(s["path"], s["bins"]) for s in spans] == [("device", len(good_cov))]
    assert spans[0]["rounds"] >= 1 and spans[0]["evals"] > 0
    _assert_fit_close(got, ref)

    dev = torch.from_numpy(np.ascontiguousarray(good_cov)).to(cuda)
    first = E.coverage_em(dev, x0, p0, total)
    second = E.coverage_em(dev, x0, p0, total)
    assert first[0].tobytes() == second[0].tobytes() and first[1:] == second[1:]
    plain = E.coverage_em(torch.from_numpy(np.ascontiguousarray(good_cov)), x0, p0, total)
    for res in (first, plain):
        with monkeypatch.context() as m:
            m.setattr(cm, "_em_host", lambda *_a, res=res: res)
            _assert_fit_close(cm.fit_coverage_model(counts), ref)


def test_coverage_em_where_the_stopping_round_hangs_on_the_last_digits(cuda, monkeypatch,
                                                                       fit_inputs):
    """A regression case kept on purpose: the isolate sample drawn with seed
    3,160,000,711 itself, K = 21, where the EM's stopping round hangs on the
    objective's last digits (4e-16 of noise on the host makes it stop after
    11 rounds, not 19).  There the card's fit and the CPU path's agree
    (`ec_bound` 22, every integer field equal), and the plain version,
    whose objective rounds otherwise, does not (`ec_bound` 21)."""
    from spades_tpu_torch.graph import coverage_model as cm
    from spades_tpu_torch.ops import coverage_em as E

    counts = fit_inputs["isolate_straight_seed_k21"]
    ref, (good_cov, x0, p0, total) = _em_call(counts)
    got = cm.fit_coverage_model(counts, device=cuda)
    plain = E.coverage_em(torch.from_numpy(np.ascontiguousarray(good_cov)), x0, p0, total)
    with monkeypatch.context() as m:
        m.setattr(cm, "_em_host", lambda *_a: plain)
        via_plain = cm.fit_coverage_model(counts)
    ints = ("ec_bound", "trusted_bound", "genome_size", "converged")
    assert [getattr(got, f) for f in ints] == [getattr(ref, f) for f in ints]
    assert (ref.ec_bound, got.ec_bound, via_plain.ec_bound) == (22, 22, 21)
