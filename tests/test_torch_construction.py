"""Port parity for the Construction slice: extension index, condensation,
`construct_graph`, the GFA/unitig writers, the `gbuilder` CLI, the state
converters, and the port's guard rails.

Under tests/conftest.py JAX sees 8 virtual devices, so the JAX package counts
through its sharded path; the port's single-device results must still be
exactly equal (tolerance 0: integer work, and `e_cov` holds integer-valued
float64 sums).
"""
import ast
import dataclasses
import gzip
import os
import pathlib

import numpy as np
import pytest
import torch

import bench
from spades_tpu.io import contigs as j_contigs
from spades_tpu.io import fastx as j_fastx
from spades_tpu.io import gfa as j_gfa
from spades_tpu.ops import condense as j_condense
from spades_tpu.ops import count as JC
from spades_tpu.ops import extension as j_ext
from spades_tpu.pipeline.construction import construct_graph as j_construct
from spades_tpu.tools import gbuilder as j_gbuilder
import spades_tpu_torch
from spades_tpu_torch import convert, native
from spades_tpu_torch.core.reads import ReadStore
from spades_tpu_torch.core import kmers as _kmers
from spades_tpu_torch.io import contigs as t_contigs
from spades_tpu_torch.io import fastx as t_fastx
from spades_tpu_torch.io import gfa as t_gfa
from spades_tpu_torch.ops import condense as t_condense
from spades_tpu_torch.ops import count as t_count
from spades_tpu_torch.ops import extension as t_ext
from spades_tpu_torch.pipeline.construction import construct_graph as t_construct
from spades_tpu_torch.tools import gbuilder as t_gbuilder
from spades_tpu_torch.tools import synthetic

REPO = pathlib.Path(__file__).resolve().parent.parent
GRAPH_FIELDS = ("e_start", "e_end", "e_conj", "e_off", "e_len", "e_cov",
                "alive", "seq_pool", "v_conj")


def _dataset(seed, G=4000, cov=12, rl=100):
    genome, r1, r2 = synthetic.make_e2e_dataset(G, cov, rl, 0.004, seed=seed,
                                                insert_mean=250, insert_sd=20)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    reads = [acgt[r].tobytes().decode() for r in np.concatenate([r1, r2])]
    reads[3] = reads[3][:40] + "NN" + reads[3][42:]
    return reads, acgt[genome].tobytes().decode()


def _same_graph(a, b):
    assert a.k == b.k
    for f in GRAPH_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        assert np.array_equal(x, y), f


def _same_counts(a, b):
    assert np.array_equal(a.words, b.words) and np.array_equal(a.counts, b.counts)


@pytest.fixture
def device_path(monkeypatch):
    monkeypatch.setenv("SPADES_HOST_COUNT_WINDOWS", "1")


@pytest.mark.parametrize("k", [21, 55])
@pytest.mark.parametrize("with_extra", [False, True])
def test_construct_graph_matches_jax(device_path, k, with_extra):
    reads, genome = _dataset(k)
    novel = "".join("ACGT"[i] for i in np.random.default_rng(k).integers(0, 4, 150))
    extra = [genome[300:2300], novel] if with_extra else None
    got = t_construct(reads, k, extra_sequences=extra, batch_size=256, device="cpu")
    ref = j_construct(reads, k, extra_sequences=extra, batch_size=256)
    _same_counts(got.p1_counts, ref.p1_counts)
    _same_graph(got.graph, ref.graph)
    for key in ("device_s", "pull_s", "merge_s", "ext_build_s", "condense_s"):
        assert key in got.timings
    if with_extra:
        assert (got.p1_counts.counts == 0).any()


@pytest.mark.parametrize("k", [21, 55])
def test_read_store_and_two_pass_structure_match_jax(device_path, k):
    reads, genome = _dataset(100 + k)
    extra = [genome[:1500]]
    # read_store: the run-wide packed store, counted at every k
    got = t_construct(None, k, read_store=ReadStore.build(reads, chunk_reads=256),
                      extra_sequences=extra, device="cpu")
    ref = j_construct(reads, k, extra_sequences=extra)
    _same_graph(got.graph, ref.graph)
    # min_count > 1 with structure takes the two-pass branch
    got = t_construct(reads, k, min_count=2, extra_sequences=extra, device="cpu")
    ref = j_construct(reads, k, min_count=2, extra_sequences=extra)
    assert "extra_count_s" in got.timings and "filter_s" in got.timings
    _same_counts(got.p1_counts, ref.p1_counts)
    _same_graph(got.graph, ref.graph)


def test_host_fallbacks_match_jax(device_path, monkeypatch):
    """Without the native library: numpy merge, and the device pair on CPU
    tensors, whose index gives `stbr_build_ext`'s arrays."""
    reads, genome = _dataset(7)
    ref = j_construct(reads, 33, extra_sequences=[genome[:900]])
    with monkeypatch.context() as mp:
        mp.setattr(native, "lib", lambda: None)
        got = t_construct(reads, 33, extra_sequences=[genome[:900]], batch_size=256,
                          device="cpu")
    assert isinstance(got._index, t_ext.DeviceExtensionIndex)
    nat = native.build_ext_native(got.p1_counts.words, 33)
    assert nat is not None
    for f, want in zip(INDEX_FIELDS, nat):
        a = getattr(got.index, f)
        assert a.dtype == want.dtype and np.array_equal(a, want), f
    _same_counts(got.p1_counts, ref.p1_counts)
    _same_graph(got.graph, ref.graph)


def test_convert_feeds_jax_state_to_port_stages():
    reads, _ = _dataset(11)
    p1 = JC.count_sequences(reads, 22)
    jidx = j_ext.build_extension_index(p1)
    ref = j_condense.condense(jidx, p1)
    tp1 = convert.counts_from_arrays(dataclasses.asdict(p1))
    tidx = convert.ext_index_from_arrays(dataclasses.asdict(jidx))
    _same_graph(t_condense.condense(tidx, tp1, device="cpu"), ref)
    # without inverse indices: the torch pair from the index's masks
    bare = {f: v for f, v in dataclasses.asdict(jidx).items()
            if f in ("k", "kmers", "in_mask", "out_mask")}
    tbare = convert.ext_index_from_arrays(bare)
    assert tbare.pref_idx is None
    _same_graph(t_condense.condense(tbare, tp1, device="cpu"), ref)
    _same_graph(t_condense.condense(tbare, None, device="cpu"),
                j_condense.condense(j_ext.ExtensionIndex(**bare), None))
    # the port's extension index on the JAX counts equals the JAX one
    tbuilt = t_ext.build_extension_index(tp1)
    for f in ("kmers", "in_mask", "out_mask", "pref_idx", "suf_idx", "pref_rc", "suf_rc"):
        assert np.array_equal(getattr(tbuilt, f), getattr(jidx, f)), f
    tg = convert.graph_from_arrays(dataclasses.asdict(ref))
    _same_graph(tg, ref)


def test_masks_only_condense_rejects_masks_its_arcs_do_not_spell():
    """A masks-only index that holds one (k+1)-mer's prefix bit without its
    suffix bit and another's suffix bit without its prefix bit: the rows the
    masks spell rebuild as many arcs as the index holds, so only the
    row-for-row comparison sees that the masks are not the index's."""
    reads, _ = _dataset(11)
    k = 21
    p1 = t_count.count_sequences(reads, k + 1, device="cpu")
    dix = t_ext.build_extension_index_device(t_ext.keys_to_device(p1.words, "cpu"), k)
    idx = dix.to_host()
    first, last = dix.first.numpy().astype(int), dix.last.numpy().astype(int)

    def bit(r, end):
        """(k-mer row, mask, base) of the bit row r sets for its prefix or suffix."""
        if end == "prefix":
            rc, b = int(idx.pref_rc[r]), last[r]
            return int(idx.pref_idx[r]), ("in_mask" if rc else "out_mask"), (3 - b if rc else b)
        rc, b = int(idx.suf_rc[r]), first[r]
        return int(idx.suf_idx[r]), ("out_mask" if rc else "in_mask"), (3 - b if rc else b)

    a, b = [r for r in range(100) if bit(r, "prefix") != bit(r, "suffix")][:2]
    masks = {"in_mask": idx.in_mask.copy(), "out_mask": idx.out_mask.copy()}
    for row, m, c in (bit(a, "suffix"), bit(b, "prefix")):
        assert masks[m][row] >> c & 1
        masks[m][row] &= np.uint8(15 - (1 << c))
    bad = t_ext.ExtensionIndex(k=k, kmers=idx.kmers, **masks)
    rebuilt = t_ext.build_extension_index_device(
        t_ext.keys_of_words(t_condense._rows_of_masks(bad, torch.device("cpu"))), k)
    assert rebuilt.num_arcs == bad.num_arcs == idx.num_arcs - 2
    with pytest.raises(ValueError, match="not those of its arcs"):
        t_condense.condense(bad, p1, device="cpu")
    good = t_ext.ExtensionIndex(k=k, kmers=idx.kmers, in_mask=idx.in_mask,
                                out_mask=idx.out_mask)
    _same_graph(t_condense.condense(good, p1, device="cpu"),
                t_condense.condense_device(dix, p1.counts))


def test_rank_chains_cuts_cycles_like_jax():
    # two chains (0->1->2, 3->4) and a cycle 5->6->7->5
    nxt = np.array([1, 2, -1, 4, -1, 6, 7, 5], np.int64)
    prv = np.array([-1, 0, 1, -1, 3, 7, 5, 6], np.int64)
    rounds = t_condense._doubling_rounds(8)
    pos, head = t_condense._rank_chains(torch.from_numpy(nxt), torch.from_numpy(prv), rounds)
    jpos, jhead = j_condense._rank_chains_device(nxt, prv, rounds)
    assert np.array_equal(pos.numpy(), jpos) and np.array_equal(head.numpy(), jhead)
    assert pos.tolist() == [0, 1, 2, 0, 1, 0, 1, 2]


def test_writers_match_jax(tmp_path, device_path):
    reads, _ = _dataset(13)
    g = j_construct(reads, 21).graph
    tg = convert.graph_from_arrays(dataclasses.asdict(g))
    j_gfa.write_gfa(str(tmp_path / "j.gfa"), g)
    t_gfa.write_gfa(str(tmp_path / "t.gfa"), tg)
    jl = (tmp_path / "j.gfa").read_text().splitlines()
    tl = (tmp_path / "t.gfa").read_text().splitlines()
    assert tl[0] == f"H\tVN:Z:1.2\tsp:Z:spades-tpu-torch-{spades_tpu_torch.__version__}"
    assert tl[1:] == jl[1:] and len(tl) > 10
    j_contigs.write_contigs(str(tmp_path / "j.fa"), j_contigs.extract_contigs(g, 30))
    t_contigs.write_contigs(str(tmp_path / "t.fa"), t_contigs.extract_contigs(tg, 30))
    assert (tmp_path / "t.fa").read_bytes() == (tmp_path / "j.fa").read_bytes()


def test_fastx_readers_match_jax(tmp_path):
    fq = tmp_path / "r.fq.gz"
    with gzip.open(fq, "wt") as fh:
        fh.write("@a 1\nACGTNacgt\n+\nIIIIIIIII\n@b\nGGGA\n+\nIIII\n")
    fa = tmp_path / "r.fa"
    fa.write_text(">x desc\nACGT\nTTGA\n>y\n\n>z\nNNA\n")
    for p in (fq, fa):
        for nat in (True, False):
            got = [dataclasses.astuple(r) for r in t_fastx.read_fastx(str(p), native=nat)]
            ref = [dataclasses.astuple(r) for r in j_fastx.read_fastx(str(p), native=nat)]
            assert got == ref
    assert (list(t_fastx.read_sequences([str(fq), str(fa)]))
            == list(j_fastx.read_sequences([str(fq), str(fa)])))
    recs = [("n1", "ACGT" * 40), ("n2", "")]
    t_fastx.write_fasta(str(tmp_path / "t.fa"), recs)
    j_fastx.write_fasta(str(tmp_path / "j.fa"), recs)
    assert (tmp_path / "t.fa").read_bytes() == (tmp_path / "j.fa").read_bytes()


def test_gbuilder_cli_matches_jax(tmp_path, capsys):
    _genome, r1, r2 = synthetic.make_e2e_dataset(3000, 10, 100, 0.003, seed=5,
                                                 insert_mean=250, insert_sd=20)
    paths = [str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")]
    synthetic.write_fastq(paths[0], r1, 1)
    synthetic.write_fastq(paths[1], r2, 2)
    args = [*paths, "-k", "33", "--unitigs"]
    assert t_gbuilder.main([*args, "-w", str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert j_gbuilder.main([*args, "-w", str(tmp_path / "j")]) == 0
    capsys.readouterr()
    tl = (tmp_path / "t" / "assembly_graph_with_scaffolds.gfa").read_text().splitlines()
    jl = (tmp_path / "j" / "assembly_graph_with_scaffolds.gfa").read_text().splitlines()
    assert tl[0].startswith("H\t") and "spades-tpu-torch-" in tl[0]
    assert tl[1:] == jl[1:]
    assert ((tmp_path / "t" / "unitigs.fasta").read_bytes()
            == (tmp_path / "j" / "unitigs.fasta").read_bytes())


def test_gbuilder_device_flag():
    p = t_gbuilder.__dict__["make_parser"]("x", "y")
    assert p.parse_args([]).device == "cuda"
    assert p.parse_args(["--device", "cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        p.parse_args(["--device", "tpu"])


def test_synthetic_generator_is_the_bench_generator(tmp_path):
    a = synthetic.make_e2e_dataset(6000, 8, 150, 0.003, seed=3)
    b = bench.make_e2e_dataset(6000, 8, 150, 0.003, seed=3)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    synthetic.write_fastq(str(tmp_path / "t"), a[1], 1)
    bench.write_e2e_fastq(str(tmp_path / "b"), G=6000, cov=8, seed=3)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "b" / "r1.fq").read_bytes()


def test_early_clipping_is_not_ported_yet():
    """Early clipping is ported now (`tests/test_torch_early_clip.py`); the
    inputs this test once saw refused build the reference's graph."""
    for clip in ({"early_tip_clip": True}, {"early_at_clip": True}):
        for seqs in (["ACGT" * 20], ["ACGT" * 20 + "A" * 30]):
            jg = j_construct(seqs, 21, **clip).graph
            tg = t_construct(seqs, 21, device="cpu", **clip).graph
            for f in ("e_start", "e_end", "e_conj", "e_len", "e_cov", "seq_pool", "v_conj"):
                assert np.array_equal(getattr(jg, f), getattr(tg, f)), f


def test_resolve_device_never_falls_back_silently(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        spades_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError):
        spades_tpu_torch.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        t_construct(["ACGT" * 20], 21)
    assert spades_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        spades_tpu_torch.resolve_device("meta")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "spades_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    scanned = {f.relative_to(REPO).as_posix() for f in files}
    assert {f"spades_tpu_torch/parallel/{m}.py" for m in (
        "distributed", "sharded_count", "sharded_extension", "sharded_de", "sharded_mapping",
        "multihost_dryrun", "dryrun")} <= scanned
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "spades_tpu", "bench", "__graft_entry__"):
                bad.append(f"{f.relative_to(REPO)}: {mod}")
    assert not bad, bad


def test_chip_smoke_refuses_to_run_without_a_card(monkeypatch, capsys):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    import shutil
    import subprocess
    import sys

    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ""})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


# -- the device pair: build_extension_index_device + condense_device ---------

INDEX_FIELDS = ("kmers", "in_mask", "out_mask", "pref_idx", "pref_rc", "suf_idx", "suf_rc")


def _device_pair_matches(p1, k):
    """The device pair under CPU torch on the port's table `p1` against
    `stbr_build_ext` / `stbr_condense` and the JAX package, array for array
    (the inverse indices included)."""
    dix = t_ext.build_extension_index_device(t_ext.keys_to_device(p1.words, "cpu"), k)
    got = dix.to_host()
    nat = native.build_ext_native(p1.words, k)
    assert nat is not None
    jp1 = JC.KmerCounts(k=p1.k, words=p1.words, counts=p1.counts)
    jidx = j_ext.build_extension_index(jp1)
    for f, want in zip(INDEX_FIELDS, nat):
        a = getattr(got, f)
        assert a.dtype == want.dtype and np.array_equal(a, want), f
        assert np.array_equal(a, getattr(jidx, f)), f
    assert dix.num_arcs == got.num_arcs
    g = t_condense.condense_device(dix, p1.counts)
    host_idx = t_ext.ExtensionIndex(k=k, **dict(zip(INDEX_FIELDS, nat)))
    _same_graph(g, t_condense.condense(host_idx, p1, device="cpu"))   # stbr_condense
    # masks only: the torch pair from the (k+1)-mers the masks hold
    bare = t_ext.ExtensionIndex(k=k, kmers=got.kmers, in_mask=got.in_mask, out_mask=got.out_mask)
    _same_graph(g, t_condense.condense(bare, p1, device="cpu"))
    _same_graph(g, j_condense.condense(jidx, jp1))
    # without counts every arc counts once, as in the vectorized path
    _same_graph(t_condense.condense_device(dix, None),
                j_condense.condense(j_ext.ExtensionIndex(
                    k=k, kmers=jidx.kmers, in_mask=jidx.in_mask, out_mask=jidx.out_mask), None))
    return g


@pytest.fixture(params=["whole", "sliced"])
def slicing(request, monkeypatch):
    """The table cut into row slices and the contributions sorted in
    top-byte ranges, as on a large table, or both in one piece."""
    if request.param == "sliced":
        monkeypatch.setattr(t_ext, "_SLICE_ROWS", 700)
        monkeypatch.setattr(t_ext, "_SORT_ROWS", 2000)
    return request.param


@pytest.mark.parametrize("k", [21, 33, 55, 77])
@pytest.mark.parametrize("table", ["reads", "structure", "min_count_2"])
def test_device_pair_matches_native_and_jax(device_path, slicing, k, table):
    reads, genome = _dataset(200 + k)
    if table == "reads":
        p1 = t_construct(reads, k, batch_size=256, device="cpu").p1_counts
    elif table == "structure":
        # prev-K contigs and a novel sequence: rows of count 0
        novel = "".join("ACGT"[i] for i in np.random.default_rng(k).integers(0, 4, 300))
        p1 = t_construct(reads, k, extra_sequences=[genome[100:2600], novel],
                         batch_size=256, device="cpu").p1_counts
        assert (p1.counts == 0).any()
    else:
        p1 = t_construct(reads, k, min_count=2, extra_sequences=[genome[:1200]],
                         batch_size=256, device="cpu").p1_counts
    _device_pair_matches(p1, k)


def _table(seqs, k):
    return t_count.count_sequences(seqs, k + 1, device="cpu")


def _circle(n, seed, k):
    s = "".join("ACGT"[i] for i in np.random.default_rng(seed).integers(0, 4, n))
    return s + s[:k]


@pytest.mark.parametrize("k", [21, 33])
@pytest.mark.parametrize("case", ["palindromes", "cycle", "single", "empty"])
def test_device_pair_edge_tables(slicing, k, case):
    rng = np.random.default_rng(k)
    if case == "palindromes":
        # (k+1)-mers equal to their reverse complements, inside reads and alone
        seqs = []
        for _ in range(12):
            half = "".join("ACGT"[i] for i in rng.integers(0, 4, (k + 1) // 2))
            rc = half[::-1].translate(str.maketrans("ACGT", "TGCA"))
            flank = "".join("ACGT"[i] for i in rng.integers(0, 4, 30))
            seqs += [flank + half + rc + flank[::-1], half + rc]
        p1 = _table(seqs, k)
        pal = np.all(_kmers.revcomp_words(p1.words, k + 1) == p1.words, axis=1)
        assert pal.sum() >= 12
    elif case == "cycle":
        # a circular sequence with no branch: one perfect cycle and its conjugate
        p1 = _table([_circle(500, k, k)], k)
    elif case == "single":
        p1 = _table(["".join("ACGT"[i] for i in rng.integers(0, 4, k + 1))], k)
        assert p1.num_unique == 1
    else:
        p1 = t_count.KmerCounts(k=k + 1, words=np.zeros((0, _kmers.kmer_words(k + 1)), np.uint32),
                                counts=np.zeros(0, np.int64))
    if case == "empty":
        dix = t_ext.build_extension_index_device(t_ext.keys_to_device(p1.words, "cpu"), k)
        assert dix.num_kmers == 0 and dix.num_arcs == 0
        g = t_condense.condense_device(dix, p1.counts)
        _same_graph(g, j_condense.condense(j_ext.build_extension_index(
            JC.KmerCounts(k=k + 1, words=p1.words, counts=p1.counts)), None))
        assert g.e_len.shape == (0,)
        return
    g = _device_pair_matches(p1, k)
    if case == "cycle":
        assert g.e_len.shape[0] == 2 and np.all(g.e_len == 500 + k)
        assert np.all(g.e_start == g.e_end)
    if case == "single":
        assert g.e_len.tolist() == [k + 1, k + 1]


def test_construct_graph_device_path_on_cpu(device_path, monkeypatch, tmp_path):
    """`construct_graph` on the CPU without the native library takes the
    device pair on CPU tensors, as a card does: the graph and the index
    equal the native path's, the index is pulled only when read or before a
    clipper (whose index then condenses from its masks), and the spans say
    which pair ran; `ext_device` counts the card only."""
    from spades_tpu_torch.utils import timetracer

    reads, genome = _dataset(31)
    extra = [genome[:1500]]
    host = t_construct(reads, 33, extra_sequences=extra, batch_size=256, device="cpu")
    assert host.timings["ext_device"] == 0
    host_clipped = t_construct(reads, 33, early_tip_clip=True, read_length=100,
                               batch_size=256, device="cpu")
    monkeypatch.setattr(native, "lib", lambda: None)
    timetracer.enable()
    try:
        got = t_construct(reads, 33, extra_sequences=extra, batch_size=256, device="cpu")
        clipped = t_construct(reads, 33, early_tip_clip=True, read_length=100,
                              batch_size=256, device="cpu")
        events = timetracer.events()
    finally:
        timetracer.disable()
    assert got.timings["ext_device"] == 0 and clipped.timings["ext_device"] == 0
    assert isinstance(clipped._index, t_ext.ExtensionIndex)
    _same_graph(clipped.graph, host_clipped.graph)
    _same_graph(got.graph, host.graph)
    assert isinstance(got._index, t_ext.DeviceExtensionIndex)
    for f in INDEX_FIELDS:
        assert np.array_equal(getattr(got.index, f), getattr(host.index, f)), f
    assert isinstance(got._index, t_ext.ExtensionIndex)
    steps = [e["args"] for e in events
             if e["name"] in ("construction.ext_build", "construction.condense", "ext_build",
                              "condense")]
    assert [a["path"] for a in steps] == ["device", "device", "device", "host"]
    assert steps[0]["kmers"] == steps[1]["kmers"] == host.index.num_kmers
    assert steps[0]["arcs"] == steps[1]["arcs"] == host.index.num_arcs > 0
    assert all("kmers" in a and "arcs" in a for a in steps[2:])
