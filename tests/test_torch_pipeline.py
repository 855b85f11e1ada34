"""Port parity for the assembly slice without repeat resolution: the stage
manager, the concrete stages, `run_assembly(disable_rr=True)` and the
single-K library entry point.

The same reads (made from a seed with numpy) go through `spades_tpu` and
`spades_tpu_torch` (`device="cpu"`).  Graph arrays, `GenomicInfo`, contigs
and every output file must be exactly equal (tolerance 0: the host code is
the same numpy and C++, and the device code is integer work); the GFA header
line alone names the writing package and is compared apart.  The native
simplification engine and the numpy loop are different engines, so the
ladder is held once with each.  The device thresholds are lowered so both
packages count, index and map on their device paths at these small sizes.

Sizes: the ladder runs on a 30,000-nt `make_e2e_dataset` genome (20x, 100-bp
pairs, seed 1: a set whose coverage-model fits converge in under a second
each); K=55 runs on the whole 200,000-nt genome of
`tests/test_scale_e2e.py::TestUniform200kb` with the native engine, and on
its first 50,000 nt with the native engine refused (the whole genome twice
would take the file past a minute and a half).
"""
import dataclasses
import filecmp
import json
import os
import shutil

import numpy as np
import pytest
import torch

from spades_tpu.core import dna as j_dna
from spades_tpu.core.reads import ReadStore as JStore
from spades_tpu.graph import simplify as j_simplify
from spades_tpu.pipeline import assembler as j_assembler
from spades_tpu.pipeline import run as j_run
from spades_tpu.pipeline import spades_stages as j_stages
from spades_tpu.pipeline.stages import AssemblyContext as JContext
from spades_tpu_torch import convert
from spades_tpu_torch.core.reads import ReadStore as TStore
from spades_tpu_torch.graph import simplify as t_simplify
from spades_tpu_torch.io.gfa import read_gfa
from spades_tpu_torch.pipeline import assembler as t_assembler
from spades_tpu_torch.pipeline import run as t_run
from spades_tpu_torch.pipeline import spades_stages as t_stages
from spades_tpu_torch.pipeline import stages as t_stage_rt
from spades_tpu_torch.pipeline.stages import AssemblyContext as TContext
from spades_tpu_torch.tools import synthetic
from tests.test_scale_e2e import paired_reads
from tests.test_torch_construction import REPO, _imported_modules

GRAPH_FIELDS = ("e_start", "e_end", "e_conj", "e_off", "e_len", "e_cov", "alive",
                "seq_pool", "v_conj")
OUTPUTS = ("contigs.fasta", "scaffolds.fasta", "assembly_graph_with_scaffolds.gfa",
           "assembly_graph.fastg", "contigs.paths", "scaffolds.paths")
GFA = "assembly_graph_with_scaffolds.gfa"
LADDER = [21, 33, 55]
THRESHOLDS = {"SPADES_HOST_COUNT_WINDOWS": "1", "SPADES_DEVICE_MAP_READS": "1",
              "SPADES_DEVICE_INDEX_POOL": "1", "SPADES_MAP_SUBCHUNK": "512"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for torch (and the OpenMP runtime it shares) while
    the module runs: the suite runs files in parallel worker processes, and
    each worker's default of one thread per core oversubscribes the host,
    which slows the many small tensor ops of the device path several-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lowered():
    with pytest.MonkeyPatch.context() as mp:
        for name, value in THRESHOLDS.items():
            mp.setenv(name, value)
        yield mp


def assert_same_file(a, b):
    """Byte-identical, but for the GFA header, which names the package."""
    if os.path.basename(a) == GFA:
        with open(a) as fa, open(b) as fb:
            la, lb = fa.readlines(), fb.readlines()
        assert la[0].startswith("H\tVN:Z:") and lb[0].startswith("H\tVN:Z:")
        assert la[0].split("\t")[1] == lb[0].split("\t")[1]     # the GFA version
        assert "spades-tpu-torch-" in lb[0] and "spades-tpu-torch-" not in la[0]
        assert la[1:] == lb[1:], f"{a} and {b} differ below the header"
        assert len(la) > 1
    else:
        assert filecmp.cmp(a, b, shallow=False), f"{a} and {b} differ"
        assert os.path.getsize(a) > 0


def assert_same_tree(jdir, tdir, ks):
    for sub in [""] + [f"K{k}" for k in ks]:
        for name in OUTPUTS:
            assert_same_file(os.path.join(jdir, sub, name), os.path.join(tdir, sub, name))


def assert_same_graph(jg, tg):
    assert jg.k == tg.k
    for f in GRAPH_FIELDS:
        a, b = getattr(jg, f), getattr(tg, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


# -- the 21,33,55 ladder --------------------------------------------------------

@pytest.fixture(scope="module")
def ladder_reads():
    _genome, r1, r2 = synthetic.make_e2e_dataset(30_000, 20, 100, 0.003, seed=1,
                                                 insert_mean=300, insert_sd=20)
    return list(r1), list(r2)


def _run_both(tmp, name, reads, libs, ks, **kw):
    jdir, tdir = str(tmp / f"{name}_j"), str(tmp / f"{name}_t")
    jres = j_run.run_assembly(reads, ks, jdir, paired_libs=libs, read_length=100,
                              disable_rr=True, **kw)
    tres = t_run.run_assembly(reads, ks, tdir, paired_libs=libs, read_length=100,
                              disable_rr=True, device="cpu", **kw)
    return jdir, tdir, jres, tres


@pytest.fixture(scope="module")
def ladder(tmp_path_factory, lowered, ladder_reads):
    """Both packages over the ladder with every checkpoint kept.  `reads` is
    exactly the library's concatenation: the runner counts from the paired
    stores' chunks (RC-stored right mates included)."""
    lefts, rights = ladder_reads
    t_stage_rt.STAGE_TIMES.clear()
    t_stages.GAP_CLOSER_STATS.clear()
    t_stages.CONSTRUCT_PHASES.clear()
    out = _run_both(tmp_path_factory.mktemp("ladder"), "native", lefts + rights,
                    [(lefts, rights)], LADDER, checkpoints="all")
    trails = (list(t_stage_rt.STAGE_TIMES), list(t_stages.GAP_CLOSER_STATS),
              list(t_stages.CONSTRUCT_PHASES))
    return (*out, trails)


@pytest.mark.parametrize("sub", ["", "K21", "K33", "K55"])
@pytest.mark.parametrize("name", OUTPUTS)
def test_ladder_files_match(ladder, sub, name):
    jdir, tdir = ladder[:2]
    assert_same_file(os.path.join(jdir, sub, name), os.path.join(tdir, sub, name))


def test_ladder_result_and_trails(ladder):
    _jdir, tdir, jres, tres, (times, gaps, phases) = ladder
    assert tres.k == jres.k == 55
    assert_same_graph(jres.graph, tres.graph)
    assert [dataclasses.astuple(c) for c in tres.contigs] == \
        [dataclasses.astuple(c) for c in jres.contigs]
    assert len(tres.contigs) > 10
    stage_ids = ["construction", "ec_threshold_finder", "raw_simplification",
                 "gap_closer_early", "simplification", "gap_closer_late", "contig_output"]
    assert [(k, s) for k, s, _ in times] == [(k, s) for k in LADDER for s in stage_ids]
    assert [(k, s) for k, s, _ in gaps] == \
        [(k, s) for k in LADDER for s in ("gap_closer_early", "gap_closer_late")]
    assert all(st["pairs"] in (0, 3000) for _, _, st in gaps)
    assert sum(st["candidates"] for _, _, st in gaps) > 0
    assert [k for k, _ in phases] == LADDER
    assert all(tm["n_batches"] > 0 and tm["host_s"] == 0.0 for _, tm in phases)
    parsed = read_gfa(os.path.join(tdir, GFA))
    assert len(parsed.segments) == len(tres.graph.canonical_edge_ids())
    assert len(parsed.paths) == len(tres.contigs)


@pytest.mark.parametrize("sub", ["saves/gap_closer_early", "saves/simplification",
                                 "saves/contig_output"])
def test_ladder_checkpoints_match(ladder, sub):
    """What the stages saved (`checkpoints="all"`) loads back equal."""
    from spades_tpu.graph.serialize import load_graph as j_load
    from spades_tpu_torch.graph.serialize import load_graph as t_load

    jdir, tdir = ladder[:2]
    for k in LADDER:
        jp, tp = (os.path.join(d, f"K{k}", sub) for d in (jdir, tdir))
        assert_same_graph(j_load(os.path.join(jp, "graph.npz")),
                          t_load(os.path.join(tp, "graph.npz")))
        with open(os.path.join(jp, "state.json")) as fj, open(os.path.join(tp, "state.json")) as ft:
            assert json.load(fj) == json.load(ft)
        assert os.path.exists(os.path.join(jp, "kmer_mapper.npz")) == \
            os.path.exists(os.path.join(tp, "kmer_mapper.npz"))


@pytest.mark.parametrize("restart", ["last", "k33:simplification", "k55:contig_output"])
def test_restart_gives_the_same_files(ladder, ladder_reads, tmp_path, lowered, restart):
    jdir, tdir = ladder[:2]
    lefts, rights = ladder_reads
    again = str(tmp_path / "again")
    shutil.copytree(tdir, again)
    for k in LADDER if restart != "last" else []:
        for name in OUTPUTS:           # what a restart must write anew
            if k >= int(restart[1:3]):
                os.remove(os.path.join(again, f"K{k}", name))
    t_stage_rt.STAGE_TIMES.clear()
    res = t_run.run_assembly(lefts + rights, LADDER, again, paired_libs=[(lefts, rights)],
                             read_length=100, disable_rr=True, device="cpu",
                             checkpoints="all", restart_from=restart)
    ran = [(k, s) for k, s, _ in t_stage_rt.STAGE_TIMES]
    if restart == "last":
        assert ran == []
    elif restart == "k33:simplification":
        assert ran[0] == (33, "simplification") and (55, "construction") in ran
        assert all(k != 21 for k, _ in ran)
    else:
        assert ran == [(55, "contig_output")]
    assert len(res.contigs) == len(ladder[3].contigs)
    assert_same_tree(jdir, again, LADDER)


def test_gfa_11_matches(ladder, ladder_reads, tmp_path, lowered):
    """GFA 1.1 from the K=55 checkpoint of each package (contig output alone)."""
    lefts, rights = ladder_reads
    dirs = []
    for mod, src, kw in ((j_run, ladder[0], {}), (t_run, ladder[1], {"device": "cpu"})):
        d = str(tmp_path / mod.__name__)
        shutil.copytree(src, d)
        mod.run_assembly(lefts + rights, LADDER, d, paired_libs=[(lefts, rights)],
                         read_length=100, disable_rr=True, checkpoints="all",
                         restart_from="k55:contig_output", gfa_version="1.1", **kw)
        dirs.append(d)
    assert_same_file(os.path.join(dirs[0], GFA), os.path.join(dirs[1], GFA))
    with open(os.path.join(dirs[1], GFA)) as fh:
        assert fh.readline().startswith("H\tVN:Z:1.1")
    assert not filecmp.cmp(os.path.join(dirs[1], GFA), os.path.join(ladder[1], GFA),
                           shallow=False)


def test_ladder_with_the_native_engine_refused(ladder_reads, tmp_path, lowered, monkeypatch):
    """The numpy simplification loop in both packages; reads given as strings
    in another order than the library, so the runner packs a store of its own
    for counting."""
    monkeypatch.setattr(j_simplify, "_simplify_loop_native", lambda *a, **k: None)
    monkeypatch.setattr(t_simplify, "_simplify_loop_native", lambda *a, **k: None)
    lefts = [j_dna.decode(r) for r in ladder_reads[0]]
    rights = [j_dna.decode(r) for r in ladder_reads[1]]
    jdir, tdir, jres, tres = _run_both(tmp_path, "refused", rights + lefts,
                                       [(lefts, rights)], LADDER, checkpoints="none")
    assert_same_graph(jres.graph, tres.graph)
    assert_same_tree(jdir, tdir, LADDER)
    assert not os.path.exists(os.path.join(tdir, "K55", "saves"))


# -- K=55 on the 200 kb uniform genome ---------------------------------------

@pytest.mark.parametrize("engine, size", [("native", 200_000), ("refused", 50_000)])
def test_k55_uniform_200kb_matches(tmp_path, lowered, monkeypatch, engine, size):
    if engine == "refused":
        monkeypatch.setattr(j_simplify, "_simplify_loop_native", lambda *a, **k: None)
        monkeypatch.setattr(t_simplify, "_simplify_loop_native", lambda *a, **k: None)
    rng = np.random.default_rng(5)
    genome = j_dna.decode(rng.integers(0, 4, 200_000).astype(np.uint8))[:size]
    lefts, rights = paired_reads(genome, rng)
    jdir, tdir, jres, tres = _run_both(tmp_path, engine, lefts + rights, [(lefts, rights)],
                                       [55], checkpoints="none")
    assert_same_graph(jres.graph, tres.graph)
    assert_same_tree(jdir, tdir, [55])
    assert len(tres.contigs) == 1
    seq = tres.contigs[0].seq
    assert seq in genome or j_dna.revcomp_str(seq) in genome
    assert len(seq) >= size - 1000


# -- stage by stage through convert.py ----------------------------------------

K_STAGE = 21
STAGE_IDS = ["construction", "ec_threshold_finder", "raw_simplification",
             "gap_closer_early", "simplification", "gap_closer_late", "contig_output"]


def _gapped_library():
    """A 6 kb genome sampled at 60x with 0.1 % errors, where no read crosses
    two planted positions: there the k=21 graph breaks into tips that overlap
    by 12 and 15 bases, which pairs span."""
    rng = np.random.default_rng(13)
    genome = rng.integers(0, 4, 6000).astype(np.uint8)
    rl, insert, n = 80, 220, 2400
    starts = rng.integers(0, len(genome) - insert, n)
    gaps = [(2000, 12), (4100, 15)]       # (position, overlap of the two sides)

    def crosses(a):                        # read [a, a+rl) is neither left nor right of a gap
        out = np.zeros(len(a), bool)
        for pos, ov in gaps:
            out |= (a + rl > pos + ov // 2) & (a < pos - (ov - ov // 2))
        return out

    keep = ~crosses(starts) & ~crosses(starts + insert - rl)
    starts = starts[keep]
    r1 = genome[starts[:, None] + np.arange(rl)]
    r2 = np.ascontiguousarray((3 - genome[(starts + insert - rl)[:, None] + np.arange(rl)])[:, ::-1])
    for r in (r1, r2):
        em = rng.random(r.shape) < 0.001
        r[em] = (r[em] + rng.integers(1, 4, int(em.sum()))) & 3
    return list(r1), list(r2)


def _snapshot(ctx):
    km = ctx.kmer_mapper
    rows = None
    if km is not None:
        km._materialize()
        rows = (km._sorted_src, km._sorted_dst)
    return {
        "graph": dataclasses.asdict(ctx.graph),
        "p1": dataclasses.asdict(ctx.p1_counts),
        "info": None if ctx.genomic_info is None else dataclasses.asdict(ctx.genomic_info),
        "kmer_mapper": rows,
        "contigs": [dataclasses.astuple(c) for c in ctx.contigs],
    }


def _j_stage_list():
    return [j_stages.Construction(), j_stages.GenomicInfoFiller(),
            j_stages.RawSimplification(), j_stages.GapClosing("early"),
            j_stages.Simplification(j_run.mode_simplify_config("multicell", 80)),
            j_stages.GapClosing("late"), j_stages.ContigOutput()]


def _t_stage_list():
    cfg = convert.simplify_config_from_dict(
        dataclasses.asdict(j_run.mode_simplify_config("multicell", 80)))
    assert cfg == t_run.mode_simplify_config("multicell", 80)
    return [t_stages.Construction(), t_stages.GenomicInfoFiller(),
            t_stages.RawSimplification(), t_stages.GapClosing("early"),
            t_stages.Simplification(cfg), t_stages.GapClosing("late"),
            t_stages.ContigOutput()]


@pytest.fixture(scope="module")
def staged(tmp_path_factory, lowered):
    """The JAX package's state after each stage at k=21 on the gapped library."""
    lefts, rights = _gapped_library()
    out = tmp_path_factory.mktemp("staged")
    ctx = JContext(k=K_STAGE, output_dir=str(out / "j"), reads=lefts + rights,
                   paired=[(lefts, rights)], read_length=80)
    ctx.read_store = JStore.build(lefts + rights)
    ctx.paired_stores = [(JStore.build(lefts), JStore.build(rights, rc=True), "paired-end")]
    snaps = []
    for stage in _j_stage_list():
        stage.run(ctx)
        snaps.append(_snapshot(ctx))
    return lefts, rights, snaps, str(out)


@pytest.mark.parametrize("i", range(len(STAGE_IDS)), ids=STAGE_IDS)
def test_stage_matches_from_the_jax_state_before_it(staged, lowered, i):
    lefts, rights, snaps, out = staged
    stage = _t_stage_list()[i]
    assert stage.id == STAGE_IDS[i]
    ctx = TContext(k=K_STAGE, output_dir=os.path.join(out, f"t{i}"), reads=lefts + rights,
                   paired=[(lefts, rights)], read_length=80, device="cpu")
    ctx.read_store = TStore.build(lefts + rights)
    ctx.paired_stores = [(TStore.build(lefts), TStore.build(rights, rc=True), "paired-end")]
    if i > 0:
        before = snaps[i - 1]
        ctx.graph = convert.graph_from_arrays(before["graph"])
        ctx.p1_counts = convert.counts_from_arrays(before["p1"])
        if before["info"] is not None:
            ctx.genomic_info = convert.genomic_info_from_dict(before["info"])
        if before["kmer_mapper"] is not None:
            ctx.kmer_mapper = convert.kmer_mapper_from_arrays(K_STAGE, *before["kmer_mapper"])
        ctx.contigs = convert.contigs_from_records(before["contigs"])
    stage.run(ctx)
    after = snaps[i]
    got = _snapshot(ctx)
    for f in GRAPH_FIELDS:
        assert np.array_equal(got["graph"][f], after["graph"][f]), f
    assert np.array_equal(got["p1"]["words"], after["p1"]["words"])
    assert np.array_equal(got["p1"]["counts"], after["p1"]["counts"])
    assert got["info"] == after["info"]
    assert got["contigs"] == after["contigs"]
    assert (got["kmer_mapper"] is None) == (after["kmer_mapper"] is None)
    if got["kmer_mapper"] is not None and after["kmer_mapper"][0] is not None:
        for a, b in zip(got["kmer_mapper"], after["kmer_mapper"]):
            assert np.array_equal(a, b)
    ctx.graph.check_invariants()
    if stage.id == "gap_closer_early":
        # the fixture is there for this: a planted gap closes, on the device
        # path, and the engine's index does not survive the closure
        assert t_stages.GAP_CLOSER_STATS[-1][2]["closed"] >= 1
        assert ctx._me is None
    if stage.id == "contig_output":
        for name in OUTPUTS:
            assert_same_file(os.path.join(out, "j", name), os.path.join(out, f"t{i}", name))


# -- the mapping-engine cache ---------------------------------------------------

def test_mapping_engine_cache_follows_the_graph(staged, lowered):
    g = convert.graph_from_arrays(staged[2][2]["graph"])
    ctx = TContext(k=K_STAGE, output_dir="unused", device="cpu")
    ctx.graph = g
    e1 = ctx.mapping_engine()
    assert ctx.mapping_engine() is e1 and e1.device == torch.device("cpu")
    e1._device_index()
    g.kill_edges(g.alive_edge_ids()[:1])          # the four-number token moves
    e2 = ctx.mapping_engine()
    assert e2 is not e1 and e1._prep is None      # the stale index was dropped
    ctx.invalidate_mapping()
    assert ctx._me is None


# -- the single-K library entry point ------------------------------------------

def test_assembler_matches(ladder_reads, lowered):
    reads = [j_dna.decode(r) for r in ladder_reads[0][:300] + ladder_reads[1][:300]]
    jres = j_assembler.assemble_multi_k(reads, [21, 33])
    tres = t_assembler.assemble_multi_k(reads, [21, 33], device="cpu")
    assert_same_graph(jres.graph, tres.graph)
    assert dataclasses.asdict(tres.genomic_info) == dataclasses.asdict(jres.genomic_info)
    assert dataclasses.asdict(tres.stats) == dataclasses.asdict(jres.stats)
    assert [c.seq for c in tres.contigs] == [c.seq for c in jres.contigs]
    assert t_assembler.default_k_ladder(150) == j_assembler.default_k_ladder(150)


def test_run_assembly_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_run.run_assembly(["ACGT" * 30], [21], str(tmp_path / "o"), disable_rr=True)
    with pytest.raises(ValueError):
        t_run.run_assembly(["ACGT" * 30], [], str(tmp_path / "o"), disable_rr=True,
                           device="cpu")


def test_import_scan_covers_the_new_modules():
    new = ["graph/compress.py", "graph/coverage_model.py", "graph/dijkstra.py",
           "graph/flanking.py", "graph/simplify.py", "graph/simplify_complex.py",
           "graph/serialize.py", "io/libraries.py", "io/fastg.py",
           "alignment/gap_closer.py", "paired/path_extend.py", "utils/timetracer.py",
           "pipeline/stages.py", "pipeline/config_overlay.py", "pipeline/spades_stages.py",
           "pipeline/run.py", "pipeline/assembler.py", "utils/errors.py", "graph/from_gfa.py",
           "graph/chromosome_remover.py", "alignment/edit.py", "alignment/long_read.py",
           "pipeline/wrappers.py", "pipeline/metaspades.py", "pipeline/plasmidspades.py",
           "pipeline/metaplasmidspades.py", "pipeline/metaviralspades.py",
           "ops/early_clip.py", "alignment/ss_coverage.py", "hmm/__init__.py", "hmm/io.py",
           "hmm/align.py", "mts/__init__.py", "mts/multiplicity.py", "mts/abundance.py",
           "mts/binning.py", "mts/series_analysis.py", "pipeline/rnaspades.py",
           "pipeline/rnaviralspades.py", "pipeline/coronaspades.py",
           "graph/synthetic.py", "graph/dot.py", "graph/positions.py", "graph/binning.py",
           "utils/memory.py", "aux_graphs/barcode_index.py", "aux_graphs/contracted_graph.py",
           "aux_graphs/vertex_resolver.py", "sewage/__init__.py", "sewage/disentangle.py",
           "tools/splitter.py", "tools/binspreader.py", "tools/sewage.py",
           "tools/cds_subgraphs.py", "tools/online_vis.py"]
    scanned = {str(p.relative_to(REPO / "spades_tpu_torch"))
               for p in (REPO / "spades_tpu_torch").rglob("*.py")}
    assert set(new) <= scanned
    for rel in new:
        tops = {m.split(".")[0] for m in _imported_modules(REPO / "spades_tpu_torch" / rel)}
        assert not tops & {"jax", "jaxlib", "spades_tpu"}, rel
