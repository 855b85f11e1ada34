"""Port parity for repeat resolution in the assembly: the stages
PairInfoCount, DistanceEstimation and RepeatResolution, and
`run_assembly(..., disable_rr=False)`.

The same reads (made from a seed with numpy) go through `spades_tpu` and
`spades_tpu_torch` (`device="cpu"`).  Every output file must be
byte-identical (tolerance 0), the GFA but for its header line, which names
the writing package.  The device thresholds are lowered so that both
packages build the edge index and map every read on their device paths.

Sizes: K=55 on the 120,000-nt repeat-rich genome of
`tests/test_scale_e2e.py::TestRepeatRich100kb` (100-bp pairs at 40x, insert
400), and a 30,000-nt genome with two unsequenced 700-nt holes, read by a
paired-end library (insert 300) and a sparse mate-pair library (RF, insert
3,000) that spans the holes.
"""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

from spades_tpu.core.reads import ReadStore as JStore
from spades_tpu.io.libraries import SequencingLibrary as JLib
from spades_tpu.pipeline import run as j_run
from spades_tpu.pipeline import spades_stages as j_stages
from spades_tpu.pipeline.stages import AssemblyContext as JContext
from spades_tpu_torch import convert
from spades_tpu_torch.core.reads import ReadStore as TStore
from spades_tpu_torch.graph import serialize as t_serialize
from spades_tpu_torch.io.libraries import SequencingLibrary as TLib
from spades_tpu_torch.pipeline import run as t_run
from spades_tpu_torch.pipeline import spades_stages as t_stages
from spades_tpu_torch.pipeline import stages as t_stage_rt
from spades_tpu_torch.pipeline.stages import AssemblyContext as TContext
from tests import test_scale_e2e as scale_e2e
from tests.test_torch_construction import REPO, _imported_modules
from tests.test_torch_pipeline import GRAPH_FIELDS, THRESHOLDS, assert_same_file

OUTPUTS = ("contigs.fasta", "scaffolds.fasta", "contigs.paths", "scaffolds.paths",
           "assembly_graph.fastg", "assembly_graph_with_scaffolds.gfa")
RR_IDS = ["pair_info_count", "distance_estimation", "repeat_resolving"]
STAGE_IDS = ["construction", "ec_threshold_finder", "raw_simplification",
             "gap_closer_early", "simplification", "gap_closer_late"] + RR_IDS + \
    ["contig_output"]
INDICES = ("paired_index", "scaffold_index", "mp_index")


@pytest.fixture(scope="module")
def lowered():
    with pytest.MonkeyPatch.context() as mp:
        for name, value in THRESHOLDS.items():
            mp.setenv(name, value)
        yield mp


def assert_same_outputs(jdir, tdir, subs=("", "K55")):
    for sub in subs:
        for name in OUTPUTS:
            assert_same_file(os.path.join(jdir, sub, name), os.path.join(tdir, sub, name))
    broken = [os.path.exists(os.path.join(d, "misc", "broken_scaffolds.fasta"))
              for d in (jdir, tdir)]
    assert broken[0] == broken[1]
    if broken[0]:
        assert_same_file(os.path.join(jdir, "misc", "broken_scaffolds.fasta"),
                         os.path.join(tdir, "misc", "broken_scaffolds.fasta"))


# -- the repeat-rich genome end to end ---------------------------------------------

@pytest.fixture(scope="module")
def repeat_rich():
    rng = np.random.default_rng(11)
    genome = scale_e2e.TestRepeatRich100kb()._genome(rng)
    lefts, rights = scale_e2e.paired_reads(genome, rng, rl=100, insert=400, cov=40)
    return genome, lefts, rights


@pytest.fixture(scope="module")
def e2e(tmp_path_factory, lowered, repeat_rich):
    """Both packages at K=55 with repeat resolution, every checkpoint kept."""
    _genome, lefts, rights = repeat_rich
    out = tmp_path_factory.mktemp("rr")
    jdir, tdir = str(out / "j"), str(out / "t")
    jres = j_run.run_assembly(lefts + rights, [55], jdir, paired_libs=[(lefts, rights)],
                              read_length=100, checkpoints="all")
    t_stage_rt.STAGE_TIMES.clear()
    t_stages.RR_STATS.clear()
    tres = t_run.run_assembly(lefts + rights, [55], tdir, paired_libs=[(lefts, rights)],
                              read_length=100, checkpoints="all", device="cpu")
    trails = (list(t_stage_rt.STAGE_TIMES), list(t_stages.RR_STATS))
    return jdir, tdir, jres, tres, trails


@pytest.mark.parametrize("sub", ["", "K55"])
@pytest.mark.parametrize("name", OUTPUTS)
def test_repeat_rich_files_match(e2e, sub, name):
    jdir, tdir = e2e[:2]
    assert_same_file(os.path.join(jdir, sub, name), os.path.join(tdir, sub, name))


def test_repeat_rich_result_and_trails(e2e, repeat_rich):
    genome = repeat_rich[0]
    jdir, tdir, jres, tres, (times, rr) = e2e
    assert_same_outputs(jdir, tdir)
    for f in GRAPH_FIELDS:
        assert np.array_equal(getattr(jres.graph, f), getattr(tres.graph, f)), f
    assert [dataclasses.astuple(c) for c in tres.contigs] == \
        [dataclasses.astuple(c) for c in jres.contigs]
    assert [dataclasses.astuple(c) for c in tres.scaffolds] == \
        [dataclasses.astuple(c) for c in jres.scaffolds]
    assert [s for k, s, _ in times] == STAGE_IDS and {k for k, _, _ in times} == {55}
    assert [s for _, s, _ in rr] == RR_IDS
    pic, de, res = (st for _, _, st in rr)
    assert pic["pairs"] == len(repeat_rich[1]) and pic["lib_type"] == "paired-end"
    assert pic["mapped_both"] >= 0.97 * pic["pairs"]
    assert abs(pic["is_median"] - 400) <= 30 and pic["raw_entries"] > 0
    assert de["clustered_entries"] > 0 and de["mp_entries"] == 0
    assert res["paths"] >= len(tres.contigs) and res["scaffold_graph_links"] is None
    # resolved: no misassembly, and fewer, longer contigs than the graph's edges
    rc = genome[::-1].translate(str.maketrans("ACGT", "TGCA"))
    assert all(c.seq in genome or c.seq in rc for c in tres.contigs)
    assert max(len(c.seq) for c in tres.contigs) >= 20_000


@pytest.mark.parametrize("stage", RR_IDS)
def test_rr_checkpoints_match(e2e, stage):
    """What each new stage saved (graph, state, indices) is equal."""
    jdir, tdir = e2e[:2]
    jp, tp = (os.path.join(d, "K55", "saves", stage) for d in (jdir, tdir))
    with open(os.path.join(jp, "state.json")) as fj, open(os.path.join(tp, "state.json")) as ft:
        assert json.load(fj) == json.load(ft)
    names = sorted(os.listdir(jp))
    assert sorted(os.listdir(tp)) == names
    for n in names:
        if n.endswith(".npz") and n != "kmer_mapper.npz":
            a, b = np.load(os.path.join(jp, n)), np.load(os.path.join(tp, n))
            assert sorted(a.files) == sorted(b.files)
            for f in a.files:
                assert a[f].dtype == b[f].dtype and np.array_equal(a[f], b[f]), (n, f)
    if stage == "distance_estimation":
        assert {"paired_index.npz", "scaffold_index.npz", "raw_pairs_0.npz"} <= set(names)


@pytest.mark.parametrize("restart", ["k55:pair_info_count", "k55:distance_estimation",
                                     "k55:repeat_resolving"])
def test_restart_inside_rr_gives_the_same_files(e2e, repeat_rich, tmp_path, lowered, restart):
    jdir, tdir = e2e[:2]
    _genome, lefts, rights = repeat_rich
    again = str(tmp_path / "again")
    shutil.copytree(tdir, again)
    for sub in ("", "K55"):
        for name in OUTPUTS:
            os.remove(os.path.join(again, sub, name))
    t_stage_rt.STAGE_TIMES.clear()
    t_run.run_assembly(lefts + rights, [55], again, paired_libs=[(lefts, rights)],
                       read_length=100, checkpoints="all", device="cpu", restart_from=restart)
    ran = [s for _, s, _ in t_stage_rt.STAGE_TIMES]
    assert ran == STAGE_IDS[STAGE_IDS.index(restart.split(":")[1]):]
    assert_same_outputs(jdir, again)


# -- each new stage from the JAX state before it ------------------------------------

def _carry(jctx, tctx):
    """The JAX context's state as the port's, through convert.py."""
    tctx.graph = convert.graph_from_arrays(dataclasses.asdict(jctx.graph))
    km = jctx.kmer_mapper
    if km is not None:
        km._materialize()
        tctx.kmer_mapper = convert.kmer_mapper_from_arrays(jctx.k, km._sorted_src,
                                                           km._sorted_dst)
    tctx.raw_pair_libs = [
        (lt, convert.paired_index_from_arrays(dataclasses.asdict(raw)),
         convert.insert_size_stats_from_list([st.median, st.mad, st.mean, st.count]))
        for lt, raw, st in jctx.raw_pair_libs]
    for name in INDICES:
        pi = getattr(jctx, name)
        setattr(tctx, name, None if pi is None
                else convert.paired_index_from_arrays(dataclasses.asdict(pi)))
    st = jctx.is_stats
    tctx.is_stats = None if st is None else \
        convert.insert_size_stats_from_list([st.median, st.mad, st.mean, st.count])
    tctx.insert_size = jctx.insert_size
    tctx.contigs = convert.contigs_from_records([dataclasses.astuple(c) for c in jctx.contigs])


def _snapshot(ctx):
    def index(pi):
        return None if pi is None else {c: getattr(pi, c) for c in ("e1", "e2", "dist", "weight")}

    return {
        "graph": {f: getattr(ctx.graph, f) for f in GRAPH_FIELDS},
        "raw": [(lt, index(raw), dataclasses.astuple(st)) for lt, raw, st in ctx.raw_pair_libs],
        **{name: index(getattr(ctx, name)) for name in INDICES},
        "is_stats": None if ctx.is_stats is None else dataclasses.astuple(ctx.is_stats),
        "insert_size": ctx.insert_size,
        "contigs": [dataclasses.astuple(c) for c in ctx.contigs],
        "scaffolds": [dataclasses.astuple(c) for c in ctx.scaffolds],
        "paths": [(n, p.edges, p.gaps) for n, p in ctx.contig_paths + ctx.scaffold_paths],
    }


def assert_same_snapshot(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if key == "graph":
            for f in GRAPH_FIELDS:
                assert np.array_equal(a[key][f], b[key][f]), f
        elif key == "raw":
            assert len(a[key]) == len(b[key])
            for (la, ia, sa), (lb, ib, sb) in zip(a[key], b[key]):
                assert (la, sa) == (lb, sb)
                for c in ia:
                    assert ia[c].dtype == ib[c].dtype and np.array_equal(ia[c], ib[c]), c
        elif key in INDICES:
            assert (a[key] is None) == (b[key] is None), key
            for c in a[key] or {}:
                assert a[key][c].dtype == b[key][c].dtype, (key, c)
                assert np.array_equal(a[key][c], b[key][c]), (key, c)
        else:
            assert a[key] == b[key], key


def _stage(pkg, sid):
    return {"pair_info_count": pkg.PairInfoCount, "distance_estimation": pkg.DistanceEstimation,
            "repeat_resolving": pkg.RepeatResolution}[sid]()


@pytest.mark.parametrize("sid, path", [("pair_info_count", "stores"), ("pair_info_count", "list"),
                                       ("distance_estimation", "stores"),
                                       ("repeat_resolving", "stores")])
def test_stage_matches_from_the_jax_state_before_it(e2e, repeat_rich, tmp_path, lowered, sid,
                                                     path):
    """The JAX package's checkpoint of the stage before `sid` is loaded by the
    JAX package, which runs `sid`; the same state, carried into the port with
    convert.py, goes through the port's `sid`."""
    _genome, lefts, rights = repeat_rich
    before = STAGE_IDS[STAGE_IDS.index(sid) - 1]
    saves = os.path.join(e2e[0], "K55", "saves", before)
    ctxs = []
    for pkg, Ctx, Store, kw in ((j_stages, JContext, JStore, {}),
                                (t_stages, TContext, TStore, {"device": "cpu"})):
        ctx = Ctx(k=55, output_dir=str(tmp_path / pkg.__name__), reads=lefts + rights,
                  paired=[(lefts, rights)], read_length=100, **kw)
        if path == "stores":
            ctx.paired_stores = [(Store.build(lefts), Store.build(rights, rc=True),
                                  "paired-end")]
        ctxs.append(ctx)
    jctx, tctx = ctxs
    j_stages.ContigOutput().load(jctx, saves)
    _carry(jctx, tctx)
    t_stages.RR_STATS.clear()
    _stage(j_stages, sid).run(jctx)
    _stage(t_stages, sid).run(tctx)
    assert_same_snapshot(_snapshot(jctx), _snapshot(tctx))
    if sid == "pair_info_count":
        assert tctx.raw_pair_libs and tctx.raw_pair_libs[0][1].e1.size > 0
        assert [s for _, s, _ in t_stages.RR_STATS] == (["pair_info_count"]
                                                         if path == "stores" else [])
    if sid == "repeat_resolving":
        assert len(tctx.contigs) > 0 and len(tctx.contig_paths) == len(tctx.contigs)


# -- a mate-pair library beside the paired-end one, in isolate mode ---------------

def _holed_libraries(seed=3, G=30_000, rl=100, holes=(10_000, 20_000), hole=700):
    """Pairs whose reads all avoid two unsequenced holes: PE (FR, insert
    300, 40x) cannot span them, mate pairs (RF, insert 3,000, 6x) can."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genome = rng.integers(0, 4, G).astype(np.uint8)

    def pairs(cov, mean, sd):
        n = G * cov // (2 * rl)
        isize = np.round(rng.normal(mean, sd, n)).astype(np.int64)
        starts = rng.integers(0, G - isize.max() - 1, n)
        ok = np.ones(n, bool)
        for a in (starts, starts + isize - rl):
            for h in holes:
                ok &= (a + rl <= h) | (a >= h + hole)
        starts, isize = starts[ok], isize[ok]
        r1 = genome[starts[:, None] + np.arange(rl)]
        r2 = (3 - genome[(starts + isize - rl)[:, None] + np.arange(rl)])[:, ::-1]
        return [acgt[r].tobytes().decode() for r in r1], [acgt[r].tobytes().decode() for r in r2]

    pe_l, pe_r = pairs(40, 300, 10)
    fr_l, fr_r = pairs(6, 3000, 100)
    rc = str.maketrans("ACGT", "TGCA")
    mp_l, mp_r = [s[::-1].translate(rc) for s in fr_l], [s[::-1].translate(rc) for s in fr_r]
    return pe_l, pe_r, mp_l, mp_r


@pytest.fixture(scope="module")
def mate_pairs(tmp_path_factory, lowered):
    """The JAX package in multicell mode, the port in isolate mode."""
    pe_l, pe_r, mp_l, mp_r = _holed_libraries()
    reads = pe_l + pe_r + mp_l + mp_r
    out = tmp_path_factory.mktemp("mp")
    jdir, tdir = str(out / "j"), str(out / "t")
    j_run.run_assembly(reads, [55], jdir, read_length=100, checkpoints="none",
                       paired_libs=[JLib(type="paired-end", left=pe_l, right=pe_r),
                                    JLib(type="mate-pairs", left=mp_l, right=mp_r)])
    t_stages.RR_STATS.clear()
    t_run.run_assembly(reads, [55], tdir, read_length=100, checkpoints="none", mode="isolate",
                       device="cpu",
                       paired_libs=[TLib(type="paired-end", left=pe_l, right=pe_r),
                                    TLib(type="mate-pairs", left=mp_l, right=mp_r)])
    return jdir, tdir, list(t_stages.RR_STATS)


def test_mate_pair_library_files_match(mate_pairs):
    jdir, tdir, _rr = mate_pairs
    assert_same_outputs(jdir, tdir)
    assert os.path.exists(os.path.join(tdir, "misc", "broken_scaffolds.fasta"))


def test_mate_pair_library_reaches_the_scaffold_graph(mate_pairs):
    rr = mate_pairs[2]
    libs = [st for _, s, st in rr if s == "pair_info_count"]
    assert [st["lib_type"] for st in libs] == ["paired-end", "mate-pairs"]
    assert abs(libs[0]["is_median"] - 300) <= 15 and abs(libs[1]["is_median"] - 3000) <= 150
    (de,) = [st for _, s, st in rr if s == "distance_estimation"]
    assert de["mp_entries"] > 0 and de["scaffold_entries"] > de["improved_entries"] - de["added"]
    (res,) = [st for _, s, st in rr if s == "repeat_resolving"]
    assert res["scaffold_graph_links"] is not None
    assert res["scaffolds"] < res["paths"]          # scaffolds join paths across the holes


# -- what stays refused -------------------------------------------------------------

def test_long_read_checkpoints_are_refused(tmp_path):
    with pytest.raises(NotImplementedError, match="A13"):
        t_serialize.load_long_reads(str(tmp_path / "long_reads.npz"))


def test_import_scan_covers_the_new_modules():
    new = ["paired/paired_info.py", "paired/distance_estimation.py",
           "paired/pair_info_improver.py", "paired/path_extend.py",
           "aux_graphs/__init__.py", "aux_graphs/scaffold_graph.py",
           "pipeline/executors.py", "pipeline/main.py", "pipeline/spades_stages.py",
           "pipeline/run.py", "graph/serialize.py", "convert.py"]
    for rel in new:
        path = REPO / "spades_tpu_torch" / rel
        assert path.exists(), rel
        tops = {m.split(".")[0] for m in _imported_modules(path)}
        assert not tops & {"jax", "jaxlib", "spades_tpu"}, rel
