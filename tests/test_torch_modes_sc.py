"""Port parity for `graph/from_gfa.py` and the LoadGraph stage
(`run_assembly(assembly_graph=)`), and for `run_assembly` in the modes `sc`
and `sewage` (which add no stage: `sc` changes the simplification config and
the coverage model's branch, `sewage` only skips error correction in the
CLI).

The same inputs (made from seeds with numpy) go through `spades_tpu` and
`spades_tpu_torch` (`device="cpu"`); loaded graphs, their synthesized
(k+1)-mer tables and every output file must be exactly equal (tolerance 0),
the GFA but for its header line, which names the writing package.  The
modes run on `make_e2e_dataset(30_000, 20, 100, 0.003, seed=1)` over
K = 21, 33, 55 with repeat resolution, at lowered device thresholds; the
GFA start loads the `sc` run's graph at K = 55 (the main iteration only).
"""
import dataclasses
import os

import numpy as np
import pytest

from spades_tpu.graph.from_gfa import graph_from_gfa as j_from_gfa
from spades_tpu.io import gfa as j_gfa
from spades_tpu.pipeline import spades_stages as j_stages
from spades_tpu.pipeline.construction import construct_graph as j_construct
from spades_tpu.pipeline.stages import AssemblyContext as JContext
from spades_tpu.utils.errors import SpadesError as JError
from spades_tpu_torch.graph.from_gfa import graph_from_gfa as t_from_gfa
from spades_tpu_torch.io import gfa as t_gfa
from spades_tpu_torch.pipeline import spades_stages as t_stages
from spades_tpu_torch.pipeline import stages as t_stage_rt
from spades_tpu_torch.pipeline.stages import AssemblyContext as TContext
from spades_tpu_torch.utils.errors import ExitCode, SpadesError
from tests.conftest import random_condensed_graph
from tests.test_torch_modes import (RR_TAIL, K, _random_seq, _to_port, assert_same_run,
                                    run_modes, stage_lists)
from tests.test_torch_pipeline import (GFA, THRESHOLDS, assert_same_file, assert_same_graph,
                                       one_torch_thread)


@pytest.fixture(scope="module")
def lowered():
    """Both packages count, index and map on their device paths."""
    with pytest.MonkeyPatch.context() as mp:
        for name, value in THRESHOLDS.items():
            mp.setenv(name, value)
        yield mp


# -- from_gfa.py ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", [3, 9])
def test_graph_from_gfa_of_either_package(tmp_path, seed):
    """A GFA written by either package loads to the JAX package's graph:
    the DSU's union order fixes the vertex ids, and the header line, the one
    line in which the files differ, is not read."""
    g = random_condensed_graph(np.random.default_rng(seed))
    jpath, tpath = str(tmp_path / "j" / GFA), str(tmp_path / "t" / GFA)
    os.makedirs(tmp_path / "j")
    os.makedirs(tmp_path / "t")
    j_gfa.write_gfa(jpath, g)
    t_gfa.write_gfa(tpath, _to_port(g))
    assert_same_file(jpath, tpath)
    want = j_from_gfa(j_gfa.read_gfa(jpath), g.k)
    for path in (jpath, tpath):
        parsed = t_gfa.read_gfa(path)
        assert dataclasses.asdict(parsed) == dataclasses.asdict(j_gfa.read_gfa(path))
        got = t_from_gfa(parsed, g.k)
        got.check_invariants()
        assert_same_graph(want, got)


def test_graph_from_gfa_of_an_assembly(tmp_path):
    """A branching graph from reads (a SNP bulge, coverage in DP tags) and
    links listed out of order, so that unions merge classes both ways."""
    a = _random_seq(300, 11)
    b = a[:150] + "ACGT"[("ACGT".index(a[150]) + 1) % 4] + a[151:]
    g = j_construct([a, a, b], K).graph
    path = str(tmp_path / "g.gfa")
    j_gfa.write_gfa(path, g)
    gg = j_gfa.read_gfa(path)
    gg.links = gg.links[::-1]
    tg = t_gfa.read_gfa(path)
    tg.links = tg.links[::-1]
    assert_same_graph(j_from_gfa(gg, K), t_from_gfa(tg, K))
    assert len(gg.links) > 2


def test_graph_from_gfa_refuses_other_overlaps(tmp_path):
    path = str(tmp_path / "g.gfa")
    with open(path, "w") as fh:
        fh.write("H\tVN:Z:1.2\nS\t1\t" + "A" * 40 + "\nS\t2\t" + "C" * 40 + "\n"
                 "L\t1\t+\t2\t+\t15M\n")
    with pytest.raises(JError) as jerr:
        j_from_gfa(j_gfa.read_gfa(path), K)
    with pytest.raises(SpadesError) as terr:
        t_from_gfa(t_gfa.read_gfa(path), K)
    assert str(terr.value) == str(jerr.value)
    assert terr.value.code == ExitCode.INVALID_INPUT_FORMAT == int(jerr.value.code) == 64


def test_load_graph_stage_matches(tmp_path):
    """LoadGraph's graph and its synthesized (k+1)-mer table, and the
    coverage model GenomicInfoFiller fits to it."""
    g = random_condensed_graph(np.random.default_rng(5))
    path = str(tmp_path / "g.gfa")
    j_gfa.write_gfa(path, g)
    jctx = JContext(k=g.k, output_dir=str(tmp_path))
    tctx = TContext(k=g.k, output_dir=str(tmp_path), device="cpu")
    for stages, ctx in ((j_stages, jctx), (t_stages, tctx)):
        stages.LoadGraph(path).run(ctx)
        stages.GenomicInfoFiller().run(ctx)
    assert_same_graph(jctx.graph, tctx.graph)
    for f in ("words", "counts"):
        a, b = getattr(jctx.p1_counts, f), getattr(tctx.p1_counts, f)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f
    assert tctx.p1_counts.k == jctx.p1_counts.k == g.k + 1
    assert dataclasses.asdict(tctx.genomic_info) == dataclasses.asdict(jctx.genomic_info)


# -- run_assembly in sc and sewage, and from a GFA -----------------------------------

@pytest.fixture(scope="module")
def sc_runs(tmp_path_factory, lowered):
    t_stage_rt.STAGE_TIMES.clear()
    t_stages.MODE_STATS.clear()
    from_gfa = ("assembly_graph", [33, 55],
                lambda runs: {"assembly_graph": os.path.join(runs["sc"][0], GFA)})
    runs = run_modes(tmp_path_factory.mktemp("sc"), ("sc", "sewage"), [from_gfa])
    return runs, list(t_stage_rt.STAGE_TIMES), list(t_stages.MODE_STATS)


@pytest.mark.parametrize("name", ["sc", "sewage", "assembly_graph"])
def test_run_files_match(sc_runs, name):
    assert_same_run(sc_runs[0][name])


def test_run_stage_lists(sc_runs):
    runs, times, stats = sc_runs
    per_run = stage_lists(times, [("sc", 3), ("sewage", 3), ("assembly_graph", 1)])
    for mode in ("sc", "sewage"):
        assert per_run[mode][-5:] == ["gap_closer_late"] + RR_TAIL
    assert per_run["assembly_graph"] == ["load_graph", "ec_threshold_finder"] + RR_TAIL
    [(k, sid, st)] = stats
    assert (k, sid) == (55, "load_graph") and st["edges"] > 0
    assert not os.path.exists(os.path.join(runs["assembly_graph"][1], "K33", "contigs.fasta"))
    # sc's own simplification and coverage branch ran: its files are not sewage's
    with open(os.path.join(runs["sc"][1], "K21", "contigs.fasta")) as a, \
            open(os.path.join(runs["sewage"][1], "K21", "contigs.fasta")) as b:
        assert a.read() != b.read()
