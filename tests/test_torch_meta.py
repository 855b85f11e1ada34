"""Port parity for metaSPAdes' two-step repeat resolution (a preliminary
PairInfoCount / DistanceEstimation / RepeatResolution, then
SecondPhaseSetup, then the main pass with the preliminary contigs as trusted
paths).  The CLI's `--meta` and the wrappers are held by
`tests/test_torch_cli_modes.py`.

The same inputs (made from seeds with numpy) go through `spades_tpu` and
`spades_tpu_torch` (`device="cpu"`); every output file, `first_pe_contigs.fasta`
included, must be exactly equal (tolerance 0), the GFA but for its header
line, which names the writing package.  The library run is
`make_e2e_dataset(30_000, 20, 100, 0.003, seed=1)` over K = 21, 33, 55 at
lowered device thresholds.

The port gives the preliminary PairInfoCount and DistanceEstimation ids of
their own (`pair_info_count_preliminary`, `distance_estimation_preliminary`),
where the JAX package runs both passes under one id each: a restart or a
checkpoint names each pass apart.  The files are the same.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest

from spades_tpu.alignment import long_read as j_lr
from spades_tpu.core import dna as j_dna
from spades_tpu.graph.graph import CondensedGraph as JGraph
from spades_tpu.io.contigs import Contig as JContig
from spades_tpu.pipeline import run as j_run
from spades_tpu.pipeline import spades_stages as j_stages
from spades_tpu.pipeline.stages import AssemblyContext as JContext
from spades_tpu_torch import convert
from spades_tpu_torch.alignment import long_read as t_lr
from spades_tpu_torch.pipeline import run as t_run
from spades_tpu_torch.pipeline import spades_stages as t_stages
from spades_tpu_torch.pipeline import stages as t_stage_rt
from spades_tpu_torch.pipeline.stages import AssemblyContext as TContext
from spades_tpu_torch.tools import synthetic
from tests.test_torch_modes import assert_same_run, files_under
from tests.test_torch_pipeline import LADDER, THRESHOLDS, assert_same_file, one_torch_thread

FIRST_PE = os.path.join("K55", "first_pe_contigs.fasta")


@pytest.fixture(scope="module")
def lowered():
    """Both packages count, index and map on their device paths."""
    with pytest.MonkeyPatch.context() as mp:
        for name, value in THRESHOLDS.items():
            mp.setenv(name, value)
        yield mp


def _rand(n, rng):
    return j_dna.decode(rng.integers(0, 4, n).astype(np.uint8))


# -- SecondPhaseSetup ------------------------------------------------------------

@pytest.mark.parametrize("with_long_reads", [False, True])
def test_second_phase_setup_matches(tmp_path, with_long_reads):
    """The case of `tests/test_two_step_rr.py`, and a graph of two edges with
    two contigs over it and hybrid paths already stored: the trusted paths
    (merged with the hybrid ones, in the JAX package's dict order),
    `first_pe_contigs.fasta`, and the cleared RR products."""
    rng = np.random.default_rng(42)
    k = 21
    a, b = _rand(400, rng), _rand(300, rng)
    if with_long_reads:
        g = JGraph.from_sequences([a, b], k)
        contigs = [a, b[:250], a[50:] + "A" + b]
    else:
        g = JGraph.from_sequences([a], k)
        contigs = [a]
    out = {}
    for name, stages, make_ctx, graph in (
            ("j", j_stages, JContext, g),
            ("t", t_stages, TContext, convert.graph_from_arrays(dataclasses.asdict(g)))):
        d = tmp_path / name
        d.mkdir()
        ctx = make_ctx(k=k, output_dir=str(d), graph=graph)
        ctx.contigs = [JContig(name=f"NODE_{i + 1}", seq=s, coverage=10.0, edge_id=-1)
                       for i, s in enumerate(contigs)]
        ctx.is_stats = ctx.paired_index = object()
        if with_long_reads:
            lr = (j_lr if name == "j" else t_lr).LongReadStorage()
            for p in ([0, 2], [3, 1], [2, 0]):
                lr.add(p)
            ctx.long_read_storage = lr
        stages.SecondPhaseSetup().run(ctx)
        out[name] = ctx
        assert ctx.contigs == [] and ctx.scaffolds == [] and ctx.raw_pair_libs == []
        assert ctx.paired_index is None and ctx.is_stats is None
    assert_same_file(str(tmp_path / "j" / "first_pe_contigs.fasta"),
                     str(tmp_path / "t" / "first_pe_contigs.fasta"))
    assert list(out["t"].long_read_storage.paths.items()) == \
        list(out["j"].long_read_storage.paths.items())
    if with_long_reads:      # the contig across both edges adds to a stored path
        assert max(out["t"].long_read_storage.paths.values()) > 1


def test_second_phase_setup_without_contigs_does_nothing(tmp_path):
    ctx = TContext(k=21, output_dir=str(tmp_path), device="cpu")
    t_stages.SecondPhaseSetup().run(ctx)
    assert ctx.long_read_storage is None and os.listdir(tmp_path) == []


# -- run_assembly(mode="meta") with RR ---------------------------------------------------

@pytest.fixture(scope="module")
def meta(tmp_path_factory, lowered):
    _genome, r1, r2 = synthetic.make_e2e_dataset(30_000, 20, 100, 0.003, seed=1,
                                                 insert_mean=300, insert_sd=20)
    lefts, rights = list(r1), list(r2)
    tmp = tmp_path_factory.mktemp("meta")
    for trail in (t_stage_rt.STAGE_TIMES, t_stages.RR_STATS, t_stages.MODE_STATS):
        trail.clear()
    kw = dict(mode="meta", paired_libs=[(lefts, rights)], read_length=100, checkpoints="all")
    jres = j_run.run_assembly(lefts + rights, LADDER, str(tmp / "j"), **kw)
    tres = t_run.run_assembly(lefts + rights, LADDER, str(tmp / "t"), device="cpu", **kw)
    trails = (list(t_stage_rt.STAGE_TIMES), list(t_stages.RR_STATS),
              list(t_stages.MODE_STATS))
    return (str(tmp / "j"), str(tmp / "t"), jres, tres), trails, (lefts, rights)


def test_meta_files_match(meta):
    run = meta[0]
    assert_same_run(run)
    assert FIRST_PE in files_under(run[1])
    assert os.path.getsize(os.path.join(run[1], FIRST_PE)) > 0


def test_meta_runs_both_passes(meta):
    (_jdir, tdir, _jres, tres), (times, rr, modes), _reads = meta
    assert [s for k, s, _ in times if k == 55] == [
        "construction", "ec_threshold_finder", "raw_simplification", "gap_closer_early",
        "simplification", "gap_closer_late", "pair_info_count_preliminary",
        "distance_estimation_preliminary", "repeat_resolving_preliminary",
        "second_phase_setup", "pair_info_count", "distance_estimation", "repeat_resolving",
        "contig_output"]
    assert all(s.startswith(("construction", "ec_", "raw_", "gap_", "simpl", "contig"))
               for k, s, _ in times if k < 55)
    ids = [s for _k, s, _st in rr]
    assert ids == ["pair_info_count_preliminary", "distance_estimation_preliminary",
                   "repeat_resolving_preliminary", "pair_info_count", "distance_estimation",
                   "repeat_resolving"]
    pre, main = rr[0][2], rr[3][2]
    # the second pass maps onto the same graph: the same mappings
    for key in ("pairs", "mapped_left", "mapped_right", "mapped_both", "is_median",
                "raw_entries"):
        assert pre[key] == main[key], key
    [(_k, sid, st)] = modes
    assert sid == "second_phase_setup" and st["trusted_paths"] > 0
    with open(os.path.join(tdir, FIRST_PE)) as fh:
        assert fh.read().count(">") == st["first_pe_contigs"]
    assert len(tres.contigs) > 0


@pytest.mark.parametrize("restart", ["k55:pair_info_count_preliminary",
                                     "k55:second_phase_setup", "k55:pair_info_count"])
def test_meta_restart_at_either_pass(meta, tmp_path, lowered, restart):
    """A restart at either pass (each has its own checkpoint) writes the
    same files again."""
    (jdir, tdir, _jres, _tres), _trails, (lefts, rights) = meta
    again = str(tmp_path / "again")
    shutil.copytree(tdir, again)
    if restart != "k55:pair_info_count":     # a restart before SecondPhaseSetup writes it
        os.remove(os.path.join(again, FIRST_PE))
    t_stage_rt.STAGE_TIMES.clear()
    t_run.run_assembly(lefts + rights, LADDER, again, mode="meta",
                       paired_libs=[(lefts, rights)], read_length=100, checkpoints="all",
                       device="cpu", restart_from=restart)
    ran = [(k, s) for k, s, _ in t_stage_rt.STAGE_TIMES]
    assert ran[0] == (55, restart.split(":")[1]) and ran[-1] == (55, "contig_output")
    assert ran.count((55, "pair_info_count")) == 1
    assert_same_run((jdir, again, _jres, _tres))
