"""Port parity for the plasmid slice: `graph/chromosome_remover.py`, the
ChromosomeRemoval and MetaplasmidExtraction stages, and `run_assembly` in
the modes `plasmid`, `metaplasmid` and `metaviral`.

The same inputs (made from seeds with numpy) go through `spades_tpu` and
`spades_tpu_torch` (`device="cpu"`); graphs, emitted components and every
output file, `components*.fasta` included, must be exactly equal (tolerance
0: the work is integer and the float code is the same numpy), the GFA but
for its header line, which names the writing package.  The cases of the
remover are those of `tests/test_plasmid_binreads.py` and
`tests/test_metaplasmid.py`; the modes run on
`make_e2e_dataset(30_000, 20, 100, 0.003, seed=1)` over K = 21, 33, 55 with
repeat resolution, at lowered device thresholds so that both packages
count, index and map on their device paths.  `sc`, `sewage` and
`assembly_graph=` are held by `tests/test_torch_modes_sc.py`.
"""
import dataclasses
import os

import numpy as np
import pytest

from spades_tpu.core import dna as j_dna
from spades_tpu.graph import chromosome_remover as j_cr
from spades_tpu.graph.graph import CondensedGraph as JGraph
from spades_tpu.pipeline import run as j_run
from spades_tpu.pipeline.construction import construct_graph as j_construct
from spades_tpu_torch import convert
from spades_tpu_torch.graph import chromosome_remover as t_cr
from spades_tpu_torch.pipeline import run as t_run
from spades_tpu_torch.pipeline import spades_stages as t_stages
from spades_tpu_torch.pipeline import stages as t_stage_rt
from spades_tpu_torch.tools import synthetic
from tests.test_torch_pipeline import (LADDER, OUTPUTS, THRESHOLDS, assert_same_file,
                                       assert_same_graph, one_torch_thread)

K = 21


@pytest.fixture(scope="module")
def lowered():
    """Both packages count, index and map on their device paths."""
    with pytest.MonkeyPatch.context() as mp:
        for name, value in THRESHOLDS.items():
            mp.setenv(name, value)
        yield mp


def _to_port(jg):
    return convert.graph_from_arrays(dataclasses.asdict(jg))


def _random_seq(n, seed):
    return j_dna.decode(np.random.default_rng(seed).integers(0, 4, n).astype(np.uint8))


def _tile(seq, cov, rl=100, seed=0):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(seq) - rl + 1, int(len(seq) * cov / rl))
    return [seq[s : s + rl] for s in starts]


# -- chromosome_remover.py -----------------------------------------------------------

def _mixed_graph():
    """A 4 kb chromosome at 30x and an 800 bp circular plasmid at 60x (the
    case of `tests/test_plasmid_binreads.py`)."""
    chrom, plasmid = _random_seq(4000, 1), _random_seq(800, 2)
    circ = plasmid + plasmid[: 2 * K]
    reads = _tile(chrom, 30, seed=3) + _tile(circ, 60, seed=4)
    return j_construct(reads, K, min_count=2).graph


def _uniform_graph():
    return j_construct(_tile(_random_seq(3000, 5), 30, seed=6), K, min_count=2).graph


def _two_cov_graph(seed):
    """A deep uniform 'plasmid' and a shallow background (the case of
    `tests/test_metaplasmid.py`)."""
    rng = np.random.default_rng(seed)
    plasmid = "".join("ACGT"[i] for i in rng.integers(0, 4, 3000))
    background = "".join("ACGT"[i] for i in rng.integers(0, 4, 2000))
    g = JGraph.from_sequences([plasmid, background], K)
    g.e_cov[0] = g.e_cov[1] = 80.0 * (g.e_len[0] - K)
    g.e_cov[2] = g.e_cov[3] = 6.0 * (g.e_len[2] - K)
    return g


@pytest.mark.parametrize("make", [_mixed_graph, _uniform_graph])
@pytest.mark.parametrize("long_edge", [1000, 300])
def test_remove_chromosomal_matches(make, long_edge):
    jg = make()
    tg = _to_port(jg)
    assert t_cr.weighted_median_coverage(tg, long_edge) == \
        j_cr.weighted_median_coverage(jg, long_edge)
    assert {r: list(e) for r, e in t_cr._components(tg).items()} == \
        {r: list(e) for r, e in j_cr._components(jg).items()}
    n = t_cr.remove_chromosomal(tg, t_cr.PlasmidConfig(long_edge_length=long_edge))
    assert n == j_cr.remove_chromosomal(jg, j_cr.PlasmidConfig(long_edge_length=long_edge))
    assert_same_graph(jg, tg)
    assert dataclasses.asdict(t_cr.PlasmidConfig()) == dataclasses.asdict(j_cr.PlasmidConfig())


def test_remove_chromosomal_keeps_the_plasmid():
    tg = _to_port(_mixed_graph())
    assert t_cr.remove_chromosomal(tg, t_cr.PlasmidConfig(long_edge_length=1000)) > 0
    remaining = [len(tg.edge_seq(int(e))) for e in tg.canonical_edge_ids()]
    assert all(n < 3000 for n in remaining) and any(n >= 700 for n in remaining)
    assert t_cr.weighted_median_coverage(_to_port(_mixed_graph()), 10**6) == 0.0


@pytest.mark.parametrize("seed", [42, 7])
def test_metaplasmid_iteration_matches(seed):
    """Every round of the loop's cutoffs, on the two-coverage case and on
    the mixed assembly graph: the emitted components (names and sequences)
    and the graph after each round's stripping."""
    for jg in (_two_cov_graph(seed), _mixed_graph()):
        tg = _to_port(jg)
        cov = 5.0
        emitted = 0
        while cov < 600.0 and jg.num_edges > 0:
            jc, jn = j_cr.metaplasmid_iteration(jg, cov)
            tc, tn = t_cr.metaplasmid_iteration(tg, cov)
            assert (tc, tn) == (jc, jn)
            assert_same_graph(jg, tg)
            emitted += len(tc)
            cov = max(cov + 5.0, cov * 1.3)
        assert emitted > 0
    comps, _ = t_cr.metaplasmid_iteration(_to_port(_two_cov_graph(seed)), 10.0)
    assert len(comps) == 1 and comps[0][0].startswith("CUTOFF_10_COMPONENT_1_EDGE_1")
    assert t_cr.metaplasmid_iteration(_to_port(_two_cov_graph(seed)), 70.0)[0] == []


# -- run_assembly in the modes ---------------------------------------------------------

MODES = ("plasmid", "metaplasmid", "metaviral")


def run_modes(tmp, modes, extra=()):
    """Both packages over the ladder in each of `modes`, then each `extra`
    (name, k_list, keyword arguments) run; returns {name: (jax dir, port dir,
    JAX result, port result)}."""
    _genome, r1, r2 = synthetic.make_e2e_dataset(30_000, 20, 100, 0.003, seed=1,
                                                 insert_mean=300, insert_sd=20)
    lefts, rights = list(r1), list(r2)
    runs = {}
    base = dict(paired_libs=[(lefts, rights)], read_length=100)
    for name, ks, kw in [(m, LADDER, {"mode": m}) for m in modes] + list(extra):
        if callable(kw):
            kw = kw(runs)
        jdir, tdir = str(tmp / f"{name}_j"), str(tmp / f"{name}_t")
        jres = j_run.run_assembly(lefts + rights, ks, jdir, **base, **kw)
        tres = t_run.run_assembly(lefts + rights, ks, tdir, device="cpu", **base, **kw)
        runs[name] = (jdir, tdir, jres, tres)
    return runs


def files_under(root):
    """Every file under `root` but the checkpoints."""
    return {os.path.relpath(os.path.join(d, n), root)
            for d, _dirs, names in os.walk(root) for n in names
            if "saves" not in os.path.relpath(d, root).split(os.sep)}


def assert_same_files(jdir, tdir, names):
    """The files `names` under both directories are equal; a graph emptied
    by the extraction loop leaves empty files and a GFA of its header."""
    for rel in sorted(names):
        a, b = os.path.join(jdir, rel), os.path.join(tdir, rel)
        with open(a) as fa, open(b) as fb:
            la, lb = fa.readlines(), fb.readlines()
        if len(la) <= 1:
            assert len(lb) == len(la), rel
            assert not la or la[0].split("\t")[:2] == lb[0].split("\t")[:2], rel
        else:
            assert_same_file(a, b)


def assert_same_run(run):
    """Every file the run wrote (the checkpoints aside), components*.fasta
    and misc/ included, and the last graph."""
    jdir, tdir, jres, tres = run
    names = files_under(jdir)
    assert names == files_under(tdir)
    assert {os.path.join("K55", n) for n in OUTPUTS[:4]} <= names    # the paths may be none
    assert_same_files(jdir, tdir, names)
    assert_same_graph(jres.graph, tres.graph)
    assert tres.k == jres.k == 55


def stage_lists(times, runs):
    """Split a `STAGE_TIMES` trail into the stage ids of each run, given
    (name, number of K) per run in order."""
    per_run, at = {}, 0
    for name, n_k in runs:
        ids = per_run[name] = []
        while ids.count("contig_output") < n_k:
            ids.append(times[at][1])
            at += 1
    assert at == len(times)
    return per_run


RR_TAIL = ["pair_info_count", "distance_estimation", "repeat_resolving", "contig_output"]


@pytest.fixture(scope="module")
def mode_runs(tmp_path_factory, lowered):
    t_stage_rt.STAGE_TIMES.clear()
    t_stages.MODE_STATS.clear()
    runs = run_modes(tmp_path_factory.mktemp("modes"), MODES)
    return runs, list(t_stage_rt.STAGE_TIMES), list(t_stages.MODE_STATS)


@pytest.mark.parametrize("mode", MODES)
def test_mode_files_match(mode_runs, mode):
    assert_same_run(mode_runs[0][mode])


def test_mode_stage_lists(mode_runs):
    """The stages each run went through, in order, and the mode stages'
    records: the chromosomal edges removed, the components emitted."""
    runs, times, stats = mode_runs
    per_mode = stage_lists(times, [(m, 3) for m in MODES])
    assert per_mode["plasmid"][-5:] == ["chromosome_removal"] + RR_TAIL
    for mode in ("metaplasmid", "metaviral"):
        assert per_mode[mode][-6:] == ["chromosome_removal", "metaplasmid_extraction"] + RR_TAIL
    assert [s for _k, s, _st in stats] == ["chromosome_removal"] + \
        ["chromosome_removal", "metaplasmid_extraction"] * 2
    assert all(st["removed"] > 0 for _k, s, st in stats if s == "chromosome_removal")
    emitted = [st["component_contigs"] for _k, s, st in stats if s == "metaplasmid_extraction"]
    assert all(n > 0 for n in emitted)
    comps = [n for n in files_under(runs["metaplasmid"][1]) if "components" in n]
    assert comps and all(n.startswith("K55" + os.sep + "components") for n in comps)
