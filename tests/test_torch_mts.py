"""Port parity for the MTS modules (`mts/multiplicity.py`, `abundance.py`,
`binning.py`, `series_analysis.py`) and the SeriesAnalysis stage.

The cases are those of `tests/test_mts.py` and `tests/test_series_analysis.py`.
The same reads (made from seeds with numpy) are counted by both packages
(the port on its device path, `device="cpu"`, at a lowered
`SPADES_HOST_COUNT_WINDOWS`); profiles, abundances, bins, the dump files and
the cleared graphs must be exactly equal (tolerance 0: integer counts, then
the same float64 numpy).  Each package loads the other's `.npz` profiles,
and the port's flat-YAML reader is held to `yaml.safe_load`.
"""
import dataclasses

import numpy as np
import pytest
import yaml

from spades_tpu.graph.graph import CondensedGraph as JGraph
from spades_tpu.mts import abundance as j_ab
from spades_tpu.mts import binning as j_bin
from spades_tpu.mts import multiplicity as j_mult
from spades_tpu.mts import series_analysis as j_sa
from spades_tpu.ops.count import count_sequences as j_count
from spades_tpu.pipeline import spades_stages as j_stages
from spades_tpu.pipeline.stages import AssemblyContext as JContext
from spades_tpu_torch import convert
from spades_tpu_torch.mts import abundance as t_ab
from spades_tpu_torch.mts import binning as t_bin
from spades_tpu_torch.mts import multiplicity as t_mult
from spades_tpu_torch.mts import series_analysis as t_sa
from spades_tpu_torch.ops.count import count_sequences as t_count
from spades_tpu_torch.pipeline import spades_stages as t_stages
from spades_tpu_torch.pipeline.stages import AssemblyContext as TContext
from tests.test_torch_pipeline import THRESHOLDS, assert_same_graph, one_torch_thread

K = 21


@pytest.fixture(scope="module", autouse=True)
def lowered():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPADES_HOST_COUNT_WINDOWS", THRESHOLDS["SPADES_HOST_COUNT_WINDOWS"])
        yield mp


def _seq(n, seed):
    return "".join("ACGT"[i] for i in np.random.default_rng(seed).integers(0, 4, n))


def _reads(genome, n, rlen, seed):
    rng = np.random.default_rng(seed)
    return [genome[s : s + rlen] for s in rng.integers(0, len(genome) - rlen, n)]


def _same_profiles(a, b):
    assert a.k == b.k
    assert a.words.dtype == b.words.dtype and np.array_equal(a.words, b.words)
    assert a.mpl.dtype == b.mpl.dtype and np.array_equal(a.mpl, b.mpl)


def _sets(seed=1, n=400):
    """A 'bin' genome deep in sample 1 and a contaminant deep in sample 2."""
    g1, g2 = _seq(n, seed), _seq(n, seed + 1)
    sets = [_reads(g1, 400, 60, seed + 2) + _reads(g2, 40, 60, seed + 3),
            _reads(g1, 40, 60, seed + 4) + _reads(g2, 400, 60, seed + 5)]
    return g1, g2, sets


# -- multiplicity ------------------------------------------------------------------

@pytest.mark.parametrize("min_samples, min_mult", [(1, 5), (2, 5), (1, 2), (3, 1)])
def test_combine_multiplicities_matches(min_samples, min_mult):
    g1, g2 = _seq(300, 10), _seq(300, 11)
    seqs = [_reads(g1, 200, 60, 12), _reads(g1, 200, 60, 13) + _reads(g2, 200, 60, 14),
            _reads(g2, 50, 60, 15)]
    jc = [j_count(s, K) for s in seqs]
    tc = [t_count(s, K, device="cpu") for s in seqs]
    for a, b in zip(jc, tc):
        assert np.array_equal(a.words, b.words) and np.array_equal(a.counts, b.counts)
    jp = j_mult.combine_multiplicities(jc, min_samples, min_mult)
    tp = t_mult.combine_multiplicities(tc, min_samples, min_mult)
    _same_profiles(jp, tp)
    probe = t_count([g2], K, device="cpu").words
    assert np.array_equal(tp.lookup(probe), jp.lookup(probe))
    with pytest.raises(ValueError):
        t_mult.combine_multiplicities([])


def test_profiles_from_read_sets_match():
    _g1, _g2, sets = _sets()
    _same_profiles(j_mult.profiles_from_read_sets(sets, K, 1, 2),
                   t_mult.profiles_from_read_sets(sets, K, 1, 2, device="cpu"))


def test_each_package_loads_the_others_profiles(tmp_path):
    _g1, _g2, sets = _sets(seed=20)
    jp = j_mult.profiles_from_read_sets(sets, K, 1, 2)
    tp = convert.kmer_profiles_from_arrays(dataclasses.asdict(jp))
    _same_profiles(jp, tp)
    jp.save(str(tmp_path / "j.npz"))
    tp.save(str(tmp_path / "t.npz"))
    _same_profiles(t_mult.KmerProfiles.load(str(tmp_path / "j.npz")), jp)
    _same_profiles(j_mult.KmerProfiles.load(str(tmp_path / "t.npz")), tp)


# -- abundance and binning -----------------------------------------------------------

def test_estimators_match():
    m = np.array([[10, 0], [12, 0], [11, 0], [100, 0]], np.uint16)
    for a, b in zip(t_ab.median_mad(m), j_ab.median_mad(m)):
        assert np.array_equal(a, b)
    for frac in (0.25, 0.1):
        for a, b in zip(t_ab.winsorized_mean_var(m, frac=frac),
                        j_ab.winsorized_mean_var(m, frac=frac)):
            assert np.array_equal(a, b)


def test_contig_profiles_match():
    g1, g2, sets = _sets(seed=30)
    jp = j_mult.profiles_from_read_sets(sets, K, 1, 2)
    tp = convert.kmer_profiles_from_arrays(dataclasses.asdict(jp))
    contigs = [g1, g2, _seq(300, 33), g1[:15], g1[:100] + "N" + g1[101:]]
    for a, b in zip(t_ab.contig_profiles(tp, contigs), j_ab.contig_profiles(jp, contigs)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ab, _disp, ok = t_ab.contig_profiles(tp, contigs)
    assert ok[:2].all() and not ok[2] and ab[0, 0] > ab[0, 1] and ab[1, 1] > ab[1, 0]


@pytest.mark.parametrize("case", ["two_groups", "single_sample", "empty"])
def test_canopy_bins_match(case):
    rng = np.random.default_rng(40)
    a, b = np.array([50.0, 5.0, 40.0]), np.array([3.0, 60.0, 8.0])
    profs = {
        "two_groups": np.vstack([a * rng.uniform(0.8, 1.2) for _ in range(5)]
                                + [b * rng.uniform(0.8, 1.2) for _ in range(5)]),
        "single_sample": np.array([[5.0], [7.0]]),
        "empty": np.zeros((0, 3)),
    }[case]
    for thr in (0.9, 0.5):
        t = t_bin.canopy_bins(profs, merge_threshold=thr)
        assert np.array_equal(t, j_bin.canopy_bins(profs, merge_threshold=thr))
    if case == "two_groups":
        assert len(set(t[:5])) == 1 and len(set(t[5:])) == 1 and t[0] != t[5]


# -- series analysis -----------------------------------------------------------------

@pytest.fixture
def series():
    g1, g2, sets = _sets(seed=50)
    jp = j_mult.profiles_from_read_sets(sets, K, 1, 2)
    jg = JGraph.from_sequences([g1, g2], K)
    tg = convert.graph_from_arrays(dataclasses.asdict(jg))
    return jg, tg, jp, convert.kmer_profiles_from_arrays(dataclasses.asdict(jp))


def test_cosine_and_bin_abundance_match(tmp_path):
    for a, b in ((np.array([1.0, 0]), np.array([2.0, 0])), (np.array([1.0, 0]), np.array([0, 3.0])),
                 (np.zeros(2), np.ones(2)), (np.array([3.0, 4.0]), np.array([4.0, 3.0]))):
        assert t_sa.cosine_sim(a, b) == j_sa.cosine_sim(a, b)
    path = str(tmp_path / "bins.prof")
    with open(path, "w") as fh:
        fh.write("BIN1 10 2\nBIN2 1 50\nBIN1 14 4\nBIN1 3\n")
    for bin_id in ("BIN1", "BIN2", "BIN3"):
        assert np.array_equal(t_sa.infer_bin_abundance(path, bin_id, 2),
                              j_sa.infer_bin_abundance(path, bin_id, 2))


@pytest.mark.parametrize("sim, norm", [(0.8, 0.1), (0.99, 0.5), (0.1, 0.0)])
def test_edge_profiles_and_clearing_match(series, sim, norm):
    jg, tg, jp, tp = series
    jep, tep = j_sa.edge_profiles(jp, jg), t_sa.edge_profiles(tp, tg)
    assert list(tep) == list(jep) and all(np.array_equal(tep[e], jep[e]) for e in jep)
    base = jep[min(jep)]
    assert t_sa.aggressive_clearing(tg, tep, base, sim, norm) == \
        j_sa.aggressive_clearing(jg, jep, base, sim, norm)
    assert_same_graph(jg, tg)


def _config(d, k, mult, **kw):
    return dict(k=k, sample_cnt=2, kmer_mult=mult, min_len=50, frag_size=100,
                edges_sqn=str(d / "edges.fasta"), edges_mpl=str(d / "edges.mpl"),
                edge_fragments_mpl=str(d / "frags.mpl"), **kw)


def test_run_series_analysis_dumps_match(series, tmp_path):
    jg, tg, jp, _tp = series
    mult = str(tmp_path / "profiles.npz")
    jp.save(mult)
    out = {}
    for name, sa, g in (("j", j_sa, jg), ("t", t_sa, tg)):
        d = tmp_path / name
        d.mkdir()
        sa.run_series_analysis(g, sa.SeriesAnalysisConfig(**_config(d, jp.k, mult)))
        out[name] = {f: (d / f).read_bytes() for f in ("edges.fasta", "edges.mpl", "frags.mpl")}
    assert out["t"] == out["j"]
    assert out["t"]["edges.fasta"].count(b">") == 2
    assert len(out["t"]["frags.mpl"].splitlines()) == 8


def test_series_analysis_stage_matches(series, tmp_path):
    """The stage reads its flat YAML config (written for PyYAML in the
    reference) and writes the three dumps."""
    jg, tg, jp, _tp = series
    mult = str(tmp_path / "profiles.npz")
    jp.save(mult)
    dumps = {}
    for name, stages, ctx_cls, g in (("j", j_stages, JContext, jg), ("t", t_stages, TContext, tg)):
        d = tmp_path / name
        d.mkdir()
        cfg = str(d / "series.yaml")
        with open(cfg, "w") as fh:
            fh.write("# series analysis\n" + yaml.safe_dump(_config(d, jp.k, mult, bin="BIN1")))
        ctx = ctx_cls(k=K, output_dir=str(d))
        ctx.graph = g
        stages.SeriesAnalysis(cfg).run(ctx)
        dumps[name] = [(d / f).read_bytes() for f in ("edges.fasta", "edges.mpl", "frags.mpl")]
    assert dumps["t"] == dumps["j"]


# -- the flat-YAML reader ----------------------------------------------------------------

SCALARS = ["21", "-3", "+4", "1_000", "0", "09", "1.5", ".5", "+.5", "-.5", "1.", "1e5",
           "1.0e+5", "yes", "No", "on", "OFF", "y", "n", "true", "~", "null", "NULL", "",
           "abc", "a b", "mult.npz", "/data/x/profiles.npz", "'quoted # x'", "'it''s'",
           '"a\\tb"', '"x"', "a#b", "value # comment", "-x", "?x", ":x", "a:b",
           "http://x", "1.2.3", "3x", "_x", "x_1", "BIN1"]
REFUSED = ["007", "0x1F", "0b101", "1:30", ".inf", "-.inf", ".nan", "2020-01-01", "-", "- x",
           "[1]", "{a: 1}", "&a", "*a", "!x", "|", ">", "%x", "@x", "`x", ",x", "a: b",
           "'open", '"bad\\q"']


@pytest.mark.parametrize("value", SCALARS)
def test_flat_yaml_reader_reads_as_pyyaml(value):
    text = f"key: {value}\n" if value else "key:\n"
    got = t_sa.load_flat_yaml(text)
    want = yaml.safe_load(text)
    assert got == want and type(got["key"]) is type(want["key"])


@pytest.mark.parametrize("value", REFUSED)
def test_flat_yaml_reader_refuses_what_it_would_misread(value):
    with pytest.raises(ValueError):
        t_sa.load_flat_yaml(f"key: {value}\n")


def test_flat_yaml_reader_reads_a_config_file():
    text = ("# config\n---\nk: 21\nsample_cnt: 3   # three\nkmer_mult: mult.npz\n\n"
            "min_len: 100\nbin:\nbin_prof: 'p.tsv'\n")
    assert t_sa.load_flat_yaml(text) == yaml.safe_load(text)
    for bad in ("k: 21\nk: 22\n", "k:\n  - 1\n", "k 21\n", "a-b: 1\n"):
        with pytest.raises(ValueError):
            t_sa.load_flat_yaml(bad)
