"""Port parity for BinSPreader: `graph/binning.py` and `tools/binspreader.py`.

The inputs are made from seeds with numpy, as `tests/test_binning.py` (the
oracle) makes them: two components of two random genomes with a SNP bulge
each, Hi-C-like mates from one genome to the other, and a bigger graph of
three genomes sharing a segment for the CLI.  Every function of the module
runs through both packages on the same inputs; the float64 states are held
bit for bit (the port keeps the reference's `np.add.at` order), the link
index (vectorized in the port), assignments, alpha masks, read splits and
the CLI's `binning.tsv`, `reads_bin_*.ids` and printed lines equal
(tolerance 0).  The port maps the mates on the device path (CPU tensors
here) where the JAX package builds a host index.
"""
import numpy as np
import pytest
import torch

from spades_tpu.alignment.mapper import build_edge_index, map_read_batch
from spades_tpu.core import dna as j_dna
from spades_tpu.graph import binning as JB
from spades_tpu.pipeline.construction import construct_graph
from spades_tpu.tools import binspreader as j_tool
from spades_tpu_torch import convert
from spades_tpu_torch.alignment.mapper import MappingEngine
from spades_tpu_torch.graph import binning as TB
from spades_tpu_torch.tools import binspreader as t_tool
from tests.test_binning import _random_seq, _two_component_graph
from tests.test_torch_graph_tools import _same_tree
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401


def _port_graph(g):
    return convert.graph_from_arrays({f: getattr(g, f) for f in (
        "k", "e_start", "e_end", "e_conj", "e_off", "e_len", "e_cov", "alive",
        "seq_pool", "v_conj")})


def _in(g, e, genome):
    s = g.edge_seq(e)
    return s[:60] in genome or j_dna.revcomp_str(s)[:60] in genome


@pytest.fixture(scope="module")
def two():
    g, a, b = _two_component_graph()
    r1 = [a[i : i + 60] for i in range(0, 200, 10)] + ["N" * 60, a[:10]]
    r2 = [b[i : i + 60] for i in range(0, 200, 10)] + [b[300:360], a[500:560]]
    idx = build_edge_index(g)
    m1, m2 = map_read_batch(idx, g, r1), map_read_batch(idx, g, r2)
    ids = sorted((int(e) for e in g.canonical_edge_ids()), key=lambda e: -int(g.e_len[e]))
    return {"g": g, "pg": _port_graph(g), "a": a, "b": b, "r1": r1, "r2": r2, "m1": m1,
            "m2": m2, "ids": ids,
            "a_edges": [e for e in ids if _in(g, e, a) and not _in(g, e, b)],
            "b_edges": [e for e in ids if _in(g, e, b) and not _in(g, e, a)]}


def _same_links(x, y):
    for f in ("src", "dst", "weight"):
        assert np.array_equal(getattr(x, f), getattr(y, f)), f
    assert x.num_links == y.num_links


def test_propagation_matches(two):
    g, pg = two["g"], two["pg"]
    initial = {two["a_edges"][0]: 0, two["b_edges"][0]: 1}
    assert np.array_equal(TB._adjacency(pg)[0], JB._adjacency(g)[0])
    for cfg in (None, JB.BinningConfig(eps=1e-9, max_iters=7, alpha=0.3)):
        tcfg = None if cfg is None else TB.BinningConfig(**vars(cfg))
        assert np.array_equal(TB.propagate_labels(pg, initial, 2, tcfg),
                              JB.propagate_labels(g, initial, 2, cfg))
    jdead = construct_graph([two["a"]], 21).graph
    jdead.kill_edges(jdead.alive_edge_ids())
    assert TB.propagate_labels(_port_graph(jdead), {}, 2).shape == (len(jdead.e_start), 2)
    names = {str(e): e for e in two["ids"]}
    binning = {str(two["a_edges"][0]): "binA", str(two["b_edges"][0]): "binB"}
    for multi in (False, True):
        assert (TB.refine_binning(pg, binning, names, multi=multi)
                == JB.refine_binning(g, binning, names, multi=multi))


def test_link_index_from_mappings_and_arrays(two):
    g, pg = two["g"], two["pg"]
    ref = JB.build_link_index(g, two["m1"], two["m2"])
    assert ref.num_links >= 1
    _same_links(TB.build_link_index(pg, two["m1"], two["m2"]), ref)
    engine = MappingEngine(pg, device="cpu")
    e1, e2 = (engine.map_sequences(r)[0] for r in (two["r1"], two["r2"]))
    assert np.array_equal(e1, TB.mapped_edges(two["m1"]))
    _same_links(TB.build_link_index(pg, e1, e2), ref)
    _same_links(TB.build_link_index(pg, e1[:5], e2), JB.build_link_index(g, two["m1"][:5],
                                                                         two["m2"]))
    none = [None] * len(two["m1"])
    _same_links(TB.build_link_index(pg, none, two["m2"]), JB.build_link_index(g, none, two["m2"]))


def test_linked_propagation_alpha_and_splits_match(two):
    g, pg = two["g"], two["pg"]
    links = JB.build_link_index(g, two["m1"], two["m2"])
    tlinks = TB.build_link_index(pg, two["m1"], two["m2"])
    a_edge, b_edge = two["a_edges"][0], two["b_edges"][0]
    for initial in ({a_edge: 0}, {a_edge: 0, b_edge: 1}):
        n = len(set(initial.values()))
        for li, tli in ((None, None), (links, tlinks)):
            assert np.array_equal(TB.propagate_labels_linked(pg, initial, n, links=tli),
                                  JB.propagate_labels_linked(g, initial, n, links=li))
    alpha = JB.alpha_mask(g, set(two["a_edges"]), links=links, metaalpha=0.6)
    assert np.array_equal(TB.alpha_mask(pg, set(two["a_edges"]), links=tlinks, metaalpha=0.6),
                          alpha)
    assert np.array_equal(TB.alpha_mask(pg, {a_edge}, length_threshold=100),
                          JB.alpha_mask(g, {a_edge}, length_threshold=100))
    state = JB.propagate_labels_linked(g, {a_edge: 0, b_edge: 1}, 2, links=links, alpha=alpha)
    assert np.array_equal(
        TB.propagate_labels_linked(pg, {a_edge: 0, b_edge: 1}, 2, links=tlinks, alpha=alpha),
        state)
    for strategy in ("majority_length", "max_likelihood"):
        bins = JB.assign_bins(state, strategy, thr=0.35)
        assert TB.assign_bins(state, strategy, thr=0.35) == bins
        for mates in ("m1", "m2"):
            assert TB.split_reads(pg, two[mates], bins) == JB.split_reads(g, two[mates], bins)
            edges = TB.mapped_edges(two[mates])
            assert TB.split_reads(pg, edges, bins) == JB.split_reads(g, two[mates], bins)
        for path in (two["ids"][:3], two["ids"], []):
            assert np.array_equal(
                TB.assign_scaffold_bins(path, bins, state, g.e_len, 2, strategy),
                JB.assign_scaffold_bins(path, bins, state, g.e_len, 2, strategy))
    fixed = np.array([[0.8, 0.2], [0.5, 0.5], [0.0, 0.0], [0.4, 0.6]])
    for strategy in ("majority_length", "max_likelihood"):
        assert TB.assign_bins(fixed, strategy) == JB.assign_bins(fixed, strategy)


@pytest.fixture(scope="module")
def community(tmp_path_factory):
    """Three random genomes, the first two sharing a 300-nt segment, as a
    k=21 graph in GFA, a seed binning of its longest segments and FR mates."""
    from spades_tpu.io.gfa import write_gfa

    d = tmp_path_factory.mktemp("binspreader")
    shared = _random_seq(300, 9)
    genomes = [_random_seq(3_000, 10) + shared + _random_seq(2_000, 11),
               _random_seq(1_500, 12) + shared + _random_seq(2_500, 13), _random_seq(2_500, 14)]
    rng = np.random.default_rng(15)
    reads, left, right = [], [], []
    for gi, gen in enumerate(genomes):
        for a in rng.integers(0, len(gen) - 300, 400):
            reads += [gen[a : a + 100], gen[a + 200 : a + 300]]
            left.append(gen[a : a + 100])
            right.append(j_dna.revcomp_str(gen[a + 200 : a + 300]))
    left.append(genomes[0][:100])                       # a Hi-C-like link
    right.append(genomes[2][1_000:1_100])
    g = construct_graph(reads, 21).graph
    gfa = str(d / "g.gfa")
    write_gfa(gfa, g)
    names = sorted(l.split("\t")[1] for l in open(gfa) if l.startswith("S\t"))
    seqs = {l.split("\t")[1]: l.split("\t")[2] for l in open(gfa) if l.startswith("S\t")}
    tsv = d / "bins.tsv"
    with open(tsv, "w") as fh:
        for n in names:
            s = seqs[n]
            hits = [i for i, gen in enumerate(genomes)
                    if s in gen or j_dna.revcomp_str(s) in gen]
            if len(s) >= 400 and len(hits) == 1:
                fh.write(f"{n}\tbin{hits[0]}\n")
    r1, r2 = d / "r1.fa", d / "r2.fa"
    r1.write_text("".join(f">p{i}/1\n{s}\n" for i, s in enumerate(left)))
    r2.write_text("".join(f">p{i}/2\n{s}\n" for i, s in enumerate(right)))
    return {"gfa": gfa, "tsv": str(tsv), "r1": str(r1), "r2": str(r2)}


@pytest.mark.parametrize("args", [
    [],
    ["--reads"],
    ["--reads", "--bin-dist", "--reads-split"],
    ["--reads", "--assignment", "max_likelihood", "--multi", "--reads-split"],
    ["--multi", "-e", "1e-3", "-n", "5"],
])
def test_cli_matches(community, tmp_path, capsys, args):
    argv = [community["gfa"], community["tsv"], "-k", "21"]
    for a in args:
        argv += ["-1", community["r1"], "-2", community["r2"]] if a == "--reads" else [a]
    outs = {}
    for name, main, extra in (("j", j_tool.main, []), ("t", t_tool.main, ["--device", "cpu"])):
        out = str(tmp_path / name)
        assert main(argv + ["-w", out] + extra) == 0
        outs[name] = capsys.readouterr().out.replace(out, "<out>")
    assert outs["t"] == outs["j"]
    names = _same_tree(str(tmp_path / "j"), str(tmp_path / "t"))
    assert "binning.tsv" in names
    if "--reads-split" in args:
        assert len(names) >= 3
    rows = open(tmp_path / "t" / "binning.tsv").read().splitlines()
    assert len(rows) > len(open(community["tsv"]).read().splitlines())
    if "--reads" in args and not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_tool.main(argv + ["-w", str(tmp_path / "x")])
