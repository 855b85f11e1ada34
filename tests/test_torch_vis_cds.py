"""Port parity for the remaining host tools and helpers: `tools/online_vis.py`
(the REPL's transcript), `graph/dot.py`, `tools/cds_subgraphs.py`,
`graph/synthetic.py` and `utils/memory.py`.

The inputs are made from seeds with numpy, as `tests/test_vis_cds_domains.py`,
`test_sam_memory.py` and the simplification benchmarks (the oracles) make
them: random genomes as k=21 graphs (one with a bulge and a tip), saved as
`.npz` and GFA, scripted REPL sessions with unknown commands and bad
arguments, CDS queries with and without a graph hit.  Transcripts, DOT and
GFA files (the GFA header names the package), synthetic graphs and memory
records must be equal (tolerance 0); cds_subgraphs maps its queries on the
device path (CPU tensors here) and raises without a card unless given
`--device cpu`.
"""
import io
import os

import numpy as np
import pytest
import torch

from spades_tpu.graph import dot as j_dot
from spades_tpu.graph import synthetic as j_synth
from spades_tpu.graph.serialize import save_graph
from spades_tpu.io.gfa import write_gfa
from spades_tpu.pipeline.construction import construct_graph
from spades_tpu.tools import cds_subgraphs as j_cds
from spades_tpu.tools import online_vis as j_vis
from spades_tpu.utils import memory as j_mem
from spades_tpu_torch import convert
from spades_tpu_torch.graph import dot as t_dot
from spades_tpu_torch.graph import synthetic as t_synth
from spades_tpu_torch.tools import cds_subgraphs as t_cds
from spades_tpu_torch.tools import online_vis as t_vis
from spades_tpu_torch.utils import memory as t_mem
from tests.test_torch_graph_tools import _same_tree
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401
from tests.test_vis_cds_domains import _random_seq

GRAPH_FIELDS = ("k", "e_start", "e_end", "e_conj", "e_off", "e_len", "e_cov", "alive",
                "seq_pool", "v_conj")


def _port_graph(g):
    return convert.graph_from_arrays({f: getattr(g, f) for f in GRAPH_FIELDS})


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    d = tmp_path_factory.mktemp("vis")
    a = _random_seq(1_500, 1)
    a2 = a[:700] + ("A" if a[700] != "A" else "C") + a[701:]
    b = _random_seq(900, 2)
    g = construct_graph([a, a, a2, b, b[:300] + "ACGTTGCA" * 4], 21).graph
    save = str(d / "g.npz")
    save_graph(save, g)
    gfa = str(d / "g.gfa")
    write_gfa(gfa, g)
    return {"g": g, "a": a, "b": b, "npz": save, "gfa": gfa, "d": d}


def _session(g):
    ids = sorted((int(e) for e in g.canonical_edge_ids()), key=lambda e: -int(g.e_len[e]))
    e = ids[0]
    v = int(g.e_start[e])
    return (f"help\nstats\ncontigs 3\ncontigs\nedge {e}\nedge {int(g.e_conj[e])}\n"
            f"seq {e}\nseq {e} 15\nin {int(g.e_end[e])}\nout {v}\nin {v}\n\n"
            f"edge x\nedge {10 ** 6}\nseq\nbogus cmd\ndraw {{dot}}\nquit\nstats\n")


@pytest.mark.parametrize("source", ["graph", "npz", "gfa"])
def test_repl_transcripts_match(graphs, tmp_path, source):
    outs = {}
    for name, vis in (("j", j_vis), ("t", t_vis)):
        dot = str(tmp_path / f"{name}.dot")
        g = (graphs["g"] if name == "j" else _port_graph(graphs["g"])) if source == "graph" \
            else vis._load(graphs[source], 21)
        out = io.StringIO()
        vis.repl(g, out=out, inp=io.StringIO(_session(g).format(dot=dot)))
        outs[name] = (out.getvalue().replace(dot, "<dot>"), open(dot).read())
    assert outs["t"] == outs["j"]
    text = outs["t"][0]
    assert "unknown command 'bogus'" in text and "error:" in text
    # nothing runs after `quit`
    assert text.endswith("> wrote <dot>\n> ") and outs["t"][1].startswith("digraph")


def test_repl_main_and_end_of_input(graphs, monkeypatch):
    """`main` loads the GFA and reads commands until the input ends (the
    REPL's default streams are bound when it is defined: patched here)."""
    outs = {}
    for name, vis in (("j", j_vis), ("t", t_vis)):
        out = io.StringIO()
        monkeypatch.setattr(vis.repl, "__defaults__",
                            (out, io.StringIO("stats\ncontigs 2\nout 0\n")))
        assert vis.main([graphs["gfa"], "-k", "21"]) == 0
        outs[name] = out.getvalue()
    assert outs["t"] == outs["j"] and outs["t"].startswith("loaded graph: ")


@pytest.mark.parametrize("kw", [{}, {"low_cov": 30.0, "high_cov": 60.0, "max_label_len": 200}])
def test_write_dot_matches(graphs, tmp_path, kw):
    j_dot.write_dot(str(tmp_path / "j.dot"), graphs["g"], **kw)
    t_dot.write_dot(str(tmp_path / "t.dot"), _port_graph(graphs["g"]), **kw)
    text = open(tmp_path / "t.dot").read()
    assert text == open(tmp_path / "j.dot").read()
    assert text.count(" -> ") == int(graphs["g"].alive.sum())


@pytest.mark.parametrize("radius", ["2000", "50"])
def test_cds_subgraphs_match(graphs, tmp_path, capsys, radius):
    a, b = graphs["a"], graphs["b"]
    q = tmp_path / "q.fasta"
    q.write_text(f">cds1 gene\n{a[100:400]}\n>cds_b\n{b[500:800]}\n>none\n{_random_seq(300, 9)}\n"
                 f">short\n{a[:15]}\n")
    argv = [graphs["gfa"], str(q), "--radius", radius]
    outs = {}
    for name, main, extra in (("j", j_cds.main, []), ("t", t_cds.main, ["--device", "cpu"])):
        out = str(tmp_path / name)
        assert main(argv + ["-w", out] + extra) == 0
        outs[name] = capsys.readouterr().out.replace(out, "<out>")
    assert outs["t"] == outs["j"]
    assert "none: no graph hit" in outs["t"] and "short: no graph hit" in outs["t"]
    assert _same_tree(str(tmp_path / "j"), str(tmp_path / "t")) == ["cds1.gfa", "cds_b.gfa"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_cds.main(argv + ["-w", str(tmp_path / "x")])


@pytest.mark.parametrize("kw", [{"n_edges": 400, "seed": 3},
                                {"n_edges": 2_000, "k": 33, "seed": 4, "fill_sequences": False},
                                {"n_edges": 10, "backbone_cov": 5.0, "noise_cov": 1.0}])
def test_synthetic_tangled_graph_matches(kw):
    ref = j_synth.synthetic_tangled_graph(**kw)
    got = t_synth.synthetic_tangled_graph(**kw)
    for f in GRAPH_FIELDS:
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f


def test_memory_matches_on_the_host():
    assert t_mem.get_memory_limit() == j_mem.get_memory_limit()
    assert t_mem.get_used_memory() > 0
    free = t_mem.get_free_memory()
    assert free is None or free > 0
    for args in ((100, 21), (150, 55, 1 << 20), (150, 55, 8 << 30, 4), (10, 21)):
        assert t_mem.suggest_batch_size(*args) == j_mem.suggest_batch_size(*args)
    ref = j_mem.get_device_memory_stats()
    got = t_mem.get_device_memory_stats("cpu")
    assert len(got) == 1 and set(ref[0]) <= set(got[0])
    assert all(got[0][key] is None for key in ("bytes_in_use", "bytes_limit"))
    assert all(r["bytes_in_use"] is None and r["bytes_limit"] is None for r in ref)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_mem.get_device_memory_stats()


def test_memory_limit_in_a_child(tmp_path):
    """`limit_memory` caps this process's address space: run it in a child."""
    import subprocess
    import sys

    code = ("from spades_tpu_torch.utils.memory import limit_memory, get_memory_limit\n"
            "limit_memory(64 << 30)\nprint(get_memory_limit())\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120, check=True)
    assert int(out.stdout.split()[-1]) == 64 << 30
