"""Port parity for SPlitteR: `aux_graphs/{barcode_index,contracted_graph,
vertex_resolver}.py` and `tools/splitter.py`.

The inputs are made from seeds with numpy, as `tests/test_splitter.py` (the
oracle) makes them: an X-shaped repeat (in edges A, B, out edges C, D, true
haplotypes A->C and B->D) with barcoded reads (`BX:Z:` and `BC:Z:` tags,
reads without a tag, reads shorter than the mapping k), chains glued through
short bridges for the contracted graph.  The port maps every read in one
pass on the device path (CPU tensors here) where the JAX package maps
batches of 4,096 reads on its host path (and, with `SPADES_DEVICE_MAP_READS`
lowered, on its device path): the barcode index, vertex results, paths,
merged graphs and every CLI file and printed line must be equal (tolerance
0; the GFA header names the package).
"""
import os

import numpy as np
import pytest
import torch

from spades_tpu.aux_graphs import barcode_index as JB
from spades_tpu.aux_graphs import contracted_graph as JC
from spades_tpu.aux_graphs import vertex_resolver as JV
from spades_tpu.graph.graph import CondensedGraph as JGraph
from spades_tpu.io.gfa import write_gfa as j_write_gfa
from spades_tpu.tools import splitter as j_tool
from spades_tpu_torch import convert
from spades_tpu_torch.aux_graphs import barcode_index as TB
from spades_tpu_torch.aux_graphs import contracted_graph as TC
from spades_tpu_torch.aux_graphs import vertex_resolver as TV
from spades_tpu_torch.tools import splitter as t_tool
from tests.conftest import random_dna
from tests.test_splitter import barcoded_reads_for, make_repeat_graph
from tests.test_torch_graph_tools import _same_tree
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

GRAPH_FIELDS = ("k", "e_start", "e_end", "e_conj", "e_off", "e_len", "e_cov", "alive",
                "seq_pool", "v_conj")
INDEX_FIELDS = ("frame_size", "edge", "barcode", "count", "left_pos", "right_pos", "covered",
                "barcode_names")


def _port_graph(g):
    return convert.graph_from_arrays({f: getattr(g, f) for f in GRAPH_FIELDS})


def _same_graph(a, b):
    for f in GRAPH_FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def _same_index(a, b):
    for f in INDEX_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x == y if isinstance(x, (int, list)) else np.array_equal(x, y)), f


def _results(res):
    return {v: (r.state.value, r.total_score, r.supporting_score, r.supported_pairs)
            for v, r in res.items()}


def _reads(rng, g, haps, n_bc=8, per=30, rl=60):
    """Barcoded reads of each haplotype, plus reads without a tag, reads with
    a `BC:Z:` tag and reads shorter than k."""
    reads = []
    for i in range(n_bc):
        for hap, tag in haps:
            reads += barcoded_reads_for(hap, f"{tag}{i}", per, rl, rng)
    hap = haps[0][0]
    reads += [(f"plain{i}", hap[i * 7 : i * 7 + rl]) for i in range(10)]
    reads += [(f"bc{i} BC:Z:X{i % 3}", hap[i * 5 : i * 5 + rl]) for i in range(10)]
    reads += [(f"tiny{i} BX:Z:T", hap[i : i + g.k - 2]) for i in range(5)]
    return reads


@pytest.fixture
def world(rng):
    g, (A, B, C, D), edges = make_repeat_graph(rng)
    haps = [(A + C[g.k:], "AC"), (B + D[g.k:], "BD")]
    return g, edges, haps


def test_parse_barcode_matches():
    for name in ("read1 BX:Z:ACGT-1", "read1 BC:Z:XYZ extra", "read1", "r BC:Z:a BX:Z:b",
                 "r\tBX:Z:", "BX:Z:first"):
        assert TB.parse_barcode(name) == JB.parse_barcode(name)


@pytest.mark.parametrize("path", ["host", "device"])
@pytest.mark.parametrize("mapping_k", [21, 15])
def test_index_one_pass_equals_batches(world, rng, monkeypatch, path, mapping_k):
    g, _edges, haps = world
    reads = _reads(rng, g, haps, n_bc=16, per=150)
    assert len(reads) > 4096
    if path == "device":
        monkeypatch.setenv("SPADES_DEVICE_MAP_READS", "1")
    ref = JB.build_barcode_index(g, reads, mapping_k=mapping_k, frame_size=50)
    got = TB.build_barcode_index(_port_graph(g), reads, mapping_k=mapping_k, frame_size=50,
                                 device="cpu")
    _same_index(got, ref)
    assert got.num_barcodes == 16 * 2 + 3 + 1 and got.num_entries > 0
    for e in range(len(g.e_start)):
        assert got.barcode_number(e) == ref.barcode_number(e)


def test_small_batches_and_empty_index(world, rng):
    g, _edges, haps = world
    reads = _reads(rng, g, haps)
    ref = JB.build_barcode_index(g, reads, mapping_k=21, frame_size=50, batch_size=37)
    _same_index(TB.build_barcode_index(_port_graph(g), reads, mapping_k=21, frame_size=50,
                                       device="cpu"), ref)
    untagged = [(f"r{i}", s) for i, (_n, s) in enumerate(reads)]
    for rs in (untagged, [], [("x BX:Z:A", "ACGT")]):
        _same_index(TB.build_barcode_index(_port_graph(g), rs, device="cpu"),
                    JB.build_barcode_index(g, rs))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TB.build_barcode_index(_port_graph(g), reads)


@pytest.mark.parametrize("case", ["completely", "trusted", "uncovered", "ambiguous"])
def test_resolver_paths_and_merge_match(world, rng, case):
    g, (eA, eB, eC, eD), haps = world
    if case == "ambiguous":          # 12 clouds join A to D, 8 A to C: within 2x
        haps = haps + [(g.edge_seq(eA) + g.edge_seq(eD)[g.k:], "AD")]
    reads = _reads(rng, g, haps)
    if case == "ambiguous":
        for i in range(4):
            reads += barcoded_reads_for(haps[2][0], f"AX{i}", 30, 60, rng)
    pg = _port_graph(g)
    ref_idx = JB.build_barcode_index(g, reads, mapping_k=21, frame_size=50)
    got_idx = TB.build_barcode_index(pg, reads, mapping_k=21, frame_size=50, device="cpu")
    if case == "uncovered":
        z = np.zeros(0, np.int64)
        ref_idx = JB.FrameBarcodeIndex(40000, z, z, z, z, z, z, [])
        got_idx = TB.FrameBarcodeIndex(40000, z, z, z, z, z, z, [])
    trusted = {eA: {eD}, eB: {eC}} if case == "trusted" else None
    kw = dict(tail_threshold=500, score_threshold=2.0)
    ref = JV.resolve_vertices(g, ref_idx, trusted, **kw)
    got = TV.resolve_vertices(pg, got_idx, trusted, **kw)
    assert _results(got) == _results(ref) and len(ref) == 1
    state = {"completely": "Completely", "trusted": "Completely", "uncovered": "Uncovered",
             "ambiguous": "Partially"}
    assert next(iter(ref.values())).state.value == state[case]
    paths = TV.extract_paths(pg, got)
    assert paths == JV.extract_paths(g, ref)
    overlaps = {(eA, eC): 15} if case == "completely" else None
    r_graph, r_map = JV.merge_paths(g, paths, overlaps)
    t_graph, t_map = TV.merge_paths(pg, paths, overlaps)
    _same_graph(t_graph, r_graph)
    assert t_map == r_map


def test_contracted_graphs_match(world):
    g, (eA, eB, eC, eD), _haps = world
    long_mask = np.zeros(len(g.e_start), bool)
    long_mask[[eA, eB, eC, eD]] = True
    k = 21
    rng = np.random.default_rng(3)
    s1 = random_dna(rng, 100)
    bridge = s1[-k:] + random_dna(rng, 5)
    s2 = bridge[-k:] + random_dna(rng, 100)
    g2 = JGraph.from_sequences([s1, bridge, s2], k)
    g2.e_start[2] = 1
    g2.e_end[3] = int(g2.v_conj[1])
    g2.e_start[4] = 5
    g2.e_end[5] = int(g2.v_conj[5])
    for graph, mask in ((g, long_mask), (g2, np.array([True, True, False, False, True, True])),
                        (g, np.zeros(len(g.e_start), bool))):
        ref = JC.build_contracted_graph(graph, mask)
        got = TC.build_contracted_graph(_port_graph(graph), mask)
        for f in ("root", "long_edges", "c_start", "c_end"):
            assert np.array_equal(getattr(got, f), getattr(ref, f)), f
        assert got.capacity == ref.capacity and got.num_vertices == ref.num_vertices


def _write_reads(path, reads):
    with open(path, "w") as fh:
        for name, seq in reads:
            fh.write(f">{name}\n{seq}\n")
    return path


@pytest.mark.parametrize("mode", ["diploid", "meta", "yaml"])
def test_cli_matches(world, rng, tmp_path, capsys, mode):
    g, (eA, eB, eC, eD), haps = world
    gfa = str(tmp_path / "graph.gfa")
    j_write_gfa(gfa, g, paths=[("p1", [eA, eC]), ("p2", [eB, eD])] if mode == "meta" else None)
    reads = _reads(rng, g, haps)
    src = _write_reads(str(tmp_path / "reads.fasta"), reads)
    argv = [gfa, src, "-k", "21", "--mapping-k", "21", "--tail-threshold", "500"]
    if mode == "meta":
        info = tmp_path / "assembly_info.txt"
        name = sorted(open(gfa).read().split("\nS\t")[1:])[1].split("\t")[0]
        info.write_text("#seq_name\tlength\tcov.\tcirc.\trepeat\tmult.\talt_group\tgraph_path\n"
                        f"contig_1\t200\t30\tN\tY\t2\t*\t{name},-{name}\n")
        argv += ["--mode", "meta", "--assembly-info", str(info), "--score", "1"]
    if mode == "yaml":
        half = len(reads) // 2
        a = _write_reads(str(tmp_path / "a.fasta"), reads[:half])
        b = _write_reads(str(tmp_path / "b.fasta"), reads[half:])
        (tmp_path / "data.yaml").write_text(
            f"- type: clouds10x\n  orientation: fr\n  left reads:\n  - {a}\n"
            f"  right reads:\n  - {b}\n")
        argv[1] = str(tmp_path / "data.yaml")
    outs = {}
    for name, main, extra in (("j", j_tool.main, []), ("t", t_tool.main, ["--device", "cpu"])):
        out = str(tmp_path / name)
        assert main(argv + ["-w", out] + extra) == 0
        outs[name] = capsys.readouterr().out.replace(out, "<out>")
    assert outs["t"] == outs["j"]
    names = _same_tree(str(tmp_path / "j"), str(tmp_path / "t"))
    assert names == ["resolved_graph.gfa", "resolved_paths.fasta", "vertex_results.tsv"]
    if mode == "diploid":
        assert "Completely" in open(tmp_path / "t" / "vertex_results.tsv").read()
