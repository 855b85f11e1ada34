"""Port parity for edge positions: `graph/positions.py:fill_positions`.

The inputs are made from seeds with numpy: random genomes, a repeat-rich one,
graphs `construct_graph` builds of them (and of reads with errors, then
simplified), sequences on both strands, with N and soft-masked letters, and
sequences longer than one row of the port's windows.  The oracle is
`tests/test_positions.py`.  The port searches each sequence's windows in the
device index (CPU tensors here) where the JAX package builds a host index;
every interval, strand and the order of the intervals of every edge must be
equal (tolerance 0).
"""
import numpy as np
import pytest
import torch

from spades_tpu.core import dna as j_dna
from spades_tpu.graph.positions import fill_positions as j_fill
from spades_tpu.pipeline.construction import construct_graph
from spades_tpu_torch import convert
from spades_tpu_torch.graph import positions as TP
from tests.conftest import random_dna
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401


def _port_graph(g):
    return convert.graph_from_arrays({f: getattr(g, f) for f in (
        "k", "e_start", "e_end", "e_conj", "e_off", "e_len", "e_cov", "alive",
        "seq_pool", "v_conj")})


def _same(got, ref):
    assert got.k == ref.k
    assert list(got.by_edge) == list(ref.by_edge)
    for e, ps in ref.by_edge.items():
        assert [vars(p) for p in got.by_edge[e]] == [vars(p) for p in ps]
        assert got.str_of(e) == "; ".join(str(p) for p in ps)


@pytest.mark.parametrize("k", [21, 33, 55])
def test_genome_and_reverse_strand_match(k):
    rng = np.random.default_rng(k)
    genome = random_dna(rng, 6_000)
    rep = random_dna(rng, 300)
    genome = genome[:1_000] + rep + genome[1_000:3_000] + rep + genome[3_000:]
    reads = [genome[i : i + 100] for i in range(0, len(genome) - 99, 3)]
    g = construct_graph(reads, k).graph
    seqs = {"genome": genome, "rc": j_dna.revcomp_str(genome), "piece": genome[2_500:2_900],
            "short": genome[:k - 1], "other": random_dna(rng, 500)}
    got = TP.fill_positions(_port_graph(g), seqs, device="cpu")
    ref = j_fill(g, seqs)
    _same(got, ref)
    assert sum(len(v) for v in ref.by_edge.values()) > 4


def test_long_sequences_span_several_rows(monkeypatch):
    monkeypatch.setattr(TP, "ROW_BASES", 256)
    monkeypatch.setattr(TP, "ROWS_PER_BATCH", 5)
    rng = np.random.default_rng(5)
    genome = random_dna(rng, 9_000)
    g = construct_graph([genome[i : i + 150] for i in range(0, 8_851, 5)], 21).graph
    seqs = {"a": genome, "b": j_dna.revcomp_str(genome[1_234:7_777])}
    _same(TP.fill_positions(_port_graph(g), seqs, device="cpu"), j_fill(g, seqs))


def test_smaller_k_and_letters_outside_acgt():
    """Windows holding N or another letter pack as the JAX package's host
    loop packs them (code 4 spills into the base before it)."""
    rng = np.random.default_rng(9)
    genome = random_dna(rng, 3_000)
    g = construct_graph([genome[i : i + 100] for i in range(0, 2_901, 4)], 33).graph
    masked = genome[:700] + "N" * 40 + genome[740:1_500].lower() + "R" + genome[1_501:]
    seqs = {"masked": masked, "clean": genome}
    pg = _port_graph(g)
    for k in (None, 21):
        _same(TP.fill_positions(pg, seqs, k=k, device="cpu"), j_fill(g, seqs, k=k))


def test_simplified_graph_and_empty_cases():
    from spades_tpu.graph.coverage_model import GenomicInfo
    from spades_tpu.graph.simplify import SimplifyConfig, simplify

    rng = np.random.default_rng(2)
    genome = random_dna(rng, 2_000)
    reads = [genome[i : i + 100] for i in range(0, 1_900, 2)]
    reads += [genome[500:580] + "ACGT" * 5]
    g2, _ = simplify(construct_graph(reads, 21).graph, GenomicInfo(2.0, 5.0, 40.0, 2_000),
                     SimplifyConfig(read_length=100))
    seqs = {"genome": genome}
    _same(TP.fill_positions(_port_graph(g2), seqs, device="cpu"), j_fill(g2, seqs))
    dead = _port_graph(g2)
    dead.alive = np.zeros_like(dead.alive)
    assert TP.fill_positions(dead, seqs, device="cpu").by_edge == {}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TP.fill_positions(_port_graph(g2), seqs)
