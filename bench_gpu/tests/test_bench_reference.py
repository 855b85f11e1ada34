"""The plain reference on small inputs: k-mer keys against a loop, the first
graph's check on the program's own graph of a 30 kb sample (and on broken
copies of it), the contig and corrected-read checks on planted changes."""
from __future__ import annotations

import collections
import os

import numpy as np
import pytest

from bench_gpu.gen.synthetic import make_e2e_dataset
from bench_gpu.reference import contigs, corrected, k1_graph
from bench_gpu.reference import kmers as R

COMP = {0: 3, 1: 2, 2: 1, 3: 0}


def _key(codes):
    v = 0
    for c in codes:
        v = v * 4 + int(c)
    return v


def _canon(codes):
    rc = [COMP[int(c)] for c in codes[::-1]]
    return min(_key(codes), _key(rc))


@pytest.fixture(scope="module")
def sample():
    genome, r1, r2, c1, c2 = make_e2e_dataset(30000, 30, 150, 0.003, seed=11, truth=True)
    return {"r1": r1, "r2": r2, "clean1": c1, "clean2": c2, "genomes": [genome]}


@pytest.mark.parametrize("k", [1, 5, 22, 31, 32])
def test_window_keys_against_a_loop(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, 60).astype(np.uint8)
    codes[[7, 40]] = 255
    keys, ok = R.window_keys(codes, k)
    for i in range(60 - k + 1):
        win = codes[i : i + k]
        assert ok[i] == (win <= 3).all()
        if ok[i]:
            assert int(keys[i]) == _canon(win)


def test_count_reads_against_a_counter():
    rng = np.random.default_rng(3)
    reads = rng.integers(0, 4, (50, 30)).astype(np.uint8)
    keys, counts = R.count_reads(reads, 9, block=7)
    want = collections.Counter(_canon(r[i : i + 9]) for r in reads for i in range(22))
    assert dict(zip(keys.tolist(), counts.tolist())) == want


def _first_graph(sample):
    from spades_tpu_torch.pipeline.construction import construct_graph

    acgt = np.frombuffer(b"ACGT", np.uint8)
    seqs = [acgt[r].tobytes().decode() for r in np.concatenate([sample["r1"], sample["r2"]])]
    g = construct_graph(seqs, 21, device="cpu").graph
    return {"k": g.k, "e_off": g.e_off.copy(), "e_len": g.e_len.copy(), "e_conj": g.e_conj.copy(),
            "e_cov": g.e_cov.copy(), "alive": g.alive.copy(), "seq_pool": g.seq_pool.copy()}


def test_first_graph_check(sample):
    g = _first_graph(sample)
    mix = {"first_k": 21}
    assert k1_graph.readings({"first_graph": g}, sample, mix) == {"k1_kmers_off": 0.0,
                                                                 "k1_cov_off": 0.0}
    # an edge pair lost, a coverage changed, a base changed, the wrong K
    lost = dict(g, alive=g["alive"].copy())
    e = int(np.flatnonzero(g["e_len"] > 40)[0])
    lost["alive"][[e, g["e_conj"][e]]] = False
    assert k1_graph.readings({"first_graph": lost}, sample, mix)["k1_kmers_off"] > 0
    cov = dict(g, e_cov=g["e_cov"].copy())
    cov["e_cov"][g["alive"]] += 1
    assert k1_graph.readings({"first_graph": cov}, sample, mix)["k1_cov_off"] > 0
    base = dict(g, seq_pool=g["seq_pool"].copy())
    base["seq_pool"][g["e_off"][e] + 30] ^= 1
    assert k1_graph.readings({"first_graph": base}, sample, mix)["k1_kmers_off"] > 0
    assert k1_graph.readings({"first_graph": None}, sample, mix)["k1_kmers_off"] > 0


def _write_fasta(path, seqs):
    acgt = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "wb") as fh:
        for i, s in enumerate(seqs):
            fh.write(b">s%d\n%s\n" % (i, acgt[np.minimum(s, 4)].tobytes()))


def test_contig_check(sample, tmp_path):
    g = sample["genomes"][0]
    pieces = [g[100:5000], (3 - g[6000:9000])[::-1].copy(), g[10000:20000]]
    scaff = [np.concatenate([g[100:5000], np.full(10, 4, np.uint8), g[5100:8000]])]
    _write_fasta(tmp_path / "contigs.fasta", pieces)
    _write_fasta(tmp_path / "scaffolds.fasta", scaff)
    job = {"out": str(tmp_path)}
    genome = R.sequence_set([g], 31)
    # the scaffolds hold fewer of the genome's 31-mers than the contigs do
    held = R.sequence_set([g[100:5000], g[5100:8000]], 31)
    missing = int((~R.member(held, genome)).sum())
    assert contigs.readings(job, sample, {}) == {
        "contig_kmers_absent_ppm": 0.0,
        "genome_kmers_missing_ppm": pytest.approx(missing / len(genome) * 1e6)}
    pieces[2] = pieces[2].copy()
    pieces[2][5000] ^= 1                           # one substitution: 31 absent 31-mers
    _write_fasta(tmp_path / "contigs.fasta", pieces)
    total = sum(len(p) - 30 for p in pieces) + (len(g[100:5000]) - 30) + (len(g[5100:8000]) - 30)
    assert contigs.readings(job, sample, {})["contig_kmers_absent_ppm"] == pytest.approx(31 / total * 1e6)
    # the whole genome in both files, then one contig left out
    _write_fasta(tmp_path / "scaffolds.fasta", [g])
    _write_fasta(tmp_path / "contigs.fasta", [g[:15030], g[15000:]])
    assert contigs.readings(job, sample, {})["genome_kmers_missing_ppm"] == 0.0
    _write_fasta(tmp_path / "contigs.fasta", [g[:15030]])
    lost = int((~R.member(R.sequence_set([g[:15030]], 31), genome)).sum())
    assert lost > 0
    assert contigs.readings(job, sample, {})["genome_kmers_missing_ppm"] == pytest.approx(
        lost / len(genome) * 1e6)
    os.unlink(tmp_path / "scaffolds.fasta")
    assert contigs.readings(job, sample, {}) == {"contig_kmers_absent_ppm": 1e6,
                                                 "genome_kmers_missing_ppm": 1e6}


def test_corrected_check(sample, tmp_path):
    d = tmp_path / "corrected"
    d.mkdir()
    c1, c2 = sample["clean1"], sample["clean2"]
    _write_fasta(d / "lib1_1.cor.fasta", list(c1))
    _write_fasta(d / "lib1_2.cor.fasta", list(c2))
    job = {"out": str(tmp_path)}
    assert corrected.readings(job, sample, {}) == {"ec_wrong_bases_ppm": 0.0}
    raw = list(sample["r2"])
    _write_fasta(d / "lib1_2.cor.fasta", raw)
    wrong = int((sample["r2"] != c2).sum())
    assert corrected.readings(job, sample, {})["ec_wrong_bases_ppm"] == pytest.approx(
        wrong / (c1.size + c2.size) * 1e6)
    _write_fasta(d / "lib1_2.cor.fasta", list(c2[:-3]) + [c2[-3][:-2]])
    assert corrected.readings(job, sample, {})["ec_wrong_bases_ppm"] == pytest.approx(
        (2 * 150 + 2) / (c1.size + c2.size) * 1e6)
