"""Port parity for the domain-guided modes and series analysis:
`run_assembly(mode="bio")` and `mode="corona"` with profile HMMs (the
DomainAnalysis stage), and `mode="meta"` with `series_analysis`.

The same inputs (made from seeds with numpy) go through `spades_tpu` and
`spades_tpu_torch` (`device="cpu"`): a 20 kb genome with two planted genes
(`synthetic.make_domain_genome`) and amino profiles of their peptides; a
small coronavirus-like sample (`synthetic.make_corona_dataset`: a 6 kb
genome with a leader, four ORFs, nested subgenomic RNAs and host
transcripts) with profiles of two ORFs and a DNA profile of the leader; and
a two-genome community in two samples whose k-mer profiles the reference
counts.  Every file each run writes (`domain_hits.tsv`, `gene_clusters.txt`
and the series dumps included) must be equal, the GFA but for its header
line (tolerance 0).  Each profile's best hit must spell its gene.
"""
import dataclasses
import os

import numpy as np
import pytest

from spades_tpu.core import dna as j_dna
from spades_tpu.hmm import io as j_hmm
from spades_tpu.mts.multiplicity import profiles_from_read_sets
from spades_tpu.pipeline import run as j_run
from spades_tpu_torch import convert
from spades_tpu_torch.hmm.align import _spell
from spades_tpu_torch.pipeline import run as t_run
from spades_tpu_torch.tools import synthetic
from tests.test_torch_modes_rna import assert_same_run
from tests.test_torch_pipeline import one_torch_thread


def _strings(codes):
    return [j_dna.decode(r) for r in codes]


def _run_both(tmp_path, reads, libs, ks, profiles, **kw):
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    common = dict(paired_libs=libs, read_length=100, checkpoints="none", **kw)
    j_run.run_assembly(reads, ks, jdir, hmm_profiles=profiles, **common)
    t_profiles = [convert.profile_hmm_from_arrays(dataclasses.asdict(h)) for h in profiles]
    res = t_run.run_assembly(reads, ks, tdir, hmm_profiles=t_profiles, device="cpu", **common)
    return tdir, res, assert_same_run(jdir, tdir)


def _best_hits(tdir, k):
    best = {}
    with open(os.path.join(tdir, f"K{k}", "domain_hits.tsv")) as fh:
        for line in fh.read().splitlines()[1:]:
            name, score, path, seq_len = line.split("\t")
            best.setdefault(name, ([int(e) for e in path.split(",")], int(seq_len)))
    return best


def _spells(graph, path, orf_codes):
    """The hit's path holds the gene (or its reverse complement) but for the
    start and stop codons, which a local alignment may leave out."""
    s = _spell(graph, path)
    body = j_dna.decode(orf_codes[3:-3])
    return body in s or j_dna.revcomp_str(body) in s


def test_bio_with_profiles_matches(tmp_path):
    d = synthetic.make_domain_genome(20_000, (60, 90), 25, seed=5, rl=100, insert_mean=300,
                                     insert_sd=20)
    lefts, rights = _strings(d["r1"]), _strings(d["r2"])
    profiles = [j_hmm.hmm_from_consensus(p, f"dom{i}", alphabet="amino")
                for i, p in enumerate(d["peptides"])]
    tdir, res, names = _run_both(tmp_path, lefts + rights, [(lefts, rights)], [33], profiles,
                                 mode="bio")
    assert {"K33/domain_hits.tsv", "K33/gene_clusters.txt"} <= set(names)
    best = _best_hits(tdir, 33)
    for i, orf in enumerate(d["orfs"]):
        path, seq_len = best[f"dom{i}"]
        assert seq_len == 3 * len(d["peptides"][i]) and _spells(res.graph, path, orf)


def test_corona_with_profiles_matches(tmp_path):
    d = synthetic.make_corona_dataset(6, genome_nt=6000, n_orfs=4, fixed_aa=(40, 60),
                                      coverage=150, host_nt=4000, host_cov=(5, 20), rl=100,
                                      insert_mean=300, insert_sd=20)
    lefts, rights = _strings(d["r1"]), _strings(d["r2"])
    g = j_dna.decode(d["genome"])
    profiles = [j_hmm.hmm_from_consensus(d["peptides"][i], f"orf{i}", alphabet="amino")
                for i in (1, 2)] + [j_hmm.hmm_from_consensus(g[:70], "leader")]
    tdir, res, names = _run_both(tmp_path, lefts + rights, [(lefts, rights)], [33], profiles,
                                 mode="corona")
    assert "K33/domain_hits.tsv" in names
    best = _best_hits(tdir, 33)
    for i in (1, 2):
        s, e = d["orfs"][i]
        assert _spells(res.graph, best[f"orf{i}"][0], d["genome"][s:e])
    assert "leader" in best


def test_meta_with_series_analysis_matches(tmp_path):
    genomes, r1, r2, origin = synthetic.make_community((12_000, 8_000), (30, 15), 100, 0.003,
                                                       seed=7, shared=0, insert_mean=300,
                                                       insert_sd=20)
    lefts, rights = _strings(r1), _strings(r2)
    half = len(lefts) // 2
    samples = [lefts[:half] + rights[:half],
               [x for x, o in zip(lefts + rights, np.concatenate([origin, origin])) if o == 0]]
    mult = str(tmp_path / "profiles.npz")
    profiles_from_read_sets(samples, 33, min_samples=1, min_mult=2).save(mult)
    cfgs = {}
    for side in ("j", "t"):
        out = tmp_path / f"dumps_{side}"
        out.mkdir()
        cfgs[side] = str(tmp_path / f"{side}.yaml")
        with open(cfgs[side], "w") as fh:
            fh.write(f"k: 33\nsample_cnt: 2\nkmer_mult: {mult}\nmin_len: 100\n"
                     f"frag_size: 500\nedges_sqn: {out / 'e.fasta'}\n"
                     f"edges_mpl: {out / 'e.mpl'}\nedge_fragments_mpl: {out / 'f.mpl'}\n")
    common = dict(paired_libs=[(lefts, rights)], read_length=100, checkpoints="none",
                  mode="meta")
    j_run.run_assembly(lefts + rights, [21, 33], str(tmp_path / "j"),
                       series_analysis=cfgs["j"], **common)
    t_run.run_assembly(lefts + rights, [21, 33], str(tmp_path / "t"),
                       series_analysis=cfgs["t"], device="cpu", **common)
    assert "K33/first_pe_contigs.fasta" in assert_same_run(str(tmp_path / "j"),
                                                           str(tmp_path / "t"))
    for name in ("e.fasta", "e.mpl", "f.mpl"):
        a, b = (tmp_path / "dumps_j" / name).read_bytes(), (tmp_path / "dumps_t" / name).read_bytes()
        assert a == b and a, name
