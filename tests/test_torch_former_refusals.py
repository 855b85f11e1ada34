"""The argument sets that `run_assembly` of the port refused until the RNA,
bio/corona and series-analysis modes were ported (they were the cases of
`test_torch_pipeline.py::test_unported_arguments_raise`), each now given
real inputs and run through both packages with equal files.

The inputs are small and made from a seed with numpy: a 2,000-nt genome with
a planted 40-codon gene, as 800 FR pairs of 80 bp (the gene's peptide as an
amino profile, a stretch of it as a DNA profile), long reads of the genome,
a GFA written by the JAX package, and a series-analysis config over k-mer
profiles of two halves of the reads.  Every file each run writes must be
equal, the GFA but for its header line (tolerance 0); the series dumps go to
paths of each package's own config and must be equal too.

The CLI refused `--read-cov-threshold` (the cases of
`test_torch_cli.py::test_unported_options_raise` that named A14); it now runs
on the same reads, written as FASTA, through both CLIs with equal files.
"""
import dataclasses
import os

import numpy as np
import pytest

from spades_tpu.core import dna as j_dna
from spades_tpu.hmm import io as j_hmm
from spades_tpu.mts.multiplicity import profiles_from_read_sets
from spades_tpu.pipeline import main as j_main
from spades_tpu.pipeline import run as j_run
from spades_tpu_torch import convert
from spades_tpu_torch.pipeline import main as t_main
from spades_tpu_torch.pipeline import run as t_run
from spades_tpu_torch.pipeline import stages as t_stage_rt
from spades_tpu_torch.tools import synthetic
from tests.test_torch_cli_modes import _cli_both
from tests.test_torch_modes_rna import assert_same_run
from tests.test_torch_pipeline import GFA, one_torch_thread

DUMPS = ("edges.fasta", "edges.mpl", "frags.mpl")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("inputs")
    rng = np.random.default_rng(7)
    orf, pep = synthetic.random_orf(rng, 40)
    genome = np.concatenate([rng.integers(0, 4, 900).astype(np.uint8), orf,
                             rng.integers(0, 4, 980).astype(np.uint8)])
    g = j_dna.decode(genome)
    lefts, rights = [], []
    for a in rng.integers(0, len(g) - 200, 800):
        lefts.append(g[a : a + 80])
        rights.append(j_dna.revcomp_str(g[a + 120 : a + 200]))
    profiles = [j_hmm.hmm_from_consensus(pep, "gene", alphabet="amino"),
                j_hmm.hmm_from_consensus(g[930:990], "stretch")]
    gdir = str(d / "graph")
    j_run.run_assembly(lefts + rights, [21], gdir, paired_libs=[(lefts, rights)],
                       read_length=80, disable_rr=True, checkpoints="none")
    mult = str(d / "profiles.npz")
    profiles_from_read_sets([lefts[:400] + rights[:400], lefts[400:] + rights[400:]], 21,
                            min_samples=1, min_mult=2).save(mult)
    return {"reads": lefts + rights, "libs": [(lefts, rights)], "genome": g,
            "profiles": profiles, "gfa": os.path.join(gdir, GFA), "mult": mult,
            "long_reads": synthetic.sample_long_reads(genome, 6, 900, 100, 0.04, 0.03,
                                                      0.03, 8)}


def _config(path, mult, out):
    os.makedirs(out, exist_ok=True)
    with open(path, "w") as fh:
        fh.write(f"k: 21\nsample_cnt: 2\nkmer_mult: {mult}\nmin_len: 30\nfrag_size: 200\n"
                 + "".join(f"{key}: {os.path.join(out, name)}\n" for key, name in
                           zip(("edges_sqn", "edges_mpl", "edge_fragments_mpl"), DUMPS)))
    return path


CASES = {
    "bio": {"mode": "bio"},                                 # with repeat resolution
    "meta_series": {"mode": "meta", "series_analysis": True},
    "corona_careful": {"disable_rr": True, "careful": True, "mode": "corona"},
    "rnaviral_mismatch": {"disable_rr": True, "mismatch_correction": True, "mode": "rnaviral"},
    "long_reads_hmms": {"disable_rr": True, "long_reads": True, "hmm_profiles": True},
    "rna_assembly_graph": {"disable_rr": True, "assembly_graph": True, "mode": "rna"},
    "series": {"disable_rr": True, "series_analysis": True},
    "ss_outside_rna": {"disable_rr": True, "ss": "fr"},
    "hmms": {"disable_rr": True, "hmm_profiles": True},
    "plasmid_ss": {"disable_rr": True, "mode": "plasmid", "ss": "rf"},
    "rna": {"disable_rr": True, "mode": "rna"},
    "early_tip_clip": {"disable_rr": True,
                       "config_overlay": {"construction": {"early_tip_clip": True}}},
}


@pytest.mark.parametrize("case", list(CASES))
def test_former_refusals_match_the_reference(tmp_path, inputs, case):
    kw = dict(CASES[case])
    j_kw, t_kw = {}, {}
    if kw.pop("hmm_profiles", None):
        j_kw["hmm_profiles"] = inputs["profiles"]
        t_kw["hmm_profiles"] = [convert.profile_hmm_from_arrays(dataclasses.asdict(h))
                                for h in inputs["profiles"]]
    if kw.pop("series_analysis", None):
        for name, side in (("j", j_kw), ("t", t_kw)):
            side["series_analysis"] = _config(str(tmp_path / f"{name}.yaml"), inputs["mult"],
                                              str(tmp_path / f"dumps_{name}"))
    if kw.pop("long_reads", None):
        kw["long_reads"] = inputs["long_reads"]
    if kw.pop("assembly_graph", None):
        kw["assembly_graph"] = inputs["gfa"]
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    common = dict(paired_libs=inputs["libs"], read_length=80, checkpoints="none", **kw)
    j_run.run_assembly(inputs["reads"], [21], jdir, **common, **j_kw)
    t_stage_rt.STAGE_TIMES.clear()
    t_run.run_assembly(inputs["reads"], [21], tdir, device="cpu", **common, **t_kw)
    names = assert_same_run(jdir, tdir)
    assert "contigs.fasta" in names
    stages = [s for _k, s, _t in t_stage_rt.STAGE_TIMES]
    if "series_analysis" in t_kw:
        for name in DUMPS:
            a, b = (tmp_path / "dumps_j" / name), (tmp_path / "dumps_t" / name)
            assert a.read_bytes() == b.read_bytes() and a.stat().st_size > 0, name
        assert "series_analysis" in stages
    if "hmm_profiles" in t_kw or kw.get("mode") in ("bio", "corona"):
        assert "domain_analysis" in stages
    # without profiles DomainAnalysis writes nothing, in either package
    assert ("K21/domain_hits.tsv" in names) == ("hmm_profiles" in t_kw)
    if kw.get("mode") == "rna":
        assert "transcripts.fasta" in names
    assert ("ss_edge_split" in stages) == (kw.get("mode") == "rna" and bool(kw.get("ss")))


@pytest.mark.parametrize("extra", [["--only-assembler"], ["--careful"]])
def test_read_cov_threshold_cli_matches_the_reference(tmp_path, inputs, extra):
    """The former refusal `--read-cov-threshold 3`, with error correction
    (and careful mode) or without it, at k=21; the log's filter line too."""
    paths = []
    for mate, reads in ((1, inputs["libs"][0][0]), (2, inputs["libs"][0][1])):
        paths.append(str(tmp_path / f"r{mate}.fa"))
        with open(paths[-1], "w") as fh:
            fh.writelines(f">p{i}/{mate}\n{r}\n" for i, r in enumerate(reads))
    args = ["-1", paths[0], "-2", paths[1], "-k", "21", "--read-cov-threshold", "3", *extra]
    jdir, tdir, names = _cli_both(tmp_path, j_main.main, t_main.main, args)
    assert "contigs.fasta" in names and "scaffolds.fasta" in names
    assert ("corrected/lib1_1.cor.fasta" in names) == ("--careful" in extra)
    found = {}
    for name, d in (("j", jdir), ("t", tdir)):
        with open(os.path.join(d, "spades.log")) as fh:
            found[name] = [ln.split(": ", 1)[1] for ln in fh.read().splitlines()
                           if "read coverage filter" in ln]
    assert found["t"] == found["j"] and len(found["t"]) == 1
