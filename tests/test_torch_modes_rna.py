"""Port parity for the RNA modes: `run_assembly(mode="rna")` with `ss="fr"`
and `ss="rf"` (SSEdgeSplit at every K), full-length transcripts as trusted
contigs (`--fl-rna`), and `mode="rnaviral"`; both run the early A/T clipper
in Construction.

The same reads (made from a seed with numpy) go through `spades_tpu` and
`spades_tpu_torch` (`device="cpu"`); the ladder runs at lowered device
thresholds, so that both packages count, index and map on their device
paths, the other runs at the default ones (the SS splitter of the port maps
on its device path either way).  Every file each
run writes (`transcripts.fasta` included) must be equal, the GFA but for its
header line, which names the writing package (tolerance 0: integer work and
the same float64 numpy).  The reads are those of
`make_e2e_dataset(30_000, 20, 100, 0.003, seed=1)` with 40 pairs whose left
mate runs into a poly-A tail: a set whose coverage-model fits converge in
seconds (a synthetic transcriptome's uneven depth makes every fit take its
hundred restarts).
"""
import numpy as np
import pytest

from spades_tpu.core import dna as j_dna
from spades_tpu.pipeline import run as j_run
from spades_tpu_torch.pipeline import run as t_run
from spades_tpu_torch.pipeline import spades_stages as t_stages
from spades_tpu_torch.pipeline import stages as t_stage_rt
from spades_tpu_torch.tools import synthetic
from tests.test_torch_modes import assert_same_files, files_under
from tests.test_torch_pipeline import THRESHOLDS, one_torch_thread


def assert_same_run(jdir, tdir):
    """Every file both runs wrote (the checkpoints aside) is equal, an
    emptied graph's empty files and header-only GFA included; returns the
    files' names."""
    names = files_under(jdir)
    assert names == files_under(tdir)
    assert_same_files(jdir, tdir, names)
    return names


def run_both(tmp, name, reads, ks, **kw):
    jdir, tdir = str(tmp / f"{name}_j"), str(tmp / f"{name}_t")
    t_stage_rt.STAGE_TIMES.clear()
    t_stages.CONSTRUCT_PHASES.clear()
    t_stages.MODE_STATS.clear()
    j_run.run_assembly(reads, ks, jdir, checkpoints="none", **kw)
    t_run.run_assembly(reads, ks, tdir, checkpoints="none", device="cpu", **kw)
    return jdir, tdir, assert_same_run(jdir, tdir)


def rna_set(G=30_000, n_tails=40):
    """Genome pairs and `n_tails` pairs whose left mate ends in 30 A."""
    genome, r1, r2 = synthetic.make_e2e_dataset(G, 20, 100, 0.003, seed=1,
                                                insert_mean=300, insert_sd=20)
    lefts = [j_dna.decode(r) for r in r1]
    rights = [j_dna.decode(r) for r in r2]
    g = j_dna.decode(genome)
    for p in np.random.default_rng(3).integers(200, G - 200, n_tails):
        lefts.append(g[p : p + 70] + "A" * 30)
        rights.append(j_dna.revcomp_str(g[p - 150 : p - 50]))
    return g, lefts, rights


@pytest.fixture(scope="module")
def reads():
    return rna_set()


@pytest.mark.parametrize("ss, ks", [("fr", [21, 33]), ("rf", [33])])
def test_rna_ss_ladder_matches(tmp_path, reads, ss, ks, monkeypatch):
    if len(ks) > 1:
        for name, value in THRESHOLDS.items():
            monkeypatch.setenv(name, value)
    g, lefts, rights = reads
    _j, tdir, names = run_both(tmp_path, f"rna_{ss}", lefts + rights, ks, mode="rna",
                               ss=ss, paired_libs=[(lefts, rights)], read_length=100)
    assert "transcripts.fasta" in names and f"K{ks[0]}/transcripts.fasta" in names
    assert [s for k, s, _t in t_stage_rt.STAGE_TIMES].count("ss_edge_split") == len(ks)
    assert all("early_clip_s" in tm for _k, tm in t_stages.CONSTRUCT_PHASES)
    ss_rows = [st for _k, sid, st in t_stages.MODE_STATS if sid == "ss_edge_split"]
    assert len(ss_rows) == len(ks) and all(st["binned_edges"] > 0 for st in ss_rows)


def test_rna_with_full_length_transcripts_matches(tmp_path, reads):
    """`--fl-rna`: full-length transcripts enter as trusted contigs."""
    g, lefts, rights = reads
    fl = [g[1000:2500], j_dna.revcomp_str(g[9000:11000]), g[20000:21200] + "A" * 25]
    _j, tdir, names = run_both(tmp_path, "rna_fl", lefts + rights, [33], mode="rna", ss="rf",
                               paired_libs=[(lefts, rights)], read_length=100,
                               trusted_contigs=fl)
    assert "transcripts.fasta" in names


def test_rnaviral_matches(tmp_path, reads):
    _g, lefts, rights = reads
    _j, _t, names = run_both(tmp_path, "rnaviral", lefts + rights, [33], mode="rnaviral",
                             paired_libs=[(lefts, rights)], read_length=100)
    assert "transcripts.fasta" not in names
    assert all("early_clip_s" in tm for _k, tm in t_stages.CONSTRUCT_PHASES)
    assert "ss_edge_split" not in [s for _k, s, _t in t_stage_rt.STAGE_TIMES]
