"""Port parity for the CLI's last modes and options: `--rna` with `--ss` and
`--fl-rna`, `--rnaviral` (error correction on by default), `--bio` and
`--corona` with `--custom-hmms`, `--meta` with `--series-analysis`, and the
wrappers `rnaspades`, `rnaviralspades` and `coronaspades`
(`pipeline/wrappers.py`, `pipeline/{rnaspades,rnaviralspades,coronaspades}.py`).

Both CLIs run in this process on the same files: a 2,000-nt genome with a
planted 40-codon gene (made from a seed with numpy) as 800 FR pairs of 80 bp
in FASTA, two full-length transcripts of it, the gene's amino profile written
by the JAX package's `write_hmm`, and a flat series-analysis config per
package; the reference with `--platform cpu`, the port with `--device cpu`,
at k = 21.  Every file either writes (the log, `params.txt` and
`run_spades.sh` aside, which name the package or the time) must be equal
exactly, the GFA but for its header line; so must the series dumps.  The
port's `rnaspades` must also write the files of the library call it stands
for.
"""
import importlib
import os

import numpy as np
import pytest

from spades_tpu.core import dna as j_dna
from spades_tpu.hmm import io as j_hmm
from spades_tpu.mts.multiplicity import profiles_from_read_sets
from spades_tpu.pipeline import main as j_main
from spades_tpu.pipeline import wrappers as j_wrappers
from spades_tpu_torch.pipeline import main as t_main
from spades_tpu_torch.pipeline import run as t_run
from spades_tpu_torch.pipeline import wrappers as t_wrappers
from spades_tpu_torch.tools import synthetic
from tests.test_torch_modes import assert_same_files, files_under
from tests.test_torch_pipeline import one_torch_thread

NOT_COMPARED = {"spades.log", "run_spades.sh", "params.txt"}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    d = tmp_path_factory.mktemp("small")
    rng = np.random.default_rng(11)
    orf, pep = synthetic.random_orf(rng, 40)
    g = j_dna.decode(np.concatenate([rng.integers(0, 4, 900).astype(np.uint8), orf,
                                     rng.integers(0, 4, 980).astype(np.uint8)]))
    r1s, r2s = [], []
    for a in rng.integers(0, len(g) - 200, 800):
        r1s.append(g[a : a + 80])
        r2s.append(j_dna.revcomp_str(g[a + 120 : a + 200]))
    paths = {k: str(d / f"{k}.fasta") for k in ("1", "2", "fl")}
    synthetic.write_fasta(paths["1"], r1s)
    synthetic.write_fasta(paths["2"], r2s)
    synthetic.write_fasta(paths["fl"], [g[100:900], j_dna.revcomp_str(g[1000:1800]) + "T" * 20])
    paths["hmm"] = str(d / "gene.hmm")
    j_hmm.write_hmm(paths["hmm"], j_hmm.hmm_from_consensus(pep, "gene", alphabet="amino"))
    paths["mult"] = str(d / "profiles.npz")
    profiles_from_read_sets([r1s[:400] + r2s[:400], r1s[400:] + r2s[400:]], 21,
                            min_samples=1, min_mult=2).save(paths["mult"])
    return paths


def _cli_both(tmp_path, j_entry, t_entry, args, j_args=(), t_args=()):
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    assert j_entry(args + list(j_args) + ["-o", jdir, "--platform", "cpu"]) == 0
    assert t_entry(args + list(t_args) + ["-o", tdir, "--device", "cpu"]) == 0
    names = files_under(jdir) - NOT_COMPARED
    assert names == files_under(tdir) - NOT_COMPARED
    assert_same_files(jdir, tdir, names)
    return jdir, tdir, names


def _log(tdir):
    with open(os.path.join(tdir, "spades.log")) as fh:
        return fh.read()


@pytest.mark.parametrize("wrapper, flags", [
    ("rnaspades", ["--ss", "rf", "--fl-rna", "fl"]),
    ("rnaviralspades", []),
    ("coronaspades", ["--custom-hmms", "hmm"]),
])
def test_wrappers_match(small, tmp_path, wrapper, flags):
    args = ["-1", small["1"], "-2", small["2"], "-k", "21"] + [small.get(f, f) for f in flags]
    if wrapper != "rnaviralspades":
        args.append("--only-assembler")
    _jdir, tdir, names = _cli_both(tmp_path, getattr(j_wrappers, wrapper),
                                   getattr(t_wrappers, wrapper), args)
    flag = {"rnaspades": "--rna", "rnaviralspades": "--rnaviral",
            "coronaspades": "--corona"}[wrapper]
    with open(os.path.join(tdir, "params.txt")) as fh:
        assert fh.readline().split()[0] == flag
    log = _log(tdir)
    if wrapper == "rnaspades":
        assert "transcripts.fasta" in names and "SS Edge Splitting" in log
    if wrapper == "rnaviralspades":          # BayesHammer runs in rnaviral mode
        assert any(n.startswith("corrected/") for n in names)
    if wrapper == "coronaspades":
        assert {"K21/domain_hits.tsv", "K21/gene_clusters.txt"} <= names
        assert "loaded 1 HMM profiles" in log
    entry = importlib.import_module(f"spades_tpu_torch.pipeline.{wrapper}")
    assert entry.main is getattr(t_wrappers, wrapper)


@pytest.mark.parametrize("flags", [["--bio", "--custom-hmms", "hmm"], ["--rna", "--ss", "fr"],
                                   ["--custom-hmms", "hmm", "--custom-hmms", "hmm"]])
def test_cli_flags_match(small, tmp_path, flags):
    args = ["-1", small["1"], "-2", small["2"], "-k", "21", "--only-assembler"]
    _jdir, tdir, names = _cli_both(tmp_path, j_main.main, t_main.main,
                                   args + [small.get(f, f) for f in flags])
    if "--custom-hmms" in flags:
        assert "K21/domain_hits.tsv" in names
        with open(os.path.join(tdir, "run_spades.yaml")) as fh:
            assert "domain_analysis" in fh.read()


def test_cli_series_analysis_matches(small, tmp_path):
    side_args = {}
    for side in ("j", "t"):
        out = tmp_path / f"dumps_{side}"
        out.mkdir()
        cfg = tmp_path / f"{side}.yaml"
        cfg.write_text(f"k: 21\nsample_cnt: 2\nkmer_mult: {small['mult']}\nmin_len: 30\n"
                       f"edges_sqn: {out / 'e.fasta'}\nedges_mpl: {out / 'e.mpl'}\n")
        side_args[side] = ["--series-analysis", str(cfg)]
    args = ["-1", small["1"], "-2", small["2"], "-k", "21", "--only-assembler", "--meta"]
    _cli_both(tmp_path, j_main.main, t_main.main, args, side_args["j"], side_args["t"])
    for name in ("e.fasta", "e.mpl"):
        a = (tmp_path / "dumps_j" / name).read_bytes()
        assert a and a == (tmp_path / "dumps_t" / name).read_bytes(), name


def test_rnaspades_writes_the_library_calls_files(small, tmp_path):
    """`rnaspades --ss rf --fl-rna` is `run_assembly(mode="rna", ss="rf")` with
    the full-length transcripts as trusted contigs."""
    from spades_tpu_torch.io.fastx import read_fastx

    def seqs(p):
        return [r.seq for r in read_fastx(p)]

    cdir, ldir = str(tmp_path / "cli"), str(tmp_path / "lib")
    assert t_wrappers.rnaspades(["-1", small["1"], "-2", small["2"], "-k", "21", "--ss", "rf",
                                 "--fl-rna", small["fl"], "--only-assembler", "--device", "cpu",
                                 "-o", cdir]) == 0
    lefts, rights = seqs(small["1"]), seqs(small["2"])
    t_run.run_assembly(lefts + rights, [21], ldir, mode="rna", ss="rf", read_length=80,
                       paired_libs=[(lefts, rights)], trusted_contigs=seqs(small["fl"]),
                       device="cpu")
    for name in ("transcripts.fasta", "contigs.fasta", "scaffolds.fasta", "contigs.paths",
                 "assembly_graph_with_scaffolds.gfa"):
        assert open(os.path.join(cdir, name), "rb").read() == \
            open(os.path.join(ldir, name), "rb").read(), name
