"""Port parity for the CLI's new modes and inputs (`--meta`, `--plasmid`,
`--metaplasmid`, `--metaviral`, `--sc`, `--sewage`, `--pacbio`, `--nanopore`,
`--sanger`, `--assembly-graph`) and the four mode wrappers
(`pipeline/wrappers.py` and `pipeline/{metaspades,plasmidspades,
metaplasmidspades,metaviralspades}.py`).

Both CLIs run in this process on the same files: the genome of
`tests/test_two_step_rr.py` (1,200 nt, made from a seed with numpy) as 600
FR pairs of 80 bp in FASTA, and noisy long reads of it, at k = 21 with
`--only-assembler`; the reference with `--platform cpu`, the port with
`--device cpu`.  Every file either writes (the log, `params.txt` and
`run_spades.sh` aside, which name the package or the time) must be equal
exactly, the GFA but for its header line.  The library runs of these modes
are held by `tests/test_torch_modes.py`, `tests/test_torch_modes_sc.py`,
`tests/test_torch_long_read.py` and `tests/test_torch_meta.py`.
"""
import importlib
import os

import numpy as np
import pytest

from spades_tpu.core import dna as j_dna
from spades_tpu.pipeline import main as j_main
from spades_tpu.pipeline import wrappers as j_wrappers
from spades_tpu_torch.pipeline import main as t_main
from spades_tpu_torch.pipeline import wrappers as t_wrappers
from spades_tpu_torch.tools import synthetic
from tests.test_torch_modes import assert_same_files, files_under
from tests.test_torch_pipeline import GFA, one_torch_thread

FIRST_PE = os.path.join("K21", "first_pe_contigs.fasta")


def _rand(n, rng):
    return j_dna.decode(rng.integers(0, 4, n).astype(np.uint8))


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The genome of `tests/test_two_step_rr.py` (1,200 nt) as FR pairs of
    80 bp over 200-bp inserts in FASTA, with noisy long reads of it."""
    rng = np.random.default_rng(42)
    genome = _rand(1200, rng)
    r1s, r2s = [], []
    for _ in range(600):
        a = int(rng.integers(0, len(genome) - 200))
        r1s.append(genome[a : a + 80])
        r2s.append(j_dna.revcomp_str(genome[a + 120 : a + 200]))
    d = tmp_path_factory.mktemp("small")
    paths = {"1": str(d / "r1.fasta"), "2": str(d / "r2.fasta"), "lr": str(d / "lr.fasta")}
    synthetic.write_fasta(paths["1"], r1s)
    synthetic.write_fasta(paths["2"], r2s)
    codes = j_dna.encode(genome)
    synthetic.write_fasta(paths["lr"], synthetic.sample_long_reads(
        codes, 6, 900, 100, 0.04, 0.03, 0.03, 7))
    return paths


def _cli_both(tmp_path, j_entry, t_entry, args):
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    assert j_entry(args + ["-o", jdir, "--platform", "cpu"]) == 0
    assert t_entry(args + ["-o", tdir, "--device", "cpu"]) == 0
    names = files_under(jdir) - {"spades.log", "run_spades.sh", "params.txt"}
    assert names == files_under(tdir) - {"spades.log", "run_spades.sh", "params.txt"}
    assert_same_files(jdir, tdir, names)
    return jdir, tdir, names


@pytest.mark.parametrize("flags", [["--sc"], ["--sewage"], ["--nanopore", "lr"],
                                   ["--pacbio", "lr", "--sanger", "lr"]])
def test_cli_modes_and_inputs_match(small, tmp_path, flags):
    """`--sewage` runs without `--only-assembler`: the mode itself skips
    error correction."""
    flags = [small.get(f, f) for f in flags]
    args = ["-1", small["1"], "-2", small["2"], "-k", "21"] + flags
    if flags != ["--sewage"]:
        args.append("--only-assembler")
    _jdir, tdir, names = _cli_both(tmp_path, j_main.main, t_main.main, args)
    assert {"contigs.fasta", "scaffolds.fasta", "run_spades.yaml", GFA} <= names
    assert not any(n.startswith("corrected") for n in names)
    with open(os.path.join(tdir, "spades.log")) as fh:
        log = fh.read()
    if flags[0] in ("--nanopore", "--pacbio", "--sanger"):
        assert "Hybrid Aligning" in log and "hybrid aligning:" in log
    with open(os.path.join(tdir, "params.txt")) as fh:
        mode = fh.read().splitlines()[-1]
    assert mode == "mode=" + {"--sc": "sc", "--sewage": "sewage"}.get(flags[0], "multicell")


def test_cli_assembly_graph_matches(small, tmp_path):
    """`--assembly-graph` loads a GFA (written by the JAX package) for the
    main iteration; the reads still feed repeat resolution."""
    base = ["-1", small["1"], "-2", small["2"], "--only-assembler"]
    gdir = str(tmp_path / "graph")
    assert j_main.main(base + ["-k", "21", "-o", gdir, "--platform", "cpu"]) == 0
    args = base + ["-k", "21", "--assembly-graph", os.path.join(gdir, GFA)]
    _jdir, tdir, names = _cli_both(tmp_path, j_main.main, t_main.main, args)
    with open(os.path.join(tdir, "spades.log")) as fh:
        assert "Load Graph" in fh.read()
    assert "contigs.fasta" in names


@pytest.mark.parametrize("wrapper", ["metaspades", "plasmidspades", "metaplasmidspades",
                                     "metaviralspades"])
def test_wrappers_match(small, tmp_path, wrapper):
    args = ["-1", small["1"], "-2", small["2"], "-k", "21", "--only-assembler"]
    _jdir, _tdir, names = _cli_both(tmp_path, getattr(j_wrappers, wrapper),
                                    getattr(t_wrappers, wrapper), args)
    flag = {"metaspades": "--meta", "plasmidspades": "--plasmid",
            "metaplasmidspades": "--metaplasmid", "metaviralspades": "--metaviral"}[wrapper]
    with open(os.path.join(tmp_path / "t", "params.txt")) as fh:
        assert fh.readline().split()[0] == flag
    with open(os.path.join(tmp_path / "t", "spades.log")) as fh:
        log = fh.read()
    if wrapper == "metaspades":         # the two-step repeat resolution
        assert FIRST_PE in names
        assert "Preliminary Repeat Resolving" in log and "Second Phase Setup" in log
    if wrapper != "metaspades":
        assert "Chromosome Removal" in log
    if wrapper in ("metaplasmidspades", "metaviralspades"):
        assert "metaplasmid loop" in log
    entry = importlib.import_module(f"spades_tpu_torch.pipeline.{wrapper}")
    assert entry.main is getattr(t_wrappers, wrapper)
