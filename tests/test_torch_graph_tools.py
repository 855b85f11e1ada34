"""Port parity for the graph tools: `tools/{gchecker,gfa_split,gsimplifier,
gmapper,spaligner,pathracer,mts}.py`.

The inputs are made from seeds with numpy: a 12,000-nt genome with a planted
40-codon gene and a 3,000-nt second replicon, 100-bp FR pairs at about 20x
with 0.5 % substitutions, the graph `spades_tpu.tools.gbuilder` builds of
them at k=21 (two components, error tips and bulges), noisy long reads, the
gene's peptide as an amino profile, and two samples that mix the replicons
at different depths.  The oracles for the inputs are `tests/test_tools.py`,
`test_gchecker.py`, `test_plasmid_binreads.py`, `test_hmm.py` and
`test_mts.py`.  Each tool of both packages runs on the same files (the port
with `--device cpu`); printed lines and output files must be equal (tolerance
0), the GFA but for its header.  gmapper is held on the host path and, with
`SPADES_DEVICE_MAP_READS=1` in both packages, on the device path (the port's
on CPU tensors).  The host tools run without a card; the device tools raise.
"""
import json
import os

import numpy as np
import pytest
import torch

from spades_tpu.core import dna as j_dna
from spades_tpu.tools import gbuilder as j_gbuilder
from spades_tpu.tools import gchecker as j_gchecker
from spades_tpu.tools import gfa_split as j_gfa_split
from spades_tpu.tools import gmapper as j_gmapper
from spades_tpu.tools import gsimplifier as j_gsimplifier
from spades_tpu.tools import mts as j_mts
from spades_tpu.tools import pathracer as j_pathracer
from spades_tpu.tools import spaligner as j_spaligner
from spades_tpu_torch.hmm.io import hmm_from_consensus, write_hmm
from spades_tpu_torch.tools import gchecker as t_gchecker
from spades_tpu_torch.tools import gfa_split as t_gfa_split
from spades_tpu_torch.tools import gmapper as t_gmapper
from spades_tpu_torch.tools import gsimplifier as t_gsimplifier
from spades_tpu_torch.tools import mts as t_mts
from spades_tpu_torch.tools import pathracer as t_pathracer
from spades_tpu_torch.tools import spaligner as t_spaligner
from spades_tpu_torch.tools import synthetic
from tests.test_torch_pipeline import THRESHOLDS, assert_same_file, one_torch_thread


def _pairs(rng, g: str, n: int, rl: int = 100, err: float = 0.005):
    acgt = np.frombuffer(b"ACGT", np.uint8)
    lefts, rights = [], []
    for a in rng.integers(0, len(g) - 300, n):
        for out, s in ((lefts, g[a : a + rl]), (rights, j_dna.revcomp_str(g[a + 200 : a + 300]))):
            b = np.frombuffer(s.encode(), np.uint8).copy()
            hit = rng.random(len(b)) < err
            b[hit] = acgt[rng.integers(0, 4, int(hit.sum()))]
            out.append(b.tobytes().decode())
    return lefts, rights


def _fasta(path, records):
    with open(path, "w") as fh:
        for name, s in records:
            fh.write(f">{name}\n{s}\n")
    return str(path)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("graph_tools")
    rng = np.random.default_rng(21)
    orf, pep = synthetic.random_orf(rng, 40)
    codes = np.concatenate([rng.integers(0, 4, 5_000).astype(np.uint8), orf,
                            rng.integers(0, 4, 12_000 - 5_000 - len(orf)).astype(np.uint8)])
    genome = j_dna.decode(codes)
    plasmid = j_dna.decode(rng.integers(0, 4, 3_000).astype(np.uint8))
    l1, r1 = _pairs(rng, genome, 1_200)
    l2, r2 = _pairs(rng, plasmid, 300)
    reads = _fasta(d / "reads.fa", [(f"r{i}", s) for i, s in enumerate(l1 + r1 + l2 + r2)])
    gdir = str(d / "gb")
    assert j_gbuilder.main([reads, "-k", "21", "-w", gdir]) == 0
    contigs = [("c_front", genome[:5_000]), ("c_back_rc", j_dna.revcomp_str(genome[6_000:])),
               ("c_chimera", genome[100:1_100] + plasmid[:900]), ("c_short", genome[:300]),
               ("c_plasmid", plasmid)]
    hmm = str(d / "gene.hmm")
    write_hmm(hmm, hmm_from_consensus(pep, "gene", alphabet="amino"))
    long_reads = synthetic.sample_long_reads(codes, 3, 2_000, 300, 0.03, 0.02, 0.02, 5)
    samples = []
    for s, (cg, cp) in enumerate(((300, 60), (60, 300))):
        la, ra = _pairs(rng, genome, cg)
        lb, rb = _pairs(rng, plasmid, cp)
        samples.append(_fasta(d / f"sample{s}.fa",
                              [(f"s{s}r{i}", x) for i, x in enumerate(la + ra + lb + rb)]))
    return {
        "d": d, "genome": genome, "plasmid": plasmid, "reads": reads,
        "gfa": os.path.join(gdir, "assembly_graph_with_scaffolds.gfa"),
        "contigs": _fasta(d / "contigs.fa", contigs),
        "ref": _fasta(d / "ref.fa", [("chr", genome), ("pl", plasmid)]),
        "hmm": hmm,
        "long": _fasta(d / "long.fa", [(f"lr{i}", s) for i, s in enumerate(long_reads)]),
        "samples": samples,
        "mts_contigs": _fasta(d / "mts_contigs.fa",
                              [(f"g{i}", genome[i * 3_000 : (i + 1) * 3_000]) for i in range(4)]
                              + [("p0", plasmid)]),
    }


def _run_both(capsys, tmp_path, j_main, t_main, argv, out_flag="-w", device=True):
    """Run both tools on `argv`, each into its own output directory; returns
    (j_dir, t_dir, printed text with the directories masked)."""
    outs = {}
    for name, fn in (("j", j_main), ("t", t_main)):
        out = str(tmp_path / name)
        extra = ["--device", "cpu"] if name == "t" and device else []
        assert fn(argv + [out_flag, out] + extra) == 0
        outs[name] = (out, capsys.readouterr().out.replace(out, "<out>"))
    assert outs["t"][1] == outs["j"][1]
    return outs["j"][0], outs["t"][0], outs["t"][1]


def _same_tree(jdir, tdir) -> list:
    names = sorted(os.path.relpath(os.path.join(r, f), jdir)
                   for r, _d, fs in os.walk(jdir) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(r, f), tdir)
                           for r, _d, fs in os.walk(tdir) for f in fs)
    for n in names:
        a, b = os.path.join(jdir, n), os.path.join(tdir, n)
        if n.endswith(".gfa") and open(a).readline().startswith("H\tVN:Z:1.2\tsp:Z:"):
            with open(a) as fa, open(b) as fb:      # a header that names the package
                la, lb = fa.readlines(), fb.readlines()
            assert lb[0] == la[0].replace("spades-tpu-", "spades-tpu-torch-")
            assert la[1:] == lb[1:] and len(la) > 1, n
        else:
            assert_same_file(a, b)
    return names


def test_quast_metrics_match(data):
    from spades_tpu.tools.gchecker import quast_metrics as j_q
    from spades_tpu_torch.tools.gchecker import quast_metrics as t_q

    g, p = data["genome"], data["plasmid"]
    cases = [([g], [g]), ([g[:3000] + g[8000:11000], g[:5000]], [g]),
             ([j_dna.revcomp_str(g)], [g]), ([g, p[:2000]], [g, p]), ([], [g]),
             ([g[:400]], [g])]
    for contigs, genomes in cases:
        assert t_q(contigs, genomes) == j_q(contigs, genomes)
    assert t_q(*cases[1])["misassembled"] == 1


def test_gchecker_cli_matches(data, tmp_path, capsys):
    argv = [data["contigs"], data["ref"], "--min-contig", "250"]
    jdir, tdir, out = _run_both(capsys, tmp_path, j_gchecker.main, t_gchecker.main, argv)
    assert _same_tree(jdir, tdir) == ["report.tsv"]
    m = json.loads(out)
    assert m["misassembled"] == 1 and m["n_contigs"] == 5


def test_gfa_split_cli_matches(data, tmp_path, capsys):
    jdir, tdir, out = _run_both(capsys, tmp_path, j_gfa_split.main, t_gfa_split.main,
                                [data["gfa"]])
    names = _same_tree(jdir, tdir)
    assert len(names) >= 2 and out.startswith(f"{len(names)} components")


@pytest.mark.parametrize("ec_bound", [None, "3.5"])
def test_gsimplifier_cli_matches(data, tmp_path, capsys, ec_bound):
    argv = [data["gfa"], "-k", "21", "--read-length", "100"]
    if ec_bound:
        argv += ["--ec-bound", ec_bound]
    jdir, tdir, out = _run_both(capsys, tmp_path, j_gsimplifier.main, t_gsimplifier.main, argv)
    assert _same_tree(jdir, tdir) == ["simplified.fasta", "simplified.gfa"]
    loaded, done = out.splitlines()[:2]
    assert int(done.split(" -> ")[1].split()[0]) < int(loaded.split()[1])


@pytest.mark.parametrize("path", ["host", "device"])
def test_gmapper_cli_matches(data, tmp_path, capsys, monkeypatch, path):
    if path == "device":
        monkeypatch.setenv("SPADES_DEVICE_MAP_READS", "1")
        monkeypatch.setenv("SPADES_MAP_SUBCHUNK", THRESHOLDS["SPADES_MAP_SUBCHUNK"])
    jdir, tdir, out = _run_both(capsys, tmp_path, j_gmapper.main, t_gmapper.main,
                                [data["gfa"], data["reads"], "-k", "21"])
    assert _same_tree(jdir, tdir) == ["mapping.tsv"]
    mapped, total = out.split()[1].split("/")
    assert int(total) == 3_000 and int(mapped) > 2_700


@pytest.mark.parametrize("datatype", ["pacbio", "contigs"])
def test_spaligner_cli_matches(data, tmp_path, capsys, datatype):
    src = data["long"] if datatype == "pacbio" else data["contigs"]
    jdir, tdir, out = _run_both(capsys, tmp_path, j_spaligner.main, t_spaligner.main,
                                [data["gfa"], src, "-k", "21", "-d", datatype])
    assert _same_tree(jdir, tdir) == ["alignment.tsv"]
    aligned, total = out.splitlines()[-1].split()[1].split("/")
    assert 2 * int(aligned) > int(total) > 0


def test_pathracer_cli_matches(data, tmp_path, capsys):
    jdir, tdir, out = _run_both(capsys, tmp_path, j_pathracer.main, t_pathracer.main,
                                [data["hmm"], data["gfa"], "-k", "21", "--top", "3"])
    assert _same_tree(jdir, tdir) == ["pathracer.fasta", "pathracer.tsv"]
    assert int(out.splitlines()[-1].split()[0]) > 0


@pytest.mark.parametrize("variant", ["fasta_split", "gfa_winsorized"])
def test_mts_cli_matches(data, tmp_path, capsys, monkeypatch, variant):
    monkeypatch.setenv("SPADES_HOST_COUNT_WINDOWS", THRESHOLDS["SPADES_HOST_COUNT_WINDOWS"])
    if variant == "fasta_split":
        argv = [data["mts_contigs"], *data["samples"], "-k", "21", "--min-mult", "2",
                "--min-length", "1000", "--split-reads"]
    else:
        argv = [data["gfa"], *data["samples"], "-k", "21", "--min-mult", "2",
                "--min-length", "500", "--estimator", "winsorized"]
    jdir, tdir, out = _run_both(capsys, tmp_path, j_mts.main, t_mts.main, argv)
    names = _same_tree(jdir, tdir)
    assert {"profiles.tsv", "binning.tsv"} <= set(names)
    if variant == "fasta_split":
        bins = dict(ln.split("\t") for ln in
                    open(os.path.join(tdir, "binning.tsv")).read().splitlines())
        assert len({bins[f"g{i}"] for i in range(4)}) == 1 and bins["p0"] != bins["g0"]
        assert any(n.startswith("binned_reads/") for n in names)


def test_host_tools_run_without_a_card(data, tmp_path, monkeypatch, capsys):
    """gchecker, gfa_split, gsimplifier, spaligner and pathracer are host code:
    no card needed, with or without `--device`."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    runs = ((t_gchecker.main, [data["contigs"], data["ref"]]),
            (t_gfa_split.main, [data["gfa"]]),
            (t_gsimplifier.main, [data["gfa"], "-k", "21"]),
            (t_spaligner.main, [data["gfa"], data["contigs"], "-k", "21", "-d", "contigs"]),
            (t_pathracer.main, [data["hmm"], data["gfa"], "-k", "21", "--top", "1"]))
    for i, (fn, argv) in enumerate(runs):
        assert fn(argv + ["-w", str(tmp_path / f"o{i}")]) == 0
    capsys.readouterr()


def test_device_graph_tools_need_a_card(data, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn, argv in ((t_gmapper.main, [data["gfa"], data["reads"], "-k", "21"]),
                     (t_mts.main, [data["mts_contigs"], *data["samples"], "-k", "21"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(argv + ["-w", str(tmp_path / "o")])
