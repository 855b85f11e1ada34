"""Port parity for the assembler CLI (`spades_tpu_torch.pipeline.main`) and
its executor files (`pipeline/executors.py`).

Both CLIs run in this process on the same FASTQ files (a 15,000-nt
`make_e2e_dataset` genome at 20x, 100-bp pairs, seed 2), the reference with
`--platform cpu`, the port with `--device cpu`, all at k=21 (the device
paths at lowered thresholds are held by `tests/test_torch_rr.py`).  Their
output files and `run_spades.yaml` must be byte-identical, the GFA but for
its header line.
`--num-processes` above 1 without a coordinator must raise a `ValueError`
naming it, before anything is read or written.
"""
import os

import pytest
import torch
import yaml

from spades_tpu.pipeline import executors as j_exec
from spades_tpu.pipeline import main as j_main
from spades_tpu_torch.pipeline import executors as t_exec
from spades_tpu_torch.pipeline import main as t_main
from spades_tpu_torch.tools import synthetic
from tests.test_torch_pipeline import assert_same_file, one_torch_thread

FILES = ("contigs.fasta", "scaffolds.fasta", "contigs.paths", "scaffolds.paths",
         "assembly_graph.fastg", "assembly_graph_with_scaffolds.gfa", "run_spades.yaml",
         "misc/broken_scaffolds.fasta")


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    """Two paired libraries of one genome, as FASTQ."""
    d = tmp_path_factory.mktemp("fq")
    _g, r1, r2 = synthetic.make_e2e_dataset(15_000, 20, 100, 0.003, seed=2,
                                            insert_mean=300, insert_sd=20)
    half = len(r1) // 2
    paths = {}
    for lib, sl in ((1, slice(None, half)), (2, slice(half, None))):
        for mate, reads in ((1, r1), (2, r2)):
            paths[(lib, mate)] = str(d / f"lib{lib}_{mate}.fq")
            synthetic.write_fastq(paths[(lib, mate)], reads[sl], mate)
    return paths


def _run_both(tmp_path, args):
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    assert j_main.main(args + ["-o", jdir, "--platform", "cpu"]) == 0
    assert t_main.main(args + ["-o", tdir, "--device", "cpu"]) == 0
    return jdir, tdir


def _compare(jdir, tdir, subs):
    n = 0
    for sub in subs:
        for name in FILES:
            a, b = os.path.join(jdir, sub, name), os.path.join(tdir, sub, name)
            assert os.path.exists(a) == os.path.exists(b), (sub, name)
            if os.path.exists(a):
                assert_same_file(a, b)
                n += 1
    return n


@pytest.mark.parametrize("variant", ["one_lib_k21", "numbered_libs_rr", "disable_rr_gfa11",
                                     "stop_after_k21"])
def test_cli_matches_the_reference(fastq, tmp_path, variant):
    one = ["-1", fastq[(1, 1)], "-2", fastq[(1, 2)]]
    numbered = ["--pe1-1", fastq[(1, 1)], "--pe1-2", fastq[(1, 2)],
                "--pe2-1", fastq[(2, 1)], "--pe2-2", fastq[(2, 2)]]
    args, subs = {
        "one_lib_k21": (one + ["--only-assembler", "-k", "21"], ["", "K21"]),
        "numbered_libs_rr": (numbered + ["--only-assembler", "-k", "21", "--isolate"],
                             ["", "K21"]),
        "disable_rr_gfa11": (numbered + ["--only-assembler", "-k", "21", "--disable-rr",
                                         "--gfa11"], ["", "K21"]),
        "stop_after_k21": (one + ["--only-assembler", "-k", "21,33", "--stop-after", "k21"],
                           ["", "K21"]),
    }[variant]
    jdir, tdir = _run_both(tmp_path, args)
    assert _compare(jdir, tdir, subs) >= 7
    with open(os.path.join(tdir, "params.txt")) as fh:
        assert fh.read().splitlines()[-1] == ("mode=isolate" if "--isolate" in args
                                              else "mode=multicell")
    if variant == "stop_after_k21":
        assert not os.path.exists(os.path.join(tdir, "K33"))
    if variant == "disable_rr_gfa11":
        with open(os.path.join(tdir, "assembly_graph_with_scaffolds.gfa")) as fh:
            assert fh.readline().startswith("H\tVN:Z:1.1")
    with open(os.path.join(tdir, "run_spades.sh")) as fh:
        assert "-m spades_tpu_torch.pipeline.main" in fh.read()


def test_only_generate_config_matches(fastq, tmp_path):
    args = ["-1", fastq[(1, 1)], "-2", fastq[(1, 2)], "--only-assembler",
            "--only-generate-config", "--grid-engine", "slurm", "--grid-queue", "q1"]
    jdir, tdir = _run_both(tmp_path, args)
    assert_same_file(os.path.join(jdir, "run_spades.yaml"), os.path.join(tdir, "run_spades.yaml"))
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert not os.path.exists(os.path.join(tdir, "contigs.fasta"))
    with open(os.path.join(tdir, "submit_spades.sh")) as fh:
        text = fh.read()
    assert "#SBATCH --partition=q1" in text and "spades_tpu_torch.pipeline.main" in text


@pytest.mark.parametrize("k_list, mode, careful, has_long, has_hmms", [
    ([21, 33, 55], "isolate", False, False, False),
    ([55], "multicell", False, False, False),
    ([21, 33, 55, 77, 99, 127], "meta", True, True, True),
    ([], "rna", False, False, False),
])
def test_run_spades_yaml_bytes_need_no_pyyaml(tmp_path, k_list, mode, careful, has_long,
                                              has_hmms):
    cmds = t_exec.pipeline_description(k_list, mode, careful, has_long, has_hmms)
    assert cmds == j_exec.pipeline_description(k_list, mode, careful, has_long, has_hmms)
    t_exec.dump_yaml(str(tmp_path / "run_spades.yaml"), cmds)
    with open(tmp_path / "run_spades.yaml") as fh:
        text = fh.read()
    assert text == yaml.safe_dump(cmds, sort_keys=False)
    assert yaml.safe_load(text) == cmds


def test_yaml_emitter_quotes_what_yaml_would_misread():
    cmds = [{"a": "yes", "b": "21", "c": "x: y", "d": "", "e": "it's", "f": None, "g": True,
             "h": 3, "i": [], "j": ["on", "plain words"]}, {}]
    text = t_exec.yaml_list_of_dicts(cmds)
    assert yaml.safe_load(text) == cmds
    assert text == yaml.safe_dump(cmds, sort_keys=False)
    assert t_exec.yaml_list_of_dicts([]) == yaml.safe_dump([], sort_keys=False)
    with pytest.raises(TypeError):
        t_exec.yaml_list_of_dicts([{"x": 1.5}])


@pytest.mark.parametrize("extra, item", [
    # every option is ported: each former refusal case keeps its flags and
    # meets the one check left, a multi-process run without a coordinator
    (["--rnaviral", "--num-processes", "2"], "coordinator"),    # error correction is the default
    (["--only-error-correction", "--rna", "--read-cov-threshold", "3",
      "--num-processes", "2"], "coordinator"),
    (["--iontorrent", "--bio", "--num-processes", "2"], "coordinator"),
    (["--only-assembler", "--read-cov-threshold", "3", "--num-processes", "2"], "coordinator"),
    (["--only-assembler", "--num-processes", "2"], "coordinator"),
    (["--only-assembler", "--rna", "--fl-rna", "lr.fq", "--read-cov-threshold", "3",
      "--num-processes", "2"], "coordinator"),
    (["--only-assembler", "--meta", "--series-analysis", "s.yaml", "--num-processes", "2"],
     "coordinator"),
    (["--only-assembler", "--nanopore", "lr.fq", "--custom-hmms", "p.hmm",
      "--read-cov-threshold", "3", "--num-processes", "2"], "coordinator"),
    (["--only-assembler", "--fl-rna", "lr.fq", "--num-processes", "2"], "coordinator"),
    (["--only-assembler", "--custom-hmms", "p.hmm", "--read-cov-threshold", "3",
      "--num-processes", "2"], "coordinator"),
    (["--only-assembler", "--assembly-graph", "g.gfa", "--rna", "--num-processes", "2"],
     "coordinator"),
    (["--careful", "--corona", "--read-cov-threshold", "3", "--num-processes", "2"], "coordinator"),
    (["--mismatch-correction", "--rnaviral", "--num-processes", "2"], "coordinator"),
    (["--only-assembler", "--meta", "--ss", "rf", "--read-cov-threshold", "3",
      "--num-processes", "2"], "coordinator"),
    (["--only-assembler", "--rna", "--ss", "fr", "--num-processes", "2"], "coordinator"),
    (["--only-assembler", "--plasmid", "--num-processes", "4"], "coordinator"),
])
def test_num_processes_without_a_coordinator_raise(tmp_path, monkeypatch, extra, item):
    monkeypatch.delenv("SPADES_COORDINATOR", raising=False)
    out = tmp_path / "o"
    with pytest.raises(ValueError, match=item):
        t_main.main(["-1", "missing_1.fq", "-2", "missing_2.fq", "-o", str(out),
                     "--device", "cpu"] + extra)
    assert not out.exists()


def test_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_main.main(["-1", "a.fq", "-2", "b.fq", "--only-assembler", "-o", str(tmp_path / "o")])
    assert t_main.main(["--only-assembler", "-o", str(tmp_path / "o")]) == 64   # no reads
    assert t_main.main(["-1", "a.fq", "--only-assembler"]) == 64                # no -o


def test_numbered_library_options_split_as_the_reference_does():
    argv = ["--pe1-1", "a.fq", "--pe1-2", "b.fq", "--pe1-rf", "--mp2-12", "c.fq", "--s3",
            "d.fq", "-k", "21", "--hqmp1-s", "e.fq"]
    assert t_main.extract_numbered_libs(argv) == j_main.extract_numbered_libs(argv)
    for flags in ([], ["--isolate"], ["--meta", "--isolate"], ["--rna"]):
        ja, ta = (m.build_parser().parse_args(flags + ["-o", "x"]) for m in (j_main, t_main))
        assert t_main.detect_mode(ta) == j_main.detect_mode(ja)


def test_profile_and_time_trace_are_written(fastq, tmp_path):
    out = str(tmp_path / "p")
    assert t_main.main(["-1", fastq[(1, 1)], "-2", fastq[(1, 2)], "--only-assembler", "-k", "21",
                        "--disable-rr", "--profile", "--time-tracing", "--device", "cpu",
                        "-o", out]) == 0
    assert os.path.getsize(os.path.join(out, "profile", "trace.json")) > 0
    assert os.path.getsize(os.path.join(out, "spades_time_trace.json")) > 0


def test_test_dataset_option(tmp_path):
    if not os.path.exists(os.path.join(t_main.test_dataset_dir(), "ecoli_1K_1.fq.gz")):
        pytest.skip("SPAdes' test dataset is not available")
    assert t_main.main(["--test", "--only-assembler", "--device", "cpu",
                        "-o", str(tmp_path / "t")]) == 0
