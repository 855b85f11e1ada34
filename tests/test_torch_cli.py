"""Port parity for the assembler CLI (`spades_tpu_torch.pipeline.main`) and
its executor files (`pipeline/executors.py`).

Both CLIs run in this process on the same FASTQ files (a 15,000-nt
`make_e2e_dataset` genome at 20x, 100-bp pairs, seed 2), the reference with
`--platform cpu`, the port with `--device cpu`, all at k=21 (the device
paths at lowered thresholds are held by `tests/test_torch_rr.py`).  Their
output files and `run_spades.yaml` must be byte-identical, the GFA but for
its header line.
`--num-processes` above 1 without a coordinator must raise a `ValueError`
naming it, before anything is read or written.  `--time-tracing` writes
the span tree of an assembly and, on its early return, of
`--only-error-correction`; the stage trail is the stage spans' measurement;
each `main` starts from an empty recorder.
"""
import json
import os

import pytest
import torch
import yaml

from spades_tpu.pipeline import executors as j_exec
from spades_tpu.pipeline import main as j_main
from spades_tpu_torch.pipeline import executors as t_exec
from spades_tpu_torch.pipeline import main as t_main
from spades_tpu_torch.pipeline import stages as t_stage_rt
from spades_tpu_torch.tools import synthetic
from spades_tpu_torch.utils import timetracer
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
    # the operator's profiler trace holds the program's spans on its clock
    with open(os.path.join(out, "profile", "trace.json")) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"spades", "cli.parse", "k21", "construction", "construction.condense"} <= names


def _span_tree(path):
    """The spans of a `--time-tracing` file by detail, after checking that
    every span has an id and a parent (none for the root alone) and lies
    within its parent, and that the file names its clock and origin."""
    with open(path) as fh:
        data = json.load(fh)
    assert data["otherData"]["clock"] == "time.perf_counter"
    assert isinstance(data["otherData"]["origin_s"], float) and data["otherData"]["run"]
    events = data["traceEvents"]
    by_id = {e["args"]["id"]: e for e in events}
    assert len(by_id) == len(events)
    assert [e["args"]["detail"] for e in events if e["args"]["parent"] is None] == ["spades"]
    by_detail = {}
    for e in events:
        by_detail.setdefault(e["args"]["detail"], []).append(e)
        if e["args"]["parent"] is not None:
            p = by_id[e["args"]["parent"]]
            assert p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 2, e
    return data, by_detail


@pytest.fixture(scope="module")
def traced(fastq, tmp_path_factory):
    """An assembly, then error correction alone, both under --time-tracing,
    then an assembly without it, in this process; the stage trail of the
    first and what the recorder held after each."""
    base = ["-1", fastq[(1, 1)], "-2", fastq[(1, 2)], "--device", "cpu"]
    asm, ec, plain = (str(tmp_path_factory.mktemp(n)) for n in ("asm", "ec", "plain"))
    t_stage_rt.STAGE_TIMES.clear()
    assert t_main.main(base + ["--only-assembler", "-k", "21", "--time-tracing", "-o", asm]) == 0
    stage_times = list(t_stage_rt.STAGE_TIMES)
    held = [timetracer.enabled(), timetracer.events()]
    assert t_main.main(base + ["--only-error-correction", "--time-tracing", "-o", ec]) == 0
    held += [timetracer.enabled(), timetracer.events()]
    assert t_main.main(base + ["--only-assembler", "-k", "21", "--disable-rr", "-o", plain]) == 0
    held += [timetracer.enabled(), timetracer.events()]
    return {"asm": asm, "ec": ec, "plain": plain, "stage_times": stage_times, "held": held}


def test_time_trace_of_an_assembly(traced):
    _data, spans = _span_tree(os.path.join(traced["asm"], "spades_time_trace.json"))
    stage_ids = [s for _k, s, _t in traced["stage_times"]]
    assert {"spades", "cli.parse", "cli.pack", "k21", "cli.checkpoint", *stage_ids} <= set(spans)
    assert {"construction.count_host", "construction.merge", "construction.ext_build",
            "construction.condense", "pair_info_count.index", "map_store"} <= set(spans)
    assert len(spans["cli.parse"]) == 2
    assert sum(e["args"]["reads"] for e in spans["cli.parse"]) == spans["cli.pack"][0]["args"][
        "reads"]
    (root,) = spans["spades"]
    for sid in stage_ids:
        (ev,) = spans[sid]
        assert ev["args"]["k"] == 21
        assert spans["k21"][0]["args"]["id"] == ev["args"]["parent"]
    # the stage trail is the stage spans' measurement, to 0.01 s
    for _k, sid, sec in traced["stage_times"]:
        assert abs(spans[sid][0]["dur"] * 1e-6 - sec) <= 0.005 + 1e-6, (sid, sec)
    cond = spans["construction.condense"][0]["args"]
    assert cond["unique_kmers"] > 0 and cond["edges"] > 0
    assert all(e["args"]["b1_launches"] == 0 and e["args"]["maxrss_mib"] > 0
               for es in spans.values() for e in es)


def test_time_trace_of_error_correction_alone(traced):
    """The trace file is written on the early return of
    --only-error-correction too."""
    _data, spans = _span_tree(os.path.join(traced["ec"], "spades_time_trace.json"))
    assert {"spades", "cli.parse", "error_correction", "cli.ec_write", "hammer.count",
            "hammer.maps", "hammer.cluster", "hammer.coverage", "hammer.vote"} <= set(spans)
    ec_id = spans["error_correction"][0]["args"]["id"]
    assert all(e["args"]["parent"] == ec_id for d, es in spans.items()
               if d.startswith("hammer.") and d.count(".") == 1 for e in es)
    assert spans["hammer.count"][0]["args"]["unique_kmers"] > 0
    assert spans["hammer.cluster"][0]["args"]["clusters"] > 0


def test_a_second_main_starts_from_an_empty_recorder(traced):
    asm, _ = _span_tree(os.path.join(traced["asm"], "spades_time_trace.json"))
    ec, spans = _span_tree(os.path.join(traced["ec"], "spades_time_trace.json"))
    assert asm["otherData"]["run"] != ec["otherData"]["run"]
    assert not {"k21", "construction", "cli.pack"} & set(spans)
    # after each run the recorder is off and empty; an untraced run records nothing
    assert traced["held"] == [False, [], False, [], False, []]
    assert not os.path.exists(os.path.join(traced["plain"], "spades_time_trace.json"))


def test_test_dataset_option(tmp_path):
    if not os.path.exists(os.path.join(t_main.test_dataset_dir(), "ecoli_1K_1.fq.gz")):
        pytest.skip("SPAdes' test dataset is not available")
    assert t_main.main(["--test", "--only-assembler", "--device", "cpu",
                        "-o", str(tmp_path / "t")]) == 0
