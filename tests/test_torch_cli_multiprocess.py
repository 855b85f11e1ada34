"""Port parity for multi-process runs of the CLI and of `construct_graph`.

`python -m spades_tpu_torch.pipeline.main --num-processes 2` runs as two
gloo CPU processes (a `file://` store as the coordinator) on a 30,000-nt
genome at 20x with four coverage gaps, the default path with `--careful` at
k=21, with the device
thresholds lowered so that counting, mapping, the gap closer's prefilter
and the vote take their group paths.  Its files must equal the JAX CLI's
one-process run byte for byte (the GFA but for its header line), and rank 1,
given an output directory of its own, must leave it unwritten.
`construct_graph` under a 2-rank group must equal the JAX package's (which
counts on its 8-device virtual mesh), with prev-K contigs, a coverage
filter and a run-wide read store.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from spades_tpu.pipeline import main as j_main
from spades_tpu.pipeline.construction import construct_graph as j_construct
from spades_tpu_torch.core.reads import ReadStore
from spades_tpu_torch.parallel.dryrun import GRAPH_FIELDS, RankPool, graph_task
from spades_tpu_torch.tools import synthetic
from tests.test_torch_construction import REPO
from tests.test_torch_pipeline import THRESHOLDS, assert_same_file, one_torch_thread  # noqa: F401

FILES = ("contigs.fasta", "scaffolds.fasta", "contigs.paths", "scaffolds.paths",
         "assembly_graph.fastg", "assembly_graph_with_scaffolds.gfa", "run_spades.yaml",
         "K21/contigs.fasta", "corrected/lib1_1.cor.fasta", "corrected/lib1_2.cor.fasta")
ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("fq")
    _g, r1, r2, _gaps = synthetic.make_gapped_dataset(30_000, 20, 100, 0.003, 4, 4,
                                                      insert_mean=300, insert_sd=20)
    paths = [str(d / "r1.fq"), str(d / "r2.fq")]
    synthetic.write_fastq(paths[0], r1, 1)
    synthetic.write_fastq(paths[1], r2, 2)
    reads = [ACGT[r].tobytes().decode() for r in np.concatenate([r1, r2])]
    return paths, reads


@pytest.fixture(scope="module")
def reference(dataset, tmp_path_factory):
    """The JAX CLI's one-process run, with the device thresholds lowered."""
    paths, _reads = dataset
    jdir = str(tmp_path_factory.mktemp("j"))
    with pytest.MonkeyPatch.context() as mp:
        for name, value in THRESHOLDS.items():
            mp.setenv(name, value)
        assert j_main.main(cli_args(paths) + ["-o", jdir, "--platform", "cpu"]) == 0
    return jdir


def cli_args(paths):
    return ["-1", paths[0], "-2", paths[1], "-k", "21", "--careful"]


@pytest.mark.parametrize("launch", ["arguments", "environment"])
def test_cli_on_two_processes_matches_the_reference(dataset, reference, tmp_path, launch):
    """The ranks learn the run's layout from their arguments, or from the
    SPADES_NUM_PROCESSES / SPADES_PROCESS_ID / SPADES_COORDINATOR
    environment alone (an mpiexec-style launcher)."""
    paths, _reads = dataset
    outs = [str(tmp_path / "t"), str(tmp_path / "rank1_out")]
    store = f"file://{tmp_path}/store"
    env = dict(os.environ, OMP_NUM_THREADS="1", **THRESHOLDS,
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmds, envs = [], []
    for r in range(2):
        cmd = [sys.executable, "-m", "spades_tpu_torch.pipeline.main", *cli_args(paths),
               "-o", outs[r], "--device", "cpu"]
        if launch == "arguments":
            cmds.append(cmd + ["--num-processes", "2", "--process-id", str(r),
                               "--coordinator", store, "--dist-backend", "gloo"])
            envs.append(env)
        else:
            cmds.append(cmd)
            envs.append(dict(env, SPADES_NUM_PROCESSES="2", SPADES_PROCESS_ID=str(r),
                             SPADES_COORDINATOR=store))
    procs = [subprocess.Popen(cmd, cwd=REPO, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd, e in zip(cmds, envs)]
    try:
        logs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-3000:]}"
    assert not os.path.exists(outs[1]), "rank 1 wrote its output directory"
    for name in FILES:
        assert_same_file(os.path.join(reference, name), os.path.join(outs[0], name))
    for log in logs:
        assert "Mismatch Correction" in log and "collectives:" in log
    with open(os.path.join(outs[0], "spades.log")) as fh:
        text = fh.read()
    assert "exchanged_bytes" in text and "gap closer prefilter" in text


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(2, "cpu", "gloo", f"file://{tmp_path_factory.mktemp('store')}/s",
                 timeout_s=300)
    yield p
    p.close()


@pytest.mark.parametrize("variant", ["plain", "extra_sequences", "min_count", "read_store"])
def test_construct_graph_under_two_ranks_matches_jax(dataset, pool, variant):
    _paths, reads = dataset
    k = 33
    extra = [reads[0] + reads[1][::-1], reads[2][:70]]
    kw = {"plain": {}, "extra_sequences": {"extra_sequences": extra},
          "min_count": {"min_count": 2, "extra_sequences": extra},
          "read_store": {"read_store": ReadStore.build(reads, chunk_reads=1000)}}[variant]
    jkw = {key: v for key, v in kw.items() if key != "read_store"}
    ref = j_construct(reads, k, **jkw)
    got = pool.run(graph_task, reads, k, "cpu", group="world", **kw)
    for r, res in enumerate(got):
        assert np.array_equal(res["words"], ref.p1_counts.words), r
        assert np.array_equal(res["counts"], ref.p1_counts.counts), r
        for f in GRAPH_FIELDS:
            assert np.array_equal(res[f], getattr(ref.graph, f)), (r, f)
    assert got[0]["exchanged_bytes"] > 0 and got[1]["exchanged_bytes"] > 0
