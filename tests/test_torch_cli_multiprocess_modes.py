"""Port parity for multi-process runs of the CLI in meta and stranded rna mode.

`python -m spades_tpu_torch.pipeline.main --num-processes 2` runs as two
gloo CPU processes (a `file://` store as the coordinator) on the 30,000-nt
gapped set of `tests/test_torch_cli_multiprocess.py`, with `--meta
--only-assembler -k 21,33` (both repeat-resolution passes) and with `--rna
--ss rf -k 21,33`, the device thresholds lowered so that counting, mapping
and the gap closer's prefilter take their group paths.  Every file of rank
0's output directory must equal the JAX CLI's one-process run (the GFA but
for its header line; checkpoint archives by their arrays and
`checkpoint.json` but for its time stamp), except `params.txt`,
`run_spades.sh` and `spades.log`, which name paths and times; rank 1, given
an output directory of its own, must leave it unwritten.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from spades_tpu.pipeline import main as j_main
from tests.test_torch_cli_multiprocess import dataset  # noqa: F401 -- a fixture
from tests.test_torch_construction import REPO
from tests.test_torch_pipeline import THRESHOLDS, assert_same_file, one_torch_thread  # noqa: F401

# meta without error correction (the JAX package's BayesHammer alone takes
# 30 s of the run here; `test_torch_cli_multiprocess.py` runs it on two ranks)
MODES = {"meta": ["--meta", "--only-assembler", "-k", "21,33"],
         "rna_rf": ["--rna", "--ss", "rf", "-k", "21,33"]}
NOT_COMPARED = {"params.txt", "run_spades.sh", "spades.log"}


def files_under(root):
    return {os.path.relpath(os.path.join(d, n), root)
            for d, _dirs, names in os.walk(root) for n in names}


def assert_same_run(jdir, tdir):
    names = {n for n in files_under(jdir) if os.path.basename(n) not in NOT_COMPARED}
    assert names == {n for n in files_under(tdir) if os.path.basename(n) not in NOT_COMPARED}
    for rel in sorted(names):
        a, b = os.path.join(jdir, rel), os.path.join(tdir, rel)
        if rel.endswith(".npz"):            # zip members carry their write time
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files), rel
            for f in za.files:
                assert za[f].dtype == zb[f].dtype and np.array_equal(za[f], zb[f]), (rel, f)
        elif os.path.basename(rel) == "checkpoint.json":
            with open(a) as fa, open(b) as fb:
                assert json.load(fa)["last_stage"] == json.load(fb)["last_stage"], rel
        else:
            assert_same_file(a, b)
    return names


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cli_modes_on_two_processes_match_the_reference(dataset, tmp_path, mode):  # noqa: F811
    paths, _reads = dataset
    args = ["-1", paths[0], "-2", paths[1], *MODES[mode]]
    jdir = str(tmp_path / "j")
    with pytest.MonkeyPatch.context() as mp:
        for name, value in THRESHOLDS.items():
            mp.setenv(name, value)
        assert j_main.main(args + ["-o", jdir, "--platform", "cpu"]) == 0
    outs = [str(tmp_path / "t"), str(tmp_path / "rank1_out")]
    env = dict(os.environ, OMP_NUM_THREADS="1", **THRESHOLDS,
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "spades_tpu_torch.pipeline.main", *args, "-o", outs[r],
         "--device", "cpu", "--num-processes", "2", "--process-id", str(r),
         "--coordinator", f"file://{tmp_path}/store", "--dist-backend", "gloo"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-3000:]}"
    assert not os.path.exists(outs[1]), "rank 1 wrote its output directory"
    names = assert_same_run(jdir, outs[0])
    want = {"meta": "K33/first_pe_contigs.fasta", "rna_rf": "transcripts.fasta"}[mode]
    assert want in names
    for log in logs:
        assert "collectives:" in log
