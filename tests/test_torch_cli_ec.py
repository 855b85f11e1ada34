"""Port parity for the CLI's default path: read error correction before the
assembly (BayesHammer, IonHammer under `--iontorrent`), careful mode, and
`--test`.

Both CLIs run in this process on the same FASTQ files, the reference with
`--platform cpu`, the port with `--device cpu`: a 10,000-nt
`make_e2e_dataset` genome at 20x, 100-bp pairs, seed 2, with qualities drawn
from the seed (Q20-40, Q2-12 on the planted errors).  The corrected reads
(`corrected/*.cor.fasta`), every output file and `run_spades.yaml` must be
byte-identical, the GFA but for its header line.  `--test` runs on a
synthetic 1,000-nt genome written as SPAdes' `ecoli_1K_{1,2}.fq.gz` into a
temporary source tree: the port finds it through `SPADES_SOURCE_DIR`, the
reference through its `TEST_DATASET_DIR`, patched here.
"""
import gzip
import os
import shutil

import numpy as np
import pytest
import torch

from spades_tpu.pipeline import main as j_main
from spades_tpu_torch.hammer import correct_reads
from spades_tpu_torch.io.fastx import read_fastx
from spades_tpu_torch.pipeline import main as t_main
from spades_tpu_torch.tools import synthetic
from tests.test_torch_cli import FILES
from tests.test_torch_pipeline import assert_same_file

COR = ("corrected/lib1_1.cor.fasta", "corrected/lib1_2.cor.fasta",
       "corrected/lib2_1.cor.fasta", "corrected/lib2_2.cor.fasta",
       "corrected/unpaired.cor.fasta")


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    """A paired library with varying qualities, its second half as a second
    library, and unpaired reads."""
    d = tmp_path_factory.mktemp("fq_ec")
    _g, r1, r2, c1, c2 = synthetic.make_e2e_dataset(10_000, 20, 100, 0.003, seed=2,
                                                    insert_mean=300, insert_sd=20,
                                                    truth=True)
    q1, q2 = synthetic.error_qualities(r1, c1, 5), synthetic.error_qualities(r2, c2, 6)
    half = len(r1) // 2
    paths = {}
    for lib, sl in ((1, slice(None, half)), (2, slice(half, None))):
        for mate, reads, quals in ((1, r1, q1), (2, r2, q2)):
            paths[(lib, mate)] = str(d / f"lib{lib}_{mate}.fq")
            synthetic.write_fastq(paths[(lib, mate)], reads[sl], mate, quals[sl])
    paths["single"] = str(d / "single.fq")
    synthetic.write_fastq(paths["single"], r1[:200], 1, q1[:200])
    return paths


def _run_both(tmp_path, args):
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    rc = (j_main.main(args + ["-o", jdir, "--platform", "cpu"]),
          t_main.main(args + ["-o", tdir, "--device", "cpu"]))
    return jdir, tdir, rc


def _compare(jdir, tdir, names):
    n = 0
    for name in names:
        a, b = os.path.join(jdir, name), os.path.join(tdir, name)
        assert os.path.exists(a) == os.path.exists(b), name
        if os.path.exists(a):
            assert_same_file(a, b)
            n += 1
    return n


@pytest.mark.parametrize("variant", ["default_careful", "iontorrent_stop_after_ec",
                                     "only_error_correction"])
def test_default_path_matches_the_reference(fastq, tmp_path, variant):
    one = ["-1", fastq[(1, 1)], "-2", fastq[(1, 2)]]
    two = ["--pe1-1", fastq[(1, 1)], "--pe1-2", fastq[(1, 2)],
           "--pe2-1", fastq[(2, 1)], "--pe2-2", fastq[(2, 2)], "-s", fastq["single"]]
    args, assembled = {
        "default_careful": (one + ["-s", fastq["single"], "-k", "21", "--careful"], True),
        "iontorrent_stop_after_ec": (one + ["--iontorrent", "--stop-after", "ec"], False),
        "only_error_correction": (two + ["--only-error-correction"], False),
    }[variant]
    jdir, tdir, rc = _run_both(tmp_path, args)
    assert rc == (0, 0)
    assert _compare(jdir, tdir, COR) == (5 if "--pe2-1" in args else 2 + ("-s" in args))
    if assembled:
        subs = ["", "K21"]
        assert _compare(jdir, tdir, [os.path.join(s, f) for s in subs for f in FILES]) >= 7
    else:
        assert not os.path.exists(os.path.join(tdir, "contigs.fasta"))
        assert not os.path.exists(os.path.join(tdir, "run_spades.yaml"))
    with open(os.path.join(tdir, "spades.log")) as fh:
        log = fh.read()
    assert "error correction:" in log and "kernel launches: canonical_windows=0" in log
    with open(os.path.join(tdir, COR[0])) as fh, open(fastq[(1, 1)]) as fq:
        cor, raw = fh.read().split("\n")[1::2], fq.read().split("\n")[1::4]
    changed = sum(a != b for a, b in zip(cor, raw))
    assert changed > 10
    if variant == "default_careful":
        with open(os.path.join(tdir, "run_spades.yaml")) as fh:
            assert "mismatch_correction" in fh.read()
        assert "Mismatch Correction" in log
        # the native FASTQ parser keeps no qualities: the CLI corrects as the
        # count-only path does
        flat = [r.seq for p in (fastq[(1, 1)], fastq[(1, 2)], fastq["single"])
                for r in read_fastx(p)]
        want, _st = correct_reads(flat, device="cpu")
        got = [r.seq for name in COR[:2] + COR[4:]
               for r in read_fastx(os.path.join(tdir, name))]
        assert got == want


def test_only_error_correction_with_only_assembler_fails_as_in_the_reference(fastq, tmp_path):
    args = ["-1", fastq[(1, 1)], "-2", fastq[(1, 2)], "--only-assembler",
            "--only-error-correction"]
    jdir, tdir, rc = _run_both(tmp_path, args)
    assert rc == (64, 64)
    assert not os.path.exists(os.path.join(tdir, "corrected"))


def test_default_path_needs_a_card_unless_asked_for_the_cpu(fastq, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_main.main(["-1", fastq[(1, 1)], "-2", fastq[(1, 2)], "-o", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()


def _write_fq_gz(path, reads, quals):
    with gzip.open(path, "wb") as fh:
        for i, (r, q) in enumerate(zip(reads, quals)):
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, r.tobytes(), q.tobytes()))


@pytest.fixture(scope="module")
def test_tree(tmp_path_factory):
    """A source tree whose `src/projects/spades/test_dataset` holds a
    synthetic 1,000-nt genome's pairs as `ecoli_1K_{1,2}.fq.gz`."""
    root = tmp_path_factory.mktemp("spades_src")
    d = root / "src" / "projects" / "spades" / "test_dataset"
    d.mkdir(parents=True)
    rng = np.random.default_rng(13)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genome = rng.integers(0, 4, 1000).astype(np.uint8)
    starts = rng.integers(0, 1000 - 250 + 1, 600)
    starts[:40] = np.repeat([0, 750], 20)       # both ends well covered
    r1 = genome[starts[:, None] + np.arange(100)]
    r2 = (3 - genome[(starts + 150)[:, None] + np.arange(100)])[:, ::-1]
    reads = []
    for r in (r1, r2):
        r = r.copy()
        em = rng.random(r.shape) < 0.003
        r[em] = (r[em] + 1) & 3
        q = rng.integers(20, 41, r.shape).astype(np.uint8) + 33
        q[em] = 35
        reads.append((acgt[r], q))
    _write_fq_gz(str(d / "ecoli_1K_1.fq.gz"), *reads[0])
    _write_fq_gz(str(d / "ecoli_1K_2.fq.gz"), *reads[1])
    return str(root), str(d)


def test_test_option_on_a_synthetic_dataset(test_tree, tmp_path, monkeypatch):
    root, dataset = test_tree
    monkeypatch.setenv("SPADES_SOURCE_DIR", root)
    monkeypatch.setattr(j_main, "TEST_DATASET_DIR", dataset)
    assert t_main.test_dataset_dir() == dataset
    jdir, tdir, rc = _run_both(tmp_path, ["--test"])
    assert rc == (0, 0)                          # one contig of 1,000 nt: the oracle holds
    assert _compare(jdir, tdir, COR + FILES) >= 8
    with open(os.path.join(tdir, "spades.log")) as fh:
        assert "TEST PASSED CORRECTLY" in fh.read()
    shutil.rmtree(jdir)
