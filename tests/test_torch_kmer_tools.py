"""Port parity for the k-mer tools: `io/fastx.py:read_batches`,
`io/binary_kmers.py`, `ops/hll.py` (HyperLogLog on the canonical-window
kernel's plain version), `tools/{kmercount,kmer_estimating,read_filter}.py`
and the CLI's `--read-cov-threshold`.

The same inputs, made from seeds with numpy, go through the JAX package and
the port (`--device cpu`, with `SPADES_HOST_COUNT_WINDOWS` lowered so that
both count on their device paths).  Batches, binary records, hashes, HLL
registers and estimates, medians, printed lines and output files must be
exactly equal (tolerance 0: integer work, and the estimator is the same
float64 numpy).  The median inputs hold N, lowercase and IUPAC letters,
reads shorter than k, reads of exactly k and odd and even window counts.
"""
import bz2
import gzip
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spades_tpu.core import dna as j_dna
from spades_tpu.core.reads import ReadBatch as JBatch
from spades_tpu.core.reads import batch_iter as j_batch_iter
from spades_tpu.io import binary_kmers as j_bk
from spades_tpu.io import fastx as j_fastx
from spades_tpu.ops import hll as j_hll
from spades_tpu.ops.count import count_sequences as j_count
from spades_tpu.parallel.sharded_count import _mix32 as j_mix32
from spades_tpu.pipeline import main as j_main
from spades_tpu.tools import kmer_estimating as j_est
from spades_tpu.tools import kmercount as j_kmercount
from spades_tpu.tools import read_filter as j_rf
from spades_tpu_torch.core import kmers as t_kmers
from spades_tpu_torch.core.reads import ReadBatch as TBatch
from spades_tpu_torch.core.reads import batch_iter as t_batch_iter
from spades_tpu_torch.io import binary_kmers as t_bk
from spades_tpu_torch.io import fastx as t_fastx
from spades_tpu_torch.ops import hll as t_hll
from spades_tpu_torch.ops.count import count_sequences as t_count
from spades_tpu_torch.parallel import sharded_count as t_sc
from spades_tpu_torch.pipeline import main as t_main
from spades_tpu_torch.tools import kmer_estimating as t_est
from spades_tpu_torch.tools import kmercount as t_kmercount
from spades_tpu_torch.tools import read_filter as t_rf
from tests.test_torch_pipeline import THRESHOLDS, assert_same_file, one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def lowered():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPADES_HOST_COUNT_WINDOWS", THRESHOLDS["SPADES_HOST_COUNT_WINDOWS"])
        yield mp


def _dna(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _mutate(rng, s, p=0.01):
    b = np.frombuffer(s.encode(), np.uint8).copy()
    hit = rng.random(len(b)) < p
    b[hit] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, int(hit.sum()))]
    return b.tobytes().decode()


def _odd_reads(rng, genome, n=300):
    """Reads of the genome at 1-119 nt with the letters the median must
    handle: N, lowercase, IUPAC (R, Y) and a lowercase n."""
    out = []
    for _ in range(n):
        a = int(rng.integers(0, len(genome) - 130))
        s = list(genome[a : a + int(rng.integers(1, 120))])
        r = rng.random()
        if r < 0.1:
            s[rng.integers(0, len(s))] = "N"
        elif r < 0.15:
            s[rng.integers(0, len(s))] = "RY"[int(rng.integers(0, 2))]
        elif r < 0.25:
            s = [c.lower() if rng.random() < 0.3 else c for c in s]
        elif r < 0.28:
            s[rng.integers(0, len(s))] = "n"
        out.append("".join(s))
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 4,000-nt genome, 300 pairs of 100 bp with 1 % substitutions, 20 pairs
    of a 20 kb contaminant, and odd reads, as FASTA/FASTQ files."""
    d = tmp_path_factory.mktemp("kmer_tools")
    rng = np.random.default_rng(11)
    genome = _dna(rng, 4_000)
    r1, r2 = [], []
    for a in rng.integers(0, len(genome) - 300, 300):
        r1.append(_mutate(rng, genome[a : a + 100]))
        r2.append(_mutate(rng, j_dna.revcomp_str(genome[a + 200 : a + 300])))
    junk = _dna(rng, 20_000)
    for a in rng.integers(0, len(junk) - 300, 20):
        r1.append(junk[a : a + 100])
        r2.append(j_dna.revcomp_str(junk[a + 200 : a + 300]))
    odd = _odd_reads(rng, genome) + [genome[:21], genome[:22], genome[:55], genome[:56],
                                     "N" * 40, "A" * 5, ""]
    paths = {"r1": str(d / "r1.fq"), "r2": str(d / "r2.fq"), "odd": str(d / "odd.fa")}
    for key, reads in (("r1", r1), ("r2", r2)):
        with open(paths[key], "w") as fh:
            for i, s in enumerate(reads):
                fh.write(f"@p{i}/{key[1]}\n{s}\n+\n{'I' * len(s)}\n")
    with open(paths["odd"], "w") as fh:
        for i, s in enumerate(odd):
            fh.write(f">odd{i}\n{s}\n")
    return {"genome": genome, "r1": r1, "r2": r2, "odd": odd, "paths": paths, "dir": d}


def _same_batch(a, b):
    for f in ("codes", "lengths", "n_mask"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.n_seqs == b.n_seqs


@pytest.mark.parametrize("suffix", ["fq", "fa", "fq.gz", "fa.bz2"])
def test_read_batches_match(data, tmp_path, suffix):
    """The native parser's batches (and the record parser's, for .bz2) are
    the JAX package's, batch for batch, at a batch size that splits the file."""
    seqs = data["r1"] + data["odd"]
    path = str(tmp_path / f"reads.{suffix}")
    opener = {"gz": gzip.open, "bz2": bz2.open}.get(suffix.rsplit(".", 1)[-1], open)
    with opener(path, "wt") as fh:
        for i, s in enumerate(seqs):
            fh.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" if suffix.startswith("fq")
                     else f">r{i}\n{s}\n")
    jb = list(j_fastx.read_batches([path], batch_size=96))
    tb = list(t_fastx.read_batches([path], batch_size=96))
    assert len(jb) == len(tb) >= 4
    for a, b in zip(jb, tb):
        _same_batch(a, b)


def test_binary_kmers_reference_format_example():
    """SPAdes' docs/standalone.md example: AGCTCT -> bytes d8 0d 00*6."""
    packed = t_kmers.pack(np.array([[0, 2, 1, 3, 1, 3]], np.uint8))
    raw = t_bk.to_binary_records(packed, 6).astype("<u8").tobytes()
    assert raw == bytes([0xD8, 0x0D]) + bytes(6)


@pytest.mark.parametrize("k", [21, 33, 55, 127])
def test_binary_kmers_match_and_cross(data, tmp_path, k):
    kc = j_count(data["r1"], k)
    assert np.array_equal(t_bk.to_binary_records(kc.words, k),
                          j_bk.to_binary_records(kc.words, k))
    jp, tp = str(tmp_path / "j_kmers"), str(tmp_path / "t_kmers")
    j_bk.write_kmer_file(jp, kc.words, k)
    t_bk.write_kmer_file(tp, kc.words, k)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    assert os.path.getsize(tp) == 8 * t_bk.record_words64(k) * kc.num_unique
    assert np.array_equal(t_bk.read_kmer_file(jp, k), kc.words)
    assert np.array_equal(j_bk.read_kmer_file(tp, k), kc.words)
    with open(tp, "ab") as fh:
        fh.write(b"\0" * 8)
    if t_bk.record_words64(k) > 1:
        with pytest.raises(ValueError, match="multiple"):
            t_bk.read_kmer_file(tp, k)


@pytest.mark.parametrize("k", [3, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127])
def test_binary_records_of_any_words_match(k):
    """The port builds records word by word: equal to the JAX package's
    base-by-base records for words and records with bits set past base k-1."""
    rng = np.random.default_rng(k)
    words = rng.integers(0, 2**32, (300, t_kmers.kmer_words(k)), dtype=np.uint64)
    words = words.astype(np.uint32)
    recs = rng.integers(0, 2**64 - 1, (300, t_bk.record_words64(k)), dtype=np.uint64)
    assert np.array_equal(t_bk.to_binary_records(words, k), j_bk.to_binary_records(words, k))
    assert np.array_equal(t_bk.from_binary_records(recs, k),
                          j_bk.from_binary_records(recs, k))


EDGE_WORDS = [0, 1, 2, 0xFFFF, 0x10000, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1,
              0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9, 0x1000193, 0xDEADBEEF]


def test_mix32_matches_on_edge_values():
    rng = np.random.default_rng(5)
    vals = np.array(EDGE_WORDS + list(rng.integers(2**32 - 4096, 2**32, 2000))
                    + list(rng.integers(0, 2**32, 2000)), np.uint64).astype(np.uint32)
    want = np.asarray(j_mix32(jnp.asarray(vals))).astype(np.int64)
    got = t_sc._mix32(torch.from_numpy(vals.astype(np.int64)))
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    c = np.array(EDGE_WORDS, np.uint64).astype(np.uint32)
    for const in (0x85EBCA6B, 0xC2B2AE35, 0x1000193, 2**32 - 1):
        want = (c.astype(np.uint64) * np.uint64(const)) & np.uint64(0xFFFFFFFF)
        got = t_sc._mul32(torch.from_numpy(c.astype(np.int64)), const).numpy()
        assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("W", [1, 2, 3, 4, 8])
def test_hash2_matches_on_edge_values(W):
    rng = np.random.default_rng(W)
    rows = np.stack([rng.choice(np.array(EDGE_WORDS, np.uint64), 500) for _ in range(W)],
                    axis=1).astype(np.uint32)
    j1, j2 = j_hll._hash2(jnp.asarray(rows))
    t1, t2 = t_hll._hash2([torch.from_numpy(rows[:, w].astype(np.int64)) for w in range(W)])
    assert np.array_equal(t1.numpy(), np.asarray(j1).astype(np.int64))
    assert np.array_equal(t2.numpy(), np.asarray(j2).astype(np.int64))
    keys = t_kmers.words_to_keys(rows)
    back = t_hll.key_words(torch.from_numpy(np.ascontiguousarray(keys.T)), W)
    assert np.array_equal(np.stack([w.numpy() for w in back], 1), rows.astype(np.int64))


@pytest.mark.parametrize("k", [21, 33, 55, 127])
def test_hll_registers_match(data, k):
    """Odd and even W, N, lowercase and IUPAC letters, reads shorter than k."""
    seqs = data["r1"] + data["odd"] + [data["genome"][:200], data["genome"][1000:1130]]
    jb, tb = JBatch.from_sequences(seqs), TBatch.from_sequences(seqs)
    want = np.asarray(j_hll.hll_registers(jnp.asarray(jb.codes), jnp.asarray(jb.lengths),
                                          jnp.asarray(jb.n_mask), k))
    pc, pn, lengths, L = tb.packed()
    got = t_hll.hll_registers(*(torch.from_numpy(a) for a in (pc, pn, lengths)), L, k)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    assert want.max() > 0


def test_estimate_kmer_cardinality_matches(data):
    seqs = data["r1"] + data["r2"] + data["odd"]
    for k in (21, 55):
        want = j_hll.estimate_kmer_cardinality(j_batch_iter(seqs, batch_size=64), k)
        got = t_hll.estimate_kmer_cardinality(t_batch_iter(seqs, batch_size=64), k,
                                              device="cpu")
        assert got == want and got > 0
    assert t_hll.estimate_kmer_cardinality(t_batch_iter([]), 21, device="cpu") == 0.0
    assert j_hll.estimate_kmer_cardinality(j_batch_iter([]), 21) == 0.0
    short = t_batch_iter(["ACGT"] * 10)
    assert t_hll.kmer_registers(short, 21, device="cpu") is None


def _printed(capsys, fn, argv, *paths):
    assert fn(argv) == 0
    out = capsys.readouterr().out
    for p in paths:
        out = out.replace(p, "<dir>")
    return out


@pytest.mark.parametrize("k", [21, 55])
def test_kmercount_cli_matches(data, tmp_path, capsys, k):
    p = data["paths"]
    jw, tw = str(tmp_path / "j"), str(tmp_path / "t")
    common = [p["r1"], p["r2"], p["odd"], "-k", str(k), "--counts"]
    jout = _printed(capsys, j_kmercount.main, common + ["-w", jw], jw)
    tout = _printed(capsys, t_kmercount.main, common + ["-w", tw, "--device", "cpu"], tw)
    assert tout == jout and "unique canonical" in tout
    for name in ("final_kmers", "final_kmers.counts"):
        assert_same_file(os.path.join(jw, name), os.path.join(tw, name))
    assert os.path.getsize(os.path.join(tw, "final_kmers")) > 0


def test_kmer_estimating_cli_matches(data, capsys):
    p = data["paths"]
    argv = [p["r1"], p["r2"], p["odd"], "-k", "33"]
    jout = _printed(capsys, j_est.main, argv)
    tout = _printed(capsys, t_est.main, argv + ["--device", "cpu"])
    assert tout == jout and tout.startswith("Estimated number of unique canonical 33-mers: ")


@pytest.mark.parametrize("k", [21, 33, 55])
def test_read_median_coverage_matches(data, monkeypatch, k):
    monkeypatch.setattr(t_rf, "_BATCH_NT", 3_000)     # several batches on both paths
    seqs = data["r1"] + data["r2"] + data["odd"]
    kc_j = j_count(seqs, k)
    kc_t = t_count(seqs, k, device="cpu")
    want = j_rf.read_median_coverage(data["odd"] + data["r1"], k, kc_j)
    got = t_rf.read_median_coverage(data["odd"] + data["r1"], k, kc_t, device="cpu")
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (want % 1 == 0.5).any() and (want == 0).any() and (want > 2).any()


@pytest.mark.parametrize("k", [21, 33, 55])
def test_read_median_coverage_packs_other_letters_as_the_reference(data, k):
    """A letter other than ACGT, acgt and N is code 4 in the reference's
    loop, and its bit 2 lands in the base before it: a read of exactly k
    that spells the genome's "CA" as "AR" packs to the genome's k-mer, so its
    median is that k-mer's count, unless the R is a word's first base (the
    bit is lost); a lowercase n is such a letter too."""
    g = data["genome"]
    seqs = data["r1"] + data["r2"]
    reads = []
    for a in range(0, len(g) - k, 5):
        w = g[a : a + k]
        p = w.find("CA", 1)
        if p > 0:
            reads.append(w[:p] + "AR" + w[p + 2 :])
            reads.append(w[:p] + "An" + w[p + 2 :])
    assert any((w.find("R") % 16) == 0 for w in reads)
    want = j_rf.read_median_coverage(reads, k, j_count(seqs, k))
    got = t_rf.read_median_coverage(reads, k, t_count(seqs, k, device="cpu"), device="cpu")
    assert np.array_equal(got, want)
    assert (want > 0).mean() > 0.5 and (want == 0).any()


def test_read_median_coverage_of_an_empty_table_and_no_reads():
    """An empty count table gives every read 0 where the reference's loop
    indexes the empty counts and raises (a recorded divergence); reads
    shorter than k and no reads at all agree."""
    reads = ["ACGT" * 10, "RYRY" * 10]
    kc = t_count(reads, 21, device="cpu")
    empty = t_count([], 21, device="cpu")
    with pytest.raises(IndexError):
        j_rf.read_median_coverage(reads, 21, j_count([], 21))
    assert np.array_equal(t_rf.read_median_coverage(reads, 21, empty, device="cpu"),
                          np.zeros(2))
    assert np.array_equal(t_rf.read_median_coverage(["ACGT"], 21, empty, device="cpu"),
                          j_rf.read_median_coverage(["ACGT"], 21, j_count([], 21)))
    assert t_rf.read_median_coverage([], 21, kc, device="cpu").shape == (0,)


def test_read_filter_cli_matches(data, tmp_path, capsys):
    """Pairs (kept when the larger median passes) and single files (kept when
    the median passes), printed lines and FASTAs."""
    p = data["paths"]
    jo, to = str(tmp_path / "j"), str(tmp_path / "t")
    common = ["-1", p["r1"], "-2", p["r2"], "-s", p["odd"], "-s", p["r1"], "-k", "21",
              "-c", "2"]
    jout = _printed(capsys, j_rf.main, common + ["-o", jo])
    tout = _printed(capsys, t_rf.main, common + ["-o", to, "--device", "cpu"])
    assert tout == jout
    names = sorted(os.listdir(jo))
    assert names == sorted(os.listdir(to)) == ["filtered_1.fasta", "filtered_2.fasta",
                                                "filtered_odd.fasta", "filtered_r1.fasta"]
    for name in names:
        assert_same_file(os.path.join(jo, name), os.path.join(to, name))
    kept = open(os.path.join(to, "filtered_1.fasta")).read()
    assert "p0/1" in kept and "p319/1" not in kept


def test_device_tools_need_a_card_unless_asked_for_the_cpu(data, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = data["paths"]
    for fn, argv in ((t_kmercount.main, [p["r1"], "-w", str(tmp_path / "kc")]),
                     (t_est.main, [p["r1"]]),
                     (t_rf.main, ["-1", p["r1"], "-2", p["r2"], "-o", str(tmp_path / "rf")])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(argv)


def test_cli_read_cov_threshold_matches(data, tmp_path):
    """`--read-cov-threshold` filters the reads that go to Construction and
    leaves the paired library whole, as the JAX package does; every output
    file must be equal (the GFA but for its header)."""
    p = data["paths"]
    args = ["-1", p["r1"], "-2", p["r2"], "-s", p["odd"], "--only-assembler", "-k", "33",
            "--read-cov-threshold", "2.5"]
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    assert j_main.main(args + ["-o", jdir, "--platform", "cpu"]) == 0
    assert t_main.main(args + ["-o", tdir, "--device", "cpu"]) == 0
    for name in ("contigs.fasta", "scaffolds.fasta", "contigs.paths", "scaffolds.paths",
                 "assembly_graph.fastg", "assembly_graph_with_scaffolds.gfa",
                 "run_spades.yaml", "K33/contigs.fasta"):
        assert_same_file(os.path.join(jdir, name), os.path.join(tdir, name))
    lines = {}
    for name, d in (("j", jdir), ("t", tdir)):
        with open(os.path.join(d, "spades.log")) as fh:
            lines[name] = [ln.split(": ", 1)[1] for ln in fh.read().splitlines()
                           if "read coverage filter" in ln]
    assert lines["t"] == lines["j"] and len(lines["t"]) == 1
    n_reads = 2 * len(data["r1"]) + len(data["odd"])
    kept = int(lines["t"][0].split(": ", 1)[1].split("/")[0])
    assert 0 < kept < n_reads
