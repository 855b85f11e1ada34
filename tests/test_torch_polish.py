"""Port parity for post-assembly polishing and its file formats: `io/sam.py`
(SAM, BAM, gzipped-SAM dispatch, `mappings_to_sam`), `io/binary_reads.py`
(files crossing between the packages), `polish/corrector.py`, and the
`corrector` and `convert_bin_to_fasta` CLIs.

The cases are those of `tests/test_corrector_core.py`,
`test_load_graph_sam_corrector.py`, `test_sam_memory.py` and
`test_plasmid_binreads.py`, at a small size: genomes made from seeds with
numpy, contigs with planted mismatches, a 60/40 vote split at one position.
Records, files, corrected contigs, statistics and printed lines must be
exactly equal (tolerance 0: host numpy, the same code).  Both tools are host
code and run without a card.
"""
import gzip
import os

import numpy as np
import pytest
import torch

from spades_tpu.alignment import mapper as j_mapper
from spades_tpu.core import dna as j_dna
from spades_tpu.graph.graph import CondensedGraph as JGraph
from spades_tpu.io import binary_reads as j_br
from spades_tpu.io import sam as j_sam
from spades_tpu.polish import CorrectorConfig as JConfig
from spades_tpu.polish import polish_contigs as j_polish
from spades_tpu.tools import convert_bin_to_fasta as j_convert
from spades_tpu.tools import corrector as j_corrector
from spades_tpu_torch.alignment import mapper as t_mapper
from spades_tpu_torch.graph.graph import CondensedGraph as TGraph
from spades_tpu_torch.io import binary_reads as t_br
from spades_tpu_torch.io import sam as t_sam
from spades_tpu_torch.polish import CorrectorConfig as TConfig
from spades_tpu_torch.polish import polish_contigs as t_polish
from spades_tpu_torch.tools import convert_bin_to_fasta as t_convert
from spades_tpu_torch.tools import corrector as t_corrector
from tests.test_torch_pipeline import one_torch_thread


def _dna(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _plant(seq, n, rng, gap=300):
    codes = j_dna.encode(seq).copy()
    pos = np.arange(gap, len(seq) - gap, gap)[:n]
    for p in pos:
        codes[p] = (codes[p] + 1 + rng.integers(0, 3)) % 4
    return j_dna.decode(codes), pos


def _reads(genome, rng, rl=100, cov=20, rc_share=0.5):
    n = len(genome) * cov // rl
    out = []
    for s in rng.integers(0, len(genome) - rl, n):
        r = genome[s : s + rl]
        out.append(j_dna.revcomp_str(r) if rng.random() < rc_share else r)
    return out


def _same_records(a, b):
    assert [(r.qname, r.flag, r.rname, r.pos, r.mapq, r.cigar, r.seq, r.tags) for r in a] \
        == [(r.qname, r.flag, r.rname, r.pos, r.mapq, r.cigar, r.seq, r.tags) for r in b]


RECS = [("r1", 0, "e1", 5, 60, "10M2I8M", "ACGTACGTACGGTTACGTAC", {"NH": 1}),
        ("r2", 16, "e2", 1, 0, "20M", "A" * 20, {}),
        ("r3", 16, "e1", 1, 30, "2S8M3D2M", "ACGTACGTACGT", {"XS": "x"}),
        ("u1", 4, "*", 0, 0, "*", "ACGTN", {})]
REFS = [("e1", 100), ("e2", 50)]


def test_sam_bam_and_gzipped_sam_match(tmp_path):
    """Each package reads the other's SAM and BAM; the text dispatch of a
    gzipped SAM; the aligned pairs of every CIGAR."""
    paths = {}
    for name, mod in (("j", j_sam), ("t", t_sam)):
        recs = [mod.SamRecord(*r) for r in RECS]
        paths[name] = (str(tmp_path / f"{name}.sam"), str(tmp_path / f"{name}.bam"))
        mod.write_sam(paths[name][0], REFS, recs)
        mod.write_bam(paths[name][1], REFS, recs)
    for i in (0, 1):
        assert open(paths["j"][i], "rb").read() != b""
        with open(paths["j"][i], "rb") as a, open(paths["t"][i], "rb") as b:
            if i == 0:
                assert a.read() == b.read()
            else:
                assert gzip.decompress(a.read()) == gzip.decompress(b.read())
    gz = str(tmp_path / "t.sam.gz")
    with open(paths["t"][0], "rb") as fi, gzip.open(gz, "wb") as fo:
        fo.write(fi.read())
    for path in (*paths["j"], *paths["t"], gz):
        got, want = list(t_sam.read_alignments(path)), list(j_sam.read_alignments(path))
        _same_records(got, want)
        assert [r.aligned_pairs() for r in got] == [r.aligned_pairs() for r in want]
        assert [r.is_reverse for r in got] == [False, True, True, False]
    _same_records(list(t_sam.read_sam(paths["j"][0])), list(j_sam.read_sam(paths["t"][0])))
    with pytest.raises(ValueError, match="BAM"):
        list(t_sam._decode_bam_records(b"NOPE"))


@pytest.mark.parametrize("device", ["host", "device"])
def test_mappings_to_sam_matches(tmp_path, monkeypatch, device):
    if device == "device":
        monkeypatch.setenv("SPADES_DEVICE_MAP_READS", "1")
    rng = np.random.default_rng(8)
    genome = _dna(rng, 2_000)
    reads = [genome[10:70], j_dna.revcomp_str(genome[100:160]), "A" * 30,
             genome[1_960:], j_dna.revcomp_str(genome[:50])] + _reads(genome, rng, 60, 3)
    names = [f"q{i}" for i in range(len(reads))]
    out = {}
    for name, graph, mapper, kw in (("j", JGraph, j_mapper, {}),
                                    ("t", TGraph, t_mapper, {"device": "cpu"})):
        g = graph.from_sequences([genome], 21)
        mappings = mapper.map_read_batch(mapper.build_edge_index(g), g, reads, **kw)
        out[name] = str(tmp_path / f"{name}.sam")
        n = (j_sam if name == "j" else t_sam).mappings_to_sam(out[name], g, names, reads,
                                                              mappings)
        assert n > len(reads) // 2
    assert open(out["j"]).read() == open(out["t"]).read()


def test_binary_reads_cross_between_packages(tmp_path):
    rng = np.random.default_rng(9)
    seqs = ["ACGTACGTAC", "GGG", "A", "ACGTNNNACGT", "", "acgtRYN"] + \
        [_dna(rng, int(n)) for n in rng.integers(1, 200, 50)]
    a, b = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    j_br.write_binary_reads(a, seqs)
    t_br.write_binary_reads(b, seqs)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert t_br.MAGIC == j_br.MAGIC and t_br.VERSION == j_br.VERSION
    assert t_br.read_binary_reads(a) == j_br.read_binary_reads(b) == j_br.read_binary_reads(a)
    jp = j_br.convert_reads(str(tmp_path / "jc"), seqs, chunks=4)
    tp = t_br.convert_reads(str(tmp_path / "tc"), seqs, chunks=4)
    assert [os.path.basename(p) for p in jp] == [os.path.basename(p) for p in tp]
    for x, y in zip(jp, tp):
        assert open(x, "rb").read() == open(y, "rb").read()
    assert t_br.convert_reads(str(tmp_path / "tc"), [], chunks=4) == tp   # done marker
    with open(a, "r+b") as fh:
        fh.write(b"XXXX")
    with pytest.raises(ValueError, match="binary reads"):
        t_br.read_binary_reads(a)


def _polish_both(contigs, reads, **cfg):
    jc, js = j_polish(contigs, reads, JConfig(**cfg))
    tc, ts = t_polish(contigs, reads, TConfig(**cfg))
    assert tc == jc and ts == js
    return tc, ts


def test_polish_planted_mismatches_in_buckets():
    rng = np.random.default_rng(1)
    genome = _dna(rng, 40_000)
    c1, p1 = _plant(genome[:20_000], 30, rng)
    c2, p2 = _plant(genome[20_000:], 30, rng)
    reads = _reads(genome, rng)
    corrected, stats = _polish_both([c1, c2], reads, bucket_nt=25_000, batch_reads=2_048)
    assert stats["fixed_simple"] + stats["fixed_interesting"] >= 0.95 * (len(p1) + len(p2))
    assert corrected == [genome[:20_000], genome[20_000:]]
    assert _polish_both([c1], [])[0] == [c1]


def test_polish_interesting_position_sweeps():
    """A 60/40 split (>= 20 votes) at one position: the weighted sweeps decide
    it, the same way in both packages."""
    rng = np.random.default_rng(4)
    genome = _dna(rng, 10_000)
    var = "ACGT"[("ACGT".index(genome[5000]) + 1) % 4]
    reads = []
    for s in rng.integers(4_800, 4_999, 60):
        s = int(min(s, 5000))
        r = list(genome[s : s + 100])
        if s <= 5000 < s + 100:
            r[5000 - s] = var
        reads.append("".join(r))
    reads += [genome[int(s) : int(s) + 100] for s in rng.integers(4_800, 5_000, 40)]
    reads += _reads(genome, rng, cov=10)
    corrected, stats = _polish_both([genome], reads)
    assert stats["interesting_positions"] >= 1
    assert set(np.flatnonzero(j_dna.encode(corrected[0]) != j_dna.encode(genome))) <= {5000}


@pytest.fixture(scope="module")
def corrector_inputs(tmp_path_factory):
    """Contigs (the edges of a graph of a genome with planted mismatches,
    named by edge id), the genome's reads, and their SAM from
    `mappings_to_sam` onto that graph."""
    d = tmp_path_factory.mktemp("corrector")
    rng = np.random.default_rng(12)
    genome = _dna(rng, 12_000)
    broken, planted = _plant(genome, 20, rng, gap=500)
    reads = _reads(genome, rng, cov=15)
    g = TGraph.from_sequences([broken], 21)
    contigs = str(d / "contigs.fa")
    with open(contigs, "w") as fh:
        for e in g.canonical_edge_ids():
            fh.write(f">{int(e)}\n{g.edge_seq(int(e))}\n")
    reads_fa = str(d / "reads.fa")
    with open(reads_fa, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f">r{i}\n{r}\n")
    mappings = t_mapper.map_read_batch(t_mapper.build_edge_index(g), g, reads, device="cpu")
    sam = str(d / "reads.sam")
    t_sam.mappings_to_sam(sam, g, [f"r{i}" for i in range(len(reads))], reads, mappings)
    return {"contigs": contigs, "reads": reads_fa, "sam": sam, "planted": planted}


@pytest.mark.parametrize("path", ["reads", "sam"])
def test_corrector_cli_matches(corrector_inputs, tmp_path, capsys, path):
    c = corrector_inputs
    argv = [c["contigs"], c["reads"]] if path == "reads" else [c["contigs"], "--sam", c["sam"]]
    outs = {}
    for name, fn in (("j", j_corrector.main), ("t", t_corrector.main)):
        wd = str(tmp_path / name)
        assert fn(argv + ["-k", "21", "-w", wd]) == 0
        outs[name] = (open(os.path.join(wd, "corrected_contigs.fasta")).read(),
                      capsys.readouterr().out.replace(wd, "<out>"))
    assert outs["t"] == outs["j"]
    fixed = int(outs["t"][1].split()[1])
    assert fixed >= len(c["planted"]) - 2


def test_corrector_needs_reads_or_sam(corrector_inputs, tmp_path):
    with pytest.raises(SystemExit):
        t_corrector.main([corrector_inputs["contigs"], "-w", str(tmp_path / "o")])


def test_convert_bin_to_fasta_cli_matches(tmp_path, capsys):
    rng = np.random.default_rng(13)
    seqs = [_dna(rng, int(n)) for n in rng.integers(20, 150, 300)] + ["ACGNNT"]
    bdir = str(tmp_path / "bin")
    j_br.convert_reads(bdir, seqs, chunks=3)
    outs = {}
    for name, fn, src in (("j", j_convert.main, bdir), ("t", t_convert.main, bdir),
                          ("t_file", t_convert.main, os.path.join(bdir, "reads_0.bin")),
                          ("j_file", j_convert.main, os.path.join(bdir, "reads_0.bin"))):
        wd = str(tmp_path / name)
        assert fn([src, "-w", wd]) == 0
        outs[name] = (open(os.path.join(wd, "reads.fasta")).read(),
                      capsys.readouterr().out.replace(wd, "<out>"))
    assert outs["t"] == outs["j"] and outs["t_file"] == outs["j_file"]
    assert outs["t"][1] == f"{len(seqs)} reads -> <out>/reads.fasta\n"
    os.makedirs(tmp_path / "empty")
    assert t_convert.main([str(tmp_path / "empty"), "-w", str(tmp_path / "e")]) == 1


def test_polish_tools_run_without_a_card(corrector_inputs, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = corrector_inputs
    assert t_corrector.main([c["contigs"], c["reads"], "-w", str(tmp_path / "a")]) == 0
    assert t_corrector.main([c["contigs"], "--sam", c["sam"], "-w", str(tmp_path / "b")]) == 0
    bdir = str(tmp_path / "bin")
    t_br.convert_reads(bdir, ["ACGT", "GGCA"], chunks=1)
    assert t_convert.main([bdir, "-w", str(tmp_path / "c")]) == 0
    capsys.readouterr()
