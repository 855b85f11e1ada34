"""Port parity for the profile-HMM modules `hmm/io.py` and `hmm/align.py`
(PathRacer's plan7 cursor DP over the graph) and the DomainAnalysis stage.

The cases are those of `tests/test_hmm.py` and the domain case of
`tests/test_vis_cds_domains.py`.  The same graphs (built by `spades_tpu` and
handed over with `convert.graph_from_arrays`) and profiles go through both
packages; hits must be equal by score, path, sequence and frame, Viterbi
scores and spans equal, and each package must read the other's HMMER3 file
(tolerance 0: the DP is the same float64 numpy).
"""
import dataclasses
import os

import numpy as np
import pytest

from spades_tpu.core import dna as j_dna
from spades_tpu.hmm import align as j_align
from spades_tpu.hmm import io as j_io
from spades_tpu.pipeline import spades_stages as j_stages
from spades_tpu.pipeline.construction import construct_graph
from spades_tpu.pipeline.stages import AssemblyContext as JContext
from spades_tpu_torch import convert
from spades_tpu_torch.hmm import align as t_align
from spades_tpu_torch.hmm import io as t_io
from spades_tpu_torch.pipeline import spades_stages as t_stages
from spades_tpu_torch.pipeline.stages import AssemblyContext as TContext
from tests.test_hmm import MOTIF, _random_seq
from tests.test_torch_pipeline import one_torch_thread

K = 21
PEP = "MKLVNWAERT" * 3
# MOTIF with a 2-base insertion after position 12 and a 1-base deletion at 20
# (`tests/test_hmm.py::TestPlan7Indels._indel_motif`)
INDEL_MOTIF = MOTIF[:12] + "GT" + MOTIF[12:20] + MOTIF[21:]
CODONS = {"M": "ATG", "K": "AAA", "L": "CTG", "V": "GTT", "N": "AAC", "W": "TGG",
          "A": "GCA", "E": "GAA", "R": "CGT", "T": "ACC"}


def _port_graph(jg):
    return convert.graph_from_arrays(dataclasses.asdict(jg))


def _port_hmm(jh):
    return convert.profile_hmm_from_arrays(dataclasses.asdict(jh))


def _same_hmm(a, b):
    assert (a.name, a.length, a.alphabet, a.K) == (b.name, b.length, b.alphabet, b.K)
    for f in ("match_emit", "insert_emit", "trans", "compo"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), f


def _same_hits(jhits, thits):
    assert [dataclasses.asdict(h) for h in thits] == [dataclasses.asdict(h) for h in jhits]


# -- io ------------------------------------------------------------------------

@pytest.mark.parametrize("consensus, alphabet", [(MOTIF, "dna"), (PEP, "amino")])
def test_hmm_from_consensus_matches(consensus, alphabet):
    _same_hmm(t_io.hmm_from_consensus(consensus, "m", alphabet=alphabet),
              j_io.hmm_from_consensus(consensus, "m", alphabet=alphabet))
    _same_hmm(_port_hmm(j_io.hmm_from_consensus(consensus, "m", 0.7, alphabet)),
              t_io.hmm_from_consensus(consensus, "m", 0.7, alphabet))


@pytest.mark.parametrize("consensus, alphabet", [(MOTIF, "dna"), (PEP, "amino")])
def test_each_package_reads_the_others_file(tmp_path, consensus, alphabet):
    jh = j_io.hmm_from_consensus(consensus, "a1", alphabet=alphabet)
    th = t_io.hmm_from_consensus(consensus, "t1", alphabet=alphabet)
    th.trans[3, 2] = np.inf                       # a '*' entry
    jf, tf = str(tmp_path / "j.hmm"), str(tmp_path / "t.hmm")
    j_io.write_hmm(jf, jh)
    t_io.write_hmm(tf, th)
    with open(jf) as fa, open(tf) as fb:
        ja, tb = fa.read().splitlines(), fb.read().splitlines()
    assert "spades_tpu_torch" in tb[0] and len(ja) == len(tb)
    [a] = t_io.read_hmm(jf)
    [b] = j_io.read_hmm(tf)
    _same_hmm(a, j_io.read_hmm(jf)[0])
    _same_hmm(t_io.read_hmm(tf)[0], b)
    assert a.name == "a1" and b.name == "t1" and np.isinf(b.trans[3, 2])
    assert np.allclose(a.match_emit[1:], jh.match_emit[1:], atol=1e-4)
    # two profiles in one file, each closed by HMMER's `//` (`write_hmm` writes
    # one profile and no terminator, in both packages)
    with open(str(tmp_path / "both.hmm"), "w") as fh:
        fh.write("\n".join(ja + ["//"] + tb + ["//"]) + "\n")
    assert [p.name for p in t_io.read_hmm(str(tmp_path / "both.hmm"))] == ["a1", "t1"]


# -- viterbi_score and translate ---------------------------------------------------

def _motif_variants():
    bg = _random_seq(200, 1)
    mut = list(MOTIF)
    mut[10] = "A" if mut[10] != "A" else "C"
    ind = INDEL_MOTIF
    return [bg[:100] + MOTIF + bg[100:], _random_seq(80, 2) + "".join(mut) + _random_seq(80, 3),
            _random_seq(300, 4), _random_seq(80, 5) + ind + _random_seq(80, 6),
            _random_seq(70, 12) + MOTIF[:10] + MOTIF[13:] + _random_seq(70, 13), ""]


@pytest.mark.parametrize("i", range(6))
def test_viterbi_score_matches_dna(i):
    seq = _motif_variants()[i]
    h = j_io.hmm_from_consensus(MOTIF)
    assert t_align.viterbi_score(_port_hmm(h), seq) == j_align.viterbi_score(h, seq)


def test_viterbi_score_and_translate_match_amino():
    orf = "".join(CODONS[a] for a in PEP)
    h = j_io.hmm_from_consensus(PEP, alphabet="amino")
    for seq in (orf, _random_seq(40, 7) + orf[:45] + "T" + orf[45:], _random_seq(120, 8)):
        assert t_align.viterbi_score(_port_hmm(h), seq) == j_align.viterbi_score(h, seq)
        for frame in range(3):
            assert t_align.translate(seq, frame) == j_align.translate(seq, frame)
    assert t_align.translate("ATGGCCT") == "MA"


# -- the graph cursor DP -----------------------------------------------------------

def _graph_cases():
    ind = INDEL_MOTIF
    a = _random_seq(300, 7) + MOTIF + _random_seq(300, 8)
    b = list(a)
    b[150] = "A" if b[150] != "A" else "C"
    orf = "".join(CODONS[x] for x in PEP)
    return {
        "single_edge": ([_random_seq(300, 5) + MOTIF + _random_seq(300, 6)], MOTIF, "dna", 10),
        "junction": ([a, "".join(b)], MOTIF, "dna", 10),
        "absent": ([_random_seq(400, 9)], MOTIF, "dna", 10),
        "indel_junction": ([_random_seq(120, 9) + ind[:15] + ind[15:] + _random_seq(120, 10),
                            _random_seq(120, 11) + ind[15:] + _random_seq(120, 10)],
                           MOTIF, "dna", 5.0),
        "deletion_run": ([_random_seq(70, 12) + MOTIF[:10] + MOTIF[13:] + _random_seq(70, 13)],
                         MOTIF, "dna", 5.0),
        "amino": ([_random_seq(250, 31) + orf + _random_seq(250, 32)], PEP, "amino", 20),
        "amino_junction": ([_random_seq(200, 33) + orf[:40] + orf[40:] + _random_seq(200, 34),
                            _random_seq(200, 35) + orf[40:] + _random_seq(200, 34)],
                           PEP, "amino", 20),
    }


@pytest.mark.parametrize("case", list(_graph_cases()))
def test_align_hmm_to_graph_matches(case):
    seqs, consensus, alphabet, thr = _graph_cases()[case]
    jg = construct_graph(seqs, K).graph
    tg = _port_graph(jg)
    h = j_io.hmm_from_consensus(consensus, alphabet=alphabet)
    jhits = j_align.align_hmm_to_graph(jg, h, score_threshold=thr)
    thits = t_align.align_hmm_to_graph(tg, _port_hmm(h), score_threshold=thr)
    _same_hits(jhits, thits)
    if case == "absent":
        assert thits == []
    else:
        assert thits and t_align._spell(tg, thits[0].path) == j_align._spell(jg, jhits[0].path)
    if case == "amino":
        t = t_align.translate(thits[0].seq)
        assert PEP in t or PEP in t_align.translate(j_dna.revcomp_str(thits[0].seq))


def test_cursor_space_matches():
    seqs, *_ = _graph_cases()["junction"]
    jg = construct_graph(seqs, K).graph
    jc, tc = j_align._build_cursor_space(jg), t_align._build_cursor_space(_port_graph(jg))
    for f in dataclasses.fields(jc):
        assert np.array_equal(getattr(jc, f.name), getattr(tc, f.name)), f.name
    for a, b in zip(j_align._compose_codon_extras(jc), t_align._compose_codon_extras(tc)):
        assert np.array_equal(a, b)


def test_scale_no_path_cap_matches():
    """The motif on a high-id edge of a >10k-edge tangle
    (`TestCursorDP.test_scale_no_path_cap`), through both packages."""
    from spades_tpu.graph.synthetic import synthetic_tangled_graph

    g = synthetic_tangled_graph(12_000, k=K, seed=3, fill_sequences=True)
    motif = j_dna.encode(MOTIF)
    cand = np.flatnonzero((np.arange(g.num_edges) % 2 == 0) & (g.e_len >= len(motif) + 4))
    e = int(cand[-1])
    L = int(g.e_len[e])
    g.seq_pool[g.e_off[e] + 2 : g.e_off[e] + 2 + len(motif)] = motif
    ec = int(g.e_conj[e])
    fwd = g.seq_pool[g.e_off[e] : g.e_off[e] + L]
    g.seq_pool[g.e_off[ec] : g.e_off[ec] + L] = (3 - fwd[::-1]).astype(np.uint8)
    h = j_io.hmm_from_consensus(MOTIF)
    thits = t_align.align_hmm_to_graph(_port_graph(g), _port_hmm(h), score_threshold=15)
    _same_hits(j_align.align_hmm_to_graph(g, h, score_threshold=15), thits)
    assert any(e in hit.path or ec in hit.path for hit in thits)


# -- the DomainAnalysis stage ----------------------------------------------------------

def test_domain_analysis_stage_matches(tmp_path):
    """Two DNA profiles and one amino profile on one graph: both files equal."""
    orf = "".join(CODONS[x] for x in PEP)
    motif2 = "ACGGATTACCAGGATCCGGATAACCGT"
    genome = (_random_seq(300, 40) + MOTIF + _random_seq(200, 41) + motif2
              + _random_seq(150, 42) + orf + _random_seq(300, 43))
    jg = construct_graph([genome, genome[:500] + "A" + genome[501:]], K).graph
    profiles = [j_io.hmm_from_consensus(MOTIF, "domA"), j_io.hmm_from_consensus(motif2, "domB"),
                j_io.hmm_from_consensus(PEP, "pepC", alphabet="amino")]
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jdir.mkdir()
    tdir.mkdir()
    jctx = JContext(k=K, output_dir=str(jdir))
    tctx = TContext(k=K, output_dir=str(tdir), device="cpu")
    jctx.graph, tctx.graph = jg, _port_graph(jg)
    jctx.hmm_profiles = profiles
    tctx.hmm_profiles = [_port_hmm(h) for h in profiles]
    j_stages.DomainAnalysis().run(jctx)
    t_stages.MODE_STATS.clear()
    t_stages.DomainAnalysis().run(tctx)
    for name in ("domain_hits.tsv", "gene_clusters.txt"):
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name
    lines = (tdir / "domain_hits.tsv").read_text().splitlines()
    assert {ln.split("\t")[0] for ln in lines[1:]} == {"domA", "domB", "pepC"}
    [(_k, sid, st)] = t_stages.MODE_STATS
    assert sid == "domain_analysis" and st["hits"] == len(lines) - 1
    assert [name for name, _m, _s in st["dp_s"]] == ["domA", "domB", "pepC"]
    # no profile, or an empty graph: nothing is written
    empty = TContext(k=K, output_dir=str(tmp_path / "e"), device="cpu")
    empty.graph = tctx.graph
    t_stages.DomainAnalysis().run(empty)
    assert not os.path.exists(tmp_path / "e")
