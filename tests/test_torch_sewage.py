"""Port parity for wastewater lineage abundances: `sewage/disentangle.py`
and `tools/sewage.py`.

The inputs are made from seeds with numpy: a random reference genome, a
barcode CSV of lineages on a random tree (each lineage its parent plus a few
mutations, the shape of the usher barcode files) and reads drawn from a
mixture of lineages with substitutions, N bases, reads running off the
genome's ends and reverse-strand reads.  The oracle is
`tests/test_sewage.py`.  The port counts the allele votes on the device
path (CPU tensors here) where the JAX package loops over the reads: the
votes and frequencies must be equal (tolerance 0), with the reference
spelled by the graph and soft-masked (the reference code then flips the
votes).  The NNLS solve runs in float64 in torch: abundances within 1e-9 of the JAX package's, the
selected lineages, their order and `lineages.csv` equal.
"""
import os

import numpy as np
import pytest
import torch

from spades_tpu.alignment.mismatch import position_votes as j_position_votes
from spades_tpu.core import dna as j_dna
from spades_tpu.graph.graph import CondensedGraph as JGraph
from spades_tpu.sewage import disentangle as J
from spades_tpu.tools import sewage as j_tool
from spades_tpu_torch.sewage import disentangle as T
from spades_tpu_torch.tools import sewage as t_tool
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

ABS_TOL = 1e-9


def barcode_world(seed, genome_nt=3_000, lineages=12, muts=4):
    """Reference, lineage sequences and the barcode CSV text of a random
    lineage tree (lineage i is a random earlier one plus `muts` mutations)."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, genome_nt).astype(np.uint8)
    seqs, sites = [ref.copy()], [set()]
    cols = []                       # (pos, ref base, alt base)
    for i in range(1, lineages):
        parent = int(rng.integers(0, i))
        s, own = seqs[parent].copy(), set(sites[parent])
        for p in rng.choice(np.arange(60, genome_nt - 60), muts, replace=False):
            alt = (int(ref[p]) + int(rng.integers(1, 4))) % 4
            s[p] = alt
            cols.append((int(p), int(ref[p]), alt))
            own.add(len(cols) - 1)
        seqs.append(s)
        sites.append(own)
    header = "," + ",".join(f"{'ACGT'[r]}{p + 1}{'ACGT'[a]}" for p, r, a in cols)
    rows = [f"lin{i}," + ",".join("1" if c in sites[i] else "0" for c in range(len(cols)))
            for i in range(lineages)]
    return j_dna.decode(ref), [j_dna.decode(s) for s in seqs], "\n".join([header, *rows]) + "\n"


def mixture_reads(seed, seqs, weights, n, rl=100, err=0.003, n_rate=0.002):
    """Reads of a lineage mixture: substitutions, N, half reverse-complemented,
    a few hanging off either end of the genome (shorter than rl there)."""
    rng = np.random.default_rng(seed)
    which = rng.choice(len(seqs), n, p=np.asarray(weights) / np.sum(weights))
    reads = []
    for w in which:
        s = seqs[w]
        a = int(rng.integers(-rl // 2, len(s) - rl // 2))
        r = list(s[max(a, 0) : a + rl])
        for i in np.flatnonzero(rng.random(len(r)) < err):
            r[i] = "ACGT"[("ACGT".index(r[i]) + int(rng.integers(1, 4))) % 4]
        for i in np.flatnonzero(rng.random(len(r)) < n_rate):
            r[i] = "N"
        r = "".join(r)
        reads.append(j_dna.revcomp_str(r) if rng.random() < 0.5 else r)
    return reads


def _flipped(ref):
    """Does `alt_frequencies` flip the votes (`v[::-1, ::-1]`)?  It does
    when the graph's edge does not spell the reference letter for letter."""
    g = JGraph.from_sequences([ref], k=21)
    return g.edge_seq(int(g.canonical_edge_ids()[0])) != ref


@pytest.fixture(scope="module")
def worlds():
    """A world whose reference the graph spells, and one with a soft-masked
    (lowercase) stretch, which the graph spells in capitals: the reference
    code then takes the orientation flip."""
    out = {}
    for orient, seed in (("forward", 0), ("flipped", 1)):
        ref, seqs, csv = barcode_world(seed)
        if orient == "flipped":
            ref = ref[:1_000] + ref[1_000:1_300].lower() + ref[1_300:]
        assert _flipped(ref) == (orient == "flipped")
        out[orient] = (seed, ref, seqs, csv)
    return out


@pytest.mark.parametrize("orient", ["forward", "flipped"])
def test_votes_and_frequencies_match_position_votes(worlds, orient, tmp_path):
    seed, ref, seqs, csv = worlds[orient]
    reads = mixture_reads(seed, seqs, np.arange(1, len(seqs) + 1), 900)
    reads += ["ACGT" * 5, "", "N" * 100, ref[:15], j_dna.revcomp_str(ref[-40:])]
    g, votes = T.allele_votes(ref, reads, device="cpu")
    jg = JGraph.from_sequences([ref], k=21)
    ref_votes = j_position_votes(jg, reads)
    assert np.array_equal(g.seq_pool, jg.seq_pool)
    assert votes.dtype == ref_votes.dtype and np.array_equal(votes, ref_votes)
    assert votes.sum() > 50_000
    path = str(tmp_path / "bc.csv")
    with open(path, "w") as fh:
        fh.write(csv)
    bc = T.read_barcodes_csv(path)
    jbc = J.read_barcodes_csv(path)
    for f in ("positions", "ref_base", "alt_base", "matrix"):
        assert np.array_equal(getattr(bc, f), getattr(jbc, f))
    assert bc.lineages == jbc.lineages
    freq, cov = T.alt_frequencies(ref, reads, bc, device="cpu")
    jfreq, jcov = J.alt_frequencies(ref, reads, jbc)
    assert np.array_equal(freq, jfreq) and np.array_equal(cov, jcov)
    assert (cov > 0).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nnls_within_tolerance(seed):
    rng = np.random.default_rng(seed)
    L, S = 30 + 10 * seed, 80
    matrix = (rng.random((L, S)) < 0.2).astype(float)
    freq = np.clip(matrix.T @ rng.dirichlet(np.ones(L)) + rng.normal(0, 0.02, S), 0, 1)
    weights = (rng.random(S) < 0.9).astype(float)
    got = T.nnls_abundances(matrix, freq, weights, device="cpu")
    ref = J.nnls_abundances(matrix, freq, weights)
    assert got.dtype == np.float64 and got.shape == ref.shape
    assert np.abs(got - ref).max() <= ABS_TOL
    assert T.nnls_abundances(np.zeros((0, S)), freq, weights, device="cpu").shape == (0,)


@pytest.mark.parametrize("orient", ["forward", "flipped"])
def test_estimates_and_lineages_csv_match(worlds, orient, tmp_path, capsys):
    seed, ref, seqs, csv = worlds[orient]
    weights = np.zeros(len(seqs))
    weights[[2, 5, 9]] = (0.55, 0.3, 0.15)
    reads = mixture_reads(seed + 1, seqs, weights, 4_000)
    d = tmp_path
    (d / "ref.fa").write_text(f">ref\n{ref}\n")
    (d / "bc.csv").write_text(csv)
    (d / "reads.fa").write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    bc = T.read_barcodes_csv(str(d / "bc.csv"))
    got = T.estimate_abundances(ref, reads, bc, device="cpu")
    exp = J.estimate_abundances(ref, reads, J.read_barcodes_csv(str(d / "bc.csv")))
    assert [n for n, _ in got] == [n for n, _ in exp]
    assert max(abs(a - b) for (_, a), (_, b) in zip(got, exp)) <= ABS_TOL
    if orient == "forward":     # the flip scrambles the frequencies of a soft-masked one
        assert got[0][0] == "lin2"
    printed = {}
    for name, main, extra in (("j", j_tool.main, []), ("t", t_tool.main, ["--device", "cpu"])):
        out = str(d / name)
        assert main([str(d / "ref.fa"), str(d / "bc.csv"), str(d / "reads.fa"), "-w", out]
                    + extra) == 0
        printed[name] = capsys.readouterr().out.replace(out, "<out>")
    assert printed["t"] == printed["j"]
    with open(d / "j" / "lineages.csv") as a, open(d / "t" / "lineages.csv") as b:
        assert a.read() == b.read()


def test_no_coverage_and_no_card(worlds, tmp_path):
    _seed, ref, _seqs, csv = worlds["forward"]
    (tmp_path / "bc.csv").write_text(csv)
    bc = T.read_barcodes_csv(str(tmp_path / "bc.csv"))
    assert T.estimate_abundances(ref, [], bc, device="cpu") == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.estimate_abundances(ref, [ref[:100]], bc)


def reference_lineages_csv(seed: int = 42) -> str:
    """The JAX package's lineages.csv for `chip_smoke.py` phase 17's
    wastewater inputs at `seed` (its generators and sizes), on the CPU: the
    text whose SHA-256 the phase holds the card's output to.  About a
    minute; run as `python -m tests.test_torch_sewage [seed]`."""
    import chip_smoke as CS
    from spades_tpu_torch.tools import synthetic

    sw = CS.SEWAGE
    ref, cols, member = synthetic.make_lineage_barcodes(sw["genome_nt"], sw["lineages"],
                                                        sw["columns"], seed + 11)
    lins = sorted(np.random.default_rng(seed + 12).choice(
        np.arange(sw["lineages"] // 2, sw["lineages"]), 5, replace=False).tolist())
    reads = synthetic.lineage_mixture_reads(ref, cols, member, lins, sw["weights"],
                                            sw["reads"], seed + 13)
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "barcodes.csv")
        synthetic.write_barcodes_csv(path, cols, member)
        res = J.estimate_abundances(j_dna.decode(ref), [j_dna.decode(r) for r in reads],
                                    J.read_barcodes_csv(path))
    return "lineage,abundance\n" + "".join(f"{n},{a:.4f}\n" for n, a in res)


if __name__ == "__main__":
    import hashlib
    import sys

    text = reference_lineages_csv(int(sys.argv[1]) if len(sys.argv) > 1 else 42)
    print(text, end="")
    print("sha256", hashlib.sha256(text.encode()).hexdigest())
