"""Synthetic data: a random genome with planted repeats and FR pairs, RF
mate pairs, a mock metagenomic community, a chromosome with circular
plasmids, noisy long reads, barcoded linked reads, and lineage barcodes with
a wastewater-like mixture of lineages.

`make_e2e_dataset` is a copy of the JAX package's benchmark generator
(`bench.py:make_e2e_dataset`) so that the port's smoke run makes the same
dataset without importing it: the same seed gives the same genome and the
same reads.  The other generators are the port's own.
"""
from __future__ import annotations

import numpy as np

from ..core.dna import revcomp_codes


def _sample_pairs(G: int, cov: int, rl: int, err: float, seed: int,
                  insert_mean: int, insert_sd: int, truth: bool = False):
    """Genome, FR pairs, each pair's insert start and size, and (with
    `truth`) the pairs as they were before the substitutions, else None."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, G).astype(np.uint8)
    elems = [rng.integers(0, 4, 500).astype(np.uint8) for _ in range(3)]
    elems.append(rng.integers(0, 4, 2000).astype(np.uint8))
    for el, cnt in zip(elems, (30, 30, 30, 10)):
        for pos in rng.integers(0, G - len(el), cnt):
            genome[pos : pos + len(el)] = el
    n_pairs = G * cov // (2 * rl)
    isize = np.clip(
        rng.normal(insert_mean, insert_sd, n_pairs).astype(np.int64), 2 * rl, None
    )
    starts = rng.integers(0, G - isize.max() - 1, n_pairs)
    r1 = genome[starts[:, None] + np.arange(rl)]
    # FR: read2 is the reverse complement of the insert's right end
    r2f = genome[(starts + isize - rl)[:, None] + np.arange(rl)]
    r2 = np.ascontiguousarray((3 - r2f)[:, ::-1])
    clean = (r1.copy(), r2.copy()) if truth else None
    for r in (r1, r2):
        em = rng.random(r.shape) < err
        r[em] = (r[em] + rng.integers(1, 4, int(em.sum()))) & 3
    return genome, r1, r2, starts, isize, clean


def make_e2e_dataset(G: int, cov: int, rl: int, err: float, seed: int = 42,
                     insert_mean: int = 400, insert_sd: int = 30, truth: bool = False):
    """G-nt random genome with planted dispersed repeats (3 x 500 bp x 30
    copies + 1 x 2 kb x 10 copies), FR paired reads at the given coverage
    with substitution errors.  Returns (genome, r1, r2) as uint8 codes; with
    `truth`, (genome, r1, r2, clean1, clean2), the reads before their
    substitutions (the same draws: the seed gives the same reads either way)."""
    genome, r1, r2, _s, _i, clean = _sample_pairs(G, cov, rl, err, seed, insert_mean,
                                                  insert_sd, truth)
    return (genome, r1, r2, *clean) if truth else (genome, r1, r2)


def make_gapped_dataset(G: int, cov: int, rl: int, err: float, seed: int, n_gaps: int,
                        min_overlap: int = 10, max_overlap: int = 45,
                        insert_mean: int = 400, insert_sd: int = 30, truth: bool = False):
    """The dataset of `make_e2e_dataset` with coverage gaps: at `n_gaps`
    evenly spread positions every pair with a read that reaches across is
    dropped, so the reads left of a position and those right of it share only
    `min_overlap`..`max_overlap` bases.  Below k that breaks the graph into
    two tips which pairs still span: what the gap closer is for.  Returns
    (genome, r1, r2, gaps) with gaps as (position, overlap) rows; with
    `truth`, the kept pairs before their substitutions follow."""
    genome, r1, r2, starts, isize, clean = _sample_pairs(G, cov, rl, err, seed,
                                                         insert_mean, insert_sd, truth)
    rng = np.random.default_rng(seed + 1)
    pos = (np.arange(1, n_gaps + 1) * (G // (n_gaps + 1))).astype(np.int64)
    overlap = rng.integers(min_overlap, max_overlap + 1, n_gaps)

    def crosses(a):
        """Read [a, a+rl) lies neither left nor right of some gap."""
        out = np.zeros(len(a), bool)
        for p, ov in zip(pos, overlap):
            out |= (a + rl > p + ov // 2) & (a < p - (ov - ov // 2))
        return out

    keep = ~crosses(starts) & ~crosses(starts + isize - rl)
    out = (genome, r1[keep], r2[keep], np.stack([pos, overlap], axis=1))
    return out + (clean[0][keep], clean[1][keep]) if truth else out


def error_qualities(reads: np.ndarray, clean: np.ndarray, seed: int) -> np.ndarray:
    """PHRED+33 qualities of (n, rl) reads as ASCII codes, drawn from `seed`:
    uniform in Q20..40 where a base is right, in Q2..12 where it is a planted
    substitution (where `reads` differs from `clean`)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(20, 41, reads.shape, dtype=np.uint8)
    wrong = reads != clean
    q[wrong] = rng.integers(2, 13, int(wrong.sum()), dtype=np.uint8)
    return q + np.uint8(33)


def write_fastq(path: str, reads: np.ndarray, mate: int,
                quals: np.ndarray | None = None, prefix: str = "p",
                comments=None) -> None:
    """Write (n, rl) uint8 codes as FASTQ records `@<prefix><i>/<mate>`, with
    the (n, rl) ASCII qualities `quals`, else quality I throughout, and each
    header followed by a space and `comments[i]` where given (a `BX:Z:` tag)."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    seqs = acgt[reads]
    qual = b"I" * reads.shape[1]
    name = prefix.encode()
    with open(path, "wb") as fh:
        for i in range(seqs.shape[0]):
            q = qual if quals is None else quals[i].tobytes()
            tail = b"" if comments is None else b" " + comments[i].encode()
            fh.write(b"@%s%d/%d%s\n%s\n+\n%s\n" % (name, i, mate, tail, seqs[i].tobytes(),
                                                      q))


def _fr_pairs(rng, genome: np.ndarray, cov: float, rl: int, err: float, insert_mean: int,
              insert_sd: int, circular: bool = False):
    """FR pairs of `genome` (uint8 codes) at coverage `cov`, with
    substitutions at rate `err`; a circular genome's inserts may wrap."""
    G = len(genome)
    n_pairs = int(G * cov) // (2 * rl)
    isize = np.clip(rng.normal(insert_mean, insert_sd, n_pairs).astype(np.int64), 2 * rl,
                    G if circular else None)
    if circular:
        starts = rng.integers(0, G, n_pairs)
    else:
        starts = rng.integers(0, G - isize.max() - 1, n_pairs)
    r1 = genome[(starts[:, None] + np.arange(rl)) % G]
    r2f = genome[((starts + isize - rl)[:, None] + np.arange(rl)) % G]
    r2 = np.ascontiguousarray((3 - r2f)[:, ::-1])
    for r in (r1, r2):
        em = rng.random(r.shape) < err
        r[em] = (r[em] + rng.integers(1, 4, int(em.sum()))) & 3
    return r1, r2


def make_mate_pairs(genome: np.ndarray, cov: float, rl: int, err: float, seed: int,
                    insert_mean: int = 3000, insert_sd: int = 300):
    """A mate-pair library of `genome` (uint8 codes) in SPAdes' default RF
    orientation: FR pairs of the given insert with both mates reverse
    complemented, `cov` times the genome, substitutions at rate `err`.
    Returns (r1, r2) as (n, rl) uint8 codes."""
    r1, r2 = _fr_pairs(np.random.default_rng(seed), genome, cov, rl, err, insert_mean,
                       insert_sd)
    return (np.ascontiguousarray((3 - r1)[:, ::-1]), np.ascontiguousarray((3 - r2)[:, ::-1]))


def make_community(sizes, coverages, rl: int, err: float, seed: int, shared: int = 5000,
                   insert_mean: int = 400, insert_sd: int = 30):
    """A mock metagenomic community: one random genome per entry of `sizes`
    (nt) sampled as FR pairs at the matching entry of `coverages`; the two
    first genomes share one segment of `shared` nt (a strain-shared region
    at two depths).  The pairs of all genomes are shuffled together.
    Returns (genomes, r1, r2, origin) with `origin` the genome of each pair."""
    rng = np.random.default_rng(seed)
    genomes = [rng.integers(0, 4, n).astype(np.uint8) for n in sizes]
    if shared and len(genomes) > 1:
        seg = rng.integers(0, 4, shared).astype(np.uint8)
        for gnm in genomes[:2]:
            at = int(rng.integers(0, len(gnm) - shared))
            gnm[at : at + shared] = seg
    r1s, r2s, origin = [], [], []
    for i, (gnm, cov) in enumerate(zip(genomes, coverages)):
        a, b = _fr_pairs(rng, gnm, cov, rl, err, insert_mean, insert_sd)
        r1s.append(a)
        r2s.append(b)
        origin.append(np.full(len(a), i, np.int64))
    order = rng.permutation(sum(len(a) for a in r1s))
    return (genomes, np.concatenate(r1s)[order], np.concatenate(r2s)[order],
            np.concatenate(origin)[order])


def make_plasmid_dataset(chromosome: int, chrom_cov: float, plasmids, multiples, rl: int,
                         err: float, seed: int, insert_mean: int = 400, insert_sd: int = 30):
    """A linear random chromosome of `chromosome` nt at `chrom_cov`, and one
    circular random plasmid per entry of `plasmids` (nt) at that entry of
    `multiples` times the chromosome's coverage, as shuffled FR pairs.
    Returns (chromosome, plasmids, r1, r2)."""
    rng = np.random.default_rng(seed)
    chrom = rng.integers(0, 4, chromosome).astype(np.uint8)
    plas = [rng.integers(0, 4, n).astype(np.uint8) for n in plasmids]
    parts = [_fr_pairs(rng, chrom, chrom_cov, rl, err, insert_mean, insert_sd)]
    for p, m in zip(plas, multiples):
        parts.append(_fr_pairs(rng, p, chrom_cov * m, rl, err, insert_mean, insert_sd,
                               circular=True))
    r1 = np.concatenate([a for a, _ in parts])
    r2 = np.concatenate([b for _, b in parts])
    order = rng.permutation(len(r1))
    return chrom, plas, r1[order], r2[order]


def sample_long_reads(genome: np.ndarray, coverage: float, mean_len: int, sd_len: int,
                      sub: float, ins: float, dele: float, seed: int) -> list[str]:
    """Noisy long reads of `genome` (uint8 codes) at `coverage`, lengths
    normal(mean_len, sd_len), half of them from the reverse strand.  Each
    base is deleted with probability `dele`, else has a random base inserted
    before it with probability `ins`, else is substituted with probability
    `sub`.  Returns the reads as strings."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    n = max(1, int(G * coverage / mean_len))
    lens = np.clip(rng.normal(mean_len, sd_len, n).astype(np.int64), 500, G)
    out = []
    for L in lens:
        a = int(rng.integers(0, G - L + 1))
        s = genome[a : a + L].copy()
        if rng.random() < 0.5:
            s = (3 - s)[::-1]
        r = rng.random(L)
        s = np.where((r >= dele + ins) & (r < dele + ins + sub),
                     (s + rng.integers(1, 4, L)) & 3, s).astype(np.uint8)
        keep = r >= dele
        insert = (r >= dele) & (r < dele + ins)
        # each kept base is preceded by its inserted base, where there is one
        n_out = keep.astype(np.int64) + insert
        pieces = np.empty(int(n_out.sum()), np.uint8)
        at = np.cumsum(n_out) - 1                  # where each kept base lands
        pieces[at[keep]] = s[keep]
        pieces[at[insert] - 1] = rng.integers(0, 4, int(insert.sum()))
        out.append(acgt[pieces].tobytes().decode())
    return out


def write_fasta(path: str, seqs) -> None:
    """Write string sequences as FASTA records `>r<i>`."""
    with open(path, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f">r{i}\n{s}\n")


def make_transcriptome(n_genes: int, n_pairs: int, seed: int, rl: int = 100,
                       err: float = 0.003, n_isoforms: int | None = None,
                       n_convergent: int | None = None, median_len: int = 1200,
                       len_sigma: float = 0.6, min_len: int = 300, max_len: int = 8000,
                       expr_sigma: float = 1.5, insert_mean: int = 250, insert_sd: int = 25,
                       chunk: int = 200_000) -> dict:
    """A stranded RNA-seq library of a synthetic transcriptome.

    `n_genes` genes of 3-6 random exons, each transcript's length log-normal
    (median `median_len`, sigma `len_sigma`) clipped to [min_len, max_len];
    `n_isoforms` genes (default a fifth) have a second isoform that skips one
    inner exon; `n_convergent` pairs of other genes (default one in sixty)
    overlap at their 3' ends by 100-300 nt on opposite strands (the second
    gene's last bases are the reverse complement of the first's); every
    transcript ends in a poly-A tail of 20-40 nt.  Expression is log-normal
    (sigma `expr_sigma`) per transcript; `n_pairs` fragments are drawn in
    proportion to expression times length, inserts normal(insert_mean,
    insert_sd) cut to the transcript, read as dUTP pairs (read 1 from the
    antisense strand, read 2 from the sense strand: `--ss rf`) with
    substitutions at rate `err`.

    Returns a dict: `transcripts` (uint8 codes, tails included), `gene` (the
    gene of each transcript), `tail` (each transcript's poly-A length),
    `isoform_pairs` (indices of the two isoforms of a gene), `convergent`
    ((first, second, overlap) transcript indices), `fragments` (per
    transcript), `r1`, `r2` ((n_pairs, rl) uint8)."""
    rng = np.random.default_rng(seed)
    n_isoforms = n_genes // 5 if n_isoforms is None else n_isoforms
    n_convergent = n_genes // 60 if n_convergent is None else n_convergent
    lens = np.clip(np.round(median_len * np.exp(rng.normal(0.0, len_sigma, n_genes))),
                   min_len, max_len).astype(np.int64)
    exons = []
    for L in lens:
        # 3-6 exons of at least 50 nt: 50 each, the rest split at random
        n_ex = int(rng.integers(3, 7))
        sizes = 50 + np.floor(rng.dirichlet(np.ones(n_ex)) * (L - 50 * n_ex)).astype(np.int64)
        sizes[-1] += L - sizes.sum()
        exons.append([rng.integers(0, 4, int(n)).astype(np.uint8) for n in sizes])
    genes = rng.permutation(n_genes)
    with_isoform = set(genes[:n_isoforms].tolist())
    conv = genes[n_isoforms : n_isoforms + 2 * n_convergent].reshape(-1, 2)
    bodies = [np.concatenate(ex) for ex in exons]
    overlaps = rng.integers(100, 301, len(conv))
    for (a, b), ov in zip(conv, overlaps):
        bodies[b][-ov:] = revcomp_codes(bodies[a][-ov:])
    transcripts, gene_of, isoform_pairs, first_of = [], [], [], {}
    for g in range(n_genes):
        first_of[g] = len(transcripts)
        transcripts.append(bodies[g])
        gene_of.append(g)
        if g in with_isoform:
            skip = int(rng.integers(1, len(exons[g]) - 1))
            isoform_pairs.append((len(transcripts) - 1, len(transcripts)))
            transcripts.append(np.concatenate([e for i, e in enumerate(exons[g]) if i != skip]))
            gene_of.append(g)
    tails = rng.integers(20, 41, len(transcripts))
    transcripts = [np.concatenate([t, np.zeros(int(n), np.uint8)])
                   for t, n in zip(transcripts, tails)]
    convergent = [(first_of[int(a)], first_of[int(b)], int(ov))
                  for (a, b), ov in zip(conv, overlaps)]
    tlen = np.array([len(t) for t in transcripts], np.int64)
    expr = np.exp(rng.normal(0.0, expr_sigma, len(transcripts)))
    weight = expr * tlen
    pick = rng.choice(len(transcripts), n_pairs, p=weight / weight.sum())
    pool = np.concatenate(transcripts)
    offs = np.concatenate([[0], np.cumsum(tlen)[:-1]])
    r1 = np.empty((n_pairs, rl), np.uint8)
    r2 = np.empty((n_pairs, rl), np.uint8)
    cols = np.arange(rl)
    for c0 in range(0, n_pairs, chunk):
        t = pick[c0 : c0 + chunk]
        n = len(t)
        isize = np.clip(rng.normal(insert_mean, insert_sd, n).astype(np.int64), rl, tlen[t])
        start = offs[t] + (rng.random(n) * (tlen[t] - isize + 1)).astype(np.int64)
        sense = pool[start[:, None] + cols]
        anti = (3 - pool[(start + isize - rl)[:, None] + cols])[:, ::-1]
        for out, src in ((r1, anti), (r2, sense)):
            em = rng.random(src.shape) < err
            src = np.where(em, (src + rng.integers(1, 4, src.shape)) & 3, src)
            out[c0 : c0 + n] = src
    return {"transcripts": transcripts, "gene": np.array(gene_of, np.int64), "tail": tails,
            "isoform_pairs": isoform_pairs, "convergent": convergent,
            "fragments": np.bincount(pick, minlength=len(transcripts)), "r1": r1, "r2": r2}


# the standard genetic code over ACGT codes (codon b0*16 + b1*4 + b2)
_AA_OF_CODON = np.frombuffer(
    b"KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSS*CWCLFLF", np.uint8)


def random_orf(rng, n_aa: int) -> tuple[np.ndarray, str]:
    """An open reading frame of `n_aa` codons (ATG, then random sense codons)
    and a stop codon, as uint8 codes, with its peptide (no stop)."""
    sense = np.flatnonzero(_AA_OF_CODON != ord("*"))
    codons = np.concatenate([[14], rng.choice(sense, n_aa - 1), [48]])   # ATG ... TAA
    codes = np.stack([codons // 16, (codons // 4) % 4, codons % 4], axis=1).reshape(-1)
    return codes.astype(np.uint8), _AA_OF_CODON[codons[:-1]].tobytes().decode()


def _pairs_of(rng, seqs, covs, rl: int, err: float, insert_mean: int, insert_sd: int):
    """FR pairs of each sequence at its coverage, shuffled together."""
    parts = [_fr_pairs(rng, s, c, rl, err, insert_mean, insert_sd) for s, c in zip(seqs, covs)]
    r1 = np.concatenate([a for a, _ in parts])
    r2 = np.concatenate([b for _, b in parts])
    order = rng.permutation(len(r1))
    return r1[order], r2[order]


def make_domain_genome(size: int, domain_aa, coverage: float, seed: int, rl: int = 150,
                       err: float = 0.003, insert_mean: int = 400, insert_sd: int = 30) -> dict:
    """A random genome of `size` nt with one planted gene per entry of
    `domain_aa` (codons each; evenly spaced, every other one on the reverse
    strand), sampled as FR pairs at `coverage`.  Returns a dict: `genome`,
    `orfs` (uint8 codes, sense strand), `peptides`, `r1`, `r2`."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size).astype(np.uint8)
    orfs, peptides = [], []
    for i, n in enumerate(domain_aa):
        orf, pep = random_orf(rng, int(n))
        at = (i + 1) * size // (len(domain_aa) + 1)
        genome[at : at + len(orf)] = orf if i % 2 == 0 else revcomp_codes(orf)
        orfs.append(orf)
        peptides.append(pep)
    r1, r2 = _pairs_of(rng, [genome], [coverage], rl, err, insert_mean, insert_sd)
    return {"genome": genome, "orfs": orfs, "peptides": peptides, "r1": r1, "r2": r2}


def make_corona_dataset(seed: int, genome_nt: int = 30_000, n_orfs: int = 10,
                        fixed_aa=(120, 200, 300),
                        leader: int = 70, coverage: float = 2000, host_nt: int = 200_000,
                        host_cov=(5, 50), rl: int = 150, err: float = 0.003,
                        insert_mean: int = 400, insert_sd: int = 30) -> dict:
    """A coronavirus-like sample: a random positive-strand genome of
    `genome_nt` nt whose first `leader` nt are the leader, with `n_orfs`
    planted ORFs (the first, ORF1-like, a quarter of the genome; then one of
    each length in `fixed_aa` codons; the rest 100 to 420 codons; in order
    along the genome), and one nested 3'-co-terminal
    subgenomic RNA per later ORF: the leader joined to the genome from just
    before that ORF to the 3' end.  Genomic RNA and subgenomic RNAs together
    give `coverage` of the genome; the sgRNAs of later ORFs are more abundant
    (as in infected cells).  Host transcripts of `host_nt` nt in all (500 to
    3,000 nt each) come at coverages drawn from `host_cov`.  Returns a dict:
    `genome`, `orfs` ((start, end) on the genome, stop included),
    `peptides`, `sg_starts`, `host`, `r1`, `r2`."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_nt).astype(np.uint8)
    lens = [genome_nt // 12, *fixed_aa]
    lens += [int(x) for x in rng.integers(100, 421, n_orfs - len(lens))]
    gaps = genome_nt - leader - 3 * (sum(lens) + n_orfs) - 300
    if gaps < 0:
        raise ValueError("the ORFs do not fit into the genome")
    spacing = rng.dirichlet(np.ones(n_orfs)) * gaps
    at, orfs, peptides = leader + 100, [], []
    for n, gap in zip(lens, spacing):
        at += int(gap)
        orf, pep = random_orf(rng, n)
        genome[at : at + len(orf)] = orf
        orfs.append((at, at + len(orf)))
        peptides.append(pep)
        at += len(orf)
    sg_starts = [s - 30 for s, _e in orfs[1:]]
    sgrnas = [np.concatenate([genome[:leader], genome[s:]]) for s in sg_starts]
    abund = np.linspace(1.0, 3.0, len(sgrnas))
    weights = np.concatenate([[1.0], abund])
    nt = np.array([genome_nt] + [len(s) for s in sgrnas], np.float64)
    covs = coverage * genome_nt * weights / (weights * nt).sum()
    host, total = [], 0
    while total < host_nt:
        n = int(min(rng.integers(500, 3001), host_nt - total + 500))
        host.append(rng.integers(0, 4, n).astype(np.uint8))
        total += n
    host_covs = rng.uniform(host_cov[0], host_cov[1], len(host))
    r1, r2 = _pairs_of(rng, [genome] + sgrnas + host, list(covs) + list(host_covs), rl, err,
                       insert_mean, insert_sd)
    return {"genome": genome, "orfs": orfs, "peptides": peptides, "sg_starts": sg_starts,
            "host": host, "r1": r1, "r2": r2}


def make_series(sizes, sample_coverages, rl: int, err: float, seed: int, shared: int = 5000,
                insert_mean: int = 400, insert_sd: int = 30):
    """One community of random genomes (`sizes` nt; the two first share a
    segment of `shared` nt, as in `make_community`) sampled several times:
    one set of shuffled FR pairs per entry of `sample_coverages`, each a
    coverage per genome (a time series of abundances).
    Returns (genomes, [(r1, r2) per sample])."""
    rng = np.random.default_rng(seed)
    genomes = [rng.integers(0, 4, n).astype(np.uint8) for n in sizes]
    if shared and len(genomes) > 1:
        seg = rng.integers(0, 4, shared).astype(np.uint8)
        for gnm in genomes[:2]:
            at = int(rng.integers(0, len(gnm) - shared))
            gnm[at : at + shared] = seg
    samples = [_pairs_of(rng, genomes, covs, rl, err, insert_mean, insert_sd)
               for covs in sample_coverages]
    return genomes, samples


def _substitute(rng, reads: np.ndarray, err: float) -> None:
    """Substitutions at rate `err`, in place (always another base)."""
    hit = rng.random(reads.shape) < err
    reads[hit] = (reads[hit] + rng.integers(1, 4, int(hit.sum()))) & 3


def make_linked_reads(genome: np.ndarray, n_reads: int, seed: int, rl: int = 150,
                      molecule_nt: int = 40_000, molecules_per_barcode: int = 10,
                      reads_per_molecule: int = 50, err: float = 0.003):
    """Linked reads, the shape of 10x Chromium / TELL-Seq libraries: DNA
    molecules of log-normal length (mean `molecule_nt`, sigma 0.5) at random
    positions of `genome` (uint8 codes), `molecules_per_barcode` molecules
    sharing each barcode, `n_reads` reads of `rl` drawn uniformly inside the
    molecules (about `reads_per_molecule` each), half of them reverse
    complemented, with substitutions at `err`.
    Returns (reads (n, rl) uint8, barcode (n,) int64 of each read)."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    n_mol = max(1, n_reads // reads_per_molecule)
    mol_len = rng.lognormal(np.log(molecule_nt) - 0.125, 0.5, n_mol).astype(np.int64)
    mol_len = np.clip(mol_len, 2 * rl, G)
    mol_start = (rng.random(n_mol) * (G - mol_len + 1)).astype(np.int64)
    mol_barcode = rng.permutation(n_mol) // molecules_per_barcode
    mol = rng.integers(0, n_mol, n_reads)
    start = mol_start[mol] + (rng.random(n_reads) * (mol_len[mol] - rl + 1)).astype(np.int64)
    reads = genome[start[:, None] + np.arange(rl)]
    flip = rng.random(n_reads) < 0.5
    reads[flip] = (3 - reads[flip])[:, ::-1]
    _substitute(rng, reads, err)
    return reads, mol_barcode[mol]


def make_lineage_barcodes(genome_nt: int, n_lineages: int, n_columns: int, seed: int):
    """A random reference genome and a lineage tree, the shape of the usher
    barcode files of wastewater tools: lineage 0 is the reference, every
    later lineage a random earlier one plus at least one new mutation, with
    `n_columns` mutations in all, at distinct positions.
    Returns (reference (G,) uint8, columns (S, 3) int64 of (0-based
    position, reference base, alternative base), membership (L, S) bool)."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, genome_nt).astype(np.uint8)
    pos = rng.choice(genome_nt, n_columns, replace=False).astype(np.int64)
    alt = (ref[pos] + rng.integers(1, 4, n_columns)) & 3
    columns = np.stack([pos, ref[pos].astype(np.int64), alt.astype(np.int64)], axis=1)
    new = 1 + rng.multinomial(n_columns - (n_lineages - 1), np.full(n_lineages - 1,
                                                                   1 / (n_lineages - 1)))
    first = np.concatenate([[0], np.cumsum(new)])
    member = np.zeros((n_lineages, n_columns), bool)
    for i in range(1, n_lineages):
        member[i] = member[int(rng.integers(0, i))]
        member[i, first[i - 1] : first[i]] = True
    return ref, columns, member


def write_barcodes_csv(path: str, columns: np.ndarray, member: np.ndarray,
                       names=None) -> None:
    """The usher barcode CSV: a header `,A123T,...` (1-based positions) and
    one row `<lineage>,0,1,...` per lineage."""
    acgt = "ACGT"
    names = names or [f"lin{i}" for i in range(member.shape[0])]
    digits = np.where(member, ord("1"), ord("0")).astype(np.uint8)
    cells = np.full((member.shape[0], 2 * member.shape[1]), ord(","), np.uint8)
    cells[:, 1::2] = digits
    with open(path, "w") as fh:
        fh.write("," + ",".join(f"{acgt[r]}{p + 1}{acgt[a]}" for p, r, a in columns) + "\n")
        for name, row in zip(names, cells):
            fh.write(name + row.tobytes().decode() + "\n")


def lineage_mixture_reads(ref: np.ndarray, columns: np.ndarray, member: np.ndarray,
                          lineages, weights, n_reads: int, seed: int, rl: int = 150,
                          err: float = 0.003) -> np.ndarray:
    """`n_reads` reads of `rl` (uint8 codes) of a mixture of `lineages` at
    `weights`: each read from one lineage's genome (the reference with that
    lineage's mutations), uniform in position, half reverse complemented,
    with substitutions at `err`."""
    rng = np.random.default_rng(seed)
    genomes = np.repeat(ref[None, :], len(lineages), axis=0)
    for j, lin in enumerate(lineages):
        cols = columns[member[lin]]
        genomes[j, cols[:, 0]] = cols[:, 2]
    which = rng.choice(len(lineages), n_reads, p=np.asarray(weights) / np.sum(weights))
    start = rng.integers(0, len(ref) - rl + 1, n_reads)
    reads = genomes[which[:, None], start[:, None] + np.arange(rl)]
    flip = rng.random(n_reads) < 0.5
    reads[flip] = (3 - reads[flip])[:, ::-1]
    _substitute(rng, reads, err)
    return reads
