"""Synthetic data: a random genome with planted repeats and FR pairs, a mock
metagenomic community, a chromosome with circular plasmids, and noisy long
reads.

`make_e2e_dataset` is a copy of the JAX package's benchmark generator
(`bench.py:make_e2e_dataset`) so that the port's smoke run makes the same
dataset without importing it: the same seed gives the same genome and the
same reads.  The other generators are the port's own.
"""
from __future__ import annotations

import numpy as np


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
                quals: np.ndarray | None = None) -> None:
    """Write (n, rl) uint8 codes as FASTQ records `@p<i>/<mate>`, with the
    (n, rl) ASCII qualities `quals`, else quality I throughout."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    seqs = acgt[reads]
    qual = b"I" * reads.shape[1]
    with open(path, "wb") as fh:
        for i in range(seqs.shape[0]):
            q = qual if quals is None else quals[i].tobytes()
            fh.write(b"@p%d/%d\n%s\n+\n%s\n" % (i, mate, seqs[i].tobytes(), q))


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
