"""Frozen copies of the port's synthetic data generators.

Copied unchanged from `spades_tpu_torch/tools/synthetic.py` at commit
03f09d041c4a0200e08c73ef280347ed79565e0d: `_sample_pairs`,
`make_e2e_dataset`, `error_qualities` and `write_fastq`.  The benchmark's
inputs come from these copies, so a later change to the program's
generators does not change what is measured.
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
