"""A mock metagenomic community: one random genome per entry of `sizes_nt`
at the matching depth of `coverages`, the first two sharing one segment of
`shared_nt`, sampled as shuffled FR pairs with substitutions.

`make_community` and `_fr_pairs` are copied unchanged from
`spades_tpu_torch/tools/synthetic.py` at commit
c325c5f32defa7ab0e815955f6b2f93754153ad3, so that a later change to the
program's generators does not change what is measured.
"""
from __future__ import annotations

import numpy as np


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


def make(params: dict, seed: int) -> dict:
    genomes, r1, r2, _origin = make_community(
        params["sizes_nt"], params["coverages"], params["read_length"], params["error_rate"],
        seed, shared=params["shared_nt"], insert_mean=params["insert_mean"],
        insert_sd=params["insert_sd"])
    return {"r1": r1, "r2": r2, "genomes": genomes}
