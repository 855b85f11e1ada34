"""Synthetic tangled-graph generator for simplification benchmarks/tests.

Array-level analog of the reference's random-graph fixture
(SPAdes `src/test/debruijn/random_graph.hpp:28-141`), scaled up: the
reference builds small random graphs object-by-object for unit tests; here the
whole conjugate flat-array graph (backbone junction web + tips + bulge arms +
low-coverage chimeric connections) is emitted vectorized so million-edge
instances build in O(seconds) and exercise every simplification pass.
"""
from __future__ import annotations

import numpy as np

from .graph import CondensedGraph


def _fill_ragged_random(
    seq_pool: np.ndarray,
    f_off: np.ndarray,
    c_off: np.ndarray,
    lens: np.ndarray,
    rng: np.random.Generator,
) -> None:
    """Write random forward sequences at f_off and their reverse complements
    at c_off, per ragged row, with no Python loop."""
    total = int(lens.sum())
    if total == 0:
        return
    ends = np.cumsum(lens)
    starts = ends - lens
    seg = np.repeat(np.arange(len(lens)), lens)
    within = np.arange(total) - starts[seg]
    fwd = rng.integers(0, 4, total).astype(np.uint8)
    seq_pool[f_off[seg] + within] = fwd
    # conjugate row j gets 3 - fwd[len-1-j]
    rev_src = starts[seg] + (lens[seg] - 1 - within)
    seq_pool[c_off[seg] + within] = (3 - fwd[rev_src]).astype(np.uint8)


def synthetic_tangled_graph(
    n_edges: int = 1_000_000,
    k: int = 21,
    seed: int = 0,
    backbone_cov: float = 30.0,
    noise_cov: float = 2.0,
    fill_sequences: bool = True,
) -> CondensedGraph:
    """A conjugate flat-array graph with ~n_edges oriented edges.

    Mix (per conjugate pair): 70% backbone junction web (long, well covered),
    15% tips (dead-end, short, low coverage), 10% bulge arms (parallel to a
    backbone edge, near-equal length, low coverage), 5% low-coverage
    erroneous connections between junctions.

    fill_sequences=False leaves the base pool zeroed (benchmarks that only
    exercise topology/coverage passes skip the ragged fill).  Note sequences
    are per-edge rc-consistent only: incident edges do not share overlap
    k-mers, so seq-level invariants stop holding once chains merge.
    """
    rng = np.random.default_rng(seed)
    n_pairs = max(n_edges // 2, 8)
    n_bb = int(n_pairs * 0.70)
    n_tip = int(n_pairs * 0.15)
    n_bul = int(n_pairs * 0.10)
    n_ec = n_pairs - n_bb - n_tip - n_bul

    # core forward vertices are even ids; v_conj pairs (2j, 2j+1)
    n_core = max(n_bb // 2, 4)

    bb_u = rng.integers(0, n_core, n_bb) * 2
    bb_w = rng.integers(0, n_core, n_bb) * 2
    # avoid loops in the backbone (self-loops are left to dedicated tests)
    loop = bb_u == bb_w
    bb_w[loop] = (bb_w[loop] + 2) % (2 * n_core)
    bb_len = rng.integers(20, 80, n_bb)  # kmer units

    tip_u = rng.integers(0, n_core, n_tip) * 2
    tip_len = rng.integers(1, 60, n_tip)

    bul_of = rng.integers(0, n_bb, n_bul)
    bul_u = bb_u[bul_of]
    bul_w = bb_w[bul_of]
    bul_len = np.maximum(bb_len[bul_of] + rng.integers(-2, 3, n_bul), 1)

    ec_u = rng.integers(0, n_core, n_ec) * 2
    ec_w = rng.integers(0, n_core, n_ec) * 2
    loop = ec_u == ec_w
    ec_w[loop] = (ec_w[loop] + 2) % (2 * n_core)
    ec_len = rng.integers(1, 10, n_ec)

    # fresh dead-end vertex pairs for tips
    tip_w = 2 * n_core + 2 * np.arange(n_tip)
    n_vertices = 2 * n_core + 2 * n_tip

    u = np.concatenate([bb_u, tip_u, bul_u, ec_u]).astype(np.int64)
    w = np.concatenate([bb_w, tip_w, bul_w, ec_w]).astype(np.int64)
    klen = np.concatenate([bb_len, tip_len, bul_len, ec_len]).astype(np.int64)
    avg_cov = np.concatenate(
        [
            backbone_cov * (0.5 + rng.random(n_bb)),
            noise_cov * rng.random(n_tip),
            noise_cov * rng.random(n_bul),
            noise_cov * rng.random(n_ec),
        ]
    )

    v_conj = np.arange(n_vertices, dtype=np.int64) ^ 1

    E = 2 * len(u)
    e_start = np.empty(E, np.int64)
    e_end = np.empty(E, np.int64)
    e_start[0::2] = u
    e_end[0::2] = w
    e_start[1::2] = v_conj[w]
    e_end[1::2] = v_conj[u]
    e_conj = np.arange(E, dtype=np.int64) ^ 1
    e_len = np.empty(E, np.int64)
    e_len[0::2] = klen + k
    e_len[1::2] = klen + k
    e_off = np.concatenate([[0], np.cumsum(e_len)])[:-1].astype(np.int64)
    e_cov = np.empty(E, np.float64)
    e_cov[0::2] = avg_cov * klen
    e_cov[1::2] = avg_cov * klen

    seq_pool = np.zeros(int(e_len.sum()), np.uint8)
    if fill_sequences:
        _fill_ragged_random(seq_pool, e_off[0::2], e_off[1::2], e_len[0::2], rng)

    return CondensedGraph(
        k=k,
        e_start=e_start,
        e_end=e_end,
        e_conj=e_conj,
        e_off=e_off,
        e_len=e_len,
        e_cov=e_cov,
        alive=np.ones(E, bool),
        seq_pool=seq_pool,
        v_conj=v_conj,
    )
