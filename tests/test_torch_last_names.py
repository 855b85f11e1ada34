"""Port parity for the last public names of the JAX package: `core/kmers.py`'s
`first_base`, `last_base` and `kmer_to_int`, `paired/path_extend.py`'s
`extend_path_forward` and `pipeline/main.py`'s `MODES`.

The same seeded inputs go through both packages; results must be equal
(tolerance 0; `kmer_to_int` as Python ints).
"""
import numpy as np
import pytest

from spades_tpu.core import kmers as jk
from spades_tpu.paired import path_extend as j_pe
from spades_tpu.pipeline import main as j_main
from spades_tpu.pipeline.construction import construct_graph
from spades_tpu_torch.core import kmers as tk
from spades_tpu_torch.paired import path_extend as t_pe
from spades_tpu_torch.pipeline import main as t_main
from tests.test_path_extend import repeat_genome
from tests.test_torch_path_extend import (_LongReads, _mapped_index, _x_junction, both_cfgs,
                                          empty_pi, port_graph, port_index, rows)


def _words(k: int, seed: int) -> np.ndarray:
    """Seeded packed k-mers (unused low bits zero) and the all-ones sentinel row."""
    rng = np.random.default_rng(seed)
    words = tk.pack(rng.integers(0, 4, (64, k)).astype(np.uint8))
    return np.concatenate([words, np.full((1, words.shape[1]), tk.SENTINEL32, np.uint32)])


@pytest.mark.parametrize("k", [13, 16, 21, 33, 56, 128])
def test_first_last_base_and_kmer_to_int_match(k):
    words = _words(k, k)
    for fn in ("first_base", "last_base"):
        want = np.asarray(getattr(jk, fn)(words, k))
        got = getattr(tk, fn)(words, k)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    want = [int(v) for v in jk.kmer_to_int(words, k)]
    got = [int(v) for v in tk.kmer_to_int(words, k)]
    assert got == want
    assert got[-1] == (1 << 2 * k) - 1          # the sentinel row is all ones


def _extend_all(extend, g, pi, cfg, long_reads, path_cls):
    """Every canonical edge as a seed, extended forward until the step fails."""
    out = []
    for seed in g.canonical_edge_ids():
        path = path_cls([int(seed)])
        steps = 0
        while steps < 50 and extend(g, pi, path, cfg, long_reads=long_reads):
            steps += 1
        out.append((steps, path))
    return out


@pytest.mark.parametrize("long_reads", [False, True])
def test_extend_path_forward_matches_on_a_paired_graph(long_reads):
    k = 21
    rng = np.random.default_rng(11)
    genome, _ = repeat_genome(rng, k)
    g = construct_graph([genome], k).graph
    pi, st = _mapped_index(g, genome, 50, 200, rng, 2)
    jc, tc = both_cfgs(insert_size=st.median, is_var=max(st.mad, 10.0))
    tg = port_graph(g)
    # votes for the last way out of every edge's end: the tie-breaker decides
    # wherever the pairs leave a branch open
    lr = _LongReads({int(e): {int(g.out_edges_of(int(g.e_end[e]))[-1]): 3}
                     for e in np.flatnonzero(g.alive)
                     if len(g.out_edges_of(int(g.e_end[e]))) > 1}) if long_reads else None
    want = _extend_all(j_pe.extend_path_forward, g, pi, jc, lr, j_pe.Path)
    got = _extend_all(t_pe.extend_path_forward, tg, port_index(pi), tc, lr, t_pe.Path)
    assert [s for s, _ in got] == [s for s, _ in want]
    assert rows([p for _, p in got]) == rows([p for _, p in want])
    assert sum(s for s, _ in want) > 0


@pytest.mark.parametrize("long_reads", [False, True])
def test_extend_path_forward_long_read_tie_break_matches(long_reads):
    """An X junction with no pairs: the PE chooser cannot decide, the long-read
    chooser (when given) breaks the tie."""
    rng = np.random.default_rng(5)
    g, (e_in1, e_in2, e_rep, e_out1, e_out2) = _x_junction(rng)
    tg = port_graph(g)
    jc, tc = both_cfgs(insert_size=250.0, is_var=30.0)
    lr = _LongReads({e_rep: {e_out2: 5, e_out1: 1}}) if long_reads else None
    for start in (e_in1, e_in2):
        jp, tp = j_pe.Path([start, e_rep]), t_pe.Path([start, e_rep])
        want = j_pe.extend_path_forward(g, empty_pi(), jp, jc, long_reads=lr)
        got = t_pe.extend_path_forward(tg, port_index(empty_pi()), tp, tc, long_reads=lr)
        assert got == want == long_reads
        assert rows([tp]) == rows([jp])


def test_modes_match():
    assert t_main.MODES == j_main.MODES
    flags = {a.dest for a in t_main.build_parser()._actions}
    assert set(t_main.MODES) - {"multicell"} <= flags
