"""Port parity for the sharded count (`spades_tpu_torch.parallel.sharded_count`).

The port's ranks are gloo CPU processes of one `RankPool` per world size
(1, 2 and 4, spawned once for the module, a `file://` store each), every rank
counting its `process_read_slice` share of the reads.  The JAX package
counts the whole batch on its 8-device virtual mesh (`tests/conftest.py`)
and, for the per-rank shards, on `make_mesh(world)`.  The bucket hash,
every rank's global table and every rank's owned shard must equal the JAX
package's exactly.
"""
import numpy as np
import pytest
import torch

from spades_tpu.core.reads import ReadBatch as JBatch
from spades_tpu.ops.count import count_sequences as j_count
from spades_tpu.parallel import sharded_count as j_sc
from spades_tpu_torch.parallel import sharded_count as t_sc
from spades_tpu_torch.parallel.dryrun import RankPool, count_task
from tests.conftest import random_dna
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    d = tmp_path_factory.mktemp("store")
    made = {w: RankPool(w, "cpu", "gloo", f"file://{d}/w{w}", timeout_s=300) for w in WORLDS}
    yield made
    for p in made.values():
        p.close()


def _assert_same(got, ref):
    assert np.array_equal(got.words, ref.words) and np.array_equal(got.counts, ref.counts)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 1000])
@pytest.mark.parametrize("k", [15, 21, 33, 55, 127])
def test_kmer_bucket_matches_jax(k, n):
    import jax.numpy as jnp

    rng = np.random.default_rng(k * 7 + n)
    words = j_count([random_dna(rng, 200) for _ in range(6)], k).words
    # the hash's edge words: all zeros, all ones, the mixing constants
    edge = np.array([[0] * words.shape[1], [0xFFFFFFFF] * words.shape[1],
                     [0x85EBCA6B] * words.shape[1]], np.uint32)
    words = np.concatenate([words, edge])
    want = np.asarray(j_sc.kmer_bucket(jnp.asarray(words), n))
    got = t_sc.kmer_bucket(torch.from_numpy(words.astype(np.int64)), n)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)


def _reads(seed, n=64, length=100):
    rng = np.random.default_rng(seed)
    seqs = [random_dna(rng, length) for _ in range(n)]
    seqs[5] = seqs[5][:30] + "N" + seqs[5][31:]
    return seqs


@pytest.mark.parametrize("world", WORLDS)
def test_count_matches_jax_and_count_sequences(pools, world):
    k = 21
    seqs = _reads(world)
    ref = j_sc.count_kmers_sharded(JBatch.from_sequences(seqs), k, j_sc.make_mesh(8))
    _assert_same(ref, j_count(seqs, k))
    for kc, _shard in pools[world].run(count_task, seqs, k, "cpu", group="world"):
        _assert_same(kc, ref)


def _jax_shards(seqs, k, world):
    """Each device's unique rows and counts of the JAX package's sharded
    counter on `make_mesh(world)`."""
    import jax.numpy as jnp

    batch = JBatch.from_sequences(seqs)
    mesh = j_sc.make_mesh(world)
    pc, pn, lengths, L = batch.packed()
    pad = (-pc.shape[0]) % world
    pc, pn = (np.pad(a, ((0, pad), (0, 0))) for a in (pc, pn))
    lengths = np.pad(lengths, (0, pad))
    cap = pc.shape[0] * (L - k + 1)           # room for every window: no overflow
    fn = j_sc.make_sharded_counter(mesh, k, L, cap)
    uw, uc, nu, overflow = fn(jnp.asarray(pc), jnp.asarray(pn), jnp.asarray(lengths))
    assert int(overflow) == 0
    uw, uc, nu = np.asarray(uw), np.asarray(uc), np.asarray(nu)
    rows = uw.shape[0] // world
    return [(uw[d * rows : d * rows + nu[d]], uc[d * rows : d * rows + nu[d]])
            for d in range(world)]


@pytest.mark.parametrize("world", WORLDS)
def test_rank_shards_equal_jax_shards(pools, world):
    k = 33
    seqs = _reads(10 + world, n=40)
    want = _jax_shards(seqs, k, world)
    got = pools[world].run(count_task, seqs, k, "cpu", group="world")
    for r in range(world):
        words, counts = got[r][1]
        assert np.array_equal(words, want[r][0]), f"rank {r}"
        assert np.array_equal(counts, want[r][1].astype(np.int64)), f"rank {r}"
    assert sum(s[1].sum() for _, s in got) == j_count(seqs, k).total


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["uneven", "skewed", "no_reads"])
def test_uneven_skewed_and_empty(pools, world, case):
    """13 reads on 2 or 4 ranks (slices of unequal size); every read the
    same k-mer, so all windows route to one owner (the JAX package retries
    with a doubled cap there; the port needs no retry); no reads at all."""
    rng = np.random.default_rng(7)
    k, seqs = {
        "uneven": (15, [random_dna(rng, 80) for _ in range(13)]),
        "skewed": (21, ["A" * 100] * 64),
        "no_reads": (21, []),
    }[case]
    got = pools[world].run(count_task, seqs, k, "cpu", group="world")
    ref = j_count(seqs, k) if seqs else None
    for kc, _shard in got:
        if ref is None:
            assert kc.num_unique == 0 and kc.words.shape == (0, 2)
        else:
            _assert_same(kc, ref)
    if case == "skewed":
        assert sorted(s[0].shape[0] for _, s in got) == [0] * (world - 1) + [1]
