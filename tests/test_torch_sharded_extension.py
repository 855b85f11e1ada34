"""Port parity for the sharded extension masks
(`spades_tpu_torch.parallel.sharded_extension`).

gloo CPU ranks of one `RankPool` per world size (1, 2, 4), each taking its
`process_read_slice` share of the reads, against the JAX package's
`extension_masks_sharded` on its 8-device virtual mesh and the host
`build_extension_index`; each rank's owned k-mer runs against the JAX
package's device shard at `make_mesh(world)`.  k = 13 and 21 hold one and two
words, k = 33 three words from 34-mers.
"""
import numpy as np
import pytest

from spades_tpu.core.reads import ReadBatch as JBatch
from spades_tpu.ops.count import count_sequences as j_count
from spades_tpu.ops.extension import build_extension_index as j_build
from spades_tpu.parallel import sharded_count as j_sc
from spades_tpu.parallel import sharded_extension as j_se
from spades_tpu_torch.parallel.dryrun import RankPool, extension_task
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    d = tmp_path_factory.mktemp("store")
    made = {w: RankPool(w, "cpu", "gloo", f"file://{d}/w{w}", timeout_s=300) for w in WORLDS}
    yield made
    for p in made.values():
        p.close()


def _reads(n, length, seed):
    rng = np.random.default_rng(seed)
    return ["".join("ACGT"[i] for i in rng.integers(0, 4, length)) for _ in range(n)]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("k", [13, 21, 33])
def test_masks_match_jax(pools, k, world):
    reads = _reads(31, 80, seed=k)
    ref = j_se.extension_masks_sharded(JBatch.from_sequences(reads), k, j_sc.make_mesh(8))
    host = j_build(j_count(reads, k + 1))
    for f in ("kmers", "in_mask", "out_mask"):
        assert np.array_equal(getattr(ref, f), getattr(host, f))
    for ei, _shard in pools[world].run(extension_task, reads, k, "cpu", group="world"):
        assert ei.k == k
        for f in ("kmers", "in_mask", "out_mask"):
            assert np.array_equal(getattr(ei, f), getattr(ref, f)), f


@pytest.mark.parametrize("world", [2, 4])
def test_rank_runs_equal_jax_shards(pools, world):
    import jax.numpy as jnp

    k = 21
    reads = _reads(24, 70, seed=world)
    b = JBatch.from_sequences(reads)
    pad = (-b.codes.shape[0]) % world
    codes = np.pad(b.codes, ((0, pad), (0, 0)))
    lengths = np.pad(b.lengths, (0, pad))
    n_mask = np.pad(b.n_mask, ((0, pad), (0, 0)))
    cap = codes.shape[0] * codes.shape[1] * 2
    fn = j_se.make_sharded_ext_builder(j_sc.make_mesh(world), k, cap)
    sk, starts, orred, overflow = (np.asarray(a) for a in fn(
        jnp.asarray(codes), jnp.asarray(lengths), jnp.asarray(n_mask)))
    assert int(overflow) == 0
    rows = sk.shape[0] // world
    got = pools[world].run(extension_task, reads, k, "cpu", group="world")
    for r in range(world):
        sw, st, om = (a[r * rows : (r + 1) * rows] for a in (sk, starts, orred))
        nv = int(np.any(sw != np.uint32(0xFFFFFFFF), axis=-1).sum())
        sidx = np.flatnonzero(st[:nv])
        words, masks = got[r][1]
        assert np.array_equal(words, sw[sidx]), f"rank {r}"
        assert np.array_equal(masks, om[: len(sidx)].astype(np.int64)), f"rank {r}"
