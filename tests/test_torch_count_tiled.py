"""Port parity: `ops/count.py:count_batch_device` and
`count_batch_device_tiled` against the JAX package's (its jnp path,
`use_pallas=False`: the Pallas path needs a TPU).

The same reads, made from a seed with numpy (N bases, lengths below the
batch's), go through both packages: the JAX functions take the unpacked
codes, the port's the packed wire format of `ReadBatch.packed()` on CPU
tensors.  Sorted words, run starts and valid counts must be equal
(tolerance 0), and the tiles' runs merged must equal the untiled run and
`count_reads` of the same reads.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spades_tpu.ops import count as JC
from spades_tpu_torch.core import reads as TR
from spades_tpu_torch.ops import count as TC
from spades_tpu_torch.ops import cuda_kernels as CK
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401


def _batch(seed, R=96, L=150, k=21, n_rate=0.01):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 3_000).astype(np.uint8)
    codes = np.stack([genome[a : a + L] for a in rng.integers(0, 3_000 - L, R)])
    lengths = rng.integers(k - 3, L + 1, R).astype(np.int32)
    n_mask = rng.random((R, L)) < n_rate
    return codes, lengths, n_mask


def _packed(codes, lengths, n_mask):
    b = TR.ReadBatch(codes=codes, lengths=lengths, n_mask=n_mask, n_seqs=len(codes))
    pc, pn, ln, L = b.packed()
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (pc, pn, ln)] + [L]


def _runs(words, starts, n_valid):
    """(unique words, counts) of one sorted run, as `_compact_run` takes them."""
    return JC._compact_run(np.asarray(words).astype(np.uint32), np.asarray(starts),
                           int(n_valid))


@pytest.mark.parametrize("k", [13, 21, 33, 55, 77])
def test_count_batch_device_matches_jax(k):
    codes, lengths, n_mask = _batch(k, k=k)
    ref = JC.count_batch_device(jnp.asarray(codes), jnp.asarray(lengths),
                                jnp.asarray(n_mask), k)
    pc, pn, ln, L = _packed(codes, lengths, n_mask)
    got = TC.count_batch_device(pc, pn, ln, L, k)
    assert got[0].dtype == torch.int64
    assert np.array_equal(got[0].numpy(), np.asarray(ref[0]).astype(np.int64))
    assert np.array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert int(got[2]) == int(ref[2]) > 0


@pytest.mark.parametrize("k,tile", [(21, 512), (33, 128), (55, 512), (55, 64), (127, 256)])
def test_count_batch_device_tiled_matches_jax(k, tile):
    codes, lengths, n_mask = _batch(100 + k, R=40, L=160, k=k)
    ref = JC.count_batch_device_tiled(jnp.asarray(codes), jnp.asarray(lengths),
                                      jnp.asarray(n_mask), k, tile=tile)
    pc, pn, ln, L = _packed(codes, lengths, n_mask)
    got = TC.count_batch_device_tiled(pc, pn, ln, L, k, tile=tile)
    assert got[0].shape == tuple(np.asarray(ref[0]).shape)
    assert np.array_equal(got[0].numpy(), np.asarray(ref[0]).astype(np.int64))
    assert np.array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert np.array_equal(got[2].numpy(), np.asarray(ref[2]))


@pytest.mark.parametrize("k,tile", [(21, 512), (55, 100)])
def test_tiles_merge_to_the_untiled_count_and_count_reads(monkeypatch, k, tile):
    codes, lengths, n_mask = _batch(200 + k, R=64, L=150, k=k)
    pc, pn, ln, L = _packed(codes, lengths, n_mask)
    words, starts, nv = TC.count_batch_device(pc, pn, ln, L, k)
    uw, uc = _runs(words, starts, nv)
    tw, ts, tn = TC.count_batch_device_tiled(pc, pn, ln, L, k, tile=tile)
    runs = [TC.KmerCounts(k, *_runs(tw[t], ts[t], tn[t])) for t in range(tw.shape[0])
            if int(tn[t])]
    merged = TC.merge_counts(runs)
    assert np.array_equal(merged.words, uw) and np.array_equal(merged.counts, uc)
    monkeypatch.setenv("SPADES_HOST_COUNT_WINDOWS", "1")
    seqs = TR.ReadBatch(codes=codes, lengths=lengths, n_mask=n_mask,
                        n_seqs=len(codes)).sequences()
    kc = TC.count_reads(TR.batch_iter(seqs, batch_size=64), k, device="cpu")
    assert np.array_equal(kc.words, uw) and np.array_equal(kc.counts, uc)


def test_all_invalid_batch_and_launch_count():
    k = 21
    codes, lengths, n_mask = _batch(7, R=16, L=40, k=k)
    n_mask[:] = True
    pc, pn, ln, L = _packed(codes, lengths, n_mask)
    before = CK.canonical_window_keys.launches
    words, starts, nv = TC.count_batch_device(pc, pn, ln, L, k)
    assert int(nv) == 0 and (words == 0xFFFFFFFF).all()
    assert starts[0] and not starts[1:].any()
    tw, ts, tn = TC.count_batch_device_tiled(pc, pn, ln, L, k, tile=32)
    assert not tn.any() and (tw == 0xFFFFFFFF).all()
    # CPU tensors take the plain version: nothing is launched
    assert CK.canonical_window_keys.launches == before
