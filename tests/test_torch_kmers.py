"""Port parity: k-mer codec, canonical windows and the packed wire format.

The same numpy inputs (made from a seed) go through `spades_tpu` and
`spades_tpu_torch`; the results must be exactly equal (integer work,
tolerance 0).  The JAX side includes the Pallas kernel in interpret mode,
as tests/test_pallas_kernels.py runs it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spades_tpu.core import kmers as JK
from spades_tpu.core import reads as JR
from spades_tpu.ops.count import unpack_batch_device as j_unpack
from spades_tpu.ops.pallas_kernels import canonical_windows_planar, planar_to_rows
from spades_tpu_torch.core import kmers as TK
from spades_tpu_torch.core import reads as TR
from spades_tpu_torch.ops import cuda_kernels as CK
from spades_tpu_torch.ops.count import unpack_batch_device as t_unpack

KS = [13, 21, 22, 33, 55, 56]


def _inputs(seed, R, L, k, n_rate=0.03):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (R, L)).astype(np.uint8)
    lengths = rng.integers(k, L + 1, R).astype(np.int32)
    n_mask = rng.random((R, L)) < n_rate
    return codes, lengths, n_mask


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("k", KS)
def test_canonical_windows_matches_jax_and_pallas(k):
    R, L = 24, 120
    codes, lengths, n_mask = _inputs(k, R, L, k)
    jc, jv = JK.canonical_windows(jnp.asarray(codes), jnp.asarray(lengths),
                                  jnp.asarray(n_mask), k)
    tc, tv = TK.canonical_windows(_t(codes), _t(lengths), _t(n_mask), k)
    assert tc.dtype == torch.int64
    assert np.array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    # the Pallas TPU kernel, interpreted on the CPU
    pc, pv = canonical_windows_planar(jnp.asarray(codes), jnp.asarray(lengths),
                                      jnp.asarray(n_mask), k, interpret=True)
    P = L - k + 1
    rows = np.asarray(planar_to_rows(pc))[:, :P]
    assert np.array_equal(tc.numpy(), rows.astype(np.int64))
    assert np.array_equal(tv.numpy(), np.asarray(pv)[:, :P])


@pytest.mark.parametrize("k", KS + [128])
def test_kernel_wrapper_cpu_keys_match_jax_words(k):
    """On a CPU tensor the wrapper takes its plain version: keys that fold
    the JAX package's canonical words, the sentinel key where invalid."""
    R, L = 16, 160
    codes, lengths, n_mask = _inputs(100 + k, R, L, k)
    pc, pn, ln, L2 = JR.ReadBatch(codes=codes, lengths=lengths, n_mask=n_mask).packed()
    before = CK.canonical_window_keys.launches
    keys, valid = CK.canonical_window_keys(_t(pc), _t(pn), _t(ln), L2, k)
    assert CK.canonical_window_keys.launches == before   # no kernel on the CPU
    jc, jv = JK.canonical_windows(jnp.asarray(codes), jnp.asarray(lengths),
                                  jnp.asarray(n_mask), k)
    W = JK.kmer_words(k)
    words = np.asarray(jc).reshape(-1, W)
    v = np.asarray(jv).reshape(-1)
    assert keys.shape == (TK.key_planes(k), R * (L - k + 1))
    assert np.array_equal(valid.numpy().reshape(-1), v)
    got = keys.T.numpy()
    assert np.array_equal(got[v], TK.words_to_keys(words[v]))
    assert np.all(got[~v] == TK.KEY_SENTINEL)
    assert np.array_equal(TK.keys_to_words(got[v], W), words[v])


def test_kernel_wrapper_checks_its_inputs():
    codes, lengths, n_mask = _inputs(0, 8, 64, 21)
    pc, pn, ln, L = TR.ReadBatch(codes=codes, lengths=lengths, n_mask=n_mask).packed()
    pc, pn, ln = _t(pc), _t(pn), _t(ln)
    with pytest.raises(TypeError):
        CK.canonical_window_keys(pc, pn, ln.to(torch.int64), L, 21)
    with pytest.raises(ValueError):
        CK.canonical_window_keys(pc[:, :-1], pn, ln, L, 21)
    with pytest.raises(ValueError):
        CK.canonical_window_keys(pc, pn, ln, L, 129)
    with pytest.raises(ValueError):
        CK.canonical_window_keys(pc, pn, ln, 16, 21)


@pytest.mark.parametrize("L", [64, 97, 150])
def test_packed_wire_and_unpack_match_jax(L):
    codes, lengths, n_mask = _inputs(L, 12, L, 11, n_rate=0.05)
    jb = JR.ReadBatch(codes=codes, lengths=lengths, n_mask=n_mask)
    tb = TR.ReadBatch(codes=codes, lengths=lengths, n_mask=n_mask)
    jpc, jpn, jln, jL = jb.packed()
    tpc, tpn, tln, tL = tb.packed()
    assert jL == tL
    for a, b in ((jpc, tpc), (jpn, tpn), (jln, tln)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    jcodes, jnm = j_unpack(jnp.asarray(jpc), jnp.asarray(jpn), L)
    tcodes, tnm = t_unpack(_t(tpc), _t(tpn), L)
    assert tcodes.dtype == torch.uint8 and tnm.dtype == torch.bool
    assert np.array_equal(tcodes.numpy(), np.asarray(jcodes))
    assert np.array_equal(tnm.numpy(), np.asarray(jnm))
    assert np.array_equal(tcodes.numpy(), codes)
    assert np.array_equal(tnm.numpy(), n_mask)


@pytest.mark.parametrize("k", [5, 16, 21, 33, 56, 128])
def test_host_helpers_match_jax(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (40, k)).astype(np.uint8)
    w = TK.pack(codes)
    assert np.array_equal(w, JK.pack(codes))
    assert np.array_equal(TK.unpack(w, k), JK.unpack(w, k))
    assert np.array_equal(TK.revcomp_words(w, k), np.asarray(JK.revcomp_words(w, k)))
    w2 = TK.pack(rng.integers(0, 4, (40, k)).astype(np.uint8))
    assert np.array_equal(TK.lex_less(w, w2), np.asarray(JK.lex_less(w, w2)))
    for j in (0, k // 2, k - 1):
        assert np.array_equal(TK.base_at(w, j, k), np.asarray(JK.base_at(w, j, k)))
    assert TK.kmer_words(k) == JK.kmer_words(k)
    assert TK.SENTINEL32 == JK.SENTINEL32


@pytest.mark.parametrize("W", [1, 2, 3, 4, 8])
def test_sort_keys_order_like_words(W):
    """Signed order of the folded int64 keys is lexicographic word order."""
    rng = np.random.default_rng(W)
    words = rng.integers(0, 1 << 32, (300, W), dtype=np.uint64).astype(np.uint32)
    words[:20, 0] = 0xFFFFFFFF       # extremes of the top word
    words[20:40, 0] = 0
    keys = TK.words_to_keys(words)
    assert keys.shape == (300, (W + 1) // 2)
    assert np.array_equal(TK.keys_to_words(keys, W), words)
    by_words = np.lexsort(tuple(words[:, w] for w in range(W - 1, -1, -1)))
    by_keys = np.lexsort(tuple(keys[:, j] for j in range(keys.shape[1] - 1, -1, -1)))
    assert np.array_equal(words[by_words], words[by_keys])


def test_window_valid_matches_jax():
    codes, lengths, n_mask = _inputs(7, 20, 90, 21, n_rate=0.05)
    jv = JK.window_valid(jnp.asarray(lengths), jnp.asarray(n_mask), 21)
    tv = TK.window_valid(_t(lengths), _t(n_mask), 21)
    assert np.array_equal(tv.numpy(), np.asarray(jv))


def test_batching_and_read_store_match_jax():
    rng = np.random.default_rng(3)
    seqs = ["".join("ACGTN"[i] for i in rng.integers(0, 5, int(n)))
            for n in rng.integers(30, 400, 150)]
    seqs += ["ACGT" * 1500]          # one long sequence, chopped
    jb = list(JR.batch_iter(JR.chop_sequences(seqs, 22), batch_size=32))
    tb = list(TR.batch_iter(TR.chop_sequences(seqs, 22), batch_size=32))
    assert len(jb) == len(tb)
    for a, b in zip(jb, tb):
        for f in ("codes", "lengths", "n_mask"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert a.n_seqs == b.n_seqs
        assert b.sequences() == a.sequences()
        ra, rb = JR.revcomp_batch(a), TR.revcomp_batch(b)
        assert np.array_equal(ra.codes, rb.codes) and np.array_equal(ra.n_mask, rb.n_mask)
    js = JR.ReadStore.build(seqs, chunk_reads=64, rc=True)
    ts = TR.ReadStore.build(seqs, chunk_reads=64, rc=True)
    assert js.n == ts.n and len(js.chunks) == len(ts.chunks)
    for a, b in zip(js.chunks, ts.chunks):
        assert (a.L, a.n) == (b.L, b.n)
        for f in ("pc", "pn", "lengths"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        ua, ub = a.unpack_host(), b.unpack_host()
        assert np.array_equal(ua.codes, ub.codes) and np.array_equal(ua.n_mask, ub.n_mask)


def test_packed_chunk_device_upload_is_cached():
    ts = TR.ReadStore.build(["ACGTACGTAC" * 5] * 10, chunk_reads=8)
    c = ts.chunks[0]
    first = c.device("cpu")
    assert all(isinstance(t, torch.Tensor) for t in first)
    assert c.device(torch.device("cpu")) is first
    assert np.array_equal(first[0].numpy(), c.pc)


@pytest.mark.parametrize("k", [13, 21, 33, 55])
def test_canonical_windows_strand_matches_jax(k):
    """The strand bit, in the plain torch function and in the kernel wrapper's
    plain path (where it is masked by `valid`)."""
    R, L = 24, 120
    codes, lengths, n_mask = _inputs(200 + k, R, L, k)
    jc, jv, jrc = JK.canonical_windows_strand(jnp.asarray(codes), jnp.asarray(lengths),
                                              jnp.asarray(n_mask), k)
    tc, tv, trc = TK.canonical_windows_strand(_t(codes), _t(lengths), _t(n_mask), k)
    assert trc.dtype == torch.bool
    assert np.array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(trc.numpy(), np.asarray(jrc))
    assert trc.any() and not trc.all()
    pc, pn, ln, L2 = JR.ReadBatch(codes=codes, lengths=lengths, n_mask=n_mask).packed()
    before = CK.canonical_window_keys.launches
    keys, valid, was_rc = CK.canonical_window_keys(_t(pc), _t(pn), _t(ln), L2, k, strand=True)
    assert CK.canonical_window_keys.launches == before   # no kernel on the CPU
    assert np.array_equal(valid.numpy(), np.asarray(jv))
    assert np.array_equal(was_rc.numpy(), np.asarray(jrc) & np.asarray(jv))
    keys2, valid2 = CK.canonical_window_keys(_t(pc), _t(pn), _t(ln), L2, k)
    assert torch.equal(keys, keys2) and torch.equal(valid, valid2)
    v = np.asarray(jv).reshape(-1)
    words = np.asarray(jc).reshape(-1, JK.kmer_words(k))
    assert np.array_equal(keys.T.numpy()[v], TK.words_to_keys(words[v]))


@pytest.mark.parametrize("rc", [False, True])
@pytest.mark.parametrize("k", [5, 16, 21, 33, 55])
def test_pack_windows_matches_jax(k, rc):
    codes, _, _ = _inputs(300 + k, 10, 80, k)
    jw = JK.pack_windows(jnp.asarray(codes), k, rc=rc)
    tw = TK.pack_windows(_t(codes), k, rc=rc)
    assert tw.dtype == torch.int64 and tw.shape == (10, 80 - k + 1, TK.kmer_words(k))
    assert np.array_equal(tw.numpy(), np.asarray(jw).astype(np.int64))
    if not rc:   # the forward pack of window 0 is the host pack of its bases
        assert np.array_equal(tw[:, 0].numpy(), TK.pack(codes[:, :k]).astype(np.int64))
    with pytest.raises(ValueError):
        TK.pack_windows(_t(codes[:, : k - 1]), k)
