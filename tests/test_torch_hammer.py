"""Port parity for read error correction: `spades_tpu_torch.hammer` against
`spades_tpu.hammer`, exactly (tolerance 0, floats bit for bit).

Inputs come from seeded numpy: a random genome, 100-bp reads from both
strands with 0.5 % substitutions, PHRED qualities that vary (Q20-40 where a
base is right, Q2-12 on a planted error), and a few N.  The port runs with
`device="cpu"`, so its device programs (window maps through the kernel's
plain version, quality sum, expansion, vote) run in torch on the CPU; each
is also held against its plain numpy version.  Mixed qualities matter: with
equal addends a float32 sum is the same in any order, and would hide a sum
taken out of order.
"""
import dataclasses

import numpy as np
import pytest
import torch

from spades_tpu.core import kmers as JK
from spades_tpu.hammer import bayes as JB
from spades_tpu.hammer import clustering as JC
from spades_tpu.hammer import hammer as JH
from spades_tpu.hammer import ionhammer as JI
from spades_tpu.ops.count import count_sequences as j_count
from spades_tpu_torch.core import kmers as TK
from spades_tpu_torch.hammer import bayes as TB
from spades_tpu_torch.hammer import clustering as TC
from spades_tpu_torch.hammer import hammer as TH
from spades_tpu_torch.hammer import ionhammer as TI
from spades_tpu_torch.ops.count import count_sequences as t_count
from tests.test_torch_construction import REPO, _imported_modules
from tests.test_torch_pipeline import one_torch_thread

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _reads(G, cov, seed, rl=100, err=0.005, n_count=5):
    """(reads, quals) from both strands of a random G-nt genome."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, G).astype(np.uint8)
    n = G * cov // rl
    starts = rng.integers(0, G - rl + 1, n)
    clean = genome[starts[:, None] + np.arange(rl)]
    rc = rng.random(n) < 0.5
    clean[rc] = (3 - clean[rc])[:, ::-1]
    reads = clean.copy()
    em = rng.random(reads.shape) < err
    reads[em] = (reads[em] + rng.integers(1, 4, int(em.sum()))) & 3
    q = rng.integers(20, 41, reads.shape)
    q[em] = rng.integers(2, 13, int(em.sum()))
    seqs = [s.tobytes().decode() for s in ACGT[reads]]
    quals = [s.tobytes().decode() for s in (q + 33).astype(np.uint8)]
    for i in rng.integers(0, n, n_count):          # a few N, read as A by hammer
        p = int(rng.integers(0, rl))
        seqs[i] = seqs[i][:p] + "N" + seqs[i][p + 1:]
    return seqs, quals


@pytest.fixture(scope="module")
def data():
    seqs, quals = _reads(24_000, 35, seed=7)
    clean = [s.upper().replace("N", "A") for s in seqs]
    jkc, tkc = j_count(clean, 21), t_count(clean, 21, device="cpu")
    assert np.array_equal(jkc.words, tkc.words) and np.array_equal(jkc.counts, tkc.counts)
    jmaps = JH.build_window_maps(seqs, jkc.words, 21, 2048)
    tmaps = TH.build_window_maps(seqs, tkc.words, 21, 2048, device="cpu")
    return seqs, quals, jkc, tkc, jmaps, tmaps


def _np_maps(maps):
    return [(b, n, *(None if a is None else a.numpy() for a in rest)) for b, n, *rest in maps]


# -- clustering ------------------------------------------------------------------

def test_hamming_distance_matches():
    rng = np.random.default_rng(0)
    for k in (13, 21, 33, 55):
        a = rng.integers(0, 4, (300, k))
        b = a.copy()
        for i in range(300):
            b[i, rng.integers(0, k, i % 4)] = rng.integers(0, 4)
        wa, wb = JK.pack(a), JK.pack(b)
        assert np.array_equal(TK.pack(a), wa)
        got = TC.hamming_distance(wa, wb)
        assert got.dtype == np.int32 and np.array_equal(got, JC.hamming_distance(wa, wb))


@pytest.mark.parametrize("case", ["pairs", "random", "large_block", "counted", "wide_k55",
                                  "large_block_k33"])
def test_cluster_kmers_labels_match(case, data):
    rng = np.random.default_rng(3)
    cap, k = 256, 21
    if case == "pairs":
        base = rng.integers(0, 4, (40, 21))
        mut = base.copy()
        mut[:, 5] = (mut[:, 5] + 1) % 4
        mut2 = mut.copy()
        mut2[:20, 15] = (mut2[:20, 15] + 2) % 4
        codes = np.concatenate([base, mut, mut2])
    elif case == "random":
        codes = rng.integers(0, 4, (500, 21))
    elif case == "large_block":     # 300 k-mers sharing the first half: one oversized block
        codes = rng.integers(0, 4, (300, 21))
        codes[:, :10] = 1
        codes[150:, 12] = codes[:150, 12]
        cap = 64
    elif case == "wide_k55":        # three words a row: the word-by-word distance
        k = 55
        base = rng.integers(0, 4, (200, k))
        mut = base.copy()
        mut[np.arange(200), rng.integers(0, k, 200)] += 1
        codes = np.concatenate([base, mut % 4])
    elif case == "large_block_k33":
        k, cap = 33, 32
        base = rng.integers(0, 4, (200, k))
        base[:, :17] = 2                # one part shared by all: a block over the cap
        mut = base.copy()
        mut[np.arange(200), rng.integers(17, k, 200)] += 1
        codes = np.concatenate([base, mut % 4])
    if case == "counted":
        words = data[2].words
    else:
        words = np.unique(JK.pack(codes), axis=0)
    got = TC.cluster_kmers(words, k, 1, cap=cap)
    ref = JC.cluster_kmers(words, k, 1, cap=cap)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert len(np.unique(got)) < len(words) or case == "random"


@pytest.mark.parametrize("native", [True, False])
def test_dsu_union_pairs_is_the_union_loop(monkeypatch, native):
    if not native:      # the Python lists where the native library does not load
        monkeypatch.setattr(TC, "dsu_union_pairs_native", lambda *a: False)
    rng = np.random.default_rng(4)
    a, b = rng.integers(0, 500, 3000), rng.integers(0, 500, 3000)
    loop, batched = JC.DSU(500), TC.DSU(500)
    for i, j in zip(a, b):
        loop.union(int(i), int(j))
    batched.union_pairs(a, b)
    assert np.array_equal(batched.parent, loop.parent) and np.array_equal(batched.size, loop.size)
    assert np.array_equal(batched.labels(), loop.labels())


def test_batched_lmeans_and_subcluster_match(data):
    rng = np.random.default_rng(5)
    for C, M in ((7, 2), (5, 9), (3, 40)):
        codes = rng.integers(0, 4, (C, M, 21)).astype(np.uint8)
        codes[:, 1:] = codes[:, :1]
        flip = rng.random((C, M, 21)) < 0.08
        codes[flip] = (codes[flip] + 1) % 4
        counts = rng.integers(1, 30, (C, M)).astype(np.float64)
        errp = rng.random((C, M, 21)) ** 4
        got = TB.batched_lmeans(codes, counts, errp)
        assert np.array_equal(got, JB.batched_lmeans(codes, counts, errp))
        assert np.array_equal(TB.bayes_subcluster(codes[0], counts[0], errp[0]),
                              JB.bayes_subcluster(codes[0], counts[0], errp[0]))
    _s, quals, jkc, tkc, jmaps, tmaps = data
    labels = JC.cluster_kmers(jkc.words, 21)
    jkq = JB.accumulate_quality(jkc, None, quals, 21, maps=jmaps)
    tkq = TB.accumulate_quality(tkc, None, quals, 21, maps=tmaps)
    got = TB.subcluster_all(tkc.words, tkc.counts, labels, tkq, 21)
    ref = JB.subcluster_all(jkc.words, jkc.counts, labels, jkq, 21)
    assert np.array_equal(got, ref) and len(np.unique(got)) > len(np.unique(labels))
    assert np.array_equal(tkq.total_err_prob(), jkq.total_err_prob())
    assert np.array_equal(TB.solid_posterior(tkc.counts, tkq.total_err_prob(), 5.0),
                          JB.solid_posterior(jkc.counts, jkq.total_err_prob(), 5.0))


# -- the device programs -----------------------------------------------------------

def test_window_maps_match(data):
    seqs, _q, jkc, tkc, jmaps, tmaps = data
    assert any("N" in s for s in seqs)
    plain = TH.build_window_maps_plain(seqs, tkc.words, 21, 2048)
    assert len(tmaps) == len(jmaps) == len(plain) > 1
    for (jb, jn, ji, jp, jr), (tb, tn, ti, tp, tr), (_b, _n, pi, pp, pr) in zip(
            jmaps, tmaps, plain):
        assert tn == jn and np.array_equal(tb.codes, jb.codes)
        ti, tp, tr = ti.numpy(), tp.numpy(), tr.numpy()
        assert ti.dtype == np.int32 and np.array_equal(tp, jp) and np.array_equal(pp, jp)
        assert np.array_equal(ti[tp], ji[jp]) and np.array_equal(pi, ji)
        assert np.array_equal(tr[tp], jr[jp]) and np.array_equal(pr, jr)
        assert (ti[~tp] == -1).all()          # the JAX package also looks past the end


def test_window_maps_without_n_and_with_short_batches():
    seqs, _q = _reads(3_000, 10, seed=11, n_count=0)
    seqs += ["ACGT" * 3, "GATTACA"]                  # shorter than k: batches of L < k
    clean = list(seqs)
    kc = t_count(clean, 21, device="cpu")
    got = TH.build_window_maps(seqs, kc.words, 21, 64, device="cpu")
    ref = JH.build_window_maps(seqs, kc.words, 21, 64)
    assert [m[2] is None for m in got] == [m[2] is None for m in ref]
    assert any(m[2] is None for m in got)
    for (_b, _n, ti, tp, tr), (_jb, _jn, ji, jp, jr) in zip(got, ref):
        if ti is not None:
            tp = tp.numpy()
            assert np.array_equal(tp, jp) and np.array_equal(ti.numpy()[tp], ji[jp])
            assert np.array_equal(tr.numpy()[tp], jr[jp])


def test_quality_sum_is_bit_equal(data):
    _s, quals, jkc, tkc, jmaps, tmaps = data
    ref = JB.accumulate_quality(jkc, None, quals, 21, maps=jmaps).pos_log_err
    got = TB.accumulate_quality(tkc, None, quals, 21, maps=tmaps).pos_log_err
    plain = TB.accumulate_quality_plain(tkc, quals, 21, _np_maps(tmaps)).pos_log_err
    assert got.dtype == np.float32 and got.view(np.uint32).tobytes() == ref.view(np.uint32).tobytes()
    assert plain.view(np.uint32).tobytes() == ref.view(np.uint32).tobytes()
    # the addends of a k-mer differ, and summing them in another order moves bits
    rows, vals, pos = [], [], 0
    for b, n, idx, present, use_rc in _np_maps(tmaps):
        R, L = b.codes.shape
        err = np.pad(TB.quals_to_array(quals[pos : pos + n], L), ((0, R - n), (0, 0)),
                     constant_values=1.0)
        w = np.lib.stride_tricks.sliding_window_view(err, 21, axis=1)[:, : idx.shape[1]]
        w = np.where(use_rc[..., None], w[:, :, ::-1], w)
        rows.append(idx[present])
        vals.append(np.log10(np.clip(w, 1e-30, 1.0)).astype(np.float32)[present])
        pos += n
    rows, vals = np.concatenate(rows), np.concatenate(vals)
    forward, backward = np.zeros_like(ref), np.zeros_like(ref)
    np.add.at(forward, rows, vals)
    np.add.at(backward, rows[::-1], vals[::-1])
    assert np.array_equal(forward, ref) and not np.array_equal(backward, ref)


def test_quality_table_gives_numpys_addends():
    q = np.arange(256, dtype=np.uint8)
    ref = np.log10(np.clip(JB.phred_to_err(np.tile(q, (3, 1))), 1e-30, 1.0)).astype(np.float32)
    table = TB._log_err_table()
    assert table.dtype == np.float32 and table[256] == 0.0
    assert np.array_equal(table[:256], ref[0]) and np.array_equal(ref[1], ref[0])
    quals = ["II#5", "", "A" * 6, "I" * 9]
    codes = TB.quals_to_codes(quals, 6, 8)
    assert np.array_equal(table[codes.astype(np.int64)],
                          np.log10(np.pad(JB.quals_to_array(quals, 8), ((0, 2), (0, 0)),
                                          constant_values=1.0)).astype(np.float32))


def test_add_in_order_is_sequential():
    rng = np.random.default_rng(8)
    rows = rng.integers(0, 50, 5000)
    vals = (rng.random((5000, 3)) * 10 ** rng.uniform(-6, 2, (5000, 1))).astype(np.float32)
    ref = np.zeros((50, 3), np.float32)
    np.add.at(ref, rows, vals)
    acc = torch.zeros((50, 3), dtype=torch.float32)
    TB._add_in_order(acc, torch.from_numpy(rows), torch.from_numpy(vals))
    assert np.array_equal(acc.numpy(), ref)


def test_expand_solid_matches(data):
    _s, _q, jkc, tkc, jmaps, tmaps = data
    solid0 = tkc.counts >= 12
    ref, jr = JB.expand_solid(jkc, solid0, None, 21, 8, maps=jmaps)
    got, tr = TB.expand_solid(tkc, solid0, None, 21, 8, maps=tmaps)
    plain, pr = TB.expand_solid_plain(solid0, 21, _np_maps(tmaps), 8)
    assert tr == jr == pr and np.array_equal(got, ref) and np.array_equal(plain, ref)
    assert got.sum() > solid0.sum()
    one, r1 = TB.expand_solid(tkc, solid0, None, 21, 1, maps=tmaps)
    assert r1 == 1 and np.array_equal(one, JB.expand_solid(jkc, solid0, None, 21, 1,
                                                           maps=jmaps)[0])


@pytest.mark.parametrize("majority", [0.5, 0.75])
def test_vote_matches(data, majority):
    _s, _q, _jkc, tkc, _jm, tmaps = data
    rng = np.random.default_rng(9)
    b, _n, idx, present, use_rc = tmaps[0]
    U = tkc.num_unique
    center = rng.integers(0, U, U)
    good_k = rng.random(U) < 0.7
    safe = torch.where(idx >= 0, idx, 0).to(torch.int64)
    cidx = torch.from_numpy(center)[safe]
    good = present & torch.from_numpy(good_k)[safe]
    ccodes = TK.unpack(tkc.words, 21)
    got, gwin = TH._vote_correct_batch(torch.from_numpy(b.codes), torch.from_numpy(ccodes),
                                       cidx, use_rc, good, 21, majority)
    oriented = ccodes[cidx.numpy()]
    oriented = np.where(use_rc.numpy()[..., None], 3 - oriented[:, :, ::-1], oriented)
    ref, rwin = JH._vote_correct_batch(b.codes, b.lengths, b.n_mask, oriented.astype(np.uint8),
                                       good.numpy(), 21, majority)
    plain, pwin = TH._vote_correct_batch_plain(b.codes, oriented.astype(np.uint8),
                                               good.numpy(), 21, majority)
    assert np.array_equal(got.numpy(), ref) and np.array_equal(gwin.numpy(), rwin)
    assert np.array_equal(plain, ref) and np.array_equal(pwin, rwin)
    assert (got.numpy() != b.codes).any()


# -- end to end ----------------------------------------------------------------------

@pytest.mark.parametrize("path", ["count_only", "quality", "quality_device_count"])
def test_correct_reads_matches(data, monkeypatch, path):
    seqs, quals = data[0], data[1]
    q = None if path == "count_only" else quals
    if path == "quality_device_count":
        monkeypatch.setenv("SPADES_HOST_COUNT_WINDOWS", "1")
    cfg = dict(batch_size=4096)
    ref, jst = JH.correct_reads(seqs, JH.HammerConfig(**cfg), quals=q)
    tm = {}
    got, tst = TH.correct_reads(seqs, TH.HammerConfig(**cfg), quals=q, device="cpu", record=tm)
    assert got == ref
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst)
    assert tst.bases_changed > 100 and tst.reads_changed > 50
    assert {"count_s", "maps_s", "cluster_s", "vote_s"} <= set(tm)
    if q is not None:
        assert {"quality_s", "subcluster_s", "expand_s"} <= set(tm)
        assert tm["pos_log_err"].shape == (tst.unique_kmers, 21)


def test_correct_reads_edge_cases():
    for seqs in ([], ["ACGT", "GGG"], ["N" * 60, "ACGTN" * 20]):
        ref = JH.correct_reads(seqs)
        got = TH.correct_reads(seqs, device="cpu")
        assert got[0] == ref[0] and dataclasses.asdict(got[1]) == dataclasses.asdict(ref[1])


def test_correct_reads_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TH.correct_reads(["ACGT" * 30])


def test_correct_ion_reads_matches():
    rng = np.random.default_rng(12)
    genome = "".join(b * int(rng.integers(1, 5)) for b in rng.choice(list("ACGT"), 1500))
    reads = []
    for s in rng.integers(0, len(genome) - 120, 700):
        r = list(genome[s : s + 120])
        for p in rng.integers(0, 119, 2):            # homopolymer run-length errors
            r.insert(int(p), r[int(p)]) if rng.random() < 0.5 else r.pop(int(p))
        reads.append("".join(r))
    reads += ["", "ACG", "ACGTNACGTACGTTTTGG" * 3]
    got = TI.correct_ion_reads(reads)
    ref = JI.correct_ion_reads(reads)
    assert got == ref and got[1] > 0
    assert TI.hp_compress("AAACCGT")[0] == JI.hp_compress("AAACCGT")[0]


def test_import_scan_covers_the_new_modules():
    new = ["hammer/__init__.py", "hammer/hammer.py", "hammer/bayes.py", "hammer/clustering.py",
           "hammer/ionhammer.py", "alignment/mismatch.py", "parallel/sharded_mapping.py"]
    for rel in new:
        tops = {m.split(".")[0] for m in _imported_modules(REPO / "spades_tpu_torch" / rel)}
        assert not tops & {"jax", "jaxlib", "spades_tpu"}, rel
