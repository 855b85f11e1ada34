"""Quality-aware Bayesian machinery for BayesHammer.

Capability mirror of SPAdes' quality-weighted clustering and solid-set
expansion (`src/projects/hammer/kmer_cluster.cpp` — lMeansClustering /
Center / GoodKMer discipline — and `src/projects/hammer/expander.cpp`):
PHRED qualities survive into the k-mer statistics, Hamming clusters are
split into sub-clusters by a BIC-scored l-means over quality-derived
per-position error probabilities, centers are quality-weighted consensi,
solidity is a posterior (count OR low total error probability), and the
solid set grows by iterating over reads fully covered by solid k-mers.

Device/host split: the quality sum (`accumulate_quality`) and the solid-set
expansion (`expand_solid`) run on the device over the per-pass window maps
of `hammer.build_window_maps`; the subclustering runs on the (small)
per-cluster member sets on the host, numpy copied from the JAX package's
`spades_tpu/hammer/bayes.py`, so every float matches to the bit (its
independent chunks run on a thread pool).
"""
from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core import kmers as K
from ..ops.count import KmerCounts

log = logging.getLogger("spades_tpu_torch.hammer")

# PHRED floor/ceiling: SPAdes clips qualities to avoid log(0)
# (kmer_stat.hpp getProb discipline).
_MIN_Q = 2.0
_MAX_Q = 60.0
# index of "no quality" (error probability 1.0) in `_log_err_table`
_NO_QUAL = 256


def phred_to_err(qual_ascii: np.ndarray, offset: int = 33) -> np.ndarray:
    """ASCII PHRED codes -> per-base error probabilities (float32)."""
    q = np.clip(qual_ascii.astype(np.float32) - offset, _MIN_Q, _MAX_Q)
    return 10.0 ** (-q / 10.0)


def quals_to_array(quals: list[str], L: int, offset: int = 33) -> np.ndarray:
    """Pad a list of PHRED strings into an (R, L) error-probability matrix.

    Positions beyond a read's length get error prob 1.0 (no information)."""
    R = len(quals)
    # uniform-length fast path (the overwhelmingly common case): one
    # frombuffer over the joined strings instead of a per-read Python loop.
    # L is the padded batch row length, so compare reads against EACH OTHER
    # (len(quals[0])), then pad columns up to L with err=1.0.
    if R:
        L0 = len(quals[0])
        if 0 < L0 <= L and all(len(q) == L0 for q in quals):
            a = np.frombuffer("".join(quals).encode("ascii"), np.uint8)
            err0 = phred_to_err(a.reshape(R, L0), offset)
            if L0 == L:
                return err0
            return np.pad(err0, ((0, 0), (0, L - L0)), constant_values=1.0)
    err = np.ones((R, L), np.float32)
    for i, qs in enumerate(quals):
        if not qs:
            continue
        a = np.frombuffer(qs.encode("ascii"), np.uint8)[:L]
        err[i, : len(a)] = phred_to_err(a, offset)
    return err


def quals_to_codes(quals: list[str], R: int, L: int) -> np.ndarray:
    """The (R, L) int16 table indices of `quals_to_array`'s entries: the
    ASCII code of each base's quality, `_NO_QUAL` where `quals_to_array`
    puts 1.0 (past a read's quality string, past its row)."""
    out = np.full((R, L), _NO_QUAL, np.int16)
    n = len(quals)
    if n:
        L0 = len(quals[0])
        if 0 < L0 <= L and all(len(q) == L0 for q in quals):
            a = np.frombuffer("".join(quals).encode("ascii"), np.uint8)
            out[:n, :L0] = a.reshape(n, L0)
            return out
    for i, qs in enumerate(quals):
        if qs:
            a = np.frombuffer(qs.encode("ascii"), np.uint8)[:L]
            out[i, : len(a)] = a
    return out


def _log_err_table(offset: int = 33) -> np.ndarray:
    """(257,) float32: log10(clip(error probability, 1e-30, 1)) of every
    ASCII quality code, and 0.0 (= log10 1.0) at `_NO_QUAL`, by the same
    numpy float32 calls as the JAX package's `accumulate_quality`, so a
    gather from it gives that function's addends bit for bit (the device's
    own log10 need not round as numpy's does)."""
    err = np.ones(_NO_QUAL + 1, np.float32)
    err[:_NO_QUAL] = phred_to_err(np.arange(_NO_QUAL, dtype=np.uint8), offset)
    return np.log10(np.clip(err, 1e-30, 1.0)).astype(np.float32)


class KmerQuality:
    """Aggregated per-unique-k-mer quality statistics.

    pos_log_err: (U, k) float32 — sum over occurrences of log10(error prob)
    at each canonical k-mer position, i.e. log10 P(this position was
    mis-called in EVERY observation).  Mirrors the role of SPAdes' per-k-mer
    QualBitSet / totalQual (kmer_stat.hpp)."""

    def __init__(self, num_unique: int, k: int):
        self.k = k
        self.pos_log_err = np.zeros((num_unique, k), np.float32)

    def total_err_prob(self) -> np.ndarray:
        """P(k-mer contains >=1 consistently mis-called position) per unique
        k-mer — the analog of SPAdes' totalQual solidity input."""
        p = 10.0 ** np.clip(self.pos_log_err, -30.0, 0.0)
        return np.clip(p.sum(axis=1), 0.0, 1.0)

    def pos_err_prob(self, rows: np.ndarray) -> np.ndarray:
        """(len(rows), k) per-position error probabilities."""
        return 10.0 ** np.clip(self.pos_log_err[rows], -30.0, 0.0)


def _add_in_order(acc: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor) -> None:
    """acc[rows[i]] += vals[i] for every i in order, as `np.add.at` does.

    A scatter-add on the card adds in atomic order, which moves float32
    sums when one row's addends differ.  Here the occurrences are stably
    sorted by row and added rank by rank: the r-th occurrence of every row
    in one step, in which no row repeats, so each row's sum is taken in the
    order of its occurrences."""
    if rows.numel() == 0:
        return
    srt = torch.sort(rows, stable=True)
    s = srt.values
    n = s.shape[0]
    first = torch.ones(n, dtype=torch.bool, device=s.device)
    first[1:] = s[1:] != s[:-1]
    pos = torch.arange(n, device=s.device)
    run_start = torch.cummax(torch.where(first, pos, 0), 0).values
    rank = pos - run_start
    by_rank = torch.sort(rank, stable=True).indices
    per_rank = torch.bincount(rank).tolist()
    occ = srt.indices[by_rank]
    a = 0
    for m in per_rank:
        o = occ[a : a + m]
        r = rows[o]
        acc[r] = acc[r] + vals[o]
        a += m


def accumulate_quality(
    kc: KmerCounts,
    seqs: list[str],
    quals: list[str],
    k: int,
    batch_size: int = 8192,
    maps: list | None = None,
    device=None,
    timings: dict | None = None,
) -> KmerQuality:
    """Aggregate per-position error log-probabilities onto the unique k-mers.

    Every read window that maps into the counted table adds its per-base
    log10(err) at the window's canonical orientation (reverse-complemented
    windows flip the position axis — base j of the canonical k-mer came from
    read position p + k - 1 - j).  `maps` (from hammer.build_window_maps)
    reuses the shared per-pass window maps instead of recomputing them.

    On the maps' device: each batch's quality codes are uploaded, their
    addends gathered from `_log_err_table`, and summed per k-mer in
    occurrence order (`_add_in_order`), so `pos_log_err` equals the JAX
    package's `np.add.at` bit for bit.  timings: optional dict whose
    `quality_ms` list receives each batch's CUDA-event time on the card."""
    if maps is None:
        from .hammer import build_window_maps

        maps = build_window_maps(seqs, kc.words, k, batch_size, device=device)
    kq = KmerQuality(kc.num_unique, k)
    dev = next((m[2].device for m in maps if m[2] is not None), None)
    if dev is None:
        return kq
    table = torch.from_numpy(_log_err_table()).to(dev)
    acc = torch.zeros((kc.num_unique, k), dtype=torch.float32, device=dev)
    events = []
    pos = 0
    for batch, n, idx, present, use_rc in maps:
        R, L = batch.codes.shape
        if idx is None:
            pos += n
            continue
        qc = torch.from_numpy(quals_to_codes(quals[pos : pos + n], R, L)).to(dev)
        if timings is not None and dev.type == "cuda":
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        P = idx.shape[1]
        win = qc.unfold(1, k, 1)[:, :P, :]
        win = torch.where(use_rc[..., None], win.flip(-1), win)
        sel = present.reshape(-1)
        rows = idx.reshape(-1)[sel].to(torch.int64)
        vals = table[win.reshape(-1, k)[sel].to(torch.int64)]
        _add_in_order(acc, rows, vals)
        if timings is not None and dev.type == "cuda":
            ev[1].record()
            events.append(ev)
        pos += n
    kq.pos_log_err = acc.cpu().numpy()
    if events:
        timings.setdefault("quality_ms", []).extend(a.elapsed_time(b) for a, b in events)
    return kq


def accumulate_quality_plain(kc: KmerCounts, quals: list[str], k: int,
                             maps: list) -> KmerQuality:
    """Plain numpy version of `accumulate_quality` over numpy maps
    (`hammer.build_window_maps_plain`): the addends by numpy's log10, summed
    by `np.add.at`."""
    kq = KmerQuality(kc.num_unique, k)
    pos = 0
    for batch, n, idx, present, use_rc in maps:
        R, L = batch.codes.shape
        if idx is None:
            pos += n
            continue
        err = quals_to_array(quals[pos : pos + n], L)
        if err.shape[0] < R:  # batch row padding
            err = np.pad(err, ((0, R - err.shape[0]), (0, 0)), constant_values=1.0)
        P = idx.shape[1]
        win_err = np.lib.stride_tricks.sliding_window_view(err, k, axis=1)[:, :P, :]
        win_err = np.where(use_rc[..., None], win_err[:, :, ::-1], win_err)
        log_err = np.log10(np.clip(win_err, 1e-30, 1.0)).astype(np.float32)
        np.add.at(kq.pos_log_err, idx[present], log_err[present])
        pos += n
    return kq


# ---------------------------------------------------------------------------
# Bayesian sub-clustering (kmer_cluster.cpp lMeansClustering analog)
# ---------------------------------------------------------------------------


def _loglike(codes: np.ndarray, counts: np.ndarray, errp: np.ndarray,
             centers: np.ndarray, assign: np.ndarray) -> float:
    """Log-likelihood of members given their assigned centers.

    For member i at positions where it differs from its center, the
    observation is explained as an error: count_i * log(err_ij / 3); matching
    positions contribute count_i * log(1 - err_ij).  This is SPAdes'
    quality-weighted distance (kmer_cluster.cpp logLikelihood) with the
    aggregated per-position error probabilities standing in for per-read
    PHRED values."""
    diff = codes != centers[assign]
    e = np.clip(errp, 1e-10, 0.75)
    ll = np.where(diff, np.log(e / 3.0), np.log1p(-e)).sum(axis=1)
    return float((counts * ll).sum())


def _consensus_center(codes: np.ndarray, counts: np.ndarray, errp: np.ndarray) -> np.ndarray:
    """Quality-weighted per-position consensus (kmer_cluster.cpp Center()):
    each member votes count * (1 - err) for its base at each position."""
    k = codes.shape[1]
    votes = np.zeros((k, 4), np.float64)
    w = counts[:, None] * (1.0 - np.clip(errp, 0.0, 0.99))
    flat_pos = np.tile(np.arange(k), len(codes))
    np.add.at(votes, (flat_pos, codes.ravel()), w.ravel())
    return votes.argmax(axis=1).astype(np.uint8)


def batched_lmeans(
    codes: np.ndarray,
    counts: np.ndarray,
    errp: np.ndarray,
    max_l: int = 5,
    iters: int = 4,
) -> np.ndarray:
    """BIC-scored l-means over MANY equal-size clusters at once.

    codes: (C, M, k) uint8 member bases; counts: (C, M) multiplicities; errp:
    (C, M, k) per-position error probabilities.  Returns sub-labels (C, M)
    int32.  Semantics identical to the per-cluster lMeansClustering loop
    (kmer_cluster.cpp): candidate center counts l = 1..max_l, members assigned
    to the likeliest center, centers re-fit as quality-weighted consensi
    (empty sub-centers keep their previous value), assignment iteration stops
    per cluster at its own fixpoint, model chosen per cluster by BIC with k*l
    free parameters and degenerate (empty-sub-cluster) solutions skipped.
    The cluster axis is the host analog of SPAdes' OpenMP outer loop over
    clusters — one vectorized sweep instead of C scalar calls."""
    C, M, k = codes.shape
    e = np.clip(errp, 1e-10, 0.75)
    log_err = np.log(e / 3.0).astype(np.float64)
    log_match = np.log1p(-e).astype(np.float64)
    order = np.argsort(-counts, axis=1, kind="stable")
    total = counts.sum(axis=1).astype(np.float64)
    w_vote = (counts[..., None] * (1.0 - np.clip(errp, 0.0, 0.99))).astype(np.float64)
    ci = np.arange(C)[:, None]
    kpos = np.arange(k)[None, None, :]
    best_labels = np.zeros((C, M), np.int32)
    best_bic = np.full(C, -np.inf)
    for l in range(1, min(max_l, M) + 1):
        centers = codes[ci, order[:, :l]].copy()  # (C, l, k) top-count seeds
        assign = np.zeros((C, M), np.int64)
        conv = np.zeros(C, bool)
        for _ in range(iters):
            diff = codes[:, :, None, :] != centers[:, None, :, :]  # (C,M,l,k)
            ll = np.where(diff, log_err[:, :, None, :], log_match[:, :, None, :]).sum(-1)
            new_assign = ll.argmax(-1)  # (C, M)
            conv = conv | (new_assign == assign).all(axis=1)
            assign = np.where(conv[:, None], assign, new_assign)
            if conv.all():
                break
            # re-fit centers as quality-weighted consensi (scatter-add votes)
            flat = (((ci * l + assign)[..., None] * k + kpos) * 4 + codes).ravel()
            votes = np.bincount(flat, weights=w_vote.ravel(), minlength=C * l * k * 4)
            votes = votes.reshape(C, l, k, 4)
            new_centers = votes.argmax(-1).astype(np.uint8)
            has = np.zeros((C, l), bool)
            has[ci, assign] = True  # sub-centers with >=1 member
            keep = conv[:, None] | ~has  # converged cluster or empty sub-center
            centers = np.where(keep[..., None], centers, new_centers)
        cc = centers[ci, assign]  # (C, M, k) each member's center
        llm = np.where(codes != cc, log_err, log_match).sum(-1)
        logl = (counts * llm).sum(axis=1)
        used = np.zeros((C, l), bool)
        used[ci, assign] = True
        bic = 2.0 * logl - l * k * np.log(np.maximum(total, 2.0))
        ok = (used.sum(axis=1) == l) & (bic > best_bic)
        best_bic = np.where(ok, bic, best_bic)
        best_labels[ok] = assign[ok].astype(np.int32)
    return best_labels


def bayes_subcluster(
    codes: np.ndarray,
    counts: np.ndarray,
    errp: np.ndarray,
    max_l: int = 5,
    iters: int = 4,
) -> np.ndarray:
    """Split one Hamming cluster into sub-clusters by BIC-scored l-means.

    Single-cluster view over `batched_lmeans` (C == 1)."""
    n, _ = codes.shape
    if n == 1:
        return np.zeros(1, np.int32)
    return batched_lmeans(
        codes[None], counts[None].astype(np.float64), errp[None], max_l, iters
    )[0]


def subcluster_all(
    words: np.ndarray,
    counts: np.ndarray,
    labels: np.ndarray,
    kq: KmerQuality,
    k: int,
    max_members: int = 64,
) -> np.ndarray:
    """Refine Hamming-cluster labels with Bayesian sub-clustering.

    Clusters larger than `max_members` are left intact (they are dominated by
    genuine repeats, and SPAdes also bounds subclustering work).
    Returns new dense labels covering every k-mer."""
    codes_all = K.unpack(words, k)
    order = np.argsort(labels, kind="stable")
    lab_sorted = labels[order]
    starts = np.flatnonzero(np.concatenate([[True], lab_sorted[1:] != lab_sorted[:-1]]))
    ends = np.append(starts[1:], len(order))
    sizes = ends - starts
    n_clusters = len(starts)

    # per-cluster sub-label array, filled bucket by bucket (clusters of the
    # SAME size batch into one (C, M, k) `batched_lmeans` call — the host
    # analog of SPAdes' parallel outer loop over clusters)
    sub_of = np.zeros(len(labels), np.int64)  # sub-label per element (by order pos)
    nsub_of = np.ones(n_clusters, np.int64)   # sub-cluster count per cluster
    eligible = (sizes >= 2) & (sizes <= max_members)
    work = []
    for m in np.unique(sizes[eligible]):
        all_rows = np.flatnonzero(eligible & (sizes == m))
        # chunk the cluster axis: batched_lmeans materializes (C, M, l, k)
        # float64 temporaries, and real datasets have millions of size-2
        # clusters — cap the per-call element count at ~25M (~200 MB/temp)
        c_chunk = max(1, 25_000_000 // (int(m) * 5 * k))
        work += [(int(m), all_rows[c0 : c0 + c_chunk])
                 for c0 in range(0, len(all_rows), c_chunk)]

    def _lmeans(item):
        m, rows = item
        # (C, M) member positions in `order`
        pos = starts[rows][:, None] + np.arange(m)[None, :]
        members = order[pos]  # (C, M) global k-mer rows
        return pos, batched_lmeans(
            codes_all[members],
            counts[members].astype(np.float64),
            kq.pos_err_prob(members.ravel()).reshape(len(rows), m, k),
        )

    # the chunks are independent: numpy releases the GIL in their array
    # work, so threads run them side by side, and each writes its own rows
    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as pool:
        for (_m, rows), (pos, sub) in zip(work, pool.map(_lmeans, work)):
            sub_of[pos.ravel()] = sub.ravel()
            nsub_of[rows] = sub.max(axis=1) + 1

    # dense renumber: cluster c's sub-label s -> base[c] + s
    base = np.concatenate([[0], np.cumsum(nsub_of)[:-1]])
    cluster_of_pos = np.repeat(np.arange(n_clusters), sizes)
    new_labels = np.empty(len(labels), np.int64)
    # sub_of is indexed by position in `order`
    new_labels[order] = base[cluster_of_pos] + sub_of
    split = int((nsub_of > 1).sum())
    if split:
        log.info("hammer: Bayesian subclustering split %d clusters (%d -> %d)",
                 split, n_clusters, int(nsub_of.sum()))
    return new_labels


# ---------------------------------------------------------------------------
# Solidity posterior + iterative expansion (expander.cpp analog)
# ---------------------------------------------------------------------------


def solid_posterior(
    counts: np.ndarray,
    total_err: np.ndarray,
    count_bound: float,
    singleton_err: float = 1e-5,
    low_count_err: float = 1e-3,
) -> np.ndarray:
    """Quality-aware solidity: a k-mer is solid if its multiplicity clears the
    coverage-model bound, OR its total error probability is so low that even a
    low count is credible (SPAdes' good/skip discipline over totalQual,
    kmer_stat.hpp:GoodForIterative)."""
    solid = counts >= count_bound
    solid |= (counts >= 2) & (total_err < low_count_err)
    solid |= (counts == 1) & (total_err < singleton_err)
    return solid


def expand_solid(
    kc: KmerCounts,
    solid: np.ndarray,
    seqs: list[str],
    k: int,
    max_rounds: int = 8,
    batch_size: int = 8192,
    maps: list | None = None,
    device=None,
) -> tuple[np.ndarray, int]:
    """Iterative solid-set expansion (expander.cpp): any read whose every
    position is covered by at least one solid k-mer certifies ALL of its
    k-mers as solid.  Repeats until fixpoint (or max_rounds).

    Runs on the maps' device, batch after batch as the JAX package's loop
    (a batch sees what earlier batches of its round certified); one host
    synchronisation a round.  `maps` (from hammer.build_window_maps) reuses
    the shared per-pass window maps.  Returns (expanded solid mask, rounds
    run)."""
    if maps is None:
        from .hammer import build_window_maps

        maps = build_window_maps(seqs, kc.words, k, batch_size, device=device)
    # (idx, present (R, P); each position's first and last window start;
    # positions past the read; rows of at least k bases)
    batch_maps = []
    for batch, n, idx, present, _use_rc in maps:
        if idx is None:
            continue
        dev = idx.device
        R, L = batch.codes.shape
        P = idx.shape[1]
        lengths = torch.zeros(R, dtype=torch.int64, device=dev)
        lengths[:n] = torch.from_numpy(batch.lengths[:n].astype(np.int64)).to(dev)
        posn = torch.arange(L, device=dev)
        lo = (posn - k + 1).clamp(min=0)
        hi = posn.clamp(max=P - 1)
        outside = posn[None, :] >= lengths[:, None]
        batch_maps.append((torch.where(present, idx, 0), present, lo, hi, outside,
                           lengths >= k))
    if not batch_maps:        # the rounds run, and find nothing to do
        return solid.copy(), min(1, max_rounds)
    sol = torch.from_numpy(solid.copy()).to(batch_maps[0][0].device)
    rounds = 0
    for rounds in range(1, max_rounds + 1):
        grew = torch.zeros((), dtype=torch.bool, device=sol.device)
        for idx, present, lo, hi, outside, has_k in batch_maps:
            idx = idx.to(torch.int64)
            win_solid = sol[idx] & present  # (R, P)
            # position p of a read is covered iff some solid window starts in
            # [p-k+1, p]; sliding any() via cumulative counts over window starts
            c = torch.cumsum(win_solid.to(torch.int32), dim=1)
            cpad = torch.nn.functional.pad(c, (1, 0))
            covered = (cpad[:, hi + 1] - cpad[:, lo]) > 0  # (R, L)
            fully = (covered | outside).all(dim=1) & has_k
            cert = idx[fully][present[fully]]
            grew |= (~sol[cert]).any()
            sol[cert] = True
        if not bool(grew):
            break
    return sol.cpu().numpy(), rounds


def expand_solid_plain(solid: np.ndarray, k: int, maps: list,
                       max_rounds: int = 8) -> tuple[np.ndarray, int]:
    """Plain numpy version of `expand_solid` over numpy maps
    (`hammer.build_window_maps_plain`)."""
    batch_maps = [(np.where(present, idx, 0), present, batch.lengths[:n], n,
                   batch.codes.shape[1])
                  for batch, n, idx, present, _rc in maps if idx is not None]
    solid = solid.copy()
    rounds = 0
    for rounds in range(1, max_rounds + 1):
        grew = False
        for idx, present, lengths, n, L in batch_maps:
            R, P = idx.shape
            c = np.cumsum((solid[idx] & present).astype(np.int32), axis=1)
            cpad = np.concatenate([np.zeros((R, 1), np.int32), c], axis=1)
            posn = np.arange(L, dtype=np.int32)
            covered = (cpad[:, np.minimum(posn, P - 1) + 1]
                       - cpad[:, np.maximum(posn - k + 1, 0)]) > 0
            full_len = np.pad(lengths, (0, R - n))
            fully = np.logical_or(covered, posn[None, :] >= full_len[:, None]).all(axis=1)
            fully &= full_len >= k
            cert = idx[fully][present[fully]]
            if (~solid[cert]).any():
                solid[cert] = True
                grew = True
        if not grew:
            break
    return solid, rounds
