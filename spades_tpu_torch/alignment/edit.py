"""Edit-distance alignment + consensus for noisy long-read segments.

Capability mirror of SPAdes' vendored edlib + SPOA usage in the
long-read path (`src/common/alignment/pacbio/gap_filler.cpp`
edlib-scored gap candidates, `hybrid_gap_closer.hpp:312-320` SPOA consensus
of gap segments; `ext/src/edlib`, `ext/src/spoa`):

* `edit_distances` — Myers' bit-parallel algorithm (the same algorithm edlib
  implements), multi-word, *batched over texts*: the bitvector state is a
  (n_texts, n_words) uint64 array, so one Python step per text column updates
  every candidate at once — the numpy-native replacement for edlib's per-pair
  C loop.
* `banded_align` — banded global alignment with traceback (unit costs),
  used where per-base alignment columns are needed.
* `consensus` — pileup consensus over noisy copies of the same segment:
  pick the medoid backbone by edit distance, band-align every copy to it,
  vote per column (match/substitution/deletion) and per inter-column
  insertion, and iterate.  This is the racon-style window consensus, which
  matches SPOA's accuracy on the short anchored windows the gap closer
  feeds it while staying a vectorized pileup rather than a partial-order
  graph of C++ objects.

Host numpy, as in `spades_tpu.alignment.edit`, and it stays numpy: the
bit-vector words rely on numpy's unsigned 64-bit wrap-around (the carry of
the multi-word add), which torch's signed int64 does not give.
"""
from __future__ import annotations

import numpy as np

from ..core import dna

_ONE = np.uint64(1)
_ZERO = np.uint64(0)
_FULL = np.uint64(0xFFFFFFFFFFFFFFFF)


def _peq(pattern: np.ndarray, w: int) -> np.ndarray:
    """(4, w) uint64 match bitmasks for the pattern (codes >=4 match nothing)."""
    peq = np.zeros((4, w), np.uint64)
    m = len(pattern)
    words = np.arange(m) >> 6
    bits = (np.arange(m) & 63).astype(np.uint64)
    for c in range(4):
        sel = pattern == c
        np.bitwise_or.at(peq[c], words[sel], _ONE << bits[sel])
    return peq


def edit_distances(query: str | np.ndarray, texts: list[str | np.ndarray]) -> np.ndarray:
    """Levenshtein distance of `query` to every text (Myers bit-parallel,
    batched).  Returns (len(texts),) int64."""
    pat = query if isinstance(query, np.ndarray) else dna.encode(query)
    m = len(pat)
    n = len(texts)
    if n == 0:
        return np.zeros(0, np.int64)
    tc = [t if isinstance(t, np.ndarray) else dna.encode(t) for t in texts]
    lens = np.array([len(t) for t in tc], np.int64)
    if m == 0:
        return lens.copy()
    L = int(lens.max()) if len(lens) else 0
    txt = np.full((n, L), 4, np.uint8)
    for i, t in enumerate(tc):
        txt[i, : len(t)] = t
    w = (m + 63) >> 6
    peq = _peq(pat, w)
    last_word = (m - 1) >> 6
    last_bit = np.uint64((m - 1) & 63)
    pv = np.full((n, w), _FULL, np.uint64)
    mv = np.zeros((n, w), np.uint64)
    score = np.full(n, m, np.int64)
    out = np.full(n, m, np.int64)  # empty texts cost m deletions
    for j in range(L):
        c = txt[:, j]
        eq = np.where(c[:, None] < 4, peq[np.minimum(c, 3)], _ZERO)  # (n, w)
        xv = eq | mv
        # xh = (((eq & pv) + pv) ^ pv) | eq with multi-word carry
        xh = np.empty_like(pv)
        carry = np.zeros(n, np.uint64)
        for t in range(w):
            a = eq[:, t] & pv[:, t]
            s1 = a + pv[:, t]
            c1 = s1 < a
            s = s1 + carry
            c2 = s < s1
            xh[:, t] = (s ^ pv[:, t]) | eq[:, t]
            carry = (c1 | c2).astype(np.uint64)
        ph = mv | ~(xh | pv)
        mh = pv & xh
        # score update at row m-1
        score += ((ph[:, last_word] >> last_bit) & _ONE).astype(np.int64)
        score -= ((mh[:, last_word] >> last_bit) & _ONE).astype(np.int64)
        # shift ph/mh left by one across words; global alignment shifts a 1
        # into ph (row 0 of the DP increases along the text)
        ph_in = np.full(n, _ONE, np.uint64)
        mh_in = np.zeros(n, np.uint64)
        for t in range(w):
            ph_out = ph[:, t] >> np.uint64(63)
            mh_out = mh[:, t] >> np.uint64(63)
            ph[:, t] = (ph[:, t] << _ONE) | ph_in
            mh[:, t] = (mh[:, t] << _ONE) | mh_in
            ph_in, mh_in = ph_out, mh_out
        pv = mh | ~(xv | ph)
        mv = ph & xv
        done = lens == j + 1
        if done.any():
            out[done] = score[done]
    return out


def edit_distance(a: str | np.ndarray, b: str | np.ndarray) -> int:
    return int(edit_distances(a, [b])[0])


def banded_align(
    a: np.ndarray, b: np.ndarray, band: int | None = None
) -> tuple[int, np.ndarray, np.ndarray]:
    """Banded global alignment of code arrays a, b (unit costs).

    Returns (distance, ai, bi): aligned index columns where ai[t] is the index
    into a (or -1 for an insertion in b) and bi[t] the index into b (or -1
    for a deletion).  Band widens automatically if the optimum may cross it."""
    la, lb = len(a), len(b)
    if la == 0:
        return lb, np.full(lb, -1, np.int64), np.arange(lb, dtype=np.int64)
    if lb == 0:
        return la, np.arange(la, dtype=np.int64), np.full(la, -1, np.int64)
    band = band or max(abs(la - lb) + 8, 16)
    while True:
        dist, cols = _banded_core(a, b, band)
        if dist <= band or band >= max(la, lb):
            return dist, cols[0], cols[1]
        band = min(band * 2, max(la, lb))


def _banded_core(a, b, band):
    la, lb = len(a), len(b)
    W = 2 * band + 1
    INF = np.int32(1 << 29)
    # dp[i, d] = cost of aligning a[:i] with b[:i+d-band]
    prev = np.full(W, INF, np.int32)
    d0 = np.arange(W) - band            # diagonal offsets
    j0 = d0                             # row i=0: j = d
    ok0 = (j0 >= 0) & (j0 <= lb)
    prev[ok0] = j0[ok0]
    tb = np.zeros((la + 1, W), np.uint8)  # 0=diag, 1=up(del a), 2=left(ins b)
    tb[0][ok0] = 2
    for i in range(1, la + 1):
        j = i + d0                       # text positions on this row
        valid = (j >= 0) & (j <= lb)
        jm = np.clip(j, 1, lb)
        sub = (a[i - 1] != b[jm - 1]).astype(np.int32)
        diag = np.where((j >= 1) & (j <= lb), prev + sub, INF)
        up = np.empty(W, np.int32)       # from dp[i-1, d+1]
        up[:-1] = prev[1:] + 1
        up[-1] = INF
        cur = np.minimum(diag, up)
        choice = np.where(diag <= up, 0, 1).astype(np.uint8)
        # left (from dp[i, d-1]) needs a serial scan; do it with a prefix trick:
        # cur is already the best without-left; one pass of cumulative min
        # along d with +1 per step equals allowing any number of left moves
        left_chain = np.minimum.accumulate(cur - np.arange(W, dtype=np.int32))
        with_left = left_chain + np.arange(W, dtype=np.int32)
        use_left = with_left < cur
        cur = np.where(use_left, with_left, cur)
        choice = np.where(use_left, np.uint8(2), choice)
        cur[~valid] = INF
        tb[i] = choice
        prev = cur
    dend = lb - la + band
    dist = int(prev[dend])
    # traceback
    ai, bi = [], []
    i, d = la, dend
    while i > 0 or (i + d - band) > 0:
        ch = tb[i][d]
        j = i + d - band
        if i == 0:
            ch = 2
        elif j == 0:
            ch = 1
        if ch == 0:
            ai.append(i - 1)
            bi.append(j - 1)
            i -= 1
        elif ch == 1:
            ai.append(i - 1)
            bi.append(-1)
            i -= 1
            d += 1
        else:
            ai.append(-1)
            bi.append(j - 1)
            d -= 1
    return dist, (np.array(ai[::-1], np.int64), np.array(bi[::-1], np.int64))


def medoid(seqs: list[str]) -> int:
    """Index of the sequence with minimal total edit distance to the rest."""
    if len(seqs) <= 2:
        return 0
    tot = np.zeros(len(seqs))
    for i, s in enumerate(seqs):
        tot += edit_distances(s, seqs)
    return int(np.argmin(tot))


def consensus(seqs: list[str], rounds: int = 2, max_copies: int = 32) -> str:
    """Pileup consensus of noisy copies of one segment (SPOA-consensus role).

    Backbone = medoid; every copy is band-aligned to it; per backbone column
    the majority of {A,C,G,T,deletion} wins, and per inter-column slot the
    majority insertion (usually the empty one) wins.  One or two rounds of
    realign-to-consensus close the gap to full POA on anchored windows."""
    seqs = [s for s in seqs if s]
    if not seqs:
        return ""
    if len(seqs) == 1:
        return seqs[0]
    if len(seqs) > max_copies:
        # keep the copies closest to the medoid
        m = medoid(seqs)
        d = edit_distances(seqs[m], seqs)
        seqs = [seqs[i] for i in np.argsort(d)[:max_copies]]
    cons = seqs[medoid(seqs)]
    for _ in range(rounds):
        bb = dna.encode(cons)
        L = len(bb)
        col = np.zeros((L, 5), np.int32)            # A C G T deletion
        ins: dict[int, dict[str, int]] = {}
        for s in seqs:
            sc = dna.encode(s)
            _, ai, bi = banded_align(bb, sc)
            run_start = None
            for t in range(len(ai)):
                if ai[t] >= 0:
                    if bi[t] >= 0:
                        col[ai[t], sc[bi[t]] if sc[bi[t]] < 4 else 0] += 1
                    else:
                        col[ai[t], 4] += 1
            # insertions: contiguous runs of ai == -1 attach before the next
            # backbone column (or L at the end)
            t = 0
            n = len(ai)
            while t < n:
                if ai[t] == -1:
                    u = t
                    while u < n and ai[u] == -1:
                        u += 1
                    pos = int(ai[u]) if u < n else L
                    piece = dna.decode(sc[bi[t:u]].astype(np.uint8))
                    slot = ins.setdefault(pos, {})
                    slot[piece] = slot.get(piece, 0) + 1
                    t = u
                else:
                    t += 1
        n_seq = len(seqs)
        parts = []
        for i in range(L + 1):
            slot = ins.get(i)
            if slot:
                best_piece, cnt = max(slot.items(), key=lambda kv: kv[1])
                if cnt * 2 > n_seq:                  # strict majority inserts
                    parts.append(best_piece)
            if i < L:
                v = col[i]
                b = int(np.argmax(v))
                if b < 4:
                    parts.append("ACGT"[b])
                # b == 4: majority deletion -> emit nothing
        new = "".join(parts)
        if new == cons:
            break
        cons = new
    return cons
