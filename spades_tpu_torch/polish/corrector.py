"""Post-assembly mismatch polishing — the spades-corrector-core engine.

Capability mirror of the reference corrector
(SPAdes `src/projects/corrector/`):

* DatasetProcessor (`dataset_processor.hpp:34-68`): contigs are split into
  bounded-size buckets and each bucket is polished independently, so memory
  stays bounded by the bucket (the reference splits contigs into per-contig
  dirs and runs BWA per split library; here the mapper is the in-repo
  batched anchor mapper and the bucket is an nt budget).
* ContigProcessor (`contig_processor.cpp`): per-position base votes from all
  mapped reads; unambiguous positions take the straight majority fix.
* InterestingPositionProcessor (`interesting_pos_processor.cpp`): positions
  where >1 variant holds 10-90% of >=20 votes (plus +-6 anchor positions at
  100 nt spacing) are "interesting"; reads covering >=2 of them become
  weighted positional reads, and two directional sweeps resolve the
  interesting positions jointly — each read's vote is weighted down by how
  often it has already disagreed (error_weight = [100,10,8,5,2,1]) and up by
  its squared agreement count (the default mapped_squared strategy,
  `configs/corrector.info`).

Substitution-only: anchors are exact k-mers, so reads spanning an indel do
not produce a dominant mapping (the SAM-driven path in tools/corrector.py
covers CIGAR indel walks).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

from ..core import dna
from ..core.kmers import kmer_words
from ..ops.count import searchsorted_rows, _lexsort_rows

log = logging.getLogger("spades_tpu_torch.corrector")

NT_COMP = np.array([3, 2, 1, 0], np.uint8)


@dataclass
class CorrectorConfig:
    k: int = 21
    bucket_nt: int = 8_000_000       # contig nt per processing bucket
    batch_reads: int = 16384
    min_votes: int = 2               # votes needed to touch a position
    interesting_total: int = 20      # sum_total > 20 (interesting_pos_processor.cpp:29)
    interesting_lo: float = 0.1
    interesting_hi: float = 0.9
    anchor_gap: int = 100            # kAnchorGap
    anchor_num: int = 6              # kAnchorNum
    error_weight: tuple = (100, 10, 8, 5, 2, 1)  # kMaxErrorCount table
    strategy: str = "mapped_squared"  # configs/corrector.info default


# ---------------------------------------------------------------------------
# contig anchor index (per bucket)
# ---------------------------------------------------------------------------


@dataclass
class _ContigIndex:
    k: int
    kmers: np.ndarray    # (U, W) sorted canonical k-mers
    contig: np.ndarray   # (U,) int64
    offset: np.ndarray   # (U,) int64
    strand: np.ndarray   # (U,) uint8  0 = window spelled == canonical


def _build_contig_index(codes_list: list[np.ndarray], k: int) -> _ContigIndex:
    from ..alignment.mapper import canonicalize
    from ..core import kmers as K

    words, cids, offs, strands = [], [], [], []
    for i, codes in enumerate(codes_list):
        n = len(codes) - k + 1
        if n <= 0:
            continue
        wins = np.lib.stride_tricks.sliding_window_view(codes, k)
        packed = K.pack(np.ascontiguousarray(wins))
        canon, was_rc = canonicalize(packed, k)
        words.append(canon)
        cids.append(np.full(n, i, np.int64))
        offs.append(np.arange(n, dtype=np.int64))
        strands.append(np.asarray(was_rc).astype(np.uint8))
    if not words:
        return _ContigIndex(k, np.zeros((0, kmer_words(k)), np.uint32),
                            np.zeros(0, np.int64), np.zeros(0, np.int64),
                            np.zeros(0, np.uint8))
    w = np.concatenate(words)
    c = np.concatenate(cids)
    o = np.concatenate(offs)
    s = np.concatenate(strands)
    order = _lexsort_rows(w)
    return _ContigIndex(k, w[order], c[order], o[order], s[order])


def _map_reads(index: _ContigIndex, codes: np.ndarray, lengths: np.ndarray):
    """Map fixed-shape read codes to (contig, start, reverse) by dominant
    anchor vote (gapless).  Returns (contig (R,), start (R,), rev (R,) bool)
    with contig == -1 for unmapped."""
    from ..alignment.mapper import canonicalize
    from ..core import kmers as K

    R, L = codes.shape
    k = index.k
    P = L - k + 1
    out_c = np.full(R, -1, np.int64)
    out_s = np.zeros(R, np.int64)
    out_r = np.zeros(R, bool)
    if P <= 0 or index.kmers.shape[0] == 0:
        return out_c, out_s, out_r
    wins = np.lib.stride_tricks.sliding_window_view(codes, k, axis=1).reshape(-1, k)
    packed = K.pack(np.ascontiguousarray(wins))
    canon, read_rc = canonicalize(packed, k)
    jj = np.tile(np.arange(P, dtype=np.int64), R)
    rid = np.repeat(np.arange(R, dtype=np.int64), P)
    valid = jj + k <= lengths[rid]
    idx = searchsorted_rows(index.kmers, canon)
    hit = (idx >= 0) & valid
    if not hit.any():
        return out_c, out_s, out_r
    idx, rid, jj, read_rc = idx[hit], rid[hit], jj[hit], np.asarray(read_rc)[hit]
    c = index.contig[idx]
    off = index.offset[idx]
    same = read_rc == index.strand[idx]
    # forward hit: contig position of read base 0 = off - jj
    # reverse hit: read maps RC; read base 0 sits at off + k - 1 + jj
    start_f = off - jj
    start_r = off + k - 1 + jj          # contig position of read base 0
    key_dir = np.where(same, 0, 1)
    key_start = np.where(same, start_f, start_r)
    order = np.lexsort((key_start, key_dir, c, rid))
    r_s, c_s, d_s, st_s = rid[order], c[order], key_dir[order], key_start[order]
    new = np.concatenate([[True], (r_s[1:] != r_s[:-1]) | (c_s[1:] != c_s[:-1])
                          | (d_s[1:] != d_s[:-1]) | (st_s[1:] != st_s[:-1])])
    gid = np.cumsum(new) - 1
    counts = np.bincount(gid)
    g_r, g_c, g_d, g_st = r_s[new], c_s[new], d_s[new], st_s[new]
    order2 = np.lexsort((-counts, g_r))
    first = np.concatenate([[True], g_r[order2][1:] != g_r[order2][:-1]])
    best = order2[first]
    out_c[g_r[best]] = g_c[best]
    out_s[g_r[best]] = g_st[best]
    out_r[g_r[best]] = g_d[best] == 1
    return out_c, out_s, out_r


def _vote_batch(votes, lens, cids, starts, revs, codes, lengths):
    """Scatter per-base votes of mapped reads into per-contig (len, 4)
    matrices (vectorized np.add.at per orientation)."""
    R, L = codes.shape
    m = cids >= 0
    if not m.any():
        return
    pos_in_read = np.arange(L)
    for rev in (False, True):
        sel = np.flatnonzero(m & (revs == rev))
        if sel.size == 0:
            continue
        # group by contig so each contig gets one add.at
        for ci in np.unique(cids[sel]):
            rows = sel[cids[sel] == ci]
            clen = lens[ci]
            rl = lengths[rows][:, None]
            within_read = pos_in_read[None, :] < rl
            if not rev:
                gpos = starts[rows][:, None] + pos_in_read[None, :]
                base = codes[rows]
            else:
                gpos = starts[rows][:, None] - pos_in_read[None, :]
                base = NT_COMP[codes[rows]]
            ok = within_read & (gpos >= 0) & (gpos < clen)
            np.add.at(votes[ci], (gpos[ok], base[ok]), 1)


def _interesting_mask(seq_codes: np.ndarray, v: np.ndarray, cfg: CorrectorConfig):
    """FillInterestingPositions (interesting_pos_processor.cpp:17-46)."""
    tot = v.sum(axis=1)
    frac_ok = (v > cfg.interesting_lo * tot[:, None]) & (
        v < cfg.interesting_hi * tot[:, None]
    )
    nvar = (frac_ok & (v > 0)).sum(axis=1)
    base_int = (nvar > 1) & (tot > cfg.interesting_total)
    mask = base_int.copy()
    n = len(seq_codes)
    for p in np.flatnonzero(base_int):
        for j in range(-cfg.anchor_num, cfg.anchor_num + 1):
            a = (p // cfg.anchor_gap + j) * cfg.anchor_gap
            if 0 <= a < n:
                mask[a] = True
    return mask


def _resolve_interesting(
    seq_codes: np.ndarray, mask: np.ndarray, wr_pos: list, wr_var: list,
    cfg: CorrectorConfig,
) -> dict[int, int]:
    """UpdateInterestingPositions (interesting_pos_processor.cpp:73-126):
    two directional sweeps, votes weighted by each read's running error
    count and (mapped_squared) squared agreement count.  Returns
    {position: new base} for positions whose winner differs."""
    pos_list = np.flatnonzero(mask)
    if pos_list.size == 0 or not wr_pos:
        return {}
    # per-position -> read ids covering it
    read_ids: dict[int, list[int]] = {int(p): [] for p in pos_list}
    var_of: list[dict[int, int]] = []
    for ri, (ps, vs) in enumerate(zip(wr_pos, wr_var)):
        d = {}
        for p, vv in zip(ps, vs):
            d[int(p)] = int(vv)
            read_ids[int(p)].append(ri)
        var_of.append(d)
    ew = cfg.error_weight
    changed: dict[int, int] = {}
    for direction in (1, -1):
        err = np.zeros(len(wr_pos), np.int64)
        processed = np.zeros(len(wr_pos), np.int64)
        order = pos_list if direction == 1 else pos_list[::-1]
        for p in order:
            rids = read_ids[int(p)]
            if not rids:
                continue
            w = np.zeros(4, np.int64)
            for ri in rids:
                var = var_of[ri][int(p)]
                coef = 1
                if cfg.strategy == "mapped_squared":
                    coef = int(processed[ri]) ** 2
                e = err[ri]
                w[var] += (ew[e] if e < len(ew) else 0) * coef
            cur = int(seq_codes[p])
            maxi = cur if w[cur] >= w.max() else int(np.argmax(w))
            for ri in rids:
                if var_of[ri][int(p)] != maxi:
                    err[ri] += 1
                else:
                    processed[ri] += 1
            if maxi != cur and w[maxi] > 0:
                changed[int(p)] = maxi
    return changed


def polish_contigs(
    contigs: list[str], reads: list[str], cfg: CorrectorConfig | None = None
) -> tuple[list[str], dict]:
    """Polish contigs against the read set.  Returns (corrected contigs,
    stats).  Memory is bounded by cfg.bucket_nt of contig sequence per
    bucket (votes = 16 B/nt); reads stream through every bucket in batches
    (the reference re-streams its split SAM per bucket the same way)."""
    cfg = cfg or CorrectorConfig()
    stats = {"fixed_simple": 0, "fixed_interesting": 0, "interesting_positions": 0}
    corrected = [None] * len(contigs)

    # greedy bucket packing by nt budget
    buckets: list[list[int]] = []
    cur, cur_nt = [], 0
    for i, s in enumerate(contigs):
        if cur and cur_nt + len(s) > cfg.bucket_nt:
            buckets.append(cur)
            cur, cur_nt = [], 0
        cur.append(i)
        cur_nt += len(s)
    if cur:
        buckets.append(cur)

    k = cfg.k
    for bucket in buckets:
        codes_list = [dna.encode(contigs[i]) for i in bucket]
        lens = np.array([len(c) for c in codes_list], np.int64)
        index = _build_contig_index(codes_list, k)
        votes = [np.zeros((n, 4), np.int32) for n in lens]
        # pass 1: vote, and remember mappings for the interesting pass
        mapped: list[tuple[np.ndarray, ...]] = []
        for b0 in range(0, len(reads), cfg.batch_reads):
            chunk = reads[b0 : b0 + cfg.batch_reads]
            L = max((len(r) for r in chunk), default=0)
            if L < k:
                continue
            codes = np.zeros((len(chunk), L), np.uint8)
            lengths = np.zeros(len(chunk), np.int64)
            for j, r in enumerate(chunk):
                e = dna.encode(r)
                codes[j, : len(e)] = np.where(e >= 4, 0, e)
                lengths[j] = len(e)
            cids, starts, revs = _map_reads(index, codes, lengths)
            _vote_batch(votes, lens, cids, starts, revs, codes, lengths)
            # keep ONLY mapped rows, 2-bit packed: storing every batch's raw
            # padded matrix would make peak memory scale with the whole read
            # set; this keeps the bucketed bounded-memory contract
            rows = np.flatnonzero(cids >= 0)
            if rows.size:
                sub = codes[rows]
                pad = (-sub.shape[1]) % 4
                if pad:
                    sub = np.pad(sub, ((0, 0), (0, pad)))
                packed = (
                    sub[:, 0::4] | (sub[:, 1::4] << 2)
                    | (sub[:, 2::4] << 4) | (sub[:, 3::4] << 6)
                )
                mapped.append((cids[rows], starts[rows], revs[rows],
                               packed, lengths[rows], codes.shape[1]))

        for bi, ci in enumerate(bucket):
            seq_codes = codes_list[bi].copy()
            v = votes[bi]
            tot = v.sum(axis=1)
            mask = _interesting_mask(seq_codes, v, cfg)
            stats["interesting_positions"] += int(mask.sum())
            # simple majority on NON-interesting positions
            best = v.argmax(axis=1)
            cur_ok = seq_codes < 4
            fix = (
                ~mask & cur_ok & (tot >= cfg.min_votes)
                & (best != seq_codes)
                & (v[np.arange(len(v)), best] * 2 > tot)
            )
            seq_codes[fix] = best[fix]
            stats["fixed_simple"] += int(fix.sum())
            # weighted positional reads over interesting positions
            if mask.any():
                wr_pos, wr_var = [], []
                for cids, starts, revs, packed, lengths, Lb in mapped:
                    rows = np.flatnonzero(cids == bi)
                    if rows.size == 0:
                        continue
                    shifts = np.arange(4, dtype=np.uint8) * 2
                    codes = ((packed[rows][:, :, None] >> shifts[None, None, :]) & 3)
                    codes = codes.reshape(rows.size, -1)[:, :Lb].astype(np.uint8)
                    for ri, r in enumerate(rows):
                        st, rv, rl = int(starts[r]), bool(revs[r]), int(lengths[r])
                        if not rv:
                            gpos = st + np.arange(rl)
                            base = codes[ri, :rl]
                        else:
                            gpos = st - np.arange(rl)
                            base = NT_COMP[codes[ri, :rl]]
                        ok = (gpos >= 0) & (gpos < len(seq_codes))
                        gi = gpos[ok]
                        bs = base[ok]
                        im = mask[gi]
                        if im.sum() >= 2:
                            wr_pos.append(gi[im])
                            wr_var.append(bs[im])
                changed = _resolve_interesting(
                    codes_list[bi], mask, wr_pos, wr_var, cfg
                )
                for p, b in changed.items():
                    if seq_codes[p] != b:
                        seq_codes[p] = b
                        stats["fixed_interesting"] += 1
            corrected[ci] = dna.decode(seq_codes)
    log.info(
        "corrector: %d simple + %d interesting fixes (%d interesting positions)",
        stats["fixed_simple"], stats["fixed_interesting"],
        stats["interesting_positions"],
    )
    return corrected, stats
