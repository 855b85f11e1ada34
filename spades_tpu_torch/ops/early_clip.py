"""Early simplification on the extension index (before condensation).

Capability mirror of SPAdes' early tip clipping and low-complexity (poly-A/T)
clipping, which run on the k-mer extension index BEFORE the graph is
materialized so the condenser never sees the error tangle:

* `EarlyTipClipperProcessor`
  (`src/common/assembly_graph/construction/early_simplification.hpp:37-160`):
  from every junction k-mer (out-degree >= 2, both orientations), walk each
  outgoing branch forward while it is a unique-in/unique-out chain, up to a
  length bound; branches ending in a dead end are tips; all tips strictly
  shorter than the longest branch of their junction are removed (their k-mers
  isolated), and the junction's now-dangling out-links are cleared.
* `EarlyLowComplexityClipperProcessor`
  (`early_simplification_extra.hpp`; `construction.cpp:317-341` invokes it
  with ratio=0.8, min_len=10, max_len=200 for RNA pipelines): removes
  length-1 edges out of low-complexity junction k-mers and low-complexity
  tips walked backward from dead ends.

Every pass is a fixed-bound vectorized wavefront over flat arrays: all
branches advance one step per iteration via packed-word shifts and a row
binary search, finished lanes drop out, and all deletions are batched bitwise
mask updates (the mask-level deletion API of
`DeBruijnExtensionIndex::DeleteOutgoing/IsolateVertex`,
`kmer_index/extension_index/kmer_extension_index.hpp:62`).  Host numpy, the
same code as `spades_tpu.ops.early_clip`.
"""
from __future__ import annotations

import logging

import numpy as np

from ..core import kmers as K
from .extension import POPCOUNT4, ExtensionIndex, canonicalize, mask_tail

log = logging.getLogger("spades_tpu_torch.early_clip")

# 4-bit mask reversal: bit c -> bit (3-c) (orientation flip of an in/out mask).
MASK_REV4 = np.zeros(16, np.uint8)
for _m in range(16):
    for _c in range(4):
        if _m & (1 << _c):
            MASK_REV4[_m] |= 1 << (3 - _c)

# single-bit mask -> bit position (8 where not a single bit)
UNIQ_BASE = np.full(16, 8, np.uint8)
for _c in range(4):
    UNIQ_BASE[1 << _c] = _c

# CheckUnique (inout_mask.hpp:61-68): popcount == 1
IS_UNIQ = POPCOUNT4 == 1


# ---------------------------------------------------------------------------
# Directed-node view: (row, orient) with orient 1 = reverse complement
# ---------------------------------------------------------------------------

def _omask_dir(E: ExtensionIndex, idx: np.ndarray, o: np.ndarray) -> np.ndarray:
    return np.where(o, MASK_REV4[E.in_mask[idx]], E.out_mask[idx])


def _imask_dir(E: ExtensionIndex, idx: np.ndarray, o: np.ndarray) -> np.ndarray:
    return np.where(o, MASK_REV4[E.out_mask[idx]], E.in_mask[idx])


def _dir_words(E: ExtensionIndex, idx: np.ndarray, o: np.ndarray) -> np.ndarray:
    w = E.kmers[idx]
    rc = K.revcomp_words(w, E.k)
    return np.where(o[:, None].astype(bool), rc, w)


def _shift_append(words: np.ndarray, nt: np.ndarray, k: int) -> np.ndarray:
    """Directed successor k-mer: drop base 0, append base nt."""
    W = words.shape[-1]
    out = (words << np.uint32(2)).astype(np.uint32)
    if W > 1:
        out[..., : W - 1] |= words[..., 1:] >> np.uint32(30)
    out = mask_tail(out, k)
    w, jj = divmod(k - 1, 16)
    out[..., w] |= nt.astype(np.uint32) << np.uint32(30 - 2 * jj)
    return out


def _shift_prepend(words: np.ndarray, nt: np.ndarray, k: int) -> np.ndarray:
    """Directed predecessor k-mer: drop base k-1, prepend base nt."""
    W = words.shape[-1]
    out = (words >> np.uint32(2)).astype(np.uint32)
    if W > 1:
        out[..., 1:] |= words[..., : W - 1] << np.uint32(30)
    out[..., 0] |= nt.astype(np.uint32) << np.uint32(30)
    return mask_tail(out, k)


def _lookup_dir(E: ExtensionIndex, words: np.ndarray):
    """Directed spelled k-mers -> (row, orient)."""
    canon, rc = canonicalize(words, E.k)
    idx = E.lookup(canon)
    return idx, rc


# ---------------------------------------------------------------------------
# Mask-level deletion API (DeleteOutgoing / DeleteIncoming / IsolateVertex)
# ---------------------------------------------------------------------------

def isolate_rows(E: ExtensionIndex, rows: np.ndarray) -> None:
    """IsolateVertex: clear both masks of the given canonical rows."""
    E.in_mask[rows] = 0
    E.out_mask[rows] = 0


def delete_out_dir(E, idx: np.ndarray, o: np.ndarray, c: np.ndarray) -> None:
    """DeleteOutgoing in the directed view (batched, duplicate-safe)."""
    o = np.asarray(o, bool)
    fw = ~o
    np.bitwise_and.at(E.out_mask, idx[fw], ~(np.uint8(1) << c[fw].astype(np.uint8)))
    np.bitwise_and.at(E.in_mask, idx[o], ~(np.uint8(1) << (np.uint8(3) - c[o].astype(np.uint8))))


def delete_in_dir(E, idx: np.ndarray, o: np.ndarray, c: np.ndarray) -> None:
    """DeleteIncoming in the directed view (batched, duplicate-safe)."""
    o = np.asarray(o, bool)
    fw = ~o
    np.bitwise_and.at(E.in_mask, idx[fw], ~(np.uint8(1) << c[fw].astype(np.uint8)))
    np.bitwise_and.at(E.out_mask, idx[o], ~(np.uint8(1) << (np.uint8(3) - c[o].astype(np.uint8))))


def fix_forward_links(E: ExtensionIndex, idx: np.ndarray, o: np.ndarray) -> int:
    """RemoveInconsistentForwardLinks (early_simplification.hpp:21-36): for each
    out-link of the given directed nodes, clear it when the target no longer
    stores the matching in-link (phantom extension into a removed tip)."""
    if idx.size == 0:
        return 0
    words = _dir_words(E, idx, o)
    om = _omask_dir(E, idx, o)
    bits = (om[:, None] >> np.arange(4, dtype=np.uint8)[None, :]) & 1
    src, c = np.nonzero(bits)
    if src.size == 0:
        return 0
    c = c.astype(np.uint8)
    tidx, to = _lookup_dir(E, _shift_append(words[src], c, E.k))
    fb = np.asarray(K.base_at(words[src], 0, E.k)).astype(np.uint8)
    tim = np.where(tidx >= 0, _imask_dir(E, np.maximum(tidx, 0), to), 0)
    bad = (tidx < 0) | (((tim >> fb) & 1) == 0)
    delete_out_dir(E, idx[src[bad]], o[src[bad]], c[bad])
    return int(bad.sum())


# ---------------------------------------------------------------------------
# Early tip clipper
# ---------------------------------------------------------------------------

def clip_tips_early(
    E: ExtensionIndex,
    length_bound: int,
    chunk_branches: int = 1 << 18,
) -> int:
    """Vectorized EarlyTipClipperProcessor::ClipTips. Returns removed k-mers.

    Semantics match early_simplification.hpp:108-155: a branch is walked from
    the first k-mer past the junction while unique-in & unique-out for at most
    `length_bound` interior nodes; the terminal node must be unique-in and a
    dead end for the branch to be a tip; per junction, every tip strictly
    shorter than the longest branch (non-tip branches count as infinite) is
    isolated, then dangling junction out-links are cleared.
    """
    if E.num_kmers == 0 or length_bound <= 0:
        return 0
    # junction directed nodes: out-degree >= 2 in either orientation
    j_fw = np.flatnonzero(POPCOUNT4[E.out_mask] >= 2)
    j_rc = np.flatnonzero(POPCOUNT4[E.in_mask] >= 2)
    jidx = np.concatenate([j_fw, j_rc])
    jo = np.concatenate([np.zeros(len(j_fw), bool), np.ones(len(j_rc), bool)])
    if jidx.size == 0:
        return 0

    removed_total = 0
    # chunk on junction boundaries so per-junction max stays inside one chunk
    n_per_branchset = max(1, chunk_branches // 4)
    for lo in range(0, jidx.size, n_per_branchset):
        hi = min(lo + n_per_branchset, jidx.size)
        removed_total += _clip_tips_chunk(E, jidx[lo:hi], jo[lo:hi], length_bound)
    log.info("%d k-mers removed by early tip clipper", removed_total)
    return removed_total


def _clip_tips_chunk(E, jidx, jo, bound: int) -> int:
    k = E.k
    jwords = _dir_words(E, jidx, jo)
    jmask = _omask_dir(E, jidx, jo)
    bits = (jmask[:, None] >> np.arange(4, dtype=np.uint8)[None, :]) & 1
    bj, bc = np.nonzero(bits)  # branch -> junction pos / out base
    B = bj.size
    if B == 0:
        return 0
    bc = bc.astype(np.uint8)

    cur_words = _shift_append(jwords[bj], bc, k)
    cur_idx, cur_o = _lookup_dir(E, cur_words)
    # index is symmetric by construction: every out-link's target exists
    cur_idx = np.maximum(cur_idx, 0)

    visited = np.full((B, bound + 1), -1, np.int64)
    size = np.zeros(B, np.int64)
    tip_ok = np.zeros(B, bool)
    walking = np.ones(B, bool)

    # FindForward, all branches in lockstep (early_simplification.hpp:108-121)
    for _t in range(bound + 1):
        act = np.flatnonzero(walking)
        if act.size == 0:
            break
        om = _omask_dir(E, cur_idx[act], cur_o[act])
        im = _imask_dir(E, cur_idx[act], cur_o[act])
        ui = IS_UNIQ[im]
        uo = IS_UNIQ[om]
        cont = ui & uo & (size[act] < bound)
        # everyone (stopping or continuing) pushes the current node
        visited[act, size[act]] = cur_idx[act]
        size[act] += 1
        # stopping lanes: tip iff unique-in terminal dead end
        stop = ~cont
        tip_ok[act[stop]] = ui[stop] & (om[stop] == 0)
        walking[act[stop]] = False
        # continuing lanes advance
        go = act[cont]
        if go.size:
            nw = _shift_append(cur_words[go], UNIQ_BASE[om[cont]], k)
            nidx, no = _lookup_dir(E, nw)
            cur_words[go] = nw
            cur_idx[go] = np.maximum(nidx, 0)
            cur_o[go] = no

    # lanes that ran out of iterations with cond still true never got a
    # terminal check -> they are over-bound, not tips (tip_ok stays False)

    # per-junction longest branch (non-tips = +inf), remove strictly shorter tips
    INF = np.int64(bound + 2)
    blen = np.where(tip_ok, size, INF)
    jmax = np.zeros(jidx.size, np.int64)
    np.maximum.at(jmax, bj, blen)
    remove = tip_ok & (size < jmax[bj])
    if not remove.any():
        return 0
    rows = visited[remove]
    rows = rows[rows >= 0]
    isolate_rows(E, np.unique(rows))
    # clear phantom out-links at tipped junctions
    tj = np.unique(bj[remove])
    fix_forward_links(E, jidx[tj], jo[tj])
    return int(size[remove].sum())


# ---------------------------------------------------------------------------
# Early low-complexity (poly-A/T) clipper
# ---------------------------------------------------------------------------

def _popcount32(x: np.ndarray) -> np.ndarray:
    x = x - ((x >> np.uint32(1)) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> np.uint32(2)) & np.uint32(0x33333333))
    x = (x + (x >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return ((x.astype(np.uint64) * np.uint64(0x01010101)) >> np.uint64(24)).astype(
        np.int32
    ) & np.int32(0x3F)


def base_counts(words: np.ndarray, k: int) -> np.ndarray:
    """(N, W) packed k-mers -> (N, 4) per-base occurrence counts (vectorized
    2-bit-field compare + SWAR popcount; no unpacking)."""
    W = words.shape[-1]
    counts = np.zeros((words.shape[0], 4), np.int32)
    for w in range(W):
        x = words[:, w]
        nfields = min(16, k - 16 * w)
        field_mask = np.uint32(0x55555555)
        if nfields < 16:
            field_mask &= np.uint32(0xFFFFFFFF) << np.uint32(32 - 2 * nfields)
        for b in range(4):
            y = x ^ np.uint32(b * 0x55555555)
            z = ~(y | (y >> np.uint32(1))) & field_mask
            counts[:, b] += _popcount32(z)
    return counts


def remove_at_edges(E: ExtensionIndex, ratio: float = 0.8) -> int:
    """Vectorized EarlyLowComplexityClipperProcessor::RemoveATEdges: drop
    length-1 out-edges of low-complexity junction k-mers whose target is
    itself a junction (construction.cpp:324-327 invokes with ratio 0.8)."""
    if E.num_kmers == 0:
        return 0
    k = E.k
    thr = k * ratio
    # max base count is orientation-invariant (complement permutes the counts)
    maxcnt = base_counts(E.kmers, k).max(axis=1)
    lowc = maxcnt >= thr
    n_edges = 0
    del_src_i, del_src_o, del_src_c = [], [], []
    del_tgt_i, del_tgt_o, del_tgt_c = [], [], []
    for o_val in (False, True):
        o_col = np.full(E.num_kmers, o_val, bool)
        om = _omask_dir(E, np.arange(E.num_kmers), o_col)
        im = _imask_dir(E, np.arange(E.num_kmers), o_col)
        junction = ~(IS_UNIQ[om] & IS_UNIQ[im])
        cand = np.flatnonzero(lowc & junction & (om > 0))
        if cand.size == 0:
            continue
        words = _dir_words(E, cand, o_col[cand])
        bits = (om[cand][:, None] >> np.arange(4, dtype=np.uint8)[None, :]) & 1
        src, c = np.nonzero(bits)
        if src.size == 0:
            continue
        c = c.astype(np.uint8)
        tidx, to = _lookup_dir(E, _shift_append(words[src], c, k))
        ok = tidx >= 0
        src, c, tidx, to = src[ok], c[ok], tidx[ok], to[ok]
        tom = _omask_dir(E, tidx, to)
        tim = _imask_dir(E, tidx, to)
        t_junction = ~(IS_UNIQ[tom] & IS_UNIQ[tim])  # IsDeadEnd implies junction
        sel = np.flatnonzero(t_junction)
        if sel.size == 0:
            continue
        n_edges += sel.size
        fb = np.asarray(K.base_at(words[src[sel]], 0, k)).astype(np.uint8)
        del_src_i.append(cand[src[sel]])
        del_src_o.append(np.full(sel.size, o_val, bool))
        del_src_c.append(c[sel])
        del_tgt_i.append(tidx[sel])
        del_tgt_o.append(to[sel])
        del_tgt_c.append(fb)
    if n_edges:
        delete_out_dir(
            E, np.concatenate(del_src_i), np.concatenate(del_src_o), np.concatenate(del_src_c)
        )
        delete_in_dir(
            E, np.concatenate(del_tgt_i), np.concatenate(del_tgt_o), np.concatenate(del_tgt_c)
        )
    log.info("%d low-complexity edges removed by early A/T remover", n_edges)
    return n_edges


def remove_at_tips(
    E: ExtensionIndex,
    ratio: float = 0.8,
    min_len: int = 10,
    max_len: int = 200,
    chunk_branches: int = 1 << 18,
) -> int:
    """Vectorized EarlyLowComplexityClipperProcessor::RemoveATTips: walk
    backward from unique-in dead ends to the nearest junction; if the tip is
    short and low-complexity (base counts padded with junction bases up to
    min_len), isolate it and clear the junction's dangling links."""
    if E.num_kmers == 0:
        return 0
    # starts: directed dead ends with unique incoming
    starts_i, starts_o = [], []
    for o_val in (False, True):
        o_col = np.full(E.num_kmers, o_val, bool)
        om = _omask_dir(E, np.arange(E.num_kmers), o_col)
        im = _imask_dir(E, np.arange(E.num_kmers), o_col)
        rows = np.flatnonzero((om == 0) & IS_UNIQ[im])
        starts_i.append(rows)
        starts_o.append(np.full(rows.size, o_val, bool))
    sidx = np.concatenate(starts_i)
    so = np.concatenate(starts_o)
    if sidx.size == 0:
        return 0
    removed = 0
    for lo in range(0, sidx.size, chunk_branches):
        hi = min(lo + chunk_branches, sidx.size)
        removed += _at_tips_chunk(E, sidx[lo:hi], so[lo:hi], ratio, min_len, max_len)
    log.info("%d k-mers removed by early poly A/T tip clipper", removed)
    return removed


def _at_tips_chunk(E, sidx, so, ratio, min_len, max_len) -> int:
    k = E.k
    B = sidx.size
    cur_words = _dir_words(E, sidx, so)
    cur_idx = sidx.copy()
    cur_o = so.copy()
    visited = np.full((B, max_len), -1, np.int64)
    counts = np.zeros((B, 4), np.int32)
    size = np.zeros(B, np.int64)
    walking = np.ones(B, bool)
    # do { push kh; counts[kh[k-1]]++; kh = unique_in(kh) }
    # while (size < max_len && !IsJunction(kh))
    for _t in range(max_len):
        act = np.flatnonzero(walking)
        if act.size == 0:
            break
        visited[act, size[act]] = cur_idx[act]
        lb = np.asarray(K.base_at(cur_words[act], k - 1, k)).astype(np.int64)
        np.add.at(counts, (act, lb), 1)
        size[act] += 1
        im = _imask_dir(E, cur_idx[act], cur_o[act])
        # step back through the unique in-link (guaranteed unique: start has
        # unique-in, interior nodes are non-junctions)
        pw = _shift_prepend(cur_words[act], UNIQ_BASE[im], k)
        pidx, po = _lookup_dir(E, pw)
        bad = pidx < 0
        pidx = np.maximum(pidx, 0)
        cur_words[act] = pw
        cur_idx[act] = pidx
        cur_o[act] = po
        pom = _omask_dir(E, pidx, po)
        pim = _imask_dir(E, pidx, po)
        is_junction = ~(IS_UNIQ[pom] & IS_UNIQ[pim])
        walking[act] = ~bad & ~is_junction & (size[act] < max_len)

    # cur is now the junction candidate; bail on dead starts & non-junctions
    jom = _omask_dir(E, cur_idx, cur_o)
    jim = _imask_dir(E, cur_idx, cur_o)
    dead_start = jim == 0
    is_junction = ~(IS_UNIQ[jom] & IS_UNIQ[jim])
    ok = is_junction & ~dead_start & ~walking
    if not ok.any():
        return 0

    # pad complexity counts with junction bases up to min_len
    # (for i in [size-1, min_len): counts[kh[k-1-i]]++)
    for i in range(min(min_len, k)):
        padme = ok & (size - 1 <= i) & (i < min_len)
        rows = np.flatnonzero(padme)
        if rows.size == 0:
            continue
        b = np.asarray(K.base_at(cur_words[rows], k - 1 - i, k)).astype(np.int64)
        np.add.at(counts, (rows, b), 1)

    curm = counts.max(axis=1)
    thr = np.maximum(size, min_len) * ratio
    accept = ok & (curm >= thr)
    if not accept.any():
        return 0
    rows = visited[accept]
    rows = rows[rows >= 0]
    isolate_rows(E, np.unique(rows))
    fix_forward_links(E, cur_idx[accept], cur_o[accept])
    return int(size[accept].sum())
