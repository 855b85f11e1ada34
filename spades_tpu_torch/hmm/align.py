"""Profile-HMM alignment to sequences and to the assembly graph.

Capability mirror of PathRacer
(`src/projects/pathracer/{main.cpp:1127,hmmpath.hpp,
find_best_path.cpp}`): find the graph paths whose spelled sequences best
match a profile HMM.

Like PathRacer, the graph search is a dynamic program over *graph
cursors* (`hmmpath.hpp` StateSet over GraphCursor): every nucleotide
position of every alive edge is a cursor; the DP iterates over profile
match states, carrying a score per cursor, so ALL graph paths are scored
simultaneously and exactly — no path enumeration, no path-count cap (the
round-1 DFS with max_paths=1000 silently missed hits on non-toy graphs).
Layer updates are fully vectorized: within-edge transitions are a shifted
array read, junction crossings are a small sparse relation table scattered
with a per-destination argmax.  Amino profiles step three cursors per
layer (codon steps); the reverse strand needs no special handling because
the conjugate edges are first-class cursors.

The per-sequence `viterbi_score` (the scoring model definition, used by the
read-level domain callers) and the graph DP both run the FULL plan7 local
recurrence — match, insert (cursor advances, state stays) and delete (state
advances, cursor stays) planes, mirroring PathRacer's
StateSet/DeletionStateSet machinery (`hmmpath.hpp:271-272` DeletionStateSet,
`:734-762` dm_new M/I/D merges, insert loops capped at
`fees.max_insertion_length` = 30, `fees.hpp:43`) — with uniform local
entry/exit, scores in nats of background-minus-model log-odds.  The two use
the identical recurrence, so a path's graph-DP score equals `viterbi_score`
of its spelled sequence."""
from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from ..core import dna
from ..graph.graph import CondensedGraph
from .io import ProfileHMM

log = logging.getLogger("spades_tpu_torch.hmm")

_CODON = {}


def _codon_table():
    global _CODON
    if _CODON:
        return _CODON
    bases = "TCAG"
    aas = (
        "FFLLSSSSYY**CC*W"
        "LLLLPPPPHHQQRRRR"
        "IIIMTTTTNNKKSSRR"
        "VVVVAAAADDEEGGGG"
    )
    for i, a in enumerate(bases):
        for j, b in enumerate(bases):
            for k, c in enumerate(bases):
                _CODON[a + b + c] = aas[16 * i + 4 * j + k]
    return _CODON


AMINO_ORDER = "ACDEFGHIKLMNPQRSTVWY"
AA_INDEX = {a: i for i, a in enumerate(AMINO_ORDER)}


def translate(seq: str, frame: int = 0) -> str:
    tab = _codon_table()
    s = seq[frame:]
    return "".join(
        tab.get(s[i : i + 3], "X") for i in range(0, len(s) - 2, 3)
    )


def _codon_aa_codes() -> np.ndarray:
    """(64,) aa index for codon b0*16+b1*4+b2 in ACGT coding (stop/unknown -> 0,
    matching `_encode_for`'s AA_INDEX.get(c, 0) fallback)."""
    tab = _codon_table()
    out = np.zeros(64, np.int64)
    acgt = "ACGT"
    for b0 in range(4):
        for b1 in range(4):
            for b2 in range(4):
                aa = tab[acgt[b0] + acgt[b1] + acgt[b2]]
                out[b0 * 16 + b1 * 4 + b2] = AA_INDEX.get(aa, 0)
    return out


def _encode_for(hmm: ProfileHMM, seq: str) -> np.ndarray:
    if hmm.K == 4:
        codes = dna.encode(seq)
        return np.where(codes >= 4, 0, codes).astype(np.int64)
    return np.array([AA_INDEX.get(c, 0) for c in seq], np.int64)


def viterbi_score(hmm: ProfileHMM, seq: str) -> tuple[float, int, int]:
    """Local plan7 Viterbi (M/I/D states): best log-odds score of aligning
    the profile inside seq.

    Returns (score, start, end) with positive score = better than background
    (scores are accumulated as background minus model, in nats).  Plane u
    (0-based) holds model node u+1; transitions out of node v live in
    hmm.trans row v (m->m, m->i, m->d, i->m, i->i, d->m, d->d)."""
    if len(seq) == 0:
        return -np.inf, 0, 0
    x = _encode_for(hmm, seq)
    L = len(x)
    M = hmm.length
    bg = hmm.compo if hmm.compo is not None else np.full(hmm.K, -np.log(1.0 / hmm.K))
    # emission log-odds: ln(p_match / p_background) = bg_score - match_score
    mlo = bg[None, :] - hmm.match_emit[1:, :]         # (M, K)  plane u <- node u+1
    ilo = bg[None, :] - hmm.insert_emit[1:, :]        # (M, K)
    t = -hmm.trans                                    # (M+1, 7) ln p
    tmm, tmi, tmd, tim, tii, tdm, tdd = (t[:, q] for q in range(7))
    # uniform local entry/exit (plan7 local mode simplification)
    entry = -np.log(M)
    NEG = -np.inf
    Mv = np.full(M, NEG)
    Iv = np.full(M, NEG)
    Dv = np.full(M, NEG)
    sM = np.zeros(M, np.int64)
    sI = np.zeros(M, np.int64)
    sD = np.zeros(M, np.int64)
    # delete-chain closed form helpers: cd[u] = sum_{v<=u} tdd[v] over planes
    cdd = np.concatenate([[0.0], np.cumsum(tdd[1:M])])  # (M,) cd[u]=sum tdd[1..u]
    best = (-np.inf, 0, 0)
    planes = np.arange(M)
    for i in range(L):
        e_m = mlo[:, x[i]]
        e_i = ilo[:, x[i]]
        # --- M plane: from (M/I/D at plane u-1, position i-1) or fresh entry
        contM = Mv[:-1] + tmm[1:M]
        contI = Iv[:-1] + tim[1:M]
        contD = Dv[:-1] + tdm[1:M]
        stay = np.maximum(np.maximum(contM, contI), contD)
        s_stay = np.where(
            contM >= np.maximum(contI, contD), sM[:-1],
            np.where(contI >= contD, sI[:-1], sD[:-1]),
        )
        newM = np.empty(M)
        nsM = np.empty(M, np.int64)
        newM[0] = entry + e_m[0]
        nsM[0] = i
        take_cont = stay >= entry
        newM[1:] = np.where(take_cont, stay, entry) + e_m[1:]
        nsM[1:] = np.where(take_cont, s_stay, i)
        # --- I plane: from M/I at the SAME plane, position i-1
        fromM = Mv + tmi[1 : M + 1]
        fromI = Iv + tii[1 : M + 1]
        newI = np.maximum(fromM, fromI) + e_i
        nsI = np.where(fromM >= fromI, sM, sI)
        # --- D plane (within-position over planes): D[u] = max(M[u-1]+tmd[u],
        # D[u-1]+tdd[u]); closed form via prefix max of newM[w]+tmd[w+1]-cd[w+1]
        with np.errstate(invalid="ignore"):
            a = np.full(M, NEG)
            a[1:] = newM[:-1] + tmd[1:M] - cdd[1:]
            run = np.maximum.accumulate(a)
            newD = run + cdd
            # start positions: index of the running max source
            src_idx = np.maximum.accumulate(np.where(a >= run, planes, -1))
            nsD = np.where(src_idx >= 1, nsM[np.maximum(src_idx - 1, 0)], 0)
        Mv, Iv, Dv, sM, sI, sD = newM, newI, newD, nsM, nsI, nsD
        j = int(np.argmax(Mv))
        if Mv[j] > best[0]:
            best = (float(Mv[j]), int(sM[j]), i + 1)
    return best


@dataclass
class HMMHit:
    path: list[int]        # graph edge ids
    score: float
    seq: str               # matched subsequence (spelled path slice)
    frame: int = 0         # reading frame for amino profiles (0..5)


def _spell(g: CondensedGraph, path: list[int]) -> str:
    parts = [g.edge_seq(path[0])]
    for e in path[1:]:
        parts.append(g.edge_seq(e)[g.k :])
    return "".join(parts)


# ---------------------------------------------------------------------------
# cursor space: every nt position of every alive edge, plus the sparse
# junction relation (last position of an edge -> position k of each out-edge,
# which is the next consumed base when spelling a path across the junction)


@dataclass
class _CursorSpace:
    eids: np.ndarray       # (Ea,) alive edge ids (both orientations)
    starts: np.ndarray     # (Ea+1,) cursor id of each edge's position 0
    base: np.ndarray       # (N,) int64 base code per cursor
    edge_row: np.ndarray   # (N,) int64 row into eids per cursor
    offset: np.ndarray     # (N,) int64 offset within edge
    jsrc: np.ndarray       # (J,) junction relation: src cursor (edge-last)
    jdst: np.ndarray       # (J,) junction relation: dst cursor (offset k)

    @property
    def n(self) -> int:
        return int(self.base.shape[0])


def _build_cursor_space(g: CondensedGraph) -> _CursorSpace:
    eids = g.alive_edge_ids().astype(np.int64)
    lens = g.e_len[eids].astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)])
    n = int(starts[-1])
    # pool indices for all cursors: e_off[e] + offset, vectorized
    edge_row = np.repeat(np.arange(len(eids)), lens)
    offset = np.arange(n) - starts[edge_row]
    base = g.seq_pool[g.e_off[eids][edge_row] + offset].astype(np.int64)
    # junction relation: for every (in-edge, out-edge) pair at a vertex,
    # (last cursor of in-edge) -> (cursor at offset k of out-edge)
    v_end = g.e_end[eids]
    v_start = g.e_start[eids]
    nv = g.num_vertices
    out_cnt = np.bincount(v_start, minlength=nv)
    out_order = np.argsort(v_start, kind="stable")
    out_ptr = np.concatenate([[0], np.cumsum(out_cnt)])
    rep = out_cnt[v_end]                      # out-degree at each in-edge's end
    jsrc_rows = np.repeat(np.arange(len(eids)), rep)
    # per-in-edge arange over its vertex's out slots
    tot = int(rep.sum())
    if tot:
        idx = np.arange(tot) - np.repeat(np.cumsum(rep) - rep, rep)
        jdst_rows = out_order[np.repeat(out_ptr[v_end], rep) + idx]
        jsrc = starts[jsrc_rows] + lens[jsrc_rows] - 1
        jdst = starts[jdst_rows] + g.k
    else:
        jsrc = np.zeros(0, np.int64)
        jdst = np.zeros(0, np.int64)
    return _CursorSpace(eids, starts, base, edge_row, offset, jsrc, jdst)


def _compose_codon_extras(
    cs: _CursorSpace,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """All 3-step cursor paths (c0,c1,c2,c3) that cross >= 1 junction.

    Returns (src=c0, m1=c1, m2=c2, dst=c3, codon_index).  Built by placing
    each junction entry at step 1, 2 or 3 and extending with the full 1-step
    relation on the other side; duplicates (multi-junction paths) are removed
    with a row unique.  Sizes stay O(junctions * fanout^2)."""
    n = cs.n
    # full 1-step successor CSR: within-edge (+1) plus junction entries
    within_src = np.flatnonzero(
        cs.offset < (cs.starts[cs.edge_row + 1] - cs.starts[cs.edge_row] - 1)
    )
    succ_src = np.concatenate([within_src, cs.jsrc])
    succ_dst = np.concatenate([within_src + 1, cs.jdst])
    order = np.argsort(succ_src, kind="stable")
    succ_src, succ_dst = succ_src[order], succ_dst[order]
    scnt = np.bincount(succ_src, minlength=n)
    sptr = np.concatenate([[0], np.cumsum(scnt)])
    # reverse CSR for predecessor expansion
    orderp = np.argsort(succ_dst, kind="stable")
    pred_dst, pred_src = succ_dst[orderp], succ_src[orderp]
    pcnt = np.bincount(pred_dst, minlength=n)
    pptr = np.concatenate([[0], np.cumsum(pcnt)])

    def _expand_fwd(cur: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """rows i of cur -> all (row_index, successor) pairs."""
        rep = scnt[cur]
        tot = int(rep.sum())
        if not tot:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        rows = np.repeat(np.arange(len(cur)), rep)
        idx = np.arange(tot) - np.repeat(np.cumsum(rep) - rep, rep)
        return rows, succ_dst[np.repeat(sptr[cur], rep) + idx]

    def _expand_bwd(cur: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        rep = pcnt[cur]
        tot = int(rep.sum())
        if not tot:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        rows = np.repeat(np.arange(len(cur)), rep)
        idx = np.arange(tot) - np.repeat(np.cumsum(rep) - rep, rep)
        return rows, pred_src[np.repeat(pptr[cur], rep) + idx]

    paths = []
    # junction at step 1: (jsrc, jdst, x, y)
    r1, c2 = _expand_fwd(cs.jdst)
    if len(r1):
        r2, c3 = _expand_fwd(c2)
        if len(r2):
            paths.append(
                np.stack([cs.jsrc[r1][r2], cs.jdst[r1][r2], c2[r2], c3], 1)
            )
    # junction at step 2: (p, jsrc, jdst, x)
    r1, c0 = _expand_bwd(cs.jsrc)
    if len(r1):
        r2, c3 = _expand_fwd(cs.jdst[r1])
        if len(r2):
            paths.append(
                np.stack([c0[r2], cs.jsrc[r1][r2], cs.jdst[r1][r2], c3], 1)
            )
    # junction at step 3: (p, q, jsrc, jdst)
    r1, c1 = _expand_bwd(cs.jsrc)
    if len(r1):
        r2, c0 = _expand_bwd(c1)
        if len(r2):
            paths.append(
                np.stack([c0, c1[r2], cs.jsrc[r1][r2], cs.jdst[r1][r2]], 1)
            )
    if not paths:
        z = np.zeros(0, np.int64)
        return z, z, z, z, z
    allp = np.unique(np.concatenate(paths, 0), axis=0)
    cod = (
        cs.base[allp[:, 1]] * 16 + cs.base[allp[:, 2]] * 4 + cs.base[allp[:, 3]]
    )
    aa = _codon_aa_codes()[cod]
    return allp[:, 0], allp[:, 1], allp[:, 2], allp[:, 3], aa


def align_hmm_to_graph(
    g: CondensedGraph,
    hmm: ProfileHMM,
    score_threshold: float = 5.0,
    top: int = 10,
) -> list[HMMHit]:
    """Best-scoring graph paths for the profile — exact cursor DP.

    PathRacer's shape: `src/projects/pathracer/hmmpath.hpp`
    (StateSet DP over graph cursors) + `find_best_path.cpp`.  One score per
    (profile state, cursor); within-edge moves are a shift, junction moves a
    sparse scatter-argmax.  Exact over all paths — nothing is enumerated or
    capped.  Backpointers are one int32 + one bool per cell; memory is
    O(M * total_nt) and logged if it exceeds ~1 GB."""
    eids = g.alive_edge_ids()
    if len(eids) == 0:
        return []
    cs = _build_cursor_space(g)
    n = cs.n
    M = hmm.length
    bg = hmm.compo if hmm.compo is not None else np.full(hmm.K, -np.log(1.0 / hmm.K))
    lo = bg[None, :] - hmm.match_emit[1:, :]          # (M, K)
    ins_lo = bg[None, :] - hmm.insert_emit[1:, :]     # (M, K)
    t_ = -hmm.trans                                   # (M+1, 7) ln p
    tmm, tmi, tmd, tim, tii, tdm, tdd = (t_[:, q] for q in range(7))
    entry = -np.log(M)
    max_insert_run = 30                               # fees.hpp:43 max_insertion_length
    est = M * n * 11
    if est > 1e9:
        log.warning(
            "pathracer DP: %d states x %d cursors ~= %.1f GB of backpointers",
            M, n, est / 1e9,
        )

    amino = hmm.K == 20
    if amino:
        # simple (within-edge) codon geometry: emission = codon ending at c
        valid = cs.offset >= 2
        sym = np.zeros(n, np.int64)
        iv = np.flatnonzero(valid)
        sym[iv] = _codon_aa_codes()[
            cs.base[iv - 2] * 16 + cs.base[iv - 1] * 4 + cs.base[iv]
        ]
        has_pred = cs.offset >= 3
        pred = np.where(has_pred, np.arange(n) - 3, -1)
        xsrc, xm1, xm2, xdst, xaa = _compose_codon_extras(cs)
        step = 3
    else:
        valid = np.ones(n, bool)
        sym = cs.base
        has_pred = cs.offset >= 1
        pred = np.where(has_pred, np.arange(n) - 1, -1)
        xsrc, xdst = cs.jsrc, cs.jdst
        xm1 = xm2 = np.zeros(0, np.int64)
        xaa = cs.base[xdst] if len(xdst) else np.zeros(0, np.int64)
        step = 1

    # pre-sort extras by destination for per-layer argmax grouping
    if len(xdst):
        xo = np.argsort(xdst, kind="stable")
        xsrc, xdst, xaa = xsrc[xo], xdst[xo], xaa[xo]
        if amino:
            xm1, xm2 = xm1[xo], xm2[xo]

    NEG = -np.inf

    def _grouped_best(xc: np.ndarray) -> np.ndarray:
        """Index of the best extra per destination (extras pre-sorted by
        xdst): returns indices w (one per distinct dst) of per-dst argmax."""
        bo = np.lexsort((-xc, xdst))
        first = np.ones(len(bo), bool)
        first[1:] = xdst[bo[1:]] != xdst[bo[:-1]]
        return bo[first]

    def _insert_plane(S: np.ndarray, j: int):
        """Build the insert plane for layer j (insert state after node j+1):
        transfer from the layer's match plane, then relax the I->I loop to
        fixpoint (<= max_insert_run rounds, `hmmpath.hpp:649`).

        The first round scores every cursor; a later round scores only the
        within-edge successors of the cursors the round before raised, since
        no other cursor's candidate can have grown (I only rises).  The
        rounds, their updates and the float sums are those of scoring every
        cursor each round.

        Returns (I, geom int32 (-1 within / extra idx), fromM bool)."""
        tmi_j = tmi[j + 1]
        tii_j = tii[j + 1]
        e_i = np.where(valid, ins_lo[j][sym], NEG)
        with np.errstate(invalid="ignore"):
            I = np.where(has_pred, S[pred] + tmi_j, NEG) + e_i
        geom = np.full(n, -1, np.int32)
        fromM = np.ones(n, bool)
        if len(xdst):
            with np.errstate(invalid="ignore"):
                xi = S[xsrc] + tmi_j + ins_lo[j][xaa]
            w = _grouped_best(xi)
            better = xi[w] > I[xdst[w]]
            wb = w[better]
            I[xdst[wb]] = xi[wb]
            geom[xdst[wb]] = wb.astype(np.int32)
        raised = None                                  # cursors the last round raised
        for _ in range(max_insert_run):
            changed = False
            with np.errstate(invalid="ignore"):
                if raised is None:
                    cand = np.where(has_pred, I[pred] + tii_j, NEG) + e_i
                    upd = np.flatnonzero(cand > I)
                    vals = cand[upd]
                else:
                    c = raised + step
                    c = c[c < n]
                    c = c[pred[c] == c - step]
                    cand = (I[c - step] + tii_j) + e_i[c]
                    keep = cand > I[c]
                    upd, vals = c[keep], cand[keep]
            if upd.size:
                I[upd] = vals
                geom[upd] = -1
                fromM[upd] = False
                changed = True
            raised = upd
            if len(xdst):
                with np.errstate(invalid="ignore"):
                    xi = I[xsrc] + tii_j + ins_lo[j][xaa]
                w = _grouped_best(xi)
                better = xi[w] > I[xdst[w]]
                wb = w[better]
                if len(wb):
                    I[xdst[wb]] = xi[wb]
                    geom[xdst[wb]] = wb.astype(np.int32)
                    fromM[xdst[wb]] = False
                    changed = True
                    raised = np.union1d(raised, xdst[wb])
            if not changed:
                break
        return I, geom, fromM

    emit0 = np.where(valid, lo[0][sym], NEG)
    S = entry + emit0                                  # layer 0: fresh start
    # extras can also fresh-start layer 0 (their emission differs from the
    # within-edge codon at the same dst)
    bp_geom = [np.full(n, -1, np.int32)]               # -1 = within-edge
    bp_src = [np.full(n, 3, np.uint8)]                 # 0=M 1=I 2=D 3=fresh
    if len(xdst):
        cand0 = entry + lo[0][xaa]
        w = _grouped_best(cand0)
        better = cand0[w] > S[xdst[w]]
        S[xdst[w[better]]] = cand0[w[better]]
        bp_geom[0][xdst[w[better]]] = w[better].astype(np.int32)

    I, ig, ifm = _insert_plane(S, 0)
    bpI_geom = [ig]
    bpI_fromM = [ifm]
    D = np.full(n, NEG)                                # delete at node 1: unreachable
    bpD_fromM = [np.ones(n, bool)]

    E = S.copy()                                       # best ending score per cursor
    jend = np.zeros(n, np.int64)
    for j in range(1, M):
        # --- delete plane for this layer (state advances, cursor stays):
        # D_j[c] = max(M_{j-1}[c] + t_MD[j], D_{j-1}[c] + t_DD[j])
        with np.errstate(invalid="ignore"):
            d_from_m = S + tmd[j]
            d_from_d = D + tdd[j]
        newD = np.maximum(d_from_m, d_from_d)
        bpD_fromM.append(d_from_m >= d_from_d)
        # --- source pool at each cursor: best of M/I/D at layer j-1
        with np.errstate(invalid="ignore"):
            pm = S + tmm[j]
            pi_ = I + tim[j]
            pd = D + tdm[j]
        preM = np.maximum(np.maximum(pm, pi_), pd)
        src_code = np.where(
            pm >= np.maximum(pi_, pd), np.uint8(0),
            np.where(pi_ >= pd, np.uint8(1), np.uint8(2)),
        )
        with np.errstate(invalid="ignore"):
            cont = np.where(has_pred, preM[pred], NEG)
        start = np.where(valid, entry, NEG)
        fresh = start > cont          # ties keep continuation (viterbi_score parity)
        base_scr = np.where(fresh, start, cont) + np.where(valid, lo[j][sym], NEG)
        geom = np.full(n, -1, np.int32)
        srcp = np.where(
            fresh, np.uint8(3),
            np.where(has_pred, src_code[np.maximum(pred, 0)], np.uint8(3)),
        )
        if len(xdst):
            with np.errstate(invalid="ignore"):
                xc = np.maximum(preM[xsrc], entry) + lo[j][xaa]
            w = _grouped_best(xc)
            better = xc[w] > base_scr[xdst[w]]
            wb = w[better]
            base_scr[xdst[wb]] = xc[wb]
            geom[xdst[wb]] = wb.astype(np.int32)
            srcp[xdst[wb]] = np.where(
                entry >= preM[xsrc[wb]], np.uint8(3), src_code[xsrc[wb]]
            )
        S = base_scr
        bp_geom.append(geom)
        bp_src.append(srcp)
        I, ig, ifm = _insert_plane(S, j)
        bpI_geom.append(ig)
        bpI_fromM.append(ifm)
        D = newD
        upd = S > E
        E[upd] = S[upd]
        jend[upd] = j

    # ------- collect hits: best ending per edge, traceback, dedup ---------
    if not np.any(E >= score_threshold):
        return []
    # best cursor per ending edge (avoid 50 adjacent cursors of one hit)
    good = np.flatnonzero(E >= score_threshold)
    order = good[np.lexsort((-E[good], cs.edge_row[good]))]
    first = np.ones(len(order), bool)
    first[1:] = cs.edge_row[order[1:]] != cs.edge_row[order[:-1]]
    cands = order[first]
    cands = cands[np.argsort(-E[cands], kind="stable")]

    def _consume(c: int, gm: int, out: list[int]) -> int:
        """Append the cursor(s) consumed at c (codon triple for amino) and
        return the predecessor cursor."""
        if gm >= 0:                                    # junction extra
            if amino:
                out.extend([c, int(xm2[gm]), int(xm1[gm])])
            else:
                out.append(c)
            return int(xsrc[gm])
        if amino:
            out.extend([c, c - 1, c - 2])
        else:
            out.append(c)
        return c - step

    def _traceback(c: int) -> list[int]:
        """Consumed cursors of the best alignment ending at cursor c,
        walking the M/I/D planes (match: state+cursor advance; insert:
        cursor-only; delete: state-only)."""
        j = int(jend[c])
        out: list[int] = []
        plane = 0                                      # start at the match exit
        guard = 10 * M + 10 * max_insert_run * M + 1000
        while guard > 0:
            guard -= 1
            if plane == 0:
                nxt = _consume(c, int(bp_geom[j][c]), out)
                src = int(bp_src[j][c])
                if src == 3 or j == 0:
                    break
                plane = src                            # 0=M 1=I 2=D at layer j-1
                c, j = nxt, j - 1
            elif plane == 1:                           # insert after node j+1
                nxt = _consume(c, int(bpI_geom[j][c]), out)
                if bpI_fromM[j][c]:
                    plane = 0                          # M at the SAME layer j —
                    # but M_j at cursor nxt was already counted when we came
                    # FROM it; the M traceback below will consume nxt itself
                c = nxt
            else:                                      # delete: no emission
                if j == 0:
                    break
                if bpD_fromM[j][c]:
                    plane = 0
                j -= 1
        out.reverse()
        return out

    hits: list[HMMHit] = []
    kept_sets: list[set[int]] = []
    for c in cands[: top * 6]:
        cursors = _traceback(int(c))
        rows = cs.edge_row[np.asarray(cursors, np.int64)]
        epath = [int(cs.eids[rows[0]])]
        for r in rows[1:]:
            e = int(cs.eids[r])
            if e != epath[-1]:
                epath.append(e)
        eset = set(epath)
        conj_eset = {int(g.e_conj[e]) for e in epath}
        if any(ks <= eset or ks <= conj_eset for ks in kept_sets):
            continue
        seq = dna.decode(g.seq_pool[
            g.e_off[cs.eids[cs.edge_row[cursors]]] + cs.offset[cursors]
        ].astype(np.uint8))
        hits.append(HMMHit(path=epath, score=float(E[c]), seq=seq, frame=0))
        kept_sets.append(eset)
        if len(hits) >= top:
            break
    hits.sort(key=lambda h: (-h.score, len(h.path)))
    return hits
