"""Graph condensation: extension index -> condensed de Bruijn graph.

Replaces SPAdes' sequential `UnbranchingPathExtractor` +
`FastGraphFromSequencesConstructor`
(`src/common/assembly_graph/construction/debruijn_graph_constructor.hpp:184,412,574`).
When the index carries the inverse indices of its native build, the whole
condensation runs in C++ (`native/graph.cpp stbr_condense`).  Otherwise the
vectorized formulation of `spades_tpu.ops.condense` runs:

1. expand canonical k-mers into 2U oriented nodes and mask bits into the arc
   list (one arc per oriented (k+1)-mer);
2. link arc a -> next arc through its destination node when that node is
   unbranching (outdeg == indeg == 1);
3. cut perfect cycles at their minimum arc, then rank every arc in its chain
   by pointer doubling (Wyllie) — in PyTorch on the run's device;
4. maximal chains are the condensed edges: materialize their sequences, pair
   each with its reverse-complement conjugate, emit junction vertices.

`condense_device` runs the same formulation on the card from the device
index's inverse indices: every (k+1)-mer row places its arc and its
reverse-complement arc by arithmetic, so no step looks a k-mer up, and only
the graph's arrays cross to the host.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core import kmers as K
from ..graph.graph import CondensedGraph
from .count import KmerCounts, _words_of_keys, searchsorted_rows
from .extension import POPCOUNT4, DeviceExtensionIndex, ExtensionIndex, canonicalize, mask_tail

# 4-bit mask reversal: MASK_REV4[m] has bit (3-c) set iff m has bit c.
MASK_REV4 = np.array(
    [sum(1 << (3 - c) for c in range(4) if m & (1 << c)) for m in range(16)], np.uint8
)


def _shift_in_base(words: np.ndarray, nt: np.ndarray, k: int) -> np.ndarray:
    """node k-mer -> successor k-mer: drop base 0, append base `nt`."""
    W = words.shape[-1]
    out = (words << np.uint32(2)).astype(np.uint32)
    out[..., : W - 1] |= words[..., 1:] >> np.uint32(30)
    # clear tail beyond k-1 bases, then set base k-1 = nt
    out = mask_tail(out, k)
    w, jj = divmod(k - 1, 16)
    out[..., w] |= nt.astype(np.uint32) << np.uint32(30 - 2 * jj)
    return out


def _set_base(words: np.ndarray, j: int, nt: np.ndarray, k: int) -> np.ndarray:
    w, jj = divmod(j, 16)
    out = words.copy()
    out[..., w] |= nt.astype(np.uint32) << np.uint32(30 - 2 * jj)
    return out


def _doubling_rounds(n: int) -> int:
    return max(1, int(np.ceil(np.log2(max(n, 2)))) + 1)


def _rank_chains(nxt: torch.Tensor, prv: torch.Tensor, rounds: int):
    """Cycle detection, a cycle cut before each cycle's minimum arc, and
    Wyllie list ranking, by pointer doubling on the tensors' device.

    nxt/prv: (A,) successor / predecessor arc (int32 or int64), -1 at chain
    ends.  Returns (pos, head) in their dtype: each arc's rank in its chain
    and the chain's first arc."""
    A = nxt.shape[0]
    idx = torch.arange(A, dtype=nxt.dtype, device=nxt.device)
    # done[a] <=> walking prv from a terminates (a is not on a cycle)
    parent = torch.where(prv >= 0, prv, idx)
    done = prv < 0
    for _ in range(rounds):
        done = done | done.index_select(0, parent)
        parent = parent.index_select(0, parent)
    in_cycle = ~done
    del parent, done
    if bool(in_cycle.any()):
        m = idx
        q = torch.where(nxt >= 0, nxt, idx)
        for _ in range(rounds):
            m = torch.minimum(m, m.index_select(0, q))
            q = q.index_select(0, q)
        # cut each cycle before its minimum arc
        prv = torch.where(in_cycle & (m == idx), -1, prv)
        del m, q
    del in_cycle
    parent = torch.where(prv >= 0, prv, idx)
    pos = (prv >= 0).to(nxt.dtype)
    for _ in range(rounds):
        pos = pos + pos.index_select(0, parent)
        parent = parent.index_select(0, parent)
    return pos, parent


def _rank_chains_device(nxt: np.ndarray, prv: np.ndarray, rounds: int, device):
    """`_rank_chains` of host (A,) int64 arrays on `device`; returns
    (pos, head) int64 numpy."""
    pos, head = _rank_chains(torch.from_numpy(nxt).to(device),
                             torch.from_numpy(prv).to(device), rounds)
    return pos.cpu().numpy(), head.cpu().numpy()


def _empty_graph(k: int) -> CondensedGraph:
    """The graph of an index without arcs."""
    z = np.zeros(0, np.int64)
    return CondensedGraph(k=k, e_start=z, e_end=z.copy(), e_conj=z.copy(), e_off=z.copy(),
                          e_len=z.copy(), e_cov=np.zeros(0, np.float64),
                          alive=np.zeros(0, bool), seq_pool=np.zeros(0, np.uint8),
                          v_conj=z.copy())


def condense(index: ExtensionIndex, p1: KmerCounts | None = None,
             device=None) -> CondensedGraph:
    """Build the condensed conjugate graph from an extension index.

    p1: the (k+1)-mer counts used for per-edge coverage sums (optional).
    device: where the chain ranking of the vectorized path runs.

    Native fast path: when the index carries the inverse indices of its
    build sort and the matching p1 table is given, the whole condensation
    runs in C++ with zero k-mer lookups and O(A) sequential chain walks.
    """
    if (
        p1 is not None
        and index.pref_idx is not None
        and index.pref_idx.shape[0] == p1.num_unique
        and index.num_kmers > 0
    ):
        from ..native import condense_native

        nat = condense_native(
            index.kmers, index.in_mask, index.out_mask, index.k,
            p1.words, p1.counts,
            index.pref_idx, index.pref_rc, index.suf_idx, index.suf_rc,
        )
        if nat is not None:
            e_start, e_end, e_conj, e_off, e_len, e_cov, seq_pool, v_conj = nat
            return CondensedGraph(
                k=index.k,
                e_start=e_start, e_end=e_end, e_conj=e_conj,
                e_off=e_off, e_len=e_len, e_cov=e_cov,
                alive=np.ones(e_start.shape[0], bool),
                seq_pool=seq_pool, v_conj=v_conj,
            )
    dev = resolve_device(device)
    k = index.k
    U = index.num_kmers
    Wk = index.kmers.shape[-1]

    # ---- oriented nodes ------------------------------------------------
    # node 2i = stored (canonical) orientation, node 2i+1 = reverse complement
    omask = np.empty(2 * U, np.uint8)
    imask = np.empty(2 * U, np.uint8)
    omask[0::2] = index.out_mask
    omask[1::2] = MASK_REV4[index.in_mask]
    imask[0::2] = index.in_mask
    imask[1::2] = MASK_REV4[index.out_mask]
    node_outdeg = POPCOUNT4[omask]
    node_indeg = POPCOUNT4[imask]

    rc_kmers = K.revcomp_words(index.kmers, k)
    node_words = np.empty((2 * U, Wk), np.uint32)
    node_words[0::2] = index.kmers
    node_words[1::2] = rc_kmers
    # first base of every oriented node (for conjugate arc resolution)
    node_fb = np.empty(2 * U, np.uint8)
    node_fb[0::2] = K.base_at(index.kmers, 0, k).astype(np.uint8)
    node_fb[1::2] = 3 - K.base_at(index.kmers, k - 1, k).astype(np.uint8)

    # ---- arcs (one per oriented (k+1)-mer) ----------------------------
    bits = (omask[:, None] >> np.arange(4, dtype=np.uint8)[None, :]) & 1
    arc_src, arc_nt = np.nonzero(bits)  # row-major: sorted by (node, nt)
    arc_src = arc_src.astype(np.int64)
    arc_nt = arc_nt.astype(np.uint8)
    A = arc_src.shape[0]
    node_arc_start = np.concatenate([[0], np.cumsum(node_outdeg)]).astype(np.int64)

    if A == 0:
        return _empty_graph(k)

    # destination nodes
    succ_words = _shift_in_base(node_words[arc_src], arc_nt, k)
    succ_canon, succ_rc = canonicalize(succ_words, k)
    succ_idx = searchsorted_rows(index.kmers, succ_canon)
    if np.any(succ_idx < 0):
        raise ValueError("dangling (k+1)-mer suffix: extension index inconsistent")
    arc_dst = 2 * succ_idx + succ_rc.astype(np.int64)

    # arc coverage = count of the canonical (k+1)-mer  node_seq + nt
    if p1 is not None:
        p1w = _set_base(node_words[arc_src], k, arc_nt, k + 1)
        p1c, _ = canonicalize(p1w, k + 1)
        cidx = searchsorted_rows(p1.words, p1c)
        if np.any(cidx < 0):
            raise ValueError("arc (k+1)-mer missing from counts")
        arc_cov = p1.counts[cidx].astype(np.float64)
    else:
        arc_cov = np.ones(A, np.float64)

    # ---- chain links ---------------------------------------------------
    nxt = np.full(A, -1, np.int64)
    link_ok = (node_outdeg[arc_dst] == 1) & (node_indeg[arc_dst] == 1)
    nxt[link_ok] = node_arc_start[arc_dst[link_ok]]
    prv = np.full(A, -1, np.int64)
    valid_n = nxt >= 0
    prv[nxt[valid_n]] = np.flatnonzero(valid_n)

    pos, head = _rank_chains_device(nxt, prv, _doubling_rounds(A), dev)

    # ---- edges ---------------------------------------------------------
    uheads, edge_of_arc = np.unique(head, return_inverse=True)
    E = uheads.shape[0]
    n_arcs = np.zeros(E, np.int64)
    np.maximum.at(n_arcs, edge_of_arc, pos + 1)
    e_len = n_arcs + k
    e_off = np.concatenate([[0], np.cumsum(e_len)])[:-1].astype(np.int64)
    e_cov = np.zeros(E, np.float64)
    np.add.at(e_cov, edge_of_arc, arc_cov)

    # sequences: k-prefix from head's source node, then one nt per arc
    seq_pool = np.zeros(int(e_len.sum()), np.uint8)
    head_src = arc_src[uheads]
    prefix_codes = K.unpack(node_words[head_src], k)  # (E, k)
    pre_pos = (e_off[:, None] + np.arange(k)[None, :]).ravel()
    seq_pool[pre_pos] = prefix_codes.ravel()
    seq_pool[e_off[edge_of_arc] + k + pos] = arc_nt

    # endpoints
    tail_arc = np.zeros(E, np.int64)
    is_tail = pos == (n_arcs[edge_of_arc] - 1)
    tail_arc[edge_of_arc[is_tail]] = np.flatnonzero(is_tail)
    start_node = head_src
    end_node = arc_dst[tail_arc]

    # ---- conjugate pairing --------------------------------------------
    # rc of arc (n -c-> m) is the arc (m^1 -comp(fb(n))-> n^1)
    rc_src = arc_dst ^ 1
    rc_nt = (3 - node_fb[arc_src]).astype(np.uint8)
    if not np.all((omask[rc_src] >> rc_nt) & 1 == 1):
        raise ValueError("conjugate arc missing: extension index inconsistent")
    below = omask[rc_src] & ((np.uint8(1) << rc_nt) - 1)
    rc_arc = node_arc_start[rc_src] + POPCOUNT4[below]
    e_conj = edge_of_arc[rc_arc[tail_arc]]
    if not np.array_equal(e_conj[e_conj], np.arange(E)):
        raise ValueError("edge conjugation is not an involution")

    # ---- vertices ------------------------------------------------------
    end_nodes = np.concatenate([start_node, end_node])
    vnodes = np.unique(np.concatenate([end_nodes, end_nodes ^ 1]))
    node2v = -np.ones(2 * U, np.int64)
    node2v[vnodes] = np.arange(vnodes.shape[0])
    v_conj = node2v[vnodes ^ 1]
    e_start = node2v[start_node]
    e_end = node2v[end_node]

    return CondensedGraph(
        k=k,
        e_start=e_start, e_end=e_end, e_conj=e_conj,
        e_off=e_off, e_len=e_len, e_cov=e_cov,
        alive=np.ones(E, bool), seq_pool=seq_pool,
        v_conj=v_conj,
    )


def condense_device(index: DeviceExtensionIndex, counts=None) -> CondensedGraph:
    """The condensed graph of a device extension index, on its device: the
    graph `stbr_condense` makes, array for array.

    counts: the (k+1)-mer table's counts (host array or tensor, one per row
    of the index's inverse indices) for the edges' coverage sums; None
    counts each arc once.  Arcs are numbered by (oriented node, base) as in
    `condense`; each row gives its arc src -s[k]-> dst, with src and dst
    its prefix's and suffix's oriented nodes, and the reverse-complement
    arc dst^1 -comp(s[0])-> src^1 (the same arc for a palindrome)."""
    dev = index.kmers.device
    k = index.k
    U = index.num_kmers
    P = int(index.pref_idx.shape[0])
    it = torch.int32 if 2 * max(U, P) + 1 < 2**31 else torch.int64
    rev4 = torch.as_tensor(MASK_REV4, device=dev)
    pop4 = torch.as_tensor(POPCOUNT4, device=dev)

    # ---- oriented nodes: 2i canonical row i, 2i+1 its reverse complement
    om = torch.stack([index.out_mask, rev4[index.in_mask.int()]], 1).reshape(-1)
    im = torch.stack([index.in_mask, rev4[index.out_mask.int()]], 1).reshape(-1)
    outdeg = pop4[om.int()]
    unbr = (outdeg == 1) & (pop4[im.int()] == 1)
    del im
    nas = torch.zeros(2 * U + 1, dtype=it, device=dev)
    nas[1:] = torch.cumsum(outdeg, 0, dtype=it)
    del outdeg
    A = int(nas[-1])
    if A == 0:
        return _empty_graph(k)

    def row_arcs(rows=None):
        """(forward arc, rc arc, src node, dst node) of the given rows (all
        when None), with the two arcs' bases."""
        def pick(t):
            return t if rows is None else t.index_select(0, rows)
        src = 2 * pick(index.pref_idx).to(it) + pick(index.pref_rc)
        dst = 2 * pick(index.suf_idx).to(it) + pick(index.suf_rc)
        nt1 = pick(index.last).to(it)
        nt2 = 3 - pick(index.first).to(it)
        fwd = nas[src] + pop4[om[src].to(it) & ((1 << nt1) - 1)]
        rca = nas[dst ^ 1] + pop4[om[dst ^ 1].to(it) & ((1 << nt2) - 1)]
        return fwd, rca, src, dst, nt1, nt2

    # ---- arcs: each row places its one or two, and their chain links
    fwd, rca, src, dst, nt1, nt2 = row_arcs()
    n_pal = int((fwd == rca).sum())
    if 2 * P - n_pal != A:
        raise ValueError("extension index inconsistent: masks and rows disagree")
    rows = torch.arange(P, dtype=it, device=dev)
    arc_row = torch.empty(A, dtype=it, device=dev)
    arc_row[fwd] = rows
    arc_row[rca] = rows
    arc_nt = torch.empty(A, dtype=torch.uint8, device=dev)
    arc_nt[fwd] = nt1.to(torch.uint8)
    arc_nt[rca] = nt2.to(torch.uint8)
    # the successor of an arc into an unbranching node is that node's only arc
    nxt = torch.empty(A, dtype=it, device=dev)
    nxt[fwd] = torch.where(unbr[dst], nas[dst], -1)
    nxt[rca] = torch.where(unbr[src ^ 1], nas[src ^ 1], -1)
    del fwd, rca, src, dst, nt1, nt2, rows, unbr
    linked = nxt >= 0
    prv = torch.full((A,), -1, dtype=it, device=dev)
    prv[nxt[linked]] = torch.nonzero(linked).squeeze(1).to(it)
    del linked

    pos, head = _rank_chains(nxt, prv, _doubling_rounds(A))
    del prv

    # ---- edges: chains in ascending head-arc order
    is_head = pos == 0
    heads = torch.nonzero(is_head).squeeze(1)
    E = int(heads.shape[0])
    edge_of_arc = (torch.cumsum(is_head, 0, dtype=it) - 1).index_select(0, head)
    del is_head, head
    # a chain's tail: its arc ends the list, or leads to a cut cycle's head
    is_tail = (nxt < 0) | (pos.index_select(0, nxt.clamp(min=0)) == 0)
    tails = torch.nonzero(is_tail).squeeze(1)
    del is_tail, nxt
    tail_edge = edge_of_arc[tails].long()
    tail_arc = torch.empty(E, dtype=torch.int64, device=dev)
    tail_arc[tail_edge] = tails
    e_len = torch.empty(E, dtype=torch.int64, device=dev)
    e_len[tail_edge] = pos[tails].long() + 1 + k
    e_off = torch.cumsum(e_len, 0) - e_len
    if counts is None:
        e_cov = (e_len - k).to(torch.float64)
    else:
        cnt = torch.as_tensor(counts, device=dev).to(torch.int64)
        e_cov = torch.zeros(E, dtype=torch.int64, device=dev).index_add_(
            0, edge_of_arc, cnt.index_select(0, arc_row)).to(torch.float64)
        del cnt

    # ---- sequences: the head's source k-mer, then one base per arc
    pool = torch.empty(int(e_off[-1] + e_len[-1]), dtype=torch.uint8, device=dev)
    pool[e_off.index_select(0, edge_of_arc) + k + pos] = arc_nt
    del arc_nt, pos
    start_node = torch.searchsorted(nas, heads.to(it), right=True) - 1
    rc = (start_node & 1).bool()
    words = _words_of_keys(index.kmers.index_select(1, start_node >> 1), K.kmer_words(k))
    for j in range(k):
        fb = (words[:, j // 16] >> (30 - 2 * (j % 16))) & 3
        jr = k - 1 - j
        rb = 3 - ((words[:, jr // 16] >> (30 - 2 * (jr % 16))) & 3)
        pool[e_off + j] = torch.where(rc, rb, fb).to(torch.uint8)
    del words, rc

    # ---- endpoints and conjugates, from the tail arc's row
    fwd, rca, src, dst, _, _ = row_arcs(arc_row.index_select(0, tail_arc))
    is_fwd = fwd == tail_arc
    end_node = torch.where(is_fwd, dst, src ^ 1).long()
    e_conj = edge_of_arc.index_select(0, torch.where(is_fwd, rca, fwd)).long()
    if not torch.equal(e_conj[e_conj], torch.arange(E, device=dev)):
        raise ValueError("edge conjugation is not an involution")

    # ---- vertices: endpoint nodes and their conjugates, in node order
    ends = torch.cat([start_node, end_node])
    vnodes = torch.unique(torch.cat([ends, ends ^ 1]))

    def host(t, dtype):
        return t.cpu().numpy().astype(dtype, copy=False)

    return CondensedGraph(
        k=k,
        e_start=host(torch.searchsorted(vnodes, start_node), np.int64),
        e_end=host(torch.searchsorted(vnodes, end_node), np.int64),
        e_conj=host(e_conj, np.int64), e_off=host(e_off, np.int64),
        e_len=host(e_len, np.int64), e_cov=host(e_cov, np.float64),
        alive=np.ones(E, bool), seq_pool=host(pool, np.uint8),
        v_conj=host(torch.searchsorted(vnodes, vnodes ^ 1), np.int64),
    )
