"""Graph condensation: extension index -> condensed de Bruijn graph.

Replaces SPAdes' sequential `UnbranchingPathExtractor` +
`FastGraphFromSequencesConstructor`
(`src/common/assembly_graph/construction/debruijn_graph_constructor.hpp:184,412,574`).
Two implementations give the same graph, array for array:

- `condense_device`, in torch on the index's device (a card, or CPU
  tensors): every (k+1)-mer row of the index's inverse indices places its
  arc and its reverse-complement arc by arithmetic, chains are ranked by
  pointer doubling (Wyllie, cycles cut before their minimum arc), and only
  the graph's arrays cross to the host;
- `native/graph.cpp stbr_condense` on the host, for a host index that
  carries the inverse indices of its table.

`condense` takes any index and chooses: a device index condenses on its
device, a host index natively where it can, and otherwise through the torch
pair from the (k+1)-mers its masks hold (`_rows_of_masks`), which serves a
masks-only index (the sharded build, JAX state) and a clipped one alike.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core import kmers as K
from ..graph.graph import CondensedGraph
from .count import KmerCounts, _words_of_keys, searchsorted_rows
from .extension import (POPCOUNT4, DeviceExtensionIndex, ExtensionIndex,
                        build_extension_index_device, keys_of_words, keys_to_device,
                        revcomp_words_t)

# 4-bit mask reversal: MASK_REV4[m] has bit (3-c) set iff m has bit c.
MASK_REV4 = np.array(
    [sum(1 << (3 - c) for c in range(4) if m & (1 << c)) for m in range(16)], np.uint8
)


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


def _empty_graph(k: int) -> CondensedGraph:
    """The graph of an index without arcs."""
    z = np.zeros(0, np.int64)
    return CondensedGraph(k=k, e_start=z, e_end=z.copy(), e_conj=z.copy(), e_off=z.copy(),
                          e_len=z.copy(), e_cov=np.zeros(0, np.float64),
                          alive=np.zeros(0, bool), seq_pool=np.zeros(0, np.uint8),
                          v_conj=z.copy())


def _rows_of_masks(index: ExtensionIndex, dev) -> torch.Tensor:
    """The canonical (k+1)-mers an index's masks hold, as (P, W1) int64-held
    words on `dev`.  Each set out-bit c of k-mer u is the (k+1)-mer u·c and
    each set in-bit c is c·u; every row s sets two such bits, one for its
    prefix and one for its suffix, each spelling s or its reverse
    complement.  The prefix's is the one kept: an out-bit that spells a
    canonical (k+1)-mer, or an in-bit that spells the reverse complement
    of one (a palindrome sets one bit twice).  Out-bits alone would miss
    the rows whose prefix is stored reverse-complemented."""
    k = index.k
    if k % 2 == 0:
        raise ValueError(f"k must be odd (got k={k})")   # so W(k+1) = W(k)
    u = torch.from_numpy(index.kmers.astype(np.int64)).to(dev)
    bases = torch.arange(4, dtype=torch.int64, device=dev)

    def bits(mask):
        return torch.nonzero((torch.from_numpy(mask).to(dev).long()[:, None] >> bases) & 1,
                             as_tuple=True)

    w, j = divmod(k, 16)
    row, c = bits(index.out_mask)
    fwd = u.index_select(0, row)
    fwd[:, w] |= c << (30 - 2 * j)
    fwd = fwd[~K.lex_less(revcomp_words_t(fwd, k + 1), fwd)]
    row, c = bits(index.in_mask)
    v = u.index_select(0, row)
    bwd = v >> 2
    bwd[:, 1:] |= (v[:, :-1] & 3) << 30
    bwd[:, 0] |= c << 30
    rc = revcomp_words_t(bwd, k + 1)
    return torch.cat([fwd, rc[~K.lex_less(bwd, rc)]])


def condense(index: ExtensionIndex | DeviceExtensionIndex, p1: KmerCounts | None = None,
             device=None) -> CondensedGraph:
    """Build the condensed conjugate graph from an extension index.

    p1: the (k+1)-mer counts used for per-edge coverage sums (optional; each
    arc counts once without them).  A device index condenses on its device
    (`condense_device`).  A host index condenses in C++ with zero k-mer
    lookups when the native library loads, the index carries the inverse
    indices of its build and the matching p1 is given; otherwise the torch
    pair runs on `device` (None: the CUDA card; see `resolve_device`) over
    the rows its masks hold, and raises unless those rows spell the index's
    masks exactly, row for row.
    """
    if isinstance(index, DeviceExtensionIndex):
        return condense_device(index, None if p1 is None else p1.counts)
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
    words = _rows_of_masks(index, dev)
    counts = None
    if p1 is not None:
        rows = searchsorted_rows(p1.words, words.cpu().numpy().astype(np.uint32))
        if np.any(rows < 0):
            raise ValueError("arc (k+1)-mer missing from counts")
        counts = p1.counts[rows]
    dix = build_extension_index_device(keys_of_words(words), index.k)
    # the rows must spell the index back: the same k-mers with arcs (a bit
    # without its partner adds or drops a k-mer or a bit) and equal masks
    held = (index.in_mask | index.out_mask) != 0
    if not (torch.equal(dix.kmers, keys_to_device(index.kmers[held], dev))
            and torch.equal(dix.in_mask, torch.from_numpy(index.in_mask[held]).to(dev))
            and torch.equal(dix.out_mask, torch.from_numpy(index.out_mask[held]).to(dev))):
        raise ValueError("extension index inconsistent: its masks are not those of its arcs")
    return condense_device(dix, counts)


def condense_device(index: DeviceExtensionIndex, counts=None) -> CondensedGraph:
    """The condensed graph of a device extension index, on its device: the
    graph `stbr_condense` makes, array for array.

    counts: the (k+1)-mer table's counts (host array or tensor, one per row
    of the index's inverse indices) for the edges' coverage sums; None
    counts each arc once.  Arcs are numbered by (oriented node, base) as in
    `stbr_condense`; each row gives its arc src -s[k]-> dst, with src and dst
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
