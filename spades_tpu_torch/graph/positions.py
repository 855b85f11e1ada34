"""Edge position tracking (developer mode).

Capability mirror of the reference's `EdgesPositionHandler`
(SPAdes `src/common/assembly_graph/handlers/edges_position_handler.hpp`):
label every graph edge with the reference-sequence intervals it spells, so
developer-mode pictures/stats can say "edge 17 = genome[12400..13100]".

Redesign (the JAX package's): the reference keeps positions consistent
through every mutation via the ObservableGraph event bus; here positions
are RECOMPUTED against any graph state with one anchor-mapping pass.
`fill_positions` maps every k-window of each named reference sequence
through the edge index and run-length collapses consecutive hits into
intervals.  On the device (`device=`, default the CUDA card): the index is
extracted and sorted there from the graph's pool (`build_index_device`, no
host index), each sequence's windows come from the canonical-windows kernel
in rows of `ROW_BASES` bases overlapping by k - 1 and are searched there
(`device_searchsorted_rows`); the run collapse stays on the host.  A
sequence holding a letter other than ACGT and acgt packs as the JAX
package's host loop packs it (`core/kmers.py:loop_window_keys`), so the
intervals, strands and order are the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..core import dna
from .graph import CondensedGraph

# bases per row of a sequence's windows (a multiple of 8), and rows per batch
ROW_BASES = 4096
ROWS_PER_BATCH = 4096


@dataclass
class EdgePosition:
    name: str          # reference sequence name
    ref_start: int     # interval on the reference (0-based, half open)
    ref_end: int
    edge_start: int    # matching interval on the edge
    edge_end: int
    strand: int        # 0 = edge spells ref forward, 1 = reverse complement

    def __str__(self) -> str:  # the reference's "ref: [a, b] --> edge [c, d]"
        s = "+" if self.strand == 0 else "-"
        return (f"{self.name}{s}: [{self.ref_start}, {self.ref_end}) -> "
                f"[{self.edge_start}, {self.edge_end})")


@dataclass
class EdgePositions:
    """edge id -> interval labels (canonical edges; conjugates mirrored)."""

    k: int
    by_edge: dict[int, list[EdgePosition]] = field(default_factory=dict)

    def positions_of(self, e: int) -> list[EdgePosition]:
        return self.by_edge.get(int(e), [])

    def str_of(self, e: int) -> str:
        return "; ".join(str(p) for p in self.positions_of(e))


def _sequence_hits(seq: str, codes: np.ndarray, k: int, prep, dev) -> tuple:
    """Every window of one sequence (and its codes) searched in the device index:
    (ref positions, edge, offset, same strand) of the windows that hit, in
    position order, as host arrays."""
    from ..core import kmers as K
    from ..ops.cuda_kernels import canonical_window_keys
    from ..parallel.sharded_mapping import device_searchsorted_rows

    n = len(codes)
    if (codes >= 4).any():
        keys, valid, use_rc = K.loop_window_keys([seq], k, dev, skip_n=False)
        parts = [(0, keys, valid.reshape(-1), use_rc.reshape(-1))]
    else:
        step = ROW_BASES - k + 1            # windows per row, rows overlap by k - 1
        nrows = (n - k) // step + 1
        seq = torch.from_numpy(codes).to(dev)
        j = torch.arange(ROW_BASES, dtype=torch.int64, device=dev)
        shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=dev)
        parts = []
        for r0 in range(0, nrows, ROWS_PER_BATCH):
            rows = torch.arange(r0, min(r0 + ROWS_PER_BATCH, nrows), dtype=torch.int64,
                                device=dev) * step
            c = seq[(rows[:, None] + j).clamp_(max=n - 1)]
            pc = (c.reshape(-1, ROW_BASES // 4, 4) << shifts).sum(dim=2, dtype=torch.uint8)
            pn = torch.zeros((pc.shape[0], ROW_BASES // 8), dtype=torch.uint8, device=dev)
            lengths = (n - rows).clamp_(max=ROW_BASES).to(torch.int32)
            keys, valid, use_rc = canonical_window_keys(pc, pn, lengths, ROW_BASES, k,
                                                        strand=True)
            parts.append((r0 * step, keys, valid.reshape(-1), use_rc.reshape(-1)))
    index_keys, index_edge, index_off, index_strand = prep[:4]
    out = []
    for p0, keys, valid, use_rc in parts:
        # window i of a part lies at p0 + i: rows of `step` windows tile the sequence
        idx = device_searchsorted_rows(index_keys, keys)
        hit = torch.nonzero((idx >= 0) & valid).reshape(-1)
        at = idx[hit].to(torch.int64)
        out.append((hit + p0, index_edge[at], index_off[at],
                    use_rc[hit].to(torch.int32) == index_strand[at]))
    return tuple(torch.cat([o[i] for o in out]).cpu().numpy().astype(
        np.int64 if i < 3 else bool) for i in range(4))


def fill_positions(
    g: CondensedGraph, named_seqs: dict[str, str], k: int | None = None, device=None,
) -> EdgePositions:
    """Anchor every k-window of each named sequence onto the graph edges and
    collapse runs into intervals (the handler's AddEdgePosition stream, one
    device pass per sequence).  device: None means the CUDA card."""
    from ..parallel.sharded_mapping import build_index_device

    dev = resolve_device(device)
    k = k or g.k
    prep = build_index_device(g, k, dev)
    out = EdgePositions(k=k)
    for name, seq in named_seqs.items():
        codes = dna.encode(seq)
        n = len(codes) - k + 1
        if n <= 0 or prep[1].shape[0] == 0:
            continue
        pos, e, off, same = _sequence_hits(seq, codes, k, prep, dev)
        if pos.size == 0:
            continue
        # orient onto the canonical edge: forward hits advance offset with
        # ref position; reverse hits decrease it
        runs_break = np.ones(pos.size, bool)
        if pos.size > 1:
            contig_ref = pos[1:] == pos[:-1] + 1
            same_edge = e[1:] == e[:-1]
            fwd_step = same[1:] & same[:-1] & (off[1:] == off[:-1] + 1)
            rev_step = ~same[1:] & ~same[:-1] & (off[1:] == off[:-1] - 1)
            runs_break[1:] = ~(contig_ref & same_edge & (fwd_step | rev_step))
        starts = np.flatnonzero(runs_break)
        ends = np.append(starts[1:], pos.size)
        for a, b in zip(starts, ends):
            ref_s = int(pos[a])
            ref_e = int(pos[b - 1]) + k
            if same[a]:
                es, ee = int(off[a]), int(off[b - 1]) + k
                strand = 0
            else:
                es, ee = int(off[b - 1]), int(off[a]) + k
                strand = 1
            ep = EdgePosition(name, ref_s, ref_e, es, ee, strand)
            out.by_edge.setdefault(int(e[a]), []).append(ep)
    return out
