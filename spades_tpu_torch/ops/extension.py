"""Extension index: de Bruijn graph as canonical k-mers + 4-bit in/out masks.

Capability mirror of SPAdes' `DeBruijnExtensionIndex`
(`src/common/kmer_index/extension_index/kmer_extension_index.hpp:62`, built
from (k+1)-mers in `kmer_extension_index_builder.hpp:83-108`): for every
canonical k-mer a 4-bit mask of incoming and one of outgoing nucleotides.
The k-mer "index" is the lexicographically sorted unique array (dense idx ==
array position); the build is a vectorized pass over unique (k+1)-mers:

  for canonical (k+1)-mer s:
    prefix  P = s[:k]  gains out-bit s[k]   (stored on canonical(P); if P is
                       stored reverse-complemented the bit lands in the IN
                       mask as comp(s[k]))
    suffix  S = s[1:]  gains in-bit s[0]    (same normalization)

Host numpy with the native fast path, as in `spades_tpu.ops.extension`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core import kmers as K
from .count import KmerCounts, RowIndex, _lexsort_rows

NT_COMP = np.array([3, 2, 1, 0], np.uint8)
POPCOUNT4 = np.array([bin(i).count("1") for i in range(16)], np.uint8)


def mask_tail(words: np.ndarray, k: int) -> np.ndarray:
    """Zero all bits beyond base k-1 in a left-aligned (N, W) packed array."""
    W = words.shape[-1]
    used_last = k - 16 * (W - 1)  # bases used in last word, in (0, 16]
    keep = np.uint32(0xFFFFFFFF) << np.uint32(32 - 2 * used_last) if used_last < 16 else np.uint32(0xFFFFFFFF)
    out = words.copy()
    out[..., W - 1] &= keep
    return out


def prefix_kmer(p1words: np.ndarray, k: int) -> np.ndarray:
    """(k+1)-mer -> its first k bases, as (N, kmer_words(k)) uint32."""
    Wk = K.kmer_words(k)
    return mask_tail(p1words[..., :Wk], k)


def suffix_kmer(p1words: np.ndarray, k: int) -> np.ndarray:
    """(k+1)-mer -> its last k bases (shift the register left by one base)."""
    W1 = p1words.shape[-1]
    shifted = (p1words << np.uint32(2))
    shifted[..., : W1 - 1] |= p1words[..., 1:] >> np.uint32(30)
    Wk = K.kmer_words(k)
    return mask_tail(shifted[..., :Wk], k)


def canonicalize(words: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Return (canonical words, was_rc flag)."""
    rc = K.revcomp_words(words, k)
    use_rc = K.lex_less(rc, words)
    return np.where(use_rc[..., None], rc, words), use_rc


@dataclass
class ExtensionIndex:
    """Sorted canonical k-mers + in/out nucleotide masks."""

    k: int
    kmers: np.ndarray     # (U, Wk) uint32, sorted
    in_mask: np.ndarray   # (U,) uint8, bit c set => (k+1)-mer  c·K  exists
    out_mask: np.ndarray  # (U,) uint8, bit c set => (k+1)-mer  K·c  exists
    # Optional inverse of the build sort, one entry per source (k+1)-mer:
    # row + orientation of its canonical prefix/suffix k-mer.  When present
    # (and matching the p1 table passed in), condensation places arcs by
    # direct arithmetic with zero lookups (native/graph.cpp stbr_condense).
    pref_idx: np.ndarray | None = None  # (P,) int64
    suf_idx: np.ndarray | None = None   # (P,) int64
    pref_rc: np.ndarray | None = None   # (P,) uint8
    suf_rc: np.ndarray | None = None    # (P,) uint8
    # search keys of `kmers`, built at the first lookup (the k-mers of an
    # index never change; the clippers look up millions of rows per step)
    _rows: RowIndex | None = field(default=None, init=False, repr=False, compare=False)

    @property
    def num_kmers(self) -> int:
        return int(self.kmers.shape[0])

    def lookup(self, words: np.ndarray) -> np.ndarray:
        """Canonical k-mer rows -> dense index (-1 if absent)."""
        if self._rows is None:
            self._rows = RowIndex(self.kmers)
        return self._rows.find(words)

    def outdeg(self) -> np.ndarray:
        return POPCOUNT4[self.out_mask]

    def indeg(self) -> np.ndarray:
        return POPCOUNT4[self.in_mask]

    # -- mask-level deletion API (DeBruijnExtensionIndex::DeleteOutgoing /
    # DeleteIncoming / IsolateVertex, kmer_extension_index.hpp:62) ----------

    def isolate(self, rows: np.ndarray) -> None:
        """Clear both masks of the given canonical rows (IsolateVertex)."""
        from .early_clip import isolate_rows

        isolate_rows(self, rows)

    def delete_outgoing(self, idx: np.ndarray, o: np.ndarray, c: np.ndarray) -> None:
        """Batched DeleteOutgoing in the directed (row, orient) view."""
        from .early_clip import delete_out_dir

        delete_out_dir(self, idx, o, c)

    def delete_incoming(self, idx: np.ndarray, o: np.ndarray, c: np.ndarray) -> None:
        """Batched DeleteIncoming in the directed (row, orient) view."""
        from .early_clip import delete_in_dir

        delete_in_dir(self, idx, o, c)


def build_extension_index(p1: KmerCounts) -> ExtensionIndex:
    """Build the extension index from unique canonical (k+1)-mers.

    Native fast path (`native/graph.cpp stbr_build_ext`) radix-sorts the
    prefix/suffix contributions and keeps the inverse indices; the numpy
    fallback below computes identical masks (without inverses)."""
    k = p1.k - 1
    if k % 2 == 0:
        raise ValueError(f"k must be odd (got k={k})")
    s = p1.words
    n = s.shape[0]
    if n > 0:
        from ..native import build_ext_native

        nat = build_ext_native(s, k)
        if nat is not None:
            kmers, in_mask, out_mask, pref_idx, pref_rc, suf_idx, suf_rc = nat
            return ExtensionIndex(
                k=k, kmers=kmers, in_mask=in_mask, out_mask=out_mask,
                pref_idx=pref_idx, pref_rc=pref_rc,
                suf_idx=suf_idx, suf_rc=suf_rc,
            )
    if n == 0:
        Wk = K.kmer_words(k)
        return ExtensionIndex(
            k=k,
            kmers=np.zeros((0, Wk), np.uint32),
            in_mask=np.zeros(0, np.uint8),
            out_mask=np.zeros(0, np.uint8),
        )
    last = K.base_at(s, k, p1.k).astype(np.uint8)   # s[k]
    first = K.base_at(s, 0, p1.k).astype(np.uint8)  # s[0]

    pref, pref_rc = canonicalize(prefix_kmer(s, k), k)
    suf, suf_rc = canonicalize(suffix_kmer(s, k), k)

    # prefix contribution: out-bit last  (or in-bit comp(last) when stored rc)
    # suffix contribution: in-bit first  (or out-bit comp(first) when stored rc)
    contrib_kmers = np.concatenate([pref, suf], axis=0)
    out_bits = np.zeros(2 * n, np.uint8)
    in_bits = np.zeros(2 * n, np.uint8)
    out_bits[:n] = np.where(pref_rc, 0, np.uint8(1) << last)
    in_bits[:n] = np.where(pref_rc, np.uint8(1) << NT_COMP[last], 0)
    in_bits[n:] = np.where(suf_rc, 0, np.uint8(1) << first)
    out_bits[n:] = np.where(suf_rc, np.uint8(1) << NT_COMP[first], 0)

    order = _lexsort_rows(contrib_kmers)
    ck = contrib_kmers[order]
    ob, ib = out_bits[order], in_bits[order]
    new = np.concatenate([[True], np.any(ck[1:] != ck[:-1], axis=1)])
    seg = np.cumsum(new) - 1
    u = int(seg[-1]) + 1 if len(seg) else 0
    out_mask = np.zeros(u, np.uint8)
    in_mask = np.zeros(u, np.uint8)
    np.bitwise_or.at(out_mask, seg, ob)
    np.bitwise_or.at(in_mask, seg, ib)
    return ExtensionIndex(k=k, kmers=ck[new], in_mask=in_mask, out_mask=out_mask)
