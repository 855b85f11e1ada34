"""K-mer substitution map tracking simplification glue events.

Capability mirror of SPAdes' `common/alignment/kmer_mapper.hpp` (KmerMapper
action handler + the packed-k-mer map of `kmer_map.hpp`): when a bulge arm
is glued onto its survivor, every (k+1)-mer of the removed sequence is
remapped to the (k+1)-mer at the uniformly-scaled position of the kept
sequence (RemapKmers), so reads spelling the removed variant still map to
the surviving graph; chains are path-compressed by Normalize().  The same
structure provides the old-k -> new-k projection used across multi-K
iterations.

The map is a pair of packed-row arrays (src sorted, dst parallel) rebuilt
lazily from an append log; Substitute over a read batch is one vectorized
row-binary-search per normalization round.  Host numpy, as in
`spades_tpu.alignment.kmer_mapper`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core import dna
from ..core import kmers as K
from ..ops.count import _lexsort_rows, searchsorted_rows
from ..ops.extension import canonicalize


@dataclass
class KmerMapper:
    """Canonical packed (k+1)-mer -> canonical packed (k+1)-mer substitution map."""

    k: int  # the mapped k-mer size (the reference uses graph k + 1)
    _src: list = field(default_factory=list)
    _dst: list = field(default_factory=list)
    _sorted_src: np.ndarray | None = None
    _sorted_dst: np.ndarray | None = None

    @property
    def size(self) -> int:
        return sum(len(a) for a in self._src)

    def _materialize(self) -> None:
        if self._sorted_src is not None or not self._src:
            return
        src = np.concatenate(self._src)
        dst = np.concatenate(self._dst)
        order = _lexsort_rows(src)
        src, dst = src[order], dst[order]
        # first writer wins (mapping_.count(old_kmer) skip in RemapKmers)
        keep = np.concatenate([[True], np.any(src[1:] != src[:-1], axis=1)])
        self._sorted_src, self._sorted_dst = src[keep], dst[keep]

    def remap_sequences(self, old_seq, new_seq) -> None:
        """RemapKmers: old sequence k-mers -> uniformly-aligned new k-mers.

        Accepts strings or uint8 code arrays."""
        k = self.k
        old_codes = dna.encode(old_seq) if isinstance(old_seq, str) else np.asarray(old_seq, np.uint8)
        new_codes = dna.encode(new_seq) if isinstance(new_seq, str) else np.asarray(new_seq, np.uint8)
        n_old = len(old_codes) - k + 1
        n_new = len(new_codes) - k + 1
        if n_old <= 0 or n_new <= 0:
            return
        old_wins = np.lib.stride_tricks.sliding_window_view(old_codes, k)
        new_wins = np.lib.stride_tricks.sliding_window_view(new_codes, k)
        # UniformPositionAligner: position i of old -> round(i * (n_new-1)/(n_old-1))
        if n_old == 1:
            tgt = np.zeros(1, np.int64)
        else:
            tgt = np.rint(np.arange(n_old) * (n_new - 1) / (n_old - 1)).astype(np.int64)
        old_p = K.pack(np.ascontiguousarray(old_wins))
        new_p = K.pack(np.ascontiguousarray(new_wins[tgt]))
        old_c, _ = canonicalize(old_p, k)
        new_c, _ = canonicalize(new_p, k)
        differ = np.any(old_c != new_c, axis=1)
        if differ.any():
            self._src.append(old_c[differ])
            self._dst.append(new_c[differ])
            self._sorted_src = None

    def substitute(self, words: np.ndarray, max_rounds: int = 8) -> np.ndarray:
        """Apply the substitution map (with chain following) to (N, W) rows."""
        self._materialize()
        if self._sorted_src is None or len(words) == 0:
            return words
        out = words.copy()
        for _ in range(max_rounds):
            idx = searchsorted_rows(self._sorted_src, out)
            hit = idx >= 0
            if not hit.any():
                break
            out[hit] = self._sorted_dst[idx[hit]]
        return out

    def normalize(self) -> None:
        """Path-compress chains (Normalize)."""
        self._materialize()
        if self._sorted_src is None:
            return
        self._sorted_dst = self.substitute(self._sorted_dst)
