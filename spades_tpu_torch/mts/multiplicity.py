"""Multi-sample k-mer multiplicity profiles.

Capability mirror of SPAdes' kmer_multiplicity_counter
(`src/projects/mts/kmer_multiplicity_counter.cpp:217-247`):
per-sample k-mer counts are combined into one table keyed by canonical k-mer,
keeping k-mers that occur with multiplicity >= min_mult in >= min_samples
samples; multiplicities are stored as saturating uint16 (`Mpl`,
`contig_abundance.hpp:19`).

Each sample is counted by the device counting engine (`ops/count.py`,
through the canonical-windows kernel on the card); combining is a sorted
multi-way union over the per-sample sorted unique arrays (vectorized
set-union + gather fill), not a KMC-file merge through temporary disk
records.  The `.npz` layout is `spades_tpu.mts.multiplicity`'s, so either
package loads the other's file.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.count import KmerCounts, _lexsort_rows, count_sequences, searchsorted_rows

MPL_MAX = np.iinfo(np.uint16).max


@dataclass
class KmerProfiles:
    """Sorted canonical k-mers with one multiplicity column per sample."""

    k: int
    words: np.ndarray  # (U, W) uint32, lexicographically sorted
    mpl: np.ndarray    # (U, S) uint16 multiplicity per sample

    @property
    def num_kmers(self) -> int:
        return int(self.words.shape[0])

    @property
    def num_samples(self) -> int:
        return int(self.mpl.shape[1])

    def lookup(self, words: np.ndarray) -> np.ndarray:
        """(N, W) packed k-mers -> (N, S) profiles; absent rows are all-zero."""
        idx = searchsorted_rows(self.words, words)
        out = np.zeros((len(words), self.num_samples), np.uint16)
        hit = idx >= 0
        out[hit] = self.mpl[idx[hit]]
        return out

    def save(self, path: str) -> None:
        np.savez_compressed(path, k=self.k, words=self.words, mpl=self.mpl)

    @classmethod
    def load(cls, path: str) -> "KmerProfiles":
        d = np.load(path)
        return cls(k=int(d["k"]), words=d["words"], mpl=d["mpl"])


def combine_multiplicities(
    samples: list[KmerCounts], min_samples: int = 1, min_mult: int = 5
) -> KmerProfiles:
    """Union per-sample counts into a filtered profile table.

    A k-mer survives if at least `min_samples` samples have it with
    multiplicity >= `min_mult` (FilterCombinedKmers semantics,
    `kmer_multiplicity_counter.cpp:79`)."""
    if not samples:
        raise ValueError("no samples")
    k = samples[0].k
    assert all(s.k == k for s in samples)
    words = np.concatenate([s.words for s in samples])
    if words.shape[0] == 0:
        return KmerProfiles(k, words.reshape(0, samples[0].words.shape[1] if samples[0].words.ndim > 1 else 1), np.zeros((0, len(samples)), np.uint16))
    order = _lexsort_rows(words)
    words = words[order]
    first = np.concatenate([[True], np.any(words[1:] != words[:-1], axis=1)])
    uniq = words[first]

    mpl = np.zeros((uniq.shape[0], len(samples)), np.uint16)
    for s, sample in enumerate(samples):
        idx = searchsorted_rows(uniq, sample.words)
        mpl[idx, s] = np.minimum(sample.counts, MPL_MAX).astype(np.uint16)

    keep = (mpl >= min_mult).sum(axis=1) >= min_samples
    return KmerProfiles(k, uniq[keep], mpl[keep])


def profiles_from_read_sets(
    read_sets: list[list[str]], k: int, min_samples: int = 1, min_mult: int = 5,
    device=None,
) -> KmerProfiles:
    """Count each sample on `device` (None: the CUDA card), then combine (the
    Snakefile's per-sample KMC + combine step in one call)."""
    counts = [count_sequences(reads, k, device=device) for reads in read_sets]
    return combine_multiplicities(counts, min_samples, min_mult)
