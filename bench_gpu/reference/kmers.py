"""Plain NumPy k-mers: 2-bit codes, canonical keys, sets and counts.

Bases are coded A=0, C=1, G=2, T=3, and a k-mer (k <= 32) is the uint64
whose two lowest bits hold its last base.  The canonical key of a k-mer is
the smaller of its key and its reverse complement's.  Nothing here reads the
program's own encodings: what it compares, it encodes itself.
"""
from __future__ import annotations

import numpy as np

_CODE = np.full(256, 255, np.uint8)
_CODE[list(b"ACGT")] = [0, 1, 2, 3]
_CODE[list(b"acgt")] = [0, 1, 2, 3]


def codes_of(text: bytes) -> np.ndarray:
    """ASCII bases to codes; anything but ACGT becomes 255."""
    return _CODE[np.frombuffer(text, np.uint8)]


def window_keys(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Canonical keys of every k-window along the last axis of `codes`
    ((..., L) uint8, 255 where the base is not ACGT), and whether each window
    holds only ACGT.  Returns two (..., L - k + 1) arrays."""
    if not 1 <= k <= 32:
        raise ValueError(f"k must be in 1..32, got {k}")
    L = codes.shape[-1]
    P = L - k + 1
    if P <= 0:
        shape = codes.shape[:-1] + (0,)
        return np.zeros(shape, np.uint64), np.zeros(shape, bool)
    bad = codes > 3
    c = np.where(bad, 0, codes).astype(np.uint64)
    fwd = np.zeros(codes.shape[:-1] + (P,), np.uint64)
    rev = np.zeros_like(fwd)
    for j in range(k):
        fwd <<= np.uint64(2)
        fwd |= c[..., j : j + P]
        rev |= (np.uint64(3) - c[..., j : j + P]) << np.uint64(2 * j)
    nbad = np.cumsum(np.concatenate([np.zeros(codes.shape[:-1] + (1,), np.int64),
                                     bad.astype(np.int64)], axis=-1), axis=-1)
    ok = (nbad[..., k:] - nbad[..., :P]) == 0
    return np.minimum(fwd, rev), ok


def count_reads(reads: np.ndarray, k: int, block: int = 65536) -> tuple[np.ndarray, np.ndarray]:
    """Sorted distinct canonical k-mers of (n, L) read codes and how often
    each occurs, counted in blocks of reads so that it fits in memory."""
    keys, counts = [], []
    for i in range(0, len(reads), block):
        kk, ok = window_keys(reads[i : i + block], k)
        u, c = np.unique(kk[ok], return_counts=True)
        keys.append(u)
        counts.append(c)
    return merge_counts(keys, counts)


def merge_counts(keys: list, counts: list) -> tuple[np.ndarray, np.ndarray]:
    """Sum the counts of sorted distinct key arrays into one."""
    if not keys:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    allk = np.concatenate(keys)
    allc = np.concatenate(counts).astype(np.int64)
    order = np.argsort(allk, kind="stable")
    allk, allc = allk[order], allc[order]
    first = np.concatenate([[True], allk[1:] != allk[:-1]]) if len(allk) else np.zeros(0, bool)
    starts = np.flatnonzero(first)
    return allk[first], np.add.reduceat(allc, starts) if len(starts) else allc[:0]


def sequence_set(seqs, k: int) -> np.ndarray:
    """Sorted distinct canonical k-mers of code arrays of any lengths."""
    parts = [np.unique(kk[ok]) for kk, ok in (window_keys(s, k) for s in seqs)]
    return np.unique(np.concatenate(parts)) if parts else np.zeros(0, np.uint64)


def member(sorted_keys: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Whether each of `keys` is in the sorted array `sorted_keys`."""
    if len(sorted_keys) == 0:
        return np.zeros(len(keys), bool)
    at = np.minimum(np.searchsorted(sorted_keys, keys), len(sorted_keys) - 1)
    return sorted_keys[at] == keys


def read_fasta(path: str) -> list[tuple[str, np.ndarray]]:
    """(name, codes) of every record of a FASTA file."""
    out, name, chunks = [], None, []
    with open(path, "rb") as fh:
        for line in fh:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    out.append((name, codes_of(b"".join(chunks))))
                name, chunks = line[1:].decode(), []
            elif line:
                chunks.append(line)
    if name is not None:
        out.append((name, codes_of(b"".join(chunks))))
    return out
