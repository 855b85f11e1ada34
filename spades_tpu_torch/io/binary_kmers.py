"""SPAdes-compatible binary k-mer records (`final_kmers` format).

Format contract from the reference (SPAdes `docs/standalone.md:5-27`):
k-mers written sequentially, 2 bits per nucleotide (00=A 01=C 10=G 11=T),
base i occupying bits [2i, 2i+1] of a little-endian bit stream, each record
padded to a 64-bit boundary (k=21 -> 8 bytes, k=33/55 -> 16 bytes).  The
records are built word by word from the packed rows (the JAX package goes
through one code column per base); the bytes are the same.
"""
from __future__ import annotations

import numpy as np

from ..core import kmers as K
from ..ops.extension import mask_tail


def record_words64(k: int) -> int:
    return (2 * k + 63) // 64


def _reverse_fields(w: np.ndarray) -> np.ndarray:
    """Reverse the order of the sixteen 2-bit fields of uint32 words."""
    m2, m4, m8 = np.uint32(0x33333333), np.uint32(0x0F0F0F0F), np.uint32(0x00FF00FF)
    w = ((w >> np.uint32(2)) & m2) | ((w & m2) << np.uint32(2))
    w = ((w >> np.uint32(4)) & m4) | ((w & m4) << np.uint32(4))
    w = ((w >> np.uint32(8)) & m8) | ((w & m8) << np.uint32(8))
    return (w >> np.uint32(16)) | (w << np.uint32(16))


def to_binary_records(words: np.ndarray, k: int) -> np.ndarray:
    """Packed big-endian (U, W) uint32 rows -> (U, record_words64) uint64.

    Word w holds bases 16w..16w+15 from its top bits down; with its fields
    reversed, base 16w+i sits at bits 2i, which is where the record wants it
    within the 32-bit half w % 2 of record word w // 2.  The bits past base
    k-1 are cleared first, as the JAX package writes only bases below k."""
    words = mask_tail(np.asarray(words, np.uint32), k)
    out = np.zeros((words.shape[0], record_words64(k)), np.uint64)
    rev = _reverse_fields(words).astype(np.uint64)
    for w in range(words.shape[1]):
        out[:, w // 2] |= rev[:, w] << np.uint64(32 * (w % 2))
    return out


def from_binary_records(recs: np.ndarray, k: int) -> np.ndarray:
    """(U, record_words64) uint64 -> packed big-endian (U, W) uint32 rows."""
    recs = np.asarray(recs, np.uint64)
    W = K.kmer_words(k)
    half = np.empty((recs.shape[0], W), np.uint32)
    for w in range(W):
        half[:, w] = (recs[:, w // 2] >> np.uint64(32 * (w % 2))) & np.uint64(0xFFFFFFFF)
    return mask_tail(_reverse_fields(half), k)


def write_kmer_file(path: str, words: np.ndarray, k: int) -> None:
    recs = to_binary_records(words, k)
    with open(path, "wb") as fh:
        fh.write(recs.astype("<u8").tobytes())


def read_kmer_file(path: str, k: int) -> np.ndarray:
    n64 = record_words64(k)
    data = np.fromfile(path, dtype="<u8")
    if data.size % n64:
        raise ValueError(f"{path}: size not a multiple of {8*n64}-byte records")
    return from_binary_records(data.reshape(-1, n64), k)
