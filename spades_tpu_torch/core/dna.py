"""Nucleotide codec: ASCII <-> 2-bit codes.

Semantics match the reference's nucleotide conventions
(`src/common/sequence/nucl.hpp`): A=0, C=1, G=2, T=3 and
complement(x) = 3 - x.  Non-ACGT characters (N etc.) encode to `NCODE`; they are
tracked out-of-band as a validity mask so device arrays stay pure 2-bit.
"""
from __future__ import annotations

import numpy as np

A, C, G, T = 0, 1, 2, 3
NCODE = 4  # any non-ACGT character

_ENC_LUT = np.full(256, NCODE, dtype=np.uint8)
for _i, _ch in enumerate("ACGT"):
    _ENC_LUT[ord(_ch)] = _i
    _ENC_LUT[ord(_ch.lower())] = _i

_DEC_LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode(seq: str | bytes | np.ndarray) -> np.ndarray:
    """ASCII sequence -> uint8 codes (NCODE for non-ACGT).

    Already-encoded uint8 code arrays pass through (contiguous copy only if
    needed) so every sequence consumer accepts both representations."""
    if isinstance(seq, np.ndarray):
        if seq.dtype == np.uint8 and (seq.size == 0 or seq.max() <= NCODE):
            return np.ascontiguousarray(seq)
        return _ENC_LUT[np.ascontiguousarray(seq).view(np.uint8)].copy()
    if isinstance(seq, str):
        seq = seq.encode()
    return _ENC_LUT[np.frombuffer(seq, dtype=np.uint8)].copy()


def decode(codes: np.ndarray) -> str:
    """uint8 codes -> ASCII string."""
    return _DEC_LUT[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


def decode_codes(codes: np.ndarray) -> np.ndarray:
    """uint8 codes (any shape) -> the uint8 ASCII letters of `decode`."""
    return _DEC_LUT[np.asarray(codes, dtype=np.uint8)]


def complement_codes(codes: np.ndarray) -> np.ndarray:
    c = np.asarray(codes)
    return np.where(c >= NCODE, np.uint8(NCODE), (3 - c)).astype(np.uint8)


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return complement_codes(np.asarray(codes)[..., ::-1])


def revcomp_str(s: str) -> str:
    return decode(revcomp_codes(encode(s)))
