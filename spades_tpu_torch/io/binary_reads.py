"""Chunked 2-bit binary read storage.

Capability mirror of the reference's binary read conversion
(SPAdes `src/common/io/reads/binary_converter.hpp:29` `BinaryWriter`,
`io/dataset_support/read_converter.hpp:42-69` `ConvertIfNeeded`): input
libraries are converted once into chunked packed-sequence files that every
later stage streams, instead of re-parsing FASTQ.

Format (little-endian), per chunk file:
    magic  b"STBR"            4 bytes
    version u32               currently 1
    n_reads u64
    then per read:
        length  u32           read length in nt
        npos    u32           number of N positions
        data    ceil(len/4)   2-bit codes, base 0 in the TOP bits of byte 0
        npos *  u32           positions whose base was not ACGT
"""
from __future__ import annotations

import os
import struct

import numpy as np

from ..core import dna

MAGIC = b"STBR"
VERSION = 1


def _pack2(codes: np.ndarray) -> bytes:
    n = len(codes)
    pad = (-n) % 4
    c = np.concatenate([codes, np.zeros(pad, np.uint8)]) if pad else codes
    c = c.reshape(-1, 4).astype(np.uint8)
    packed = (c[:, 0] << 6) | (c[:, 1] << 4) | (c[:, 2] << 2) | c[:, 3]
    return packed.tobytes()


def _unpack2(buf: bytes, n: int) -> np.ndarray:
    raw = np.frombuffer(buf, np.uint8)
    out = np.empty(len(raw) * 4, np.uint8)
    out[0::4] = raw >> 6
    out[1::4] = (raw >> 4) & 3
    out[2::4] = (raw >> 2) & 3
    out[3::4] = raw & 3
    return out[:n]


def write_binary_reads(path: str, seqs: list[str]) -> None:
    with open(path, "wb") as fh:
        fh.write(MAGIC)
        fh.write(struct.pack("<IQ", VERSION, len(seqs)))
        for s in seqs:
            codes = dna.encode(s)
            npos = np.flatnonzero(codes >= 4).astype(np.uint32)
            codes = np.where(codes >= 4, 0, codes).astype(np.uint8)
            fh.write(struct.pack("<II", len(codes), len(npos)))
            fh.write(_pack2(codes))
            fh.write(npos.tobytes())


def read_binary_reads(path: str) -> list[str]:
    out = []
    with open(path, "rb") as fh:
        if fh.read(4) != MAGIC:
            raise ValueError(f"{path}: not an STBR binary reads file")
        version, n = struct.unpack("<IQ", fh.read(12))
        if version != VERSION:
            raise ValueError(f"{path}: unsupported version {version}")
        for _ in range(n):
            ln, npos = struct.unpack("<II", fh.read(8))
            nbytes = (ln + 3) // 4
            codes = _unpack2(fh.read(nbytes), ln).copy()
            if npos:
                pos = np.frombuffer(fh.read(4 * npos), np.uint32)
                codes[pos] = dna.NCODE
            out.append(dna.decode(codes))
    return out


def convert_reads(out_dir: str, seqs: list[str], chunks: int = 16) -> list[str]:
    """ConvertIfNeeded semantics: chunked one-time conversion, idempotent.

    Returns the chunk file paths."""
    os.makedirs(out_dir, exist_ok=True)
    done = os.path.join(out_dir, "conversion_done")
    paths = [os.path.join(out_dir, f"reads_{i}.bin") for i in range(chunks)]
    if os.path.exists(done):
        return [p for p in paths if os.path.exists(p)]
    per = (len(seqs) + chunks - 1) // max(chunks, 1) or 1
    written = []
    for i in range(chunks):
        part = seqs[i * per : (i + 1) * per]
        if not part:
            break
        write_binary_reads(paths[i], part)
        written.append(paths[i])
    with open(done, "w") as fh:
        fh.write(f"{len(seqs)}\n")
    return written
