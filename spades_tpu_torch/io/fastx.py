"""FASTA/FASTQ readers and writers (host side).

The native C++ parser (`native/fastx.cpp`) reads plain and gzipped files;
the pure-Python parser below is its fallback and behavioural oracle.
"""
from __future__ import annotations

import gzip
import io as _io
import os
from dataclasses import dataclass
from typing import Iterable, Iterator


@dataclass
class FastxRecord:
    name: str
    seq: str
    qual: str | None = None


def _open_text(path: str):
    if str(path).endswith(".gz"):
        return _io.TextIOWrapper(gzip.open(path, "rb"))
    if str(path).endswith(".bz2"):
        import bz2

        return _io.TextIOWrapper(bz2.open(path, "rb"))
    return open(path, "rt")


def read_fastx(path: str, native: bool = True) -> Iterator[FastxRecord]:
    """Parse FASTA or FASTQ (optionally gzipped), auto-detected."""
    if native and not str(path).endswith(".bz2"):
        from .. import native as _native

        res = _native.read_fastx_native(path)
        if res is not None:
            names, seq, soff = res
            pool = seq.tobytes()
            for i, name in enumerate(names):
                yield FastxRecord(
                    name=name, seq=pool[soff[i] : soff[i + 1]].decode("ascii")
                )
            return
    with _open_text(path) as fh:
        first = fh.read(1)
        if not first:
            return
        if first == ">":
            yield from _read_fasta(fh)
        elif first == "@":
            yield from _read_fastq(fh)
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")


def _read_fasta(fh) -> Iterator[FastxRecord]:
    # fh positioned just after the first '>'
    name = fh.readline().strip()
    chunks: list[str] = []
    for line in fh:
        if line.startswith(">"):
            yield FastxRecord(name=name, seq="".join(chunks))
            name = line[1:].strip()
            chunks = []
        else:
            chunks.append(line.strip())
    yield FastxRecord(name=name, seq="".join(chunks))


def _read_fastq(fh) -> Iterator[FastxRecord]:
    # fh positioned just after the first '@'
    name = fh.readline().strip()
    while True:
        seq = fh.readline().strip()
        plus = fh.readline()
        qual = fh.readline().strip()
        if not plus:
            raise ValueError("truncated FASTQ record")
        yield FastxRecord(name=name, seq=seq, qual=qual)
        nxt = fh.readline()
        if not nxt:
            return
        if not nxt.startswith("@"):
            raise ValueError("malformed FASTQ record header")
        name = nxt[1:].strip()


def read_sequences(paths: str | Iterable[str]) -> Iterator[str]:
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    for p in paths:
        for rec in read_fastx(p):
            yield rec.seq


def read_batches(paths: str | Iterable[str], batch_size: int = 65536):
    """Stream ReadBatches straight from files with no per-read Python objects.

    Native parser (flat ASCII pool + offsets) -> vectorized LUT encode ->
    padded (R, L) batch scatter: the ingest path of the counting tools (the
    role of SPAdes' binary-read streaming,
    `io/dataset_support/read_converter.hpp`).  A `.bz2` file, or a machine
    without the native library, goes through the record parser instead, as
    in the JAX package."""
    import numpy as np

    from ..core import dna
    from ..core.reads import ReadBatch, batch_iter
    from .. import native as _native

    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    lut = np.full(256, dna.NCODE, np.uint8)
    for i, b in enumerate(b"ACGT"):
        lut[b] = i
        lut[ord(chr(b).lower())] = i

    for p in paths:
        res = None if str(p).endswith(".bz2") else _native.read_fastx_native(p)
        if res is None:
            yield from batch_iter(read_sequences(p), batch_size=batch_size)
            continue
        _names, seq, soff = res
        codes_all = lut[seq]
        lengths_all = np.diff(soff).astype(np.int64)
        n = len(lengths_all)
        for lo in range(0, n, batch_size):
            hi = min(lo + batch_size, n)
            lens = lengths_all[lo:hi]
            R = hi - lo
            L = max(int(lens.max(initial=1)), 1)
            L = ((L + 7) // 8) * 8
            flat = codes_all[soff[lo] : soff[hi]]
            rows = np.repeat(np.arange(R), lens)
            cols = np.arange(len(flat)) - np.repeat(
                (soff[lo:hi] - soff[lo]).astype(np.int64), lens
            )
            codes = np.zeros((R, L), np.uint8)
            n_mask = np.zeros((R, L), bool)
            codes[rows, cols] = flat
            nm = codes >= dna.NCODE
            codes[nm] = 0
            n_mask |= nm
            yield ReadBatch(codes=codes, lengths=lens.astype(np.int32), n_mask=n_mask)


def write_fasta(path: str, records: Iterable[tuple[str, str]], width: int = 60) -> None:
    """Write (name, seq) pairs as FASTA wrapped at `width` columns."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as fh:
        for name, seq in records:
            fh.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i : i + width] + "\n")
