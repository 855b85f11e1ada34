"""Fixed-shape read batches and the run-wide packed read store.

Reads are materialized as padded (R, L) uint8 code matrices plus a length
vector and an N-position mask (`ReadBatch`), and cross to the device in a
2-bit packed wire format (`ReadBatch.packed`, `PackedChunk`) that the
canonical-window kernel reads directly.  Same layout and bucketing rules as
`spades_tpu.core.reads`, so both packages pad and batch identically.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np
import torch

from . import dna


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class ReadBatch:
    """A batch of reads as fixed-shape arrays.

    codes:   (R, L) uint8 in {0..3}; N positions are stored as 0 but flagged.
    lengths: (R,)  int32 true read lengths (<= L).
    n_mask:  (R, L) bool, True where the original base was not ACGT.
    """

    codes: np.ndarray
    lengths: np.ndarray
    n_mask: np.ndarray
    # real (unpadded) sequence count; rows beyond it are padding.  Batches
    # from batch_iter may be SHORTER than batch_size (footprint or
    # length-bucket flush) so consumers must use this, never batch_size.
    n_seqs: int = -1

    @property
    def num_reads(self) -> int:
        return int(self.codes.shape[0])

    @property
    def max_len(self) -> int:
        return int(self.codes.shape[1])

    def packed(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Wire format for host->device transfer: 2-bit packed codes
        (4 bases/byte, base i at bits 2*(i%4)) + bit-packed N mask (little
        bit order).  Returns (packed_codes (R, ceil(L/4)) uint8,
        packed_nmask (R, ceil(L/8)) uint8, lengths, L)."""
        R, L = self.codes.shape
        Lp = (L + 3) // 4 * 4
        c = self.codes
        if Lp != L:
            c = np.pad(c, ((0, 0), (0, Lp - L)))
        c = c.reshape(R, Lp // 4, 4).astype(np.uint8)
        packed = (
            c[:, :, 0]
            | (c[:, :, 1] << 2)
            | (c[:, :, 2] << 4)
            | (c[:, :, 3] << 6)
        )
        nbits = np.packbits(self.n_mask, axis=1, bitorder="little")
        return packed, nbits, self.lengths, L

    @classmethod
    def from_sequences(
        cls,
        seqs: Sequence[str | bytes | np.ndarray],
        pad_len_to: int = 8,
        pad_reads_to: int = 8,
    ) -> "ReadBatch":
        if len(seqs) == 0:
            L = pad_len_to
            return cls(
                codes=np.zeros((0, L), np.uint8),
                lengths=np.zeros((0,), np.int32),
                n_mask=np.zeros((0, L), bool),
                n_seqs=0,
            )
        # uniform-length fast paths: millions of fixed-length reads build as
        # ONE stack/encode instead of a per-read Python loop
        first = seqs[0]
        n0 = len(first)
        if isinstance(first, np.ndarray):
            if all(isinstance(s, np.ndarray) and len(s) == n0 for s in seqs):
                mat = np.stack([np.asarray(s, np.uint8) for s in seqs])
                return cls._from_code_matrix(mat, len(seqs), pad_len_to, pad_reads_to)
        elif isinstance(first, str):
            if all(isinstance(s, str) and len(s) == n0 for s in seqs):
                mat = dna.encode("".join(seqs)).reshape(len(seqs), n0)
                return cls._from_code_matrix(mat, len(seqs), pad_len_to, pad_reads_to)
        encoded = [
            s if isinstance(s, np.ndarray) else dna.encode(s) for s in seqs
        ]
        L = _round_up(max((len(e) for e in encoded), default=1) or 1, pad_len_to)
        R = _round_up(len(encoded), pad_reads_to)
        codes = np.zeros((R, L), np.uint8)
        n_mask = np.zeros((R, L), bool)
        lengths = np.zeros((R,), np.int32)
        for i, e in enumerate(encoded):
            n = len(e)
            lengths[i] = n
            nm = e >= dna.NCODE
            codes[i, :n] = np.where(nm, 0, e)
            n_mask[i, :n] = nm
        return cls(codes=codes, lengths=lengths, n_mask=n_mask, n_seqs=len(seqs))

    @classmethod
    def _from_code_matrix(cls, mat: np.ndarray, n_seqs: int,
                          pad_len_to: int, pad_reads_to: int) -> "ReadBatch":
        R0, L0 = mat.shape
        L = _round_up(max(L0, 1), pad_len_to)
        R = _round_up(R0, pad_reads_to)
        codes = np.zeros((R, L), np.uint8)
        n_mask = np.zeros((R, L), bool)
        nm = mat >= dna.NCODE
        codes[:R0, :L0] = np.where(nm, 0, mat)
        n_mask[:R0, :L0] = nm
        lengths = np.zeros((R,), np.int32)
        lengths[:R0] = L0
        return cls(codes=codes, lengths=lengths, n_mask=n_mask, n_seqs=n_seqs)

    def sequences(self) -> list[str]:
        """Every row as a string, N where flagged; rows of one length are
        decoded in one numpy step."""
        chars = dna.decode_codes(np.where(self.n_mask, np.uint8(dna.NCODE), self.codes))
        out: list[str] = [""] * self.num_reads
        for n in np.unique(self.lengths).tolist():
            rows = np.flatnonzero(self.lengths == n)
            if n == 0:
                continue
            block = np.ascontiguousarray(chars[rows, :n]).view(f"S{n}").ravel()
            for r, text in zip(rows.tolist(), block.astype(f"U{n}").tolist()):
                out[r] = text
        return out


def _next_pow2(n: int, lo: int = 8) -> int:
    p = lo
    while p < n:
        p <<= 1
    return p


def batch_iter(
    seq_iter: Iterable[str | bytes],
    batch_size: int = 65536,
    pad_len_to: int = 8,
    max_batch_nt: int = 64 << 20,
) -> Iterable[ReadBatch]:
    """Group a sequence stream into fixed-shape ReadBatches.

    Batches flush at `batch_size` sequences OR when the padded footprint
    (count x longest-in-batch) would exceed `max_batch_nt`.  Rows and padded
    length are bucketed to powers of two, and two buffers stay open keyed by
    length bucket (a sequence joins a buffer whose bucket is within 4x of
    its own), so short reads and long contig chunks do not pad each other.
    The batching is the JAX package's exactly, which keeps the two packages'
    batch boundaries (and so their host/device split) identical."""
    bufs: list[list] = []     # [sequences]
    maxlens: list[int] = []

    def flush(i: int):
        seqs, ml = bufs.pop(i), maxlens.pop(i)
        return ReadBatch.from_sequences(
            seqs,
            pad_len_to=_next_pow2(max(ml, pad_len_to)),
            pad_reads_to=_next_pow2(len(seqs)),
        )

    for s in seq_iter:
        new = _next_pow2(max(len(s), pad_len_to))
        ti = None
        for i in range(len(bufs)):
            cur = _next_pow2(max(maxlens[i], pad_len_to))
            if new < 4 * cur and cur < 4 * new:
                ti = i
                break
        if ti is None:
            if len(bufs) >= 2:
                yield flush(0)          # evict the oldest open buffer
            bufs.append([])
            maxlens.append(0)
            ti = len(bufs) - 1
        elif (len(bufs[ti]) + 1) * max(maxlens[ti], len(s)) > max_batch_nt:
            yield flush(ti)
            bufs.append([])
            maxlens.append(0)
            ti = len(bufs) - 1
        bufs[ti].append(s)
        maxlens[ti] = max(maxlens[ti], len(s))
        if len(bufs[ti]) >= batch_size:
            yield flush(ti)
    while bufs:
        yield flush(0)


def chop_sequences(seqs: Iterable[str], k: int, max_len: int = 4096) -> Iterable[str]:
    """Split sequences longer than `max_len` into chunks overlapping by k-1.

    The chunks spell exactly the same k-mer multiset as the original
    sequence, so counting is unaffected; this keeps prev-K contigs from
    forcing every read in a batch to pad to contig length."""
    step = max_len - (k - 1)
    assert step > 0
    for s in seqs:
        if len(s) <= max_len:
            yield s
        else:
            for a in range(0, len(s) - (k - 1), step):
                yield s[a : a + max_len]


def revcomp_batch(batch: ReadBatch) -> ReadBatch:
    """Vectorized reverse-complement of a ReadBatch (per-row, length-aware).

    Row i's valid prefix [0, len_i) becomes the reverse complement in the
    same left-aligned layout; padding stays at the tail."""
    codes, lengths, n_mask = batch.codes, batch.lengths, batch.n_mask
    R, L = codes.shape
    j = np.arange(L, dtype=np.int64)[None, :]
    src = lengths.astype(np.int64)[:, None] - 1 - j          # (R, L)
    valid = src >= 0
    src = np.where(valid, src, 0)
    rows = np.arange(R, dtype=np.int64)[:, None]
    rc = np.where(valid, (3 - codes[rows, src]) & 3, 0).astype(np.uint8)
    nm = np.where(valid, n_mask[rows, src], False)
    rc[nm] = 0
    return ReadBatch(codes=rc, lengths=lengths.copy(), n_mask=nm,
                     n_seqs=batch.n_seqs)


@dataclass
class PackedChunk:
    """One fixed-shape chunk of the run-wide read store, in wire format."""

    pc: np.ndarray        # (R, ceil(L/4)) uint8 2-bit packed codes
    pn: np.ndarray        # (R, ceil(L/8)) uint8 bit-packed N mask
    lengths: np.ndarray   # (R,) int32
    L: int
    n: int                # real reads in this chunk (rows beyond are padding)
    _dev: dict = field(default_factory=dict, repr=False, compare=False)

    def device(self, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(pc, pn, lengths) as torch tensors on `device` — uploaded once per
        device, then reused by every counting pass of the run."""
        dev = torch.device(device)
        if dev not in self._dev:
            self._dev[dev] = tuple(
                torch.from_numpy(a).to(dev)
                for a in (self.pc, self.pn, self.lengths)
            )
        return self._dev[dev]

    def unpack_host(self) -> ReadBatch:
        """Wire -> host ReadBatch (for the numpy counting path)."""
        R = self.pc.shape[0]
        shifts = np.arange(4, dtype=np.uint8) * 2
        codes = ((self.pc[:, :, None] >> shifts[None, None, :]) & 3)
        codes = codes.reshape(R, -1)[:, : self.L].astype(np.uint8)
        nm = np.unpackbits(self.pn, axis=1, bitorder="little")[:, : self.L].astype(bool)
        return ReadBatch(codes=codes, lengths=self.lengths.copy(), n_mask=nm,
                         n_seqs=self.n)


class ReadStore:
    """Run-wide packed read set: encode + 2-bit pack ONCE, reuse everywhere.

    Counting at every k consumes the same immutable chunks (and their
    one-time device uploads) instead of re-encoding Python strings per k."""

    def __init__(self, chunks: list[PackedChunk], n: int):
        self.chunks = chunks
        self.n = n

    @classmethod
    def build(cls, seqs, chunk_reads: int = 262144, rc: bool = False) -> "ReadStore":
        """Pack a sequence list (str or uint8 codes) into pow2-row chunks.

        rc=True stores each read's reverse complement (FR right mates are
        stored pre-normalized onto the forward strand)."""
        chunks: list[PackedChunk] = []
        n = len(seqs)
        # one shared padded length across chunks, rounded to a multiple of 8
        # (not pow2: padding becomes sentinel sort work in counting)
        maxlen = max((len(s) for s in seqs), default=8)
        L8 = _round_up(max(maxlen, 8), 8)
        for c0 in range(0, n, chunk_reads):
            part = seqs[c0 : c0 + chunk_reads]
            b = ReadBatch.from_sequences(
                part,
                pad_len_to=L8,
                pad_reads_to=_next_pow2(len(part), lo=min(chunk_reads, 1024)),
            )
            if rc:
                b = revcomp_batch(b)
            pc, pn, lengths, L = b.packed()
            chunks.append(PackedChunk(pc=pc, pn=pn, lengths=lengths, L=L,
                                      n=len(part)))
        return cls(chunks, n)


def subset_store(store: "ReadStore", idx: np.ndarray,
                 chunk_reads: int = 262144) -> "ReadStore":
    """New ReadStore holding only the reads at global indices `idx`
    (ascending).  Gathers wire rows on the host — used by the gap closer to
    map only prefiltered candidate reads."""
    idx = np.asarray(idx, np.int64)
    pcs, pns, lens = [], [], []
    a = 0
    L = store.chunks[0].L if store.chunks else 8
    for ch in store.chunks:
        sel = idx[(idx >= a) & (idx < a + ch.n)] - a
        if sel.size:
            pcs.append(ch.pc[sel])
            pns.append(ch.pn[sel])
            lens.append(ch.lengths[sel])
        a += ch.n
    if not pcs:
        return ReadStore([], 0)
    pc = np.concatenate(pcs)
    pn = np.concatenate(pns)
    ln = np.concatenate(lens)
    n = pc.shape[0]
    chunks = []
    for c0 in range(0, n, chunk_reads):
        part = slice(c0, min(c0 + chunk_reads, n))
        m = part.stop - part.start
        R = _next_pow2(m, lo=1024)
        pcp = np.zeros((R, pc.shape[1]), np.uint8)
        pnp = np.zeros((R, pn.shape[1]), np.uint8)
        lnp = np.zeros(R, np.int32)
        pcp[:m] = pc[part]
        pnp[:m] = pn[part]
        lnp[:m] = ln[part]
        chunks.append(PackedChunk(pc=pcp, pn=pnp, lengths=lnp, L=L, n=m))
    return ReadStore(chunks, n)
