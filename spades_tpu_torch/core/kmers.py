"""Packed multi-word k-mer codec.

Layout (the same as `spades_tpu.core.kmers`): a k-mer is a row of
W = ceil(k/16) uint32 words, **big-endian** — base 0 sits in the top 2 bits
of word 0 and unused low bits of the last word are zero — so word-wise
unsigned comparison is lexicographic sequence order.  The canonical k-mer is
min(kmer, revcomp(kmer)), and the all-ones row is an impossible canonical
k-mer (its revcomp would be smaller), so it serves as the padding sentinel.

Host arrays are numpy uint32.  Torch has no unsigned 32-bit shift or compare
on the CPU, so torch code carries each uint32 word in an int64.  For sorting,
each pair of words (w[2j], w[2j+1]) folds into one signed int64 *key*,
`((w[2j] << 32) | w[2j+1]) ^ INT64_MIN` (a missing odd word reads as 0),
so that signed key order is lexicographic word order: W <= 2 sorts as one
key, W <= 4 as two, W <= 8 as four.  Invalid windows carry the sentinel key
INT64_MAX in every plane, which sorts after every valid row.
"""
from __future__ import annotations

import numpy as np
import torch

SENTINEL32 = np.uint32(0xFFFFFFFF)
KEY_SENTINEL = (1 << 63) - 1  # INT64_MAX, the sentinel key in every plane


def kmer_words(k: int) -> int:
    """Number of uint32 words per k-mer."""
    return (k + 15) // 16


def key_planes(k: int) -> int:
    """Number of int64 sort keys per k-mer."""
    return (kmer_words(k) + 1) // 2


# ---------------------------------------------------------------------------
# Host-side (numpy) helpers
# ---------------------------------------------------------------------------

def lex_less(a, b):
    """Lexicographic a < b over the trailing word axis. Shapes (..., W) -> (...).

    Works on numpy arrays and on torch tensors alike."""
    lt = a < b
    eq = a == b
    res = lt[..., 0]
    eqacc = eq[..., 0]
    for w in range(1, a.shape[-1]):
        res = res | (eqacc & lt[..., w])
        eqacc = eqacc & eq[..., w]
    return res


def base_at(words: np.ndarray, j: int, k: int) -> np.ndarray:
    """Extract base j (0-indexed from the 5' end) of packed k-mers (..., W)."""
    w, jj = divmod(j, 16)
    return (words[..., w] >> np.uint32(30 - 2 * jj)) & np.uint32(3)


def first_base(words: np.ndarray, k: int) -> np.ndarray:
    return base_at(words, 0, k)


def last_base(words: np.ndarray, k: int) -> np.ndarray:
    return base_at(words, k - 1, k)


def unpack(words: np.ndarray, k: int) -> np.ndarray:
    """Packed (N, W) -> (N, k) uint8 base codes."""
    words = np.asarray(words, dtype=np.uint32)
    n = words.shape[0]
    out = np.empty((n, k), np.uint8)
    for j in range(k):
        w, jj = divmod(j, 16)
        out[:, j] = (words[:, w] >> np.uint32(30 - 2 * jj)) & 3
    return out


def pack(codes: np.ndarray) -> np.ndarray:
    """(N, k) base codes -> packed (N, W) uint32."""
    codes = np.asarray(codes)
    n, k = codes.shape
    W = kmer_words(k)
    out = np.zeros((n, W), np.uint32)
    for j in range(k):
        w, jj = divmod(j, 16)
        out[:, w] |= codes[:, j].astype(np.uint32) << np.uint32(30 - 2 * jj)
    return out


def revcomp_words(words: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement packed k-mers (..., W) uint32.

    A pure bit-shuffle: complement every 2-bit field, reverse the field order
    across the whole W*32-bit register, then realign for the left-aligned
    layout."""
    W = words.shape[-1]
    comp = [~words[..., w] for w in range(W)]

    def rev2(x):
        m2 = np.uint32(0x33333333)
        m4 = np.uint32(0x0F0F0F0F)
        m8 = np.uint32(0x00FF00FF)
        x = ((x >> 2) & m2) | ((x & m2) << 2)
        x = ((x >> 4) & m4) | ((x & m4) << 4)
        x = ((x >> 8) & m8) | ((x & m8) << 8)
        return (x >> 16) | (x << 16)

    rev = [rev2(comp[W - 1 - w]) for w in range(W)]
    # the k-mer now occupies the LOW 2k bits; shift left by 32W - 2k
    pad = 32 * W - 2 * k
    if pad:
        sh = np.uint32(pad)
        out = []
        for w in range(W):
            hi = rev[w] << sh
            lo = rev[w + 1] >> np.uint32(32 - pad) if w + 1 < W else np.uint32(0)
            out.append(hi | lo)
        rev = out
    return np.stack(rev, axis=-1).astype(np.uint32)


def kmer_to_int(words: np.ndarray, k: int) -> np.ndarray:
    """Packed k-mer -> Python-int array (arbitrary precision), for tests."""
    words = np.asarray(words, dtype=np.uint64)
    val = np.zeros(words.shape[:-1], dtype=object)
    for w in range(words.shape[-1]):
        val = val * (1 << 32) + words[..., w].astype(object)
    return val >> (32 * words.shape[-1] - 2 * k)


def words_to_keys(words: np.ndarray) -> np.ndarray:
    """Host: (N, W) uint32 words -> (N, ceil(W/2)) int64 sort keys."""
    words = np.asarray(words, np.uint32)
    n, W = words.shape
    if W % 2:
        words = np.concatenate([words, np.zeros((n, 1), np.uint32)], axis=1)
    u = (words[:, 0::2].astype(np.uint64) << np.uint64(32)) | words[:, 1::2]
    return (u ^ np.uint64(1 << 63)).view(np.int64)


def keys_to_words(keys: np.ndarray, W: int) -> np.ndarray:
    """Host: (N, ceil(W/2)) int64 sort keys -> (N, W) uint32 words."""
    u = np.ascontiguousarray(keys, np.int64).view(np.uint64) ^ np.uint64(1 << 63)
    out = np.empty((u.shape[0], 2 * u.shape[1]), np.uint32)
    out[:, 0::2] = u >> np.uint64(32)
    out[:, 1::2] = u & np.uint64(0xFFFFFFFF)
    return out[:, :W]


# ---------------------------------------------------------------------------
# Torch: canonical windows of a read batch (the plain version of the
# canonical_windows CUDA kernel, ops/cuda_kernels.py)
# ---------------------------------------------------------------------------

def window_valid(lengths: torch.Tensor, n_mask: torch.Tensor, k: int) -> torch.Tensor:
    """Which windows are real k-mers: inside the read and N-free.

    lengths: (R,), n_mask: (R, L) -> (R, P) bool."""
    R, L = n_mask.shape
    P = L - k + 1
    ncum = torch.zeros((R, L + 1), dtype=torch.int32, device=n_mask.device)
    ncum[:, 1:] = torch.cumsum(n_mask.to(torch.int32), dim=1)
    n_in_window = ncum[:, k : k + P] - ncum[:, 0:P]
    offs = torch.arange(P, dtype=torch.int64, device=n_mask.device)[None, :]
    inside = offs + k <= lengths.to(torch.int64)[:, None]
    return inside & (n_in_window == 0)


def _shift_cols(a: torch.Tensor, n: int) -> torch.Tensor:
    """a[:, i] -> a[:, i+n], zero-filled at the tail (column left-shift)."""
    out = torch.zeros_like(a)
    out[:, : a.shape[1] - n] = a[:, n:]
    return out


def doubling_packs(codes: torch.Tensor):
    """Prefix-doubling 16-base packs at every position.

    codes: (R, Lx) int64 base codes.  Returns (B16, R16), uint32 values in
    int64:  B16[:, i] = pack of codes[i..i+15] (base i in the top 2 bits),
    R16[:, i] = pack of (3 - codes)[i+15..i] (complemented, decreasing)."""
    B = codes << 30
    D = (3 - codes) << 30
    for n in (1, 2, 4, 8):
        B = B | (_shift_cols(B, n) >> (2 * n))
        D = _shift_cols(D, n) | (D >> (2 * n))
    return B, D


def _canonical_windows_strand(codes: torch.Tensor, lengths: torch.Tensor,
                              n_mask: torch.Tensor, k: int):
    """Shared body of `canonical_windows` and `canonical_windows_strand`:
    (canon, valid, use_rc)."""
    R, L = codes.shape
    P = L - k + 1
    if P <= 0:
        raise ValueError(f"read length {L} < k {k}")
    W = kmer_words(k)
    m = k - 16 * (W - 1)  # bases in the last word (1..16)
    need = P + 16 * W - 1  # doubling packs are read up to index need-1
    c = codes.to(torch.int64)
    if need > L:
        c = torch.nn.functional.pad(c, (0, need - L))
    B16, R16 = doubling_packs(c)
    fwd_w, rc_w = [], []
    for w in range(W):
        if w < W - 1:
            fwd_w.append(B16[:, 16 * w : 16 * w + P])
            rc_w.append(R16[:, k - 16 * (w + 1) : k - 16 * (w + 1) + P])
        else:
            f_last = B16[:, 16 * w : 16 * w + P]
            r_last = R16[:, 0:P]
            if m < 16:  # keep the top m bases of fw; drop the top 16-m of rc
                f_last = f_last & (0xFFFFFFFF ^ ((1 << (32 - 2 * m)) - 1))
                r_last = (r_last << (32 - 2 * m)) & 0xFFFFFFFF
            fwd_w.append(f_last)
            rc_w.append(r_last)
    fwd = torch.stack(fwd_w, dim=-1)
    rcw = torch.stack(rc_w, dim=-1)
    use_rc = lex_less(rcw, fwd)
    canon = torch.where(use_rc[..., None], rcw, fwd)
    valid = window_valid(lengths, n_mask, k)
    canon = torch.where(valid[..., None], canon, int(SENTINEL32))
    return canon, valid, use_rc


def canonical_windows(codes: torch.Tensor, lengths: torch.Tensor,
                      n_mask: torch.Tensor, k: int):
    """All canonical k-mers of a read batch.

    codes (R, L) integer codes in {0..3}, lengths (R,), n_mask (R, L) bool.
    Returns (canon (R, P, W) int64 holding uint32 words, with sentinel rows
    where invalid; valid (R, P) bool), P = L - k + 1 — the semantics of
    `spades_tpu.core.kmers.canonical_windows`."""
    canon, valid, _ = _canonical_windows_strand(codes, lengths, n_mask, k)
    return canon, valid


def canonical_windows_strand(codes: torch.Tensor, lengths: torch.Tensor,
                             n_mask: torch.Tensor, k: int):
    """Like `canonical_windows` but also returns was_rc (R, P) bool: True
    where the canonical form is the reverse complement of the spelled window
    (the orientation bit read mappers need).  As in
    `spades_tpu.core.kmers.canonical_windows_strand`, was_rc is not masked by
    `valid`."""
    return _canonical_windows_strand(codes, lengths, n_mask, k)


def pack_windows(codes: torch.Tensor, k: int, rc: bool = False) -> torch.Tensor:
    """Pack every length-k window of each read, base by base.

    codes (R, L) integer codes in {0..3} -> (R, P, W) int64 holding uint32
    words, P = L - k + 1.  With rc=True, packs the reverse complement of each
    window instead (rc_kmer[j] = 3 - base[i + k - 1 - j])."""
    R, L = codes.shape
    P = L - k + 1
    if P <= 0:
        raise ValueError(f"read length {L} < k {k}")
    c = codes.to(torch.int64)
    words = []
    for w in range(kmer_words(k)):
        acc = torch.zeros((R, P), dtype=torch.int64, device=codes.device)
        for jj in range(min(16, k - 16 * w)):
            j = 16 * w + jj
            col = 3 - c[:, k - 1 - j : k - 1 - j + P] if rc else c[:, j : j + P]
            acc = acc | (col << (30 - 2 * jj))
        words.append(acc)
    return torch.stack(words, dim=-1)


def canon_to_keys(canon: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(R, P, W) int64-held words + (R, P) valid -> (ceil(W/2), R*P) int64
    sort keys, INT64_MAX in every plane where invalid."""
    W = canon.shape[-1]
    flat = canon.reshape(-1, W)
    planes = []
    for j in range(0, W, 2):
        hi = flat[:, j]
        lo = flat[:, j + 1] if j + 1 < W else torch.zeros_like(hi)
        # ((hi << 32) | lo) ^ INT64_MIN without leaving the int64 range
        planes.append((hi - (1 << 31)) * (1 << 32) + lo)
    keys = torch.stack(planes)
    return torch.where(valid.reshape(1, -1), keys, KEY_SENTINEL)


def loop_window_keys(seqs: list[str], k: int, dev: torch.device, skip_n: bool = True):
    """Canonical keys, validity and strand of every window of `seqs` as the
    JAX package's host loops pack them (`pack` of `dna.encode` codes, then
    `canonicalize`), letters other than ACGT and acgt included: such a
    letter encodes to code 4, whose own field stays 0 and whose bit 2 sets
    the low bit of the base before it in the same word (it is lost at a
    word's first base).  skip_n: a window holding an uppercase "N" is
    invalid (read_filter's loop skips it); without it only windows past a
    sequence's end are.  Plain torch on `dev`; returns (keys (nK, R*P),
    valid (R, P), use_rc (R, P))."""
    from . import dna

    R, L = len(seqs), max(map(len, seqs))
    letters = np.full((R, L), ord("N"), np.uint8)
    for i, s in enumerate(seqs):
        letters[i, : len(s)] = np.frombuffer(s.encode(), np.uint8)
    c = torch.from_numpy(dna.encode(letters)).to(dev).to(torch.int64)
    n_mask = torch.from_numpy(letters == ord("N") if skip_n else np.zeros((R, L), bool)).to(dev)
    lengths = torch.tensor([len(s) for s in seqs], dtype=torch.int64, device=dev)
    base = torch.where(c < 4, c, 0)
    four = (c == 4).to(torch.int64)
    P = L - k + 1

    def field(i):  # the packed 2-bit field of window base i, (R, P)
        f = base[:, i : i + P]
        return f | four[:, i + 1 : i + 1 + P] if i % 16 != 15 and i + 1 < k else f

    fwd, rc = [], []
    for w in range(kmer_words(k)):
        a = torch.zeros((R, P), dtype=torch.int64, device=dev)
        b = torch.zeros_like(a)
        for jj in range(min(16, k - 16 * w)):
            j = 16 * w + jj
            a = a | (field(j) << (30 - 2 * jj))
            b = b | ((3 - field(k - 1 - j)) << (30 - 2 * jj))
        fwd.append(a)
        rc.append(b)
    fwd, rc = torch.stack(fwd, dim=-1), torch.stack(rc, dim=-1)
    use_rc = lex_less(rc, fwd)
    canon = torch.where(use_rc[..., None], rc, fwd)
    valid = window_valid(lengths, n_mask, k)
    return canon_to_keys(canon, valid), valid, use_rc & valid
