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

Two builds give the same index, inverse indices included:
`build_extension_index_device` from the table's key planes in torch, on a
card or on CPU tensors (the contributions and the run OR that
`parallel/sharded_extension.py` shares), and the native `stbr_build_ext`
on the host, which `build_extension_index` runs where the library loads.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import kmers as K
from .count import KmerCounts, RowIndex, _lex_order, _words_of_keys

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

    @property
    def num_arcs(self) -> int:
        """Oriented (k+1)-mers: every set bit of both masks."""
        return int(POPCOUNT4[self.out_mask].sum(dtype=np.int64)
                   + POPCOUNT4[self.in_mask].sum(dtype=np.int64))

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
    """Build the extension index, with its inverse indices, from unique
    canonical (k+1)-mers, on the host.

    `native/graph.cpp stbr_build_ext` radix-sorts the prefix/suffix
    contributions where the native library loads; elsewhere the device
    build runs on CPU tensors and gives the same arrays."""
    k = p1.k - 1
    if k % 2 == 0:
        raise ValueError(f"k must be odd (got k={k})")
    from ..native import build_ext_native

    nat = build_ext_native(p1.words, k) if p1.num_unique else None
    if nat is None:
        return build_extension_index_device(keys_to_device(p1.words, "cpu"), k).to_host()
    kmers, in_mask, out_mask, pref_idx, pref_rc, suf_idx, suf_rc = nat
    return ExtensionIndex(k=k, kmers=kmers, in_mask=in_mask, out_mask=out_mask,
                          pref_idx=pref_idx, pref_rc=pref_rc, suf_idx=suf_idx, suf_rc=suf_rc)


# ---------------------------------------------------------------------------
# On the device: the same index from the table's key planes, in torch.  Words
# are int64-held uint32, as everywhere in the port's torch code; keys are the
# count's int64 sort planes (`keys_of_words`).
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
# rows of the (k+1)-mer table turned into contributions at once, and
# contributions sorted at once: neither the whole table as (N, W) words nor
# one sort of every contribution is held on the device
_SLICE_ROWS = 1 << 20
_SORT_ROWS = 1 << 22


def _mask_tail_j(words: torch.Tensor, k: int) -> torch.Tensor:
    """Zero the bits past base k-1 of (N, W) words."""
    W = words.shape[-1]
    used_last = k - 16 * (W - 1)
    if used_last == 16:
        return words
    out = words.clone()
    out[:, W - 1] &= (_M32 << (32 - 2 * used_last)) & _M32
    return out


def _prefix_kmer_j(p1words: torch.Tensor, k: int) -> torch.Tensor:
    return _mask_tail_j(p1words[:, : K.kmer_words(k)], k)


def _suffix_kmer_j(p1words: torch.Tensor, k: int) -> torch.Tensor:
    shifted = (p1words << 2) & _M32
    shifted[:, :-1] |= p1words[:, 1:] >> 30
    return _mask_tail_j(shifted[:, : K.kmer_words(k)], k)


def _rev2(x: torch.Tensor) -> torch.Tensor:
    """Reverse the sixteen 2-bit fields of int64-held uint32 words."""
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & _M32


def revcomp_words_t(words: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of packed k-mers (N, W), int64-held uint32 words
    (`core/kmers.py:revcomp_words` in torch)."""
    W = words.shape[-1]
    rev = [_rev2(~words[:, W - 1 - w] & _M32) for w in range(W)]
    pad = 32 * W - 2 * k
    if pad:
        rev = [((rev[w] << pad) & _M32) | (rev[w + 1] >> (32 - pad) if w + 1 < W else 0)
               for w in range(W)]
    return torch.stack(rev, dim=-1)


def _canonicalize_j(words: torch.Tensor, k: int):
    rc = revcomp_words_t(words, k)
    use_rc = K.lex_less(rc, words)
    return torch.where(use_rc[:, None], rc, words), use_rc


def keys_of_words(words: torch.Tensor) -> torch.Tensor:
    """(N, W) int64-held uint32 words -> (ceil(W/2), N) sort keys."""
    if words.shape[1] % 2:
        words = torch.cat([words, torch.zeros_like(words[:, :1])], dim=1)
    u = (words[:, 0::2] << 32) | words[:, 1::2]
    return (u ^ torch.iinfo(torch.int64).min).T.contiguous()


def keys_to_device(words: np.ndarray, device) -> torch.Tensor:
    """Host (N, W) uint32 words -> (ceil(W/2), N) int64 key planes on
    `device`: the words cross as they are, 4 bytes each, and become planes
    there."""
    n, W = words.shape
    w = torch.from_numpy(np.ascontiguousarray(words, np.uint32).view(np.int32)).to(device)
    keys = torch.empty((K.key_planes(16 * W), n), dtype=torch.int64, device=device)
    for j in range(keys.shape[0]):
        u = (w[:, 2 * j].to(torch.int64) & _M32) << 32
        if 2 * j + 1 < W:
            u |= w[:, 2 * j + 1].to(torch.int64) & _M32
        keys[j] = u ^ torch.iinfo(torch.int64).min
    return keys


def _contributions(s: torch.Tensor, k: int):
    """Unique canonical (k+1)-mer words (N, W1) -> (k-mer words (2N, Wk),
    payload (2N,)): each prefix and suffix with its in/out bits, out bits in
    the low nibble and in bits in the high one (the JAX package's layout).
    A stored-rc prefix sets only an in bit and a stored-rc suffix only an
    out bit, so the payload also says which of the two was stored rc."""
    w_last, j_last = divmod(k, 16)
    last = (s[:, w_last] >> (30 - 2 * j_last)) & 3
    first = s[:, 0] >> 30
    pref, pref_rc = _canonicalize_j(_prefix_kmer_j(s, k), k)
    suf, suf_rc = _canonicalize_j(_suffix_kmer_j(s, k), k)
    one = torch.ones_like(last)
    p_out = torch.where(pref_rc, 0, one << last)
    p_in = torch.where(pref_rc, one << (3 - last), 0)
    s_in = torch.where(suf_rc, 0, one << first)
    s_out = torch.where(suf_rc, one << (3 - first), 0)
    return (torch.cat([pref, suf]),
            torch.cat([p_out | (p_in << 4), s_out | (s_in << 4)]))


def _run_starts(planes) -> torch.Tensor:
    """Sorted key planes (an iterable of (N,) tensors, taken one at a time)
    -> (N,) bool, True where a run of equal keys starts."""
    starts = diff = None
    for p in planes:
        if starts is None:
            starts = torch.ones(p.shape[0], dtype=torch.bool, device=p.device)
            diff = torch.zeros(max(p.shape[0] - 1, 0), dtype=torch.bool, device=p.device)
        diff |= p[1:] != p[:-1]
    starts[1:] = diff
    return starts


def _or_by_run(seg: torch.Tensor, pay: torch.Tensor, u: int) -> torch.Tensor:
    """OR of the payloads of each run: seg (N,) int64 run ids, pay (N,)
    eight bits each -> (u,) int64, one max-scatter per payload bit."""
    orred = torch.zeros(u, dtype=torch.int64, device=pay.device)
    for b in range(8):
        got = torch.zeros(u, dtype=torch.int32, device=pay.device)
        got.scatter_reduce_(0, seg, ((pay >> b) & 1).to(torch.int32), reduce="amax")
        orred |= got.to(torch.int64) << b
    return orred


def _or_runs(keys: torch.Tensor, pay: torch.Tensor):
    """Sorted (nK, N) keys and their payloads -> (run keys (nK, U), OR of
    each run's payloads (U,))."""
    starts = _run_starts(keys)
    seg = torch.cumsum(starts, 0) - 1
    return keys[:, starts], _or_by_run(seg, pay, int(starts.sum()))


@dataclass
class DeviceExtensionIndex:
    """The extension index on the device: what `ExtensionIndex` holds with
    its inverse indices, plus the two end bases of every (k+1)-mer row, so
    that condensation places every arc from the rows alone."""

    k: int
    kmers: torch.Tensor     # (nK, U) int64 key planes, sorted
    in_mask: torch.Tensor   # (U,) uint8
    out_mask: torch.Tensor  # (U,) uint8
    pref_idx: torch.Tensor  # (P,) int32 row of each (k+1)-mer's canonical prefix
    pref_rc: torch.Tensor   # (P,) uint8, 1 where that prefix is stored rc
    suf_idx: torch.Tensor   # (P,) int32
    suf_rc: torch.Tensor    # (P,) uint8
    first: torch.Tensor     # (P,) uint8 base 0 of each (k+1)-mer
    last: torch.Tensor      # (P,) uint8 base k

    @property
    def num_kmers(self) -> int:
        return int(self.kmers.shape[1])

    @property
    def num_arcs(self) -> int:
        """Oriented (k+1)-mers: every set bit of both masks."""
        pop = torch.as_tensor(POPCOUNT4, device=self.kmers.device)
        return int(pop[self.out_mask.int()].sum() + pop[self.in_mask.int()].sum())

    def to_host(self) -> ExtensionIndex:
        """The same index as `build_extension_index` gives, on the host."""
        return ExtensionIndex(
            k=self.k,
            kmers=K.keys_to_words(self.kmers.T.contiguous().cpu().numpy(),
                                  K.kmer_words(self.k)),
            in_mask=self.in_mask.cpu().numpy(), out_mask=self.out_mask.cpu().numpy(),
            pref_idx=self.pref_idx.cpu().numpy().astype(np.int64),
            pref_rc=self.pref_rc.cpu().numpy(),
            suf_idx=self.suf_idx.cpu().numpy().astype(np.int64),
            suf_rc=self.suf_rc.cpu().numpy(),
        )


def _sort_slices(top: torch.Tensor | None, n: int):
    """Ranges of the first plane's top byte [b0, b1) whose contributions
    sort together, each at most `_SORT_ROWS` of them unless one byte value
    alone holds more; (0, 256) alone when `top` is None."""
    if top is None:
        return [(0, 256)]
    hist = torch.bincount(top, minlength=256).cpu().tolist()
    out, b0, rows = [], 0, 0
    for b, c in enumerate(hist):
        if rows and rows + c > _SORT_ROWS:
            out.append((b0, b))
            b0, rows = b, 0
        rows += c
    out.append((b0, 256))
    return out


def build_extension_index_device(keys: torch.Tensor, k: int) -> DeviceExtensionIndex:
    """The extension index, with its inverse indices, from the unique
    canonical (k+1)-mers' key planes (nK, P) on their device: what
    `stbr_build_ext` gives, in torch.

    Every row's canonical prefix and suffix contribute a k-mer key and a
    payload bit (`_contributions`, row slice by row slice); the 2P keys are
    sorted (`_lex_order`, in ranges of the first plane's top byte when they
    are many); each run of equal keys is one k-mer, its masks the OR of its
    payloads, and each contribution's run id, scattered back by
    contribution id, is the inverse index.  Pass the planes as a temporary:
    they are let go once the contributions are made."""
    if k % 2 == 0:
        raise ValueError(f"k must be odd (got k={k})")
    dev = keys.device
    P = int(keys.shape[1])
    n2 = 2 * P
    if n2 >= 2**31:
        raise ValueError(f"{P} (k+1)-mers: row ids must fit int32")
    nK, W1 = K.key_planes(k), K.kmer_words(k + 1)
    ck = [torch.empty(n2, dtype=torch.int64, device=dev) for _ in range(nK)]
    pay = torch.empty(n2, dtype=torch.uint8, device=dev)
    first = torch.empty(P, dtype=torch.uint8, device=dev)
    last = torch.empty(P, dtype=torch.uint8, device=dev)
    w_last, j_last = divmod(k, 16)
    for lo in range(0, P, _SLICE_ROWS):
        hi = min(P, lo + _SLICE_ROWS)
        s = _words_of_keys(keys[:, lo:hi], W1)
        kms, pays = _contributions(s, k)
        planes = keys_of_words(kms)
        n = hi - lo
        for j in range(nK):
            ck[j][lo:hi] = planes[j, :n]
            ck[j][P + lo:P + hi] = planes[j, n:]
        pay[lo:hi] = pays[:n]
        pay[P + lo:P + hi] = pays[n:]
        first[lo:hi] = s[:, 0] >> 30
        last[lo:hi] = (s[:, w_last] >> (30 - 2 * j_last)) & 3
        del s, kms, pays, planes
    del keys

    # signed top byte of the first plane, shifted to 0..255: its order is the keys'
    top = ((ck[0] >> 56) + 128).to(torch.uint8) if n2 > _SORT_ROWS else None
    inv = torch.empty(n2, dtype=torch.int32, device=dev)
    kmer_parts: list[list[torch.Tensor]] = [[] for _ in range(nK)]
    mask_parts = []
    u = 0
    for b0, b1 in _sort_slices(top, n2):
        if top is None:
            sel, sub = None, ck
        else:
            inside = top >= b0
            if b1 < 256:
                inside &= top < b1
            sel = torch.nonzero(inside).squeeze(1)
            sub = [c[sel] for c in ck]
        order = _lex_order(sub)
        starts = _run_starts(c[order] for c in sub)
        seg = torch.cumsum(starts, 0) - 1
        heads = order[starts]
        for j in range(nK):
            kmer_parts[j].append(sub[j][heads])
        ids = order if sel is None else sel[order]
        inv[ids] = (seg + u).to(torch.int32)
        mask_parts.append(_or_by_run(seg, pay[ids], int(heads.shape[0])))
        u += int(heads.shape[0])
        del sel, sub, order, starts, seg, heads, ids
    del ck, top
    if u:
        kmers = torch.stack([torch.cat(p) for p in kmer_parts])
        masks = torch.cat(mask_parts)
    else:
        kmers = torch.empty((nK, 0), dtype=torch.int64, device=dev)
        masks = torch.empty(0, dtype=torch.int64, device=dev)
    return DeviceExtensionIndex(
        k=k, kmers=kmers,
        in_mask=(masks >> 4).to(torch.uint8), out_mask=(masks & 0xF).to(torch.uint8),
        pref_idx=inv[:P], pref_rc=((pay[:P] & 0xF) == 0).to(torch.uint8),
        suf_idx=inv[P:], suf_rc=((pay[P:] >> 4) == 0).to(torch.uint8),
        first=first, last=last,
    )
