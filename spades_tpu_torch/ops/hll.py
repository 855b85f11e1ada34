"""HyperLogLog cardinality estimation for k-mer streams.

Counterpart of `spades_tpu.ops.hll` (SPAdes' `hll::hll` + `HllProcessor`,
`src/common/adt/hll.hpp:18`, `kmer_index/kmer_counting.hpp:23-120`, behind
`EstimateCardinalityUpperBound` and spades-kmer-estimating).  The canonical
windows of a packed read batch come from the canonical-window kernel
(`ops/cuda_kernels.py`); each k-mer's W words are recovered from its sort
keys and hashed twice (the JAX package's `_hash2`, murmur3 finalizers); the
bucket is the low 12 bits of the first hash and the rank `clz(h2|1) + 1`,
and one `scatter_reduce(amax)` gives the 4,096 registers.  Torch has no
unsigned 32-bit arithmetic, so every uint32 value is carried in an int64
and every product is kept below 2**63 (`_mul32`).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core import kmers as K
from ..parallel.sharded_count import _M32, _mix32
from .cuda_kernels import canonical_window_keys

HLL_P = 12  # 4096 registers, ~1.6% relative error (the reference's precision)
HLL_M = 1 << HLL_P


def _hash2(words: list[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """Two decorrelated 32-bit hashes per k-mer from its W words (int64-held
    uint32, most significant first)."""
    h1 = torch.zeros_like(words[0])
    h2 = torch.full_like(words[0], 0x9E3779B9)
    for w in words:
        h1 = _mix32(h1 ^ w)
        # w * 0x1000193 < 2**57: the product stays inside int64
        h2 = _mix32((h2 + w * 0x1000193) & _M32)
    return h1, h2


def key_words(keys: torch.Tensor, W: int) -> list[torch.Tensor]:
    """(ceil(W/2), N) sort keys -> W int64-held uint32 words of (N,), the
    inverse of the key layout `((w0 << 32) | w1) ^ INT64_MIN` (the padding
    word of an odd W dropped)."""
    words = []
    for j in range(keys.shape[0]):
        u = keys[j] ^ torch.iinfo(torch.int64).min      # the uint64 bit pattern
        words.append((u >> 32) & _M32)
        words.append(u & _M32)
    return words[:W]


def _rank(h2: torch.Tensor) -> torch.Tensor:
    """clz(h2 | 1) + 1 by the reference's bit smear and popcount."""
    y = h2 | 1
    for s in (1, 2, 4, 8, 16):
        y = y | (y >> s)
    v = y - ((y >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    pop = ((v * 0x01010101) & _M32) >> 24
    return 32 - pop + 1


def hll_registers(pc: torch.Tensor, pn: torch.Tensor, lengths: torch.Tensor,
                  L: int, k: int) -> torch.Tensor:
    """One pass over a packed read batch (`ReadBatch.packed()`, on one
    device) -> (HLL_M,) uint8 register maxima on that device.  On a CUDA
    tensor the windows come from the canonical-window kernel (or it raises);
    on a CPU tensor from its plain version."""
    keys, valid = canonical_window_keys(pc, pn, lengths, L, k)
    h1, h2 = _hash2(key_words(keys, K.kmer_words(k)))
    bucket = h1 & (HLL_M - 1)
    rank = torch.where(valid.reshape(-1), _rank(h2), 0)
    regs = torch.zeros(HLL_M, dtype=torch.int64, device=pc.device)
    regs.scatter_reduce_(0, bucket, rank, reduce="amax")
    return regs.to(torch.uint8)


def merge_registers(regs: list[np.ndarray]) -> np.ndarray:
    out = np.zeros(HLL_M, np.uint8)
    for r in regs:
        out = np.maximum(out, np.asarray(r))
    return out


def estimate_cardinality(registers: np.ndarray) -> float:
    """Standard HLL estimator with small-range correction (the JAX package's
    float64 numpy, so the estimate is bit-equal)."""
    regs = np.asarray(registers, np.float64)
    m = float(HLL_M)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    est = alpha * m * m / np.sum(np.exp2(-regs))
    zeros = np.sum(regs == 0)
    if est <= 2.5 * m and zeros > 0:
        est = m * np.log(m / zeros)
    return float(est)


def kmer_registers(batches, k: int, device=None) -> np.ndarray | None:
    """Merged registers of every ReadBatch that holds a k-mer window, or None
    when none does."""
    dev = resolve_device(device)
    regs = []
    for b in batches:
        if b.codes.shape[0] == 0 or b.codes.shape[1] < k:
            continue
        pc, pn, lengths, L = b.packed()
        pc, pn, lengths = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                           for a in (pc, pn, lengths))
        regs.append(hll_registers(pc, pn, lengths, L, k).cpu().numpy())
    return merge_registers(regs) if regs else None


def estimate_kmer_cardinality(batches, k: int, device=None) -> float:
    """Host loop over ReadBatches: the spades-kmer-estimating path."""
    regs = kmer_registers(batches, k, device=device)
    return 0.0 if regs is None else estimate_cardinality(regs)
