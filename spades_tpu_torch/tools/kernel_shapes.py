"""Yardsticks of the canonical-windows kernel: the shapes the main path gives
it, random inputs, the card's bound and a timer; and the coverage EM
kernel's bound.  One copy, used by
`chip_smoke.py` and `tools/kernel_bench.py`."""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core.reads import ReadBatch

H100_BYTES_PER_S = 3.35e12     # HBM3 rate of an H100 SXM (NVIDIA data sheet)
# the non-tensor float32 peak of an H100 SXM (data sheet), taken as the rate
# of the kernel's 32-bit integer operations
H100_INT32_OPS_PER_S = 67e12

# name, rows, padded row length, k, strand plane, length of every row (None:
# ragged, k..L).  The index tiers are the row plans of `build_index_device`
# (2^25 bases a step), the rest are slices of 150-base reads.  A 21,33,55
# ladder counts (k+1)-mers at 22, 34 and 56 and maps, prefilters and indexes
# at each k; `gbuilder` and the mapping pass on its graph run at k=55.  Read
# error correction counts 21-mers in batches of 65,536 reads and takes its
# window maps in batches of 8,192 reads with the strand plane (150-base reads
# pad to 256).
def _ladder_shapes(k: int):
    return (
        (f"index tier 8192 k={k}, strand", 4096, 8192, k, True, 8192),
        (f"index tier 2048 k={k}, strand", 16384, 2048, k, True, 2048),
        (f"index tier 256 k={k}, strand", 131072, 256, k, True, None),
        (f"prefilter sub-slice k={k}", 65536, 152, k, False, 150),
        (f"mapper sub-slice k={k}, strand", 131072, 152, k, True, 150),
    )


MAIN_SHAPES = (
    *_ladder_shapes(21),
    *_ladder_shapes(33),
    *_ladder_shapes(55),
    ("ReadBatch k=56", 65536, 256, 56, False, 150),
    ("ReadStore chunk k=22", 262144, 152, 22, False, 150),
    ("ReadStore chunk k=34", 262144, 152, 34, False, 150),
    ("ReadStore chunk k=56", 262144, 152, 56, False, 150),
    ("hammer count k=21", 65536, 256, 21, False, 150),
    ("hammer maps k=21, strand", 8192, 256, 21, True, 150),
)


def random_packed(seed: int, R: int, L: int, k: int, read_len: int | None = None,
                  n_rate: float = 0.03):
    """Packed wire arrays (pc, pn, lengths, L) of R random reads in an (R, L)
    batch: ragged lengths in [k, L] (or all `read_len`), ~n_rate N bases."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (R, L), dtype=np.uint8)
    if read_len is None:
        lengths = rng.integers(k, L + 1, R).astype(np.int32)
        lengths[: R // 8] = L
    else:
        lengths = np.full(R, read_len, np.int32)
    pos = np.arange(L)[None, :]
    codes[pos >= lengths[:, None]] = 0
    n_mask = (rng.random((R, L), dtype=np.float32) < n_rate) & (pos < lengths[:, None])
    return ReadBatch(codes=codes, lengths=lengths, n_mask=n_mask).packed()


def canonical_windows_bound(R: int, L: int, k: int,
                            strand: bool = False) -> tuple[float, str]:
    """Least time (ms) an H100 needs for one canonical-windows call, and
    what bounds it: each input byte read once, each output byte written once
    (bytes; one more per window with the strand plane), or ~16 integer
    operations per k-mer word and per window."""
    W = (k + 15) // 16
    P = L - k + 1
    nbytes = (R * ((L + 3) // 4 + (L + 7) // 8 + 4)
              + R * P * (8 * ((W + 1) // 2) + 1 + (1 if strand else 0)))
    ops = R * P * 16 * (W + 1)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# float64 instructions of the coverage EM's objective, estimated (not read
# from the SASS): each (bin, copy) term an exp (about 20), an erf (about 30)
# and about 15 more; each bin's error density two pows (about 40 each), two
# logs (about 25 each) and about 10 more
EM_TERM_OPS = 65
EM_BIN_OPS = 140
# FP64 lanes of one H100 SM, and its boost clock
H100_FP64_LANES_PER_SM = 64
H100_SM_HZ = 1.98e9


def coverage_em_bound(bins: int, evals: int, copies: int = 10) -> float:
    """Least time (ms) the coverage EM kernel needs for `evals` evaluations
    of its objective over `bins` non-empty bins: one block, so the float64
    work of each evaluation over the FP64 lanes of one SM, the evaluations
    one after another (each simplex step needs the last)."""
    ops = bins * (copies * EM_TERM_OPS + EM_BIN_OPS)
    return evals * ops / (H100_FP64_LANES_PER_SM * H100_SM_HZ) * 1e3


def key_words(keys: torch.Tensor) -> torch.Tensor:
    """(nK, N) int64 sort keys -> (2nK, N) int64 holding the uint32 words."""
    u = keys ^ torch.iinfo(torch.int64).min
    return torch.cat([(u >> 32) & 0xFFFFFFFF, u & 0xFFFFFFFF])


def max_abs_err(got, ref) -> int:
    """Largest difference between two (keys, valid[, was_rc]) results: of the
    keys' uint32 words, else the count of differing flags."""
    if len(got) != len(ref) or any(a.shape != b.shape for a, b in zip(got, ref)):
        raise ValueError("the two results differ in shape")
    err = int((key_words(got[0]) - key_words(ref[0])).abs().max())
    for a, b in zip(got[1:], ref[1:]):
        err = max(err, int((a != b).sum()))
    return err


def time_ms(fn, dev, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call: CUDA events on the card, else the host clock."""
    for _ in range(warmup):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters
