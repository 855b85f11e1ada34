"""The card's published peaks and the least time of the canonical-windows
kernel (B1), frozen.

Copied from `spades_tpu_torch/tools/kernel_shapes.py` at commit
03f09d041c4a0200e08c73ef280347ed79565e0d (`H100_BYTES_PER_S`,
`H100_INT32_OPS_PER_S`, `canonical_windows_bound`), so that a later change
to the program cannot move the yardstick of its kernel.
"""
from __future__ import annotations

H100_BYTES_PER_S = 3.35e12     # HBM3 rate of an H100 SXM (NVIDIA data sheet)
# the non-tensor float32 peak of an H100 SXM (data sheet), taken as the rate
# of the kernel's 32-bit integer operations
H100_INT32_OPS_PER_S = 67e12


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
