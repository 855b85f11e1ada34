"""b1_roofline_pct: the canonical-windows kernel's share of its roofline:
the least time of every launch of the window (the frozen
`canonical_windows_bound` of its (R, L, k, strand), from the program's
launch counter) over the kernel's device time in the traced window."""
from bench_gpu.peaks import canonical_windows_bound

KERNEL = "canonical_windows_kernel"


def read(rec):
    if rec["trace"] is None:
        return None
    device_s = sum(s for n, s in rec["trace"]["by_name"].items() if KERNEL in n)
    least_s = sum(n * canonical_windows_bound(R, L, k, bool(strand))[0] / 1e3
                  for job in rec["jobs"] for R, L, k, strand, n in job["b1_shapes"])
    if device_s <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / device_s
