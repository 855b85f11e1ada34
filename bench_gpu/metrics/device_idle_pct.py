"""device_idle_pct: the share of the jobs' wall time in which no kernel,
copy or memset ran on the device (the profiler's trace)."""


def read(rec):
    if rec["trace"] is None or rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["trace"]["busy_s"] / rec["window_s"])
