"""rr_s: seconds per job in DistanceEstimation and RepeatResolution (both
passes)."""
from bench_gpu.records import stage_seconds


def read(rec):
    return stage_seconds(rec, prefixes=("distance_estimation", "repeat_resolving"))
