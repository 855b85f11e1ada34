"""coverage_fit_s: seconds per job in GenomicInfoFiller (the coverage
model's fit), summed over every K."""
from bench_gpu.records import stage_seconds


def read(rec):
    return stage_seconds(rec, ids=("ec_threshold_finder",))
