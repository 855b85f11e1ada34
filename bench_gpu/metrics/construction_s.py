"""construction_s: seconds per job in Construction, summed over every K."""
from bench_gpu.records import stage_seconds


def read(rec):
    return stage_seconds(rec, ids=("construction",))
