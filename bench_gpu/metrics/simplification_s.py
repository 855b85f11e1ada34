"""simplification_s: seconds per job in RawSimplification and
Simplification, summed over every K."""
from bench_gpu.records import stage_seconds


def read(rec):
    return stage_seconds(rec, ids=("raw_simplification", "simplification"))
