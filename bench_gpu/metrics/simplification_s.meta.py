"""simplification_s.meta: seconds per job in RawSimplification and
Simplification, summed over every K (in `meta.asm`, Simplification runs the
numpy loop with the relative-coverage disconnector and its flanking index)."""
from bench_gpu.records import stage_seconds


def read(rec):
    return stage_seconds(rec, ids=("raw_simplification", "simplification"))
