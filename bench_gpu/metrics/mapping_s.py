"""mapping_s: seconds per job in the gap closers and PairInfoCount (both
passes), summed over every K."""
from bench_gpu.records import stage_seconds


def read(rec):
    return stage_seconds(rec, ids=("gap_closer_early", "gap_closer_late"),
                         prefixes=("pair_info_count",))
