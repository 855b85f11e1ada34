"""second_phase_s: seconds per job in meta's preliminary repeat resolution
and the second phase's set-up (PairInfoCount, DistanceEstimation and
RepeatResolution of the first pass, then SecondPhaseSetup), at the last K;
None where no such stage ran."""
from bench_gpu.records import stage_seconds


def read(rec):
    return stage_seconds(rec, ids=("pair_info_count_preliminary",
                                   "distance_estimation_preliminary",
                                   "repeat_resolving_preliminary", "second_phase_setup"))
