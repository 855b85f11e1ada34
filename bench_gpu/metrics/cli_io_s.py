"""cli_io_s: seconds per job outside every stage and outside error
correction: FASTQ parsing, library set-up, writing corrected reads and
outputs, checkpoints."""
from bench_gpu.records import ec_seconds, per_job


def read(rec):
    return per_job(rec, lambda j: j["wall_s"] - sum(s for _k, _i, s in j["stage_times"])
                   - (ec_seconds(j) or 0.0))
