"""cli_io_s.ec: `cli_io_s` in the cells that report no `job_s`."""
from bench_gpu.records import ec_seconds, per_job


def read(rec):
    return per_job(rec, lambda j: j["wall_s"] - sum(s for _k, _i, s in j["stage_times"])
                   - (ec_seconds(j) or 0.0))
